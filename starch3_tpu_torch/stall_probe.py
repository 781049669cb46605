"""Which host calls wait on a stalled CUDA stream.

From the root of the repository, on a machine with one CUDA card, each
in a fresh process (a cold CUDA context and host allocator are the case):

    python -m starch3_tpu_torch.stall_probe alloc
    python -m starch3_tpu_torch.stall_probe dispatch
    CUDA_MODULE_LOADING=EAGER python -m starch3_tpu_torch.stall_probe dispatch

Each case first enqueues a ``torch.cuda._sleep`` spin of 2 s (``alloc``)
or 3 s (``dispatch``) on the current stream, then times host calls with
the host clock, then synchronizes.  ``alloc``: a page-locked
``torch.empty`` of a size the caching host allocator has not seen, the
same after a warm-up of its size, ``Tensor.pin_memory()``, a
non-blocking upload, and a cold and a warm page-locked ``torch.empty``
while another thread's launches are blocked on the full stream.
``dispatch``: each part of a fast-mode bits-4 batch of three config-2
blocks as the driver once ran it on its own thread (pack, pin, upload,
the BWT, the width-16 MTF kernel, the rows' pinned buffer and copy, the
event), twice: the first launches of a process load their kernels.
Prints one line per call.
"""

from __future__ import annotations

import sys
import threading
import time

import torch


def _timed(label: str, fn):
    t0 = time.perf_counter()
    out = fn()
    print(f"  {label}: {time.perf_counter() - t0:.4f} s", flush=True)
    return out


def _stall(seconds: float) -> None:
    """Enqueue a spin of about ``seconds`` on the current stream, its
    clock cycles per second timed first with CUDA events."""
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    torch.cuda._sleep(100_000_000)
    b.record()
    b.synchronize()
    torch.cuda._sleep(int(seconds * 100_000_000 / (a.elapsed_time(b) / 1e3)))


def _pinned(n: int) -> torch.Tensor:
    return torch.empty(n, dtype=torch.uint8, pin_memory=True)


def probe_alloc() -> None:
    _stall(2.0)
    _timed("pinned empty, 7.3 MB, cold", lambda: _pinned(7_300_000))
    _timed("synchronize", torch.cuda.synchronize)
    _pinned(5_100_000)  # freed at once, kept by the caching host allocator
    _stall(2.0)
    _timed("pinned empty, 5.1 MB, warm", lambda: _pinned(5_100_000))
    _timed("synchronize", torch.cuda.synchronize)
    pageable = torch.zeros(3_300_001, dtype=torch.uint8)
    _stall(2.0)
    pin = _timed("pin_memory(), 3.3 MB, cold", pageable.pin_memory)
    _timed("non-blocking upload of it", lambda: pin.to("cuda", non_blocking=True))
    _timed("synchronize", torch.cuda.synchronize)
    small = torch.zeros(16, device="cuda")
    _stall(2.0)
    filler = threading.Thread(target=lambda: [small.add_(1) for _ in range(5000)])
    filler.start()
    time.sleep(0.3)
    print(f"  another thread's 5,000 launches blocked: {filler.is_alive()}", flush=True)
    _timed("pinned empty, 9.1 MB, cold, beside them", lambda: _pinned(9_100_000))
    _timed("pinned empty, 5.1 MB, warm, beside them", lambda: _pinned(5_100_000))
    filler.join()
    torch.cuda.synchronize()


def probe_dispatch() -> None:
    from starch3_tpu_torch.ops.mtf_narrow import mtf_ranks_narrow_batch
    from starch3_tpu_torch.parallel import host, pipeline
    from starch3_tpu_torch.profile_kernels import corpus_texts

    texts = corpus_texts("config2", 5)[:3]
    datas = [blk.data for t in texts for blk in host._split_classify(t, 9)[0]][:3]
    n_max, dev = 458_752, torch.device("cuda")
    for rnd in range(2):
        print(f" batch {rnd}, behind a 3 s stall", flush=True)
        _stall(3.0)
        t0 = time.perf_counter()
        packed, lens, _nsyms, _useds = _timed("pack_batch", lambda: pipeline.pack_batch(datas, n_max, 4, 3))
        packed = _timed("pin_memory()", packed.pin_memory)
        packed = _timed("upload", lambda: packed.to(dev, non_blocking=True))
        lens = torch.from_numpy(lens).pin_memory().to(dev, non_blocking=True)
        last, ptrs, ties = _timed("bwt_of_batch", lambda: pipeline.bwt_of_batch(packed, lens, 4, n_max))
        ranks = _timed("mtf_ranks_narrow_batch", lambda: mtf_ranks_narrow_batch(last, 16))
        rows = torch.cat([ptrs[:, None], ties[:, None], ranks], 1)
        out = _timed("pinned rows buffer", lambda: torch.empty(rows.shape, dtype=rows.dtype, pin_memory=True))
        _timed("non-blocking copy", lambda: out.copy_(rows, non_blocking=True))
        _timed("event", lambda: torch.cuda.Event().record())
        print(f"  the batch's host time: {time.perf_counter() - t0:.4f} s", flush=True)
        _timed("synchronize", torch.cuda.synchronize)


def main(argv=None) -> int:
    case = (argv or sys.argv[1:] or ["alloc"])[0]
    if not torch.cuda.is_available():
        raise SystemExit("stall_probe needs a CUDA card")
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    print(f"{case}: {torch.cuda.get_device_name(0)}", flush=True)
    {"alloc": probe_alloc, "dispatch": probe_dispatch}[case]()
    return 0


if __name__ == "__main__":
    sys.exit(main())
