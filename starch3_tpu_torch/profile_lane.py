"""Where the device lane's time goes in a hybrid encode: each drain-rate
sample of the driver (``note_drain`` in ``parallel/pipeline.py``) with its
parts, each batch's pack, and how long a thread that slept 1 ms waits to
run Python again (the GIL's hand-over) while the encode runs.

    python -m starch3_tpu_torch.profile_lane BED [--feed file|texts|paced]
        [--rate MB_PER_S] [--device cuda] [--level 9]

``file`` encodes BED through ``api.compress_bed_file(use_jax=True)``, the
streaming feed of ``scale_run encode --jax`` (without its RSS sampler).
``texts`` transforms each chromosome before the encode and feeds the texts
to ``pipeline.encode_streams_iter`` as fast as it takes them; ``paced``
feeds them at ``--rate`` MB/s of text.  The two leave out the file entry's
chunk handling, so they tell the feed's share of the lane's time from the
rest.  Prints one JSON line: the rate in MB/s (of BED for ``file``, of text
otherwise), ``scheduler_stats``, the device's blocks and batches, every
rate sample (``dry`` when its batch found the pipeline empty, ``queued``
when it ran behind another, ``first`` when no drain came before it) with
the pack, drain and device ms, the rate the rule gives it, the driver's
rate after it and the line below which it benches the device (half the
stealers' aggregate), the medians of
each kind, and the 10th, 50th, 90th and 99th percentiles and the maximum
of the pack's ms over every batch and of the GIL probe's wait.
On a card the device ms are CUDA-event times; on the CPU the step's wall
time.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time


def _quantiles(values, fractions=(0.1, 0.5, 0.9, 0.99, 1.0)):
    v = sorted(values)
    return [round(v[int(f * (len(v) - 1))], 3) for f in fractions] if v else []


def _chromosome_texts(path: str) -> list[bytes]:
    from starch3_tpu_torch.runtime import bed_transform_native
    from starch3_tpu_torch.scale_run import iter_chromosome_raw

    with open(path, "rb") as f:
        return [bed_transform_native(raw)[0][1] for _chrom, raw in iter_chromosome_raw(f)]


def _paced(texts, rate: float | None):
    t0, sent = time.monotonic(), 0
    for text in texts:
        if rate:
            wait = t0 + sent / rate - time.monotonic()
            if wait > 0:
                time.sleep(wait)
        sent += len(text)
        yield text


def run(path: str, feed: str = "file", rate_mb_s: float = 35.0, device: str = "cuda", level: int = 9) -> dict:
    """One hybrid encode of ``path`` under ``feed``, with the driver's rate
    samples, the packs and the GIL probe recorded; the patched names are
    restored and the probe thread joined before it returns."""
    from starch3_tpu_torch.parallel import host, pipeline
    from starch3_tpu_torch.scale_run import _zero_counters

    texts = _chromosome_texts(path) if feed != "file" else None
    samples, packs, probe, queues = [], [], [], []
    last_drain = [None]
    real_pack, real_after_all = pipeline.pack_batch, pipeline._after_all
    real_stealers = pipeline._start_host_stealers

    def start_stealers(q, *args):
        queues.append(q)
        return real_stealers(q, *args)

    def pack_batch(*args, **kw):
        t0 = time.perf_counter()
        try:
            return real_pack(*args, **kw)
        finally:
            packs.append((time.perf_counter() - t0) * 1e3)

    def after_all(n, note):
        # ``note`` is note_drain bound to (nbytes, bits, t_dispatch, pack_s)
        nbytes, _bits, t_dispatch, pack_s = note.args

        def record(work_s: float, device_s: float) -> None:
            now, prev = time.monotonic(), last_drain[0]
            last_drain[0] = now
            kind = "first" if prev is None else "queued" if t_dispatch < prev else "dry"
            span = now - prev if kind == "queued" else max(pack_s + work_s, device_s)
            note(work_s, device_s)
            q = queues[-1]
            samples.append({"kind": kind, "pack_ms": pack_s * 1e3, "drain_ms": work_s * 1e3,
                            "device_ms": device_s * 1e3, "span_ms": span * 1e3,
                            "mb_per_s": nbytes / span / 1e6 if span > 0 else None,
                            "ema_mb_s": q.device_rate and q.device_rate / 1e6,
                            "bench_mb_s": q.stealer_rate and host._DEMOTE_FRACTION * q.stealer_rate
                            * q.n_stealers / 1e6, "benched": q.device_demoted})

        return real_after_all(n, record)

    stop = threading.Event()

    def gil_probe():
        while not stop.is_set():
            t0 = time.perf_counter()
            time.sleep(0.001)
            probe.append((time.perf_counter() - t0 - 0.001) * 1e3)
            time.sleep(0.01)

    _zero_counters()
    pipeline.pack_batch, pipeline._after_all = pack_batch, after_all
    pipeline._start_host_stealers = start_stealers
    prober = threading.Thread(target=gil_probe, name="gil-probe", daemon=True)
    prober.start()
    try:
        t0 = time.perf_counter()
        if feed == "file":
            from starch3_tpu_torch import api
            from starch3_tpu_torch.config import EncodeConfig

            with open(os.devnull, "wb") as out:
                api.compress_bed_file(path, out, EncodeConfig(use_jax=True, block_size_100k=level), device=device)
            n = os.path.getsize(path)
        else:
            rate = rate_mb_s * 1e6 if feed == "paced" else None
            for _ in pipeline.encode_streams_iter(_paced(texts, rate), level=level, device=device):
                pass
            n = sum(map(len, texts))
        seconds = time.perf_counter() - t0
    finally:
        stop.set()
        prober.join()
        pipeline.pack_batch, pipeline._after_all = real_pack, real_after_all
        pipeline._start_host_stealers = real_stealers
    res = {"feed": feed, "device": device, "level": level, "seconds": seconds, "mb_per_s": n / seconds / 1e6,
           "rate_mb_s": rate_mb_s if feed == "paced" else None,
           "scheduler_stats": dict(host.scheduler_stats),
           "device_blocks": pipeline.device_stats["blocks"], "device_batches": pipeline.device_stats["batches"],
           "samples": samples, "pack_ms": _quantiles(packs), "gil_wait_ms": _quantiles(probe)}
    for kind in ("dry", "queued"):
        of = [s for s in samples if s["kind"] == kind]
        res[kind] = {"n": len(of), **{k: (_quantiles([s[k] for s in of], (0.5,)) or [None])[0]
                                      for k in ("pack_ms", "drain_ms", "device_ms", "span_ms")}}
    if device.startswith("cuda"):
        import torch

        res["card"] = torch.cuda.get_device_name(0)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("bed")
    ap.add_argument("--feed", choices=("file", "texts", "paced"), default="file")
    ap.add_argument("--rate", type=float, default=35.0, help="MB/s of text for --feed paced")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--level", type=int, default=9)
    args = ap.parse_args(argv)
    print(json.dumps(run(args.bed, args.feed, args.rate, args.device, args.level)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
