"""Where the port's device path spends its time, on a CUDA card.

From the root of the repository, on a machine with one CUDA card:

    python -m starch3_tpu_torch.profile_step [--corpus NAME] [--seed N] [--reps N]

On one corpus of ``corpus.py``, each the main input of one alphabet tier
(``config2``: bits 4, the default; ``config3``: bits 5; ``bits6``;
``wide8``: bits 8), it prints:

  1. the tier's device step time for one production batch (3 blocks of
     the tier, bucket 458,752 at bits 4 and 901,120 otherwise): the
     median of CUDA-event timings;
  2. the device time of that step by operator, over ``--reps`` steps
     (``torch.profiler``), largest first;
  3. host time per block of the dense pack and of the native tail (RLE2
     at bits 4-6, Huffman, bit emission), on one thread;
  4. a device-only encode of the corpus under the profiler: wall time,
     device busy time and the device's idle share;
  5. where each host thread spends that encode: every thread's innermost
     frame and its caller, sampled each millisecond, by thread and line.
"""

from __future__ import annotations

import argparse
import collections
import os
import statistics
import sys
import threading
import time

import torch

from starch3_tpu_torch import api, corpus
from starch3_tpu_torch.parallel import pipeline


def _device_us(evt) -> float:
    return getattr(evt, "self_device_time_total", None) or getattr(evt, "self_cuda_time_total", 0.0)


def _profile(fn):
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(e.key, _device_us(e), e.count) for e in prof.key_averages()]
    return sorted((r for r in rows if r[1] > 0), key=lambda r: -r[1])


def _sample_threads(fn, period_s: float = 0.001):
    """Run ``fn`` while a sampler records every other thread's innermost
    frame and its caller each ``period_s``: {(thread name, where): count}."""
    counts: collections.Counter = collections.Counter()
    done = threading.Event()
    me = threading.get_ident()

    def sample():
        while not done.is_set():
            names = {t.ident: t.name for t in threading.enumerate()}
            for ident, frame in sys._current_frames().items():
                if ident == me or ident == threading.get_ident():
                    continue
                where = " < ".join(
                    f"{os.path.basename(f.f_code.co_filename)}:{f.f_lineno} {f.f_code.co_name}"
                    for f in (frame, frame.f_back) if f is not None
                )
                name = names.get(ident, "?").rstrip("0123456789_")
                counts[(name, where)] += 1
            time.sleep(period_s)

    sampler = threading.Thread(target=sample, name="sampler", daemon=True)
    sampler.start()
    try:
        fn()
    finally:
        done.set()
        sampler.join()
    return counts


# corpus name -> (generator taking a seed, alphabet class, bucket)
CORPORA = {
    "config2": (corpus.config2_bed, 4, 458_752),
    "config3": (corpus.config3_bed, 5, 901_120),
    "bits6": (corpus.bits6_bed, 6, 901_120),
    "wide8": (corpus.wide8_bed, 8, 901_120),
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--corpus", choices=sorted(CORPORA), default="config2")
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("profile_step needs a CUDA card")
    dev = torch.device("cuda")
    print(f"device {torch.cuda.get_device_name(0)}; torch {torch.__version__}")

    make, bits, n_max = CORPORA[args.corpus]
    texts = [tf.text for tf in api._parse_transform(make(seed=args.seed))]
    blocks = []
    for t in texts:
        bl, cl = pipeline._split_classify(t, 9)
        blocks += [b for b, c in zip(bl, cl) if c == bits and len(b.data) <= n_max]
        if len(blocks) >= 3:
            break
    blocks = blocks[:3]
    t0 = time.perf_counter()
    host, lens, nsyms, useds = pipeline.pack_batch([b.data for b in blocks], n_max, bits)
    pack_ms = (time.perf_counter() - t0) * 1e3 / len(blocks)
    seqs_d, lens_d, nsyms_d = (torch.as_tensor(x).to(dev) for x in (host, lens, nsyms))

    def step():
        return pipeline.step_for_class(seqs_d, lens_d, nsyms_d, bits, n_max)

    step()
    torch.cuda.synchronize()
    times = []
    for _ in range(args.reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        step()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    print(f"{args.corpus} bits {bits} step (3, {n_max}): median {statistics.median(times)} ms device, "
          f"min {min(times)} ms, over {args.reps} steps; block lengths {lens.tolist()}")

    rows = _profile(lambda: [step() for _ in range(args.reps)])
    total = sum(r[1] for r in rows)
    print(f"device time by operator, {args.reps} steps ({total / args.reps / 1e3} ms per step):")
    for key, us, count in rows[:20]:
        print(f"  {us / args.reps / 1e3:10.4f} ms/step {100 * us / total:6.2f}%  x{count // args.reps:<3} {key}")

    out = step().cpu().numpy()
    t0 = time.perf_counter()
    for i, blk in enumerate(blocks):
        if bits == 8:
            pipeline._fragment_from_row(out[i], 8, useds[i], blk.crc)
        else:
            pipeline._fragment_from_ranks_row(out[i], useds[i], blk.crc, int(lens[i]), bits)
    tail_ms = (time.perf_counter() - t0) * 1e3 / len(blocks)
    print(f"host per block (one thread): dense pack {pack_ms} ms, tail {tail_ms} ms")

    total_bytes = sum(map(len, texts))
    pipeline.encode_streams(texts[:3], device=dev, host_assist=False)  # warm
    wall = []

    def encode():
        t0 = time.perf_counter()
        pipeline.encode_streams(texts, device=dev, host_assist=False)
        wall.append(time.perf_counter() - t0)

    rows = _profile(encode)
    busy = sum(r[1] for r in rows) / 1e6
    print(f"device-only encode of {args.corpus}: {total_bytes} bytes in {wall[0]} s "
          f"({total_bytes / wall[0] / 1e6} MB/s) under the profiler; device busy "
          f"{busy} s, idle share {1 - busy / wall[0]}")
    for key, us, count in rows[:8]:
        print(f"  {us / 1e3:10.3f} ms  x{count:<4} {key}")

    wall.clear()
    counts = _sample_threads(encode)
    print(f"host threads during a device-only encode ({wall[0]} s), samples by line:")
    by_thread = collections.Counter()
    for (name, _), c in counts.items():
        by_thread[name] += c
    for name, total_c in by_thread.most_common():
        print(f"  thread {name}: {total_c} samples")
        top = sorted(((c, w) for (n, w), c in counts.items() if n == name), reverse=True)
        for c, where in top[:6]:
            print(f"    {c:6d} {where}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
