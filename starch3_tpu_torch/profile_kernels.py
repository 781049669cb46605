"""Time the port's MTF kernels on a CUDA card, at the main path's shapes.

From the root of the repository, on a machine with one CUDA card:

    python -m starch3_tpu_torch.profile_kernels --make-inputs FILE [--seed N]
    python starch3_tpu_torch/profile_kernels.py --inputs FILE [--root DIR] [--reps N] [--plain]

``--make-inputs`` writes the inputs: uniform random rows for every width
at (3, 458,752) and (3, 901,120), and the real MTF input of each tier
(the BWT of three real blocks of its corpus, as the device step computes
it: bits 4 at both buckets for widths 16 and 128, bits 5, 6 and 8 at
901,120, bits 8 at 458,752 too).  The timing run loads the kernels of
the checkout at ``--root`` (default: the one this file is in), so one
call can time two commits on one card, in turns.  It prints one JSON
object per case: the CUDA-event median of the wrapper call in ms, the
memory bound (each input read once and each output written once, at
3.35 TB/s, the H100 SXM's rate), the share of the bound, and each CUDA
kernel's device time by name under ``torch.profiler``; with ``--plain``
also the plain version's time.  ``chip_smoke.py`` uses the same helpers.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
BUCKETS = (458_752, 901_120)
# width -> (alphabet class, corpus) of its real input; 128 is the bits-4
# batch through the wide kernel (``step_bwt_mtf_fast``)
REAL = {16: (4, "config2"), 32: (5, "config3"), 64: (6, "bits6"), 128: (4, "config2"), 256: (8, "wide8")}


def bound_ms(shape) -> float:
    """Least time for ``shape`` int32 positions: 4 bytes read and 4
    written per position over the card's memory rate (bytes bound it:
    the W compares per position are far below the card's integer rate)."""
    b, n = shape
    return 8 * b * n / HBM_BYTES_PER_S * 1e3


def cuda_median_ms(fn, reps: int) -> float:
    """Median device time of ``fn`` over ``reps`` calls, by CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_us_by_kernel(fn, reps: int) -> dict[str, float]:
    """Device time per call of each CUDA kernel that ``fn`` launches, by
    name, under ``torch.profiler`` (mean over ``reps`` calls)."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        if getattr(evt, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None) or getattr(evt, "self_cuda_time_total", 0.0)
        if us > 0:
            out[evt.key] = us / reps
    return out


def corpus_texts(name: str, seed: int) -> list[bytes]:
    """The transformed texts of one corpus of ``corpus.py``."""
    from starch3_tpu_torch import api, corpus

    bed = {
        "config2": lambda: corpus.config2_bed(seed) + corpus.big_chrom_bed(seed + 1),
        "config3": corpus.config3_bed,
        "bits6": corpus.bits6_bed,
        "wide8": corpus.wide8_bed,
    }[name]()
    return [tf.text for tf in api._parse_transform(bed)]


def real_batch(texts, bits: int, n_max: int, b: int = 3):
    """The first ``b`` blocks of alphabet class ``bits`` in ``texts`` that
    fit bucket ``n_max`` (the bucket's own blocks first), packed as the
    dispatch packs them: (packed, lens, nsyms) tensors on the CPU."""
    import torch

    from starch3_tpu_torch.parallel import host, pipeline

    fits, smaller = [], []
    for t in texts:
        bl, cl = host._split_classify(t, 9)
        for x, c in zip(bl, cl):
            if c == bits and len(x.data) <= n_max:
                (fits if host._bucket_for(len(x.data)) == n_max else smaller).append(x.data)
        if len(fits) >= b:
            break
    blocks = (fits + smaller)[:b]
    if len(blocks) < b:
        raise AssertionError(f"fewer than {b} bits=={bits} blocks fit {n_max}")
    packed, lens, nsyms, _ = pipeline.pack_batch(blocks, n_max, bits)
    return packed, torch.from_numpy(lens), torch.from_numpy(nsyms)


def real_mtf_input(texts, width: int, n_max: int, device):
    """The MTF kernel's input of a real batch at ``width``: the ``last``
    column of the BWT that the device step runs, on ``device``."""
    from starch3_tpu_torch.parallel import pipeline

    bits = REAL[width][0]
    packed, lens, _ = real_batch(texts, bits, n_max)
    last, _, _ = pipeline.bwt_of_batch(packed.to(device), lens.to(device), bits, n_max, wide=width >= 128)
    return last.contiguous()


def make_inputs(path: str, seed: int) -> None:
    """Random and real inputs of every width, saved on the CPU."""
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(seed)
    cases = {}
    for width in sorted(REAL):
        for n in BUCKETS:
            cases[f"random w{width} {n}"] = torch.randint(0, width, (3, n), generator=gen, dtype=torch.int32)
    texts = {name: corpus_texts(name, seed) for name in sorted({c for _, c in REAL.values()})}
    reals = [(16, n) for n in BUCKETS] + [(128, n) for n in BUCKETS] + [(32, 901_120), (64, 901_120)]
    reals += [(256, n) for n in BUCKETS]
    for width, n in reals:
        cases[f"real w{width} {n}"] = real_mtf_input(texts[REAL[width][1]], width, n, dev).cpu()
    torch.save(cases, path)


def kernel_for(width: int):
    """(module, wrapper, plain version) of the kernel at ``width``."""
    from starch3_tpu_torch.ops import mtf_narrow, mtf_wide

    if width in mtf_narrow.WIDTHS:
        return mtf_narrow, mtf_narrow.mtf_ranks_narrow_batch, mtf_narrow.mtf_ranks_narrow_reference
    return mtf_wide, mtf_wide.mtf_ranks_wide_batch, mtf_wide.mtf_ranks_wide_reference


def time_case(seqs, width: int, reps: int, plain: bool) -> dict:
    """One case: kernel time, bound, share, kernels by name (and the plain
    version's time); the kernel's output is checked against the plain
    version's first."""
    import torch

    _, kernel, ref = kernel_for(width)
    got = kernel(seqs, width)
    want = ref(seqs, width)
    if not torch.equal(got, want):
        raise AssertionError(f"width {width} {tuple(seqs.shape)}: kernel != plain")
    ms = cuda_median_ms(lambda: kernel(seqs, width), reps)
    out = {
        "width": width,
        "shape": list(seqs.shape),
        "ms": ms,
        "bound_ms": bound_ms(seqs.shape),
        "share_of_bound": bound_ms(seqs.shape) / ms,
        "kernels_us": device_us_by_kernel(lambda: kernel(seqs, width), reps),
    }
    if plain:
        out["plain_ms"] = cuda_median_ms(lambda: ref(seqs, width), 3)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--make-inputs", metavar="FILE")
    ap.add_argument("--inputs", metavar="FILE")
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--plain", action="store_true")
    args = ap.parse_args()
    # the checkout whose kernels run: first on the path, and never this
    # file's own directory, which holds the package's modules loose
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [os.path.abspath(args.root)] + [p for p in sys.path if os.path.abspath(p or ".") != here]
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("profile_kernels needs a CUDA card")
    if args.make_inputs:
        make_inputs(args.make_inputs, args.seed)
        return 0
    import starch3_tpu_torch

    cases = torch.load(args.inputs)
    print(json.dumps({"root": args.root, "package": starch3_tpu_torch.__file__,
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    for name, seqs in cases.items():
        width = int(name.split()[1][1:])
        res = time_case(seqs.cuda(), width, args.reps, args.plain)
        print(json.dumps({"case": name, **res}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
