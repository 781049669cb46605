"""Time the port's MTF kernels on a CUDA card, at the main path's shapes.

From the root of the repository, on a machine with one CUDA card:

    python -m starch3_tpu_torch.profile_kernels --make-inputs FILE [--seed N]
    python starch3_tpu_torch/profile_kernels.py --inputs FILE [--root DIR] [--reps N] [--plain]
    python starch3_tpu_torch/profile_kernels.py --inputs FILE --phases [--root DIR]

``--make-inputs`` writes the inputs: uniform random rows for every width
at (3, 458,752) and (3, 901,120), one random row at (1, 901,120) for the
one-row form of the width-256 kernel (``mtf_ranks_wide``), and the real
MTF input of each tier (the BWT of three real blocks of its corpus, as
the device step computes it: bits 4 at both buckets for widths 16 and
128, bits 5, 6 and 8 at 901,120, bits 8 at 458,752 too).  The timing run
loads the kernels of the checkout at ``--root`` (default: the one this
file is in), so one call can time two commits on one card, in turns.  It
prints one JSON object per case: the CUDA-event median of the wrapper
call in ms, the memory bound (each input read once and each output
written once, at 3.35 TB/s, the H100 SXM's rate), the share of the
bound, and each CUDA kernel's device time by name under
``torch.profiler``; with ``--plain`` also the plain version's time.
``chip_smoke.py`` uses the same helpers.

``--phases`` splits the rank kernel of widths 32-256 by phase instead.
It copies the checkout's ``csrc/mtf_wide.cu``, puts a ``%globaltimer``
stamp of each block's thread 0 at the start of each ``mtf_rank*kernel``,
before each comment line of the form ``// a. ...``, ``// b. ...`` in its
body, and at its end, builds the copy into ``build/`` and runs it.  It
prints, per case, each phase's mean time per block in microseconds and
the span from the first block's start to the last block's end.  The
stamps cost a few instructions a block; the phases are those of the
kernel as written, not a separate design.
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
    cases[f"one-row w256 {BUCKETS[1]}"] = torch.randint(0, 256, (1, BUCKETS[1]), generator=gen, dtype=torch.int32)
    texts = {name: corpus_texts(name, seed) for name in sorted({c for _, c in REAL.values()})}
    reals = [(16, n) for n in BUCKETS] + [(128, n) for n in BUCKETS] + [(32, 901_120), (64, 901_120)]
    reals += [(256, n) for n in BUCKETS]
    for width, n in reals:
        cases[f"real w{width} {n}"] = real_mtf_input(texts[REAL[width][1]], width, n, dev).cpu()
    torch.save(cases, path)


def kernel_for(width: int, one_row: bool = False):
    """(module, wrapper, plain version) of the kernel at ``width``; with
    ``one_row``, the wrapper is ``mtf_ranks_wide`` (K2, width 256) taking
    a [1, n] batch."""
    from starch3_tpu_torch.ops import mtf_narrow, mtf_wide

    if one_row:
        return mtf_wide, lambda seqs, _: mtf_wide.mtf_ranks_wide(seqs[0])[None], mtf_wide.mtf_ranks_wide_reference
    if width in mtf_narrow.WIDTHS:
        return mtf_narrow, mtf_narrow.mtf_ranks_narrow_batch, mtf_narrow.mtf_ranks_narrow_reference
    return mtf_wide, mtf_wide.mtf_ranks_wide_batch, mtf_wide.mtf_ranks_wide_reference


def time_case(seqs, width: int, reps: int, plain: bool, one_row: bool = False) -> dict:
    """One case: kernel time, bound, share, kernels by name (and the plain
    version's time); the kernel's output is checked against the plain
    version's first."""
    import torch

    _, kernel, ref = kernel_for(width, one_row)
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


# the stamps: a block's thread 0 writes %globaltimer into its row
_STAMP_HEAD = r"""
#define S3T_MAX_BLOCKS 8192
#define S3T_MAX_STAMPS 16
__device__ unsigned long long s3t_stamps[S3T_MAX_BLOCKS][S3T_MAX_STAMPS];
#define S3T_STAMP(k)                                                        \
  do {                                                                      \
    const unsigned s3t_blk = blockIdx.y * gridDim.x + blockIdx.x;           \
    if (threadIdx.x == 0 && s3t_blk < S3T_MAX_BLOCKS) {                     \
      unsigned long long s3t_t;                                             \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(s3t_t)::"memory");   \
      s3t_stamps[s3t_blk][k] = s3t_t;                                       \
    }                                                                       \
  } while (0)
"""
_STAMP_TAIL = r"""
// copies the stamps to dst (host, S3T_MAX_BLOCKS * S3T_MAX_STAMPS) and
// zeroes them
extern "C" int s3t_take_stamps(unsigned long long* dst) {
  cudaError_t e = cudaDeviceSynchronize();
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(dst, s3t_stamps, sizeof(s3t_stamps));
  void* p = nullptr;
  if (e == cudaSuccess) e = cudaGetSymbolAddress(&p, s3t_stamps);
  if (e == cudaSuccess) e = cudaMemset(p, 0, sizeof(s3t_stamps));
  if (e == cudaSuccess) e = cudaDeviceSynchronize();
  return (int)e;
}
"""


def instrument(src: str) -> tuple[str, list[str]]:
    """``src`` with a stamp at the start of every ``mtf_rank*kernel``,
    before each ``// x. ...`` comment line of its body, and at its end;
    and the phases' names (phase k runs from stamp k to stamp k + 1; where
    the source holds several such kernels, one name lists them all)."""
    import re

    out, names, pos = [], {}, 0
    for m in re.finditer(r"__global__[^;{]*?\b(mtf_rank\w*kernel)\s*\(", src):
        open_ = src.index("{", m.end())
        depth, end = 0, open_
        for end in range(open_, len(src)):
            depth += {"{": 1, "}": -1}.get(src[end], 0)
            if depth == 0:
                break
        body = src[open_ + 1 : end]
        k, lines, kernel_names = 1, [], ["start"]
        for line in body.split("\n"):
            mark = re.match(r"^(\s*)// ([a-z])\. (.*)$", line)
            if mark:
                lines.append(f"{mark.group(1)}S3T_STAMP({k});")
                kernel_names.append(f"{mark.group(2)}. {mark.group(3).strip()}")
                k += 1
            lines.append(line)
        out += [src[pos : open_ + 1], "\n  S3T_STAMP(0);", "\n".join(lines), f"  S3T_STAMP({k});\n"]
        pos = end
        for i, n in enumerate(kernel_names):
            names.setdefault(i, []).append(f"{m.group(1)}: {n}")
    if not names:
        raise ValueError("no mtf_rank*kernel in the source")
    out.append(src[pos:])
    text = "".join(out)
    inc = "#include <cuda_runtime.h>\n"
    return text.replace(inc, inc + _STAMP_HEAD, 1) + _STAMP_TAIL, [" | ".join(n) for n in names.values()]


# the rank kernels of every width from 32 up, relative to a checkout
PHASE_SOURCE = Path("starch3_tpu_torch/csrc/mtf_wide.cu")


def phase_case(root: str, seqs, width: int, reps: int) -> dict:
    """Per-block phase times of the rank kernel at ``width`` on ``seqs``
    (mean over ``reps`` calls after one warm-up), checked against the
    plain version."""
    import ctypes

    import torch

    from starch3_tpu_torch._build import BUILD_DIR, NVCC_FLAGS, _compile, find_nvcc
    from starch3_tpu_torch.ops.mtf_wide import CHUNK

    src = Path(root) / PHASE_SOURCE
    text, names = instrument(src.read_text())
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stem = f"{src.stem}_phases"
    copy = BUILD_DIR / f"{stem}-{len(text)}.cu"
    copy.write_text(text)
    lib = ctypes.CDLL(str(_compile(stem, copy, NVCC_FLAGS, find_nvcc)))
    lib.s3t_mtf_wide.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    stamps = torch.zeros((8192, 16), dtype=torch.int64)
    b, n_max = seqs.shape
    tables = torch.empty((b, n_max // CHUNK, width), dtype=torch.int32, device=seqs.device)
    out = torch.empty_like(seqs)
    per_phase, spans, blocks = [[] for _ in range(len(names))], [], 0
    for rep in range(reps + 1):
        err = lib.s3t_mtf_wide(seqs.data_ptr(), out.data_ptr(), tables.data_ptr(), b,
                               n_max // CHUNK, width, torch.cuda.current_stream().cuda_stream)
        err = err or lib.s3t_take_stamps(ctypes.c_void_p(stamps.data_ptr()))
        if err:
            raise RuntimeError(f"{src.name} with stamps: CUDA error {err}")
        if rep == 0:
            continue
        st = stamps[:, : len(names) + 1]
        st = st[(st > 0).all(dim=1)]  # blocks that ran to the end
        d = (st[:, 1:] - st[:, :-1]).double() / 1e3
        for k in range(len(names)):
            per_phase[k].append(d[:, k].mean().item())
        spans.append((st[:, -1].max() - st[:, 0].min()).item() / 1e3)
        blocks = st.shape[0]
    if not torch.equal(out, kernel_for(width)[2](seqs, width)):
        raise AssertionError(f"{src.name} with stamps, width {width}: != plain")
    return {
        "width": width, "shape": list(seqs.shape), "source": str(src.relative_to(root)),
        "blocks": blocks, "span_us": statistics.mean(spans),
        "phases_us_per_block": {n: statistics.mean(v) for n, v in zip(names, per_phase)},
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--make-inputs", metavar="FILE")
    ap.add_argument("--inputs", metavar="FILE")
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--plain", action="store_true")
    ap.add_argument("--phases", action="store_true")
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
        if args.phases:
            if width >= 32 and not name.startswith("one-row"):
                res = phase_case(args.root, seqs.cuda(), width, min(args.reps, 10))
                print(json.dumps({"case": name, **res}), flush=True)
            continue
        res = time_case(seqs.cuda(), width, args.reps, args.plain, name.startswith("one-row"))
        print(json.dumps({"case": name, **res}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
