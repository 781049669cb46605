#!/usr/bin/env python3
"""On-card smoke run of the PyTorch + CUDA port (``starch3_tpu_torch``).

Run from the root of the repository on a machine with one NVIDIA GPU
(Hopper, for the sm_90a kernels):

    python3 chip_smoke.py [--seed N]

It drives the port's device paths through the entry points a user calls:
the bits==4 encode of whole-genome 3-column BED (BASELINE config 2) and
the remainder-column tiers, bits 5/6 (BASELINE config 3 and gene-id BED)
and bits 8 (BED6 with free-text names).  It exits 0 only if every phase
passes:

  1. the card: its name and power limit (nvidia-smi) and torch's name;
  2. the kernel builds from ``starch3_tpu_torch/csrc``, one nvcc per
     source, all started together (timed);
  3. each MTF kernel against its plain PyTorch version on the card, at
     the main path's shapes, exactly equal: the narrow kernel at widths
     16/32/64, the wide kernel at 128/256 (and at one row, width 256);
     short rows whose pad holds out-of-range and negative symbols; a rare
     symbol silent across many chunks.  Median CUDA-event times of kernel
     and plain version at (3, 901,120) and (3, 458,752): width 16 narrow,
     width 256 wide;
  4. each tier's device step on the card against the same step on the
     CPU, for one production batch of real transformed blocks: bits 4 at
     458,752, bits 5, 6 and 8 at 901,120.  Rows equal (a tied bits-8 row:
     columns ptr and ties);
  5. device-only end to end, ``encode_streams(host_assist=False)``, one
     run per corpus: config 2 plus one ~400,000-interval chromosome
     (bits 4, multi-block streams), config 3 (bits 5), the gene-id corpus
     (bits 6) and the free-text corpus (bits 8, multi-block streams).
     Every stream equals ``bz2.compress(text, 9)``, the device blocks
     equal all blocks, each corpus's class ran on the device, the narrow
     kernel's launches equal the bits 4/5/6 batches and the wide kernel's
     the bits-8 batches, and at least one bits-8 block was tie-free;
     MB/s beside same-run libbz2 -9;
  6. the entry points, on config 2 and on config 3:
     ``compress_bed_bytes(use_jax=True)`` equals the host path's archive
     and decodes back to the BED, and ``python -m starch3_tpu_torch.cli
     --jax FILE`` writes the same bytes.

The line before the last is one JSON object describing each kernel of
the path; the last line is ``{"ok": true, "device": {...}}``.  Without a
card, or without the rest of the repository, it fails before printing
any result.
"""

from __future__ import annotations

import argparse
import bz2
import concurrent.futures
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from starch3_tpu_torch import api, corpus
from starch3_tpu_torch._build import build
from starch3_tpu_torch.ops import mtf_narrow, mtf_wide
from starch3_tpu_torch.parallel import pipeline

ROOT = os.path.dirname(os.path.abspath(__file__))
BUCKETS = (901_120, 458_752)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_median_ms(fn, reps: int) -> float:
    """Median device time of ``fn`` over ``reps`` calls, by CUDA events."""
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


def check_equal(name: str, got: torch.Tensor, want: torch.Tensor) -> int:
    """Exact equality; returns the max absolute difference (0)."""
    err = int((got.long() - want.long()).abs().max().item()) if got.numel() else 0
    if got.shape != want.shape or err != 0:
        bad = (got != want).nonzero()[:5].tolist()
        raise AssertionError(f"{name}: kernel != plain (max |diff| {err}, first at {bad})")
    return err


# name -> (module, kernel wrapper, plain version, width timed)
KERNELS = {
    "mtf_narrow": (
        mtf_narrow, mtf_narrow.mtf_ranks_narrow_batch, mtf_narrow.mtf_ranks_narrow_reference, 16,
    ),
    "mtf_wide": (
        mtf_wide, mtf_wide.mtf_ranks_wide_batch, mtf_wide.mtf_ranks_wide_reference, 256,
    ),
}


def phase_kernel(device, seed: int, name: str, buckets=BUCKETS, short=8192, reps=20, plain_reps=20):
    """Phase 3: one kernel vs its plain version at the main path's shapes.
    Returns (max_abs_err, {n_max: (kernel_ms, plain_ms)} at the timed
    width)."""
    mod, kernel, plain, timed_width = KERNELS[name]
    gen = torch.Generator(device="cpu").manual_seed(seed)
    max_err = 0
    times = {}
    for width in mod.WIDTHS:
        for n_max in buckets:
            seqs = torch.randint(0, width, (3, n_max), generator=gen, dtype=torch.int32).to(device)
            got = kernel(seqs, width)
            want = plain(seqs, width)
            max_err = max(max_err, check_equal(f"{name} w{width} (3, {n_max})", got, want))
            if width == timed_width:
                k = cuda_median_ms(lambda: kernel(seqs, width), reps)
                p = cuda_median_ms(lambda: plain(seqs, width), plain_reps)
                times[n_max] = (k, p)
                log(f"{name} (3, {n_max}) w{width}: kernel {k:.4f} ms (median of {reps}), "
                    f"plain {p:.4f} ms (median of {plain_reps})")
            del seqs, got, want
        # short rows: the pad holds symbols outside [0, width)
        seqs = torch.randint(0, width, (2, short), generator=gen, dtype=torch.int32)
        seqs[0, 5000:] = width + 3
        seqs[1, 100:] = -1
        seqs = seqs.to(device)
        got = kernel(seqs, width)
        want = plain(seqs, width)
        max_err = max(max_err, check_equal(f"{name} w{width} short rows", got, want))
        # a rare symbol silent across many chunks
        n_max = buckets[0]
        seqs = torch.randint(0, 3, (1, n_max), generator=gen, dtype=torch.int32)
        seqs[0, 5] = width - 1
        seqs[0, 100] = width - 2
        seqs[0, n_max - 1] = width - 1
        seqs = seqs.to(device)
        got = kernel(seqs, width)
        want = plain(seqs, width)
        max_err = max(max_err, check_equal(f"{name} w{width} rare symbol", got, want))
        if name == "mtf_wide" and width == 256:  # mtf_ranks_pallas's one-row form
            got = mtf_wide.mtf_ranks_wide(seqs[0])
            max_err = max(max_err, check_equal(f"{name} one row", got[None, :], want))
        log(f"{name} width {width}: equal to plain at every shape")
    return max_err, times


def real_batch(texts, bits: int, n_max: int, b: int = 3):
    """The first ``b`` blocks of alphabet class ``bits`` in ``texts`` that
    fit bucket ``n_max``, packed as the dispatch packs them: (packed,
    lens, nsyms) tensors on the CPU."""
    blocks = []
    for t in texts:
        bl, cl = pipeline._split_classify(t, 9)
        blocks += [x.data for x, c in zip(bl, cl) if c == bits and len(x.data) <= n_max]
        if len(blocks) >= b:
            break
    if len(blocks) < b:
        raise AssertionError(f"fewer than {b} bits=={bits} blocks fit {n_max}")
    packed, lens, nsyms, _ = pipeline.pack_batch(blocks[:b], n_max, bits)
    return packed, torch.from_numpy(lens), torch.from_numpy(nsyms)


def phase_step(device, texts, bits: int, n_max: int):
    """Phase 4: one tier's device step on ``device`` vs the CPU, real
    blocks.  A tied bits-8 row compares its ptr and ties columns only:
    the order of tied rotations is not defined there."""
    packed, lens, nsyms = real_batch(texts, bits, n_max)
    got = pipeline.step_for_class(
        packed.to(device), lens.to(device), nsyms.to(device), bits, n_max
    ).cpu()
    want = pipeline.step_for_class(packed, lens, nsyms, bits, n_max)
    tie_col = 2 if bits == 8 else 1
    for i in range(got.shape[0]):
        cols = slice(None) if want[i, tie_col] == 0 or bits != 8 else [0, 2]
        check_equal(f"bits {bits} step row {i} (3, {n_max})", got[i, cols], want[i, cols])
    log(f"bits {bits} step: {device} rows equal CPU rows at n_max {n_max}; lens {lens.tolist()}, "
        f"ptrs {got[:, 0].tolist()}, ties {got[:, tie_col].tolist()}")


def phase_end_to_end(device, label: str, texts, classes):
    """Phase 5: device-only encode of one corpus whose blocks fall in
    ``classes``.  Returns (narrow launches, wide launches, device_stats)
    of the run."""
    total = sum(map(len, texts))
    mtf_narrow.launches = 0
    mtf_wide.launches = 0
    for k in pipeline.device_stats:
        pipeline.device_stats[k] = 0
    t0 = time.perf_counter()
    encs = pipeline.encode_streams(texts, device=device, host_assist=False)
    dt = time.perf_counter() - t0
    narrow, wide = mtf_narrow.launches, mtf_wide.launches
    stats = dict(pipeline.device_stats)
    t1 = time.perf_counter()
    want = [bz2.compress(t, 9) for t in texts]
    dt_bz2 = time.perf_counter() - t1
    for i, (e, w) in enumerate(zip(encs, want)):
        if e.data != w:
            raise AssertionError(f"{label} stream {i}: device bytes != bz2.compress(text, 9)")
    n_blocks = sum(len(e.block_bit_offsets) for e in encs)
    if stats["blocks"] != n_blocks:
        raise AssertionError(f"{label}: device blocks {stats['blocks']} != all blocks {n_blocks}")
    for c in classes:
        if stats[f"blocks_bits{c}"] == 0:
            raise AssertionError(f"{label}: no bits=={c} block ran on the device")
    mid = sum(stats[f"batches_bits{c}"] for c in (4, 5, 6))
    if narrow != mid or wide != stats["batches_bits8"]:
        raise AssertionError(
            f"{label}: launches narrow {narrow} wide {wide} != batches bits 4/5/6 {mid}, "
            f"bits 8 {stats['batches_bits8']}"
        )
    per_class = {c: (stats[f"blocks_bits{c}"], stats[f"batches_bits{c}"],
                     stats[f"tie_reencodes_bits{c}"]) for c in pipeline.CLASSES}
    log(f"{label} end to end (device only): {len(texts)} streams, {total} bytes, {n_blocks} blocks, "
        f"{stats['batches']} batches, launches narrow {narrow} wide {wide}, "
        f"{stats['tie_reencodes']} tie re-encodes; (blocks, batches, tie re-encodes) per class "
        f"{per_class}; all streams == bz2.compress(text, 9)")
    log(f"{label} end to end: {total / dt / 1e6:.3f} MB/s ({dt:.3f} s); "
        f"same-run libbz2 -9 one core: {total / dt_bz2 / 1e6:.3f} MB/s ({dt_bz2:.3f} s)")
    return narrow, wide, stats


def phase_entry_points(device, label: str, bed: bytes):
    """Phase 6: the archive API and the CLI against the host path."""
    cfg = api.EncodeConfig(use_jax=True)
    t0 = time.perf_counter()
    got = api.compress_bed_bytes(bed, cfg, device=device)
    dt = time.perf_counter() - t0
    t1 = time.perf_counter()
    want = api.compress_bed_bytes(bed, api.EncodeConfig())
    dt_host = time.perf_counter() - t1
    if got != want:
        raise AssertionError(f"{label} compress_bed_bytes: device archive != host archive")
    if api.decompress_starch_bytes(got) != bed:
        raise AssertionError(f"{label} compress_bed_bytes: archive does not decode to the input")
    log(f"{label} compress_bed_bytes: archive == host path's, decodes to the input; "
        f"{len(bed) / dt / 1e6:.3f} MB/s of BED ({dt:.3f} s); host path "
        f"{len(bed) / dt_host / 1e6:.3f} MB/s ({dt_host:.3f} s)")
    with tempfile.TemporaryDirectory() as d:
        src, out = os.path.join(d, "in.bed"), os.path.join(d, "out.starch")
        with open(src, "wb") as f:
            f.write(bed)
        cmd = [sys.executable, "-m", "starch3_tpu_torch.cli", "--jax",
               f"--platform={device.type}", "-o", out, src]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True)
        dt = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"{label} CLI exit {proc.returncode}: {proc.stderr[-2000:]}")
        with open(out, "rb") as f:
            if f.read() != want:
                raise AssertionError(f"{label} CLI --jax archive != host archive")
    log(f"{label} cli --jax: same archive bytes ({dt:.3f} s with process start)")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=5)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: chip_smoke needs a CUDA card")
    device = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; device {kind}")

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(KERNELS)) as ex:
        libs = list(ex.map(build, KERNELS))
    log(f"build: {', '.join(lib.name for lib in libs)} in {time.perf_counter() - t0:.2f} s")
    for lib in libs:
        ptxas = lib.with_suffix(".log")
        if ptxas.exists():
            for line in ptxas.read_text().splitlines():
                if "Used" in line or "spill" in line:
                    log(f"  ptxas {lib.stem}: {line.strip()}")

    checks = {
        "mtf_narrow": phase_kernel(device, args.seed, "mtf_narrow"),
        "mtf_wide": phase_kernel(device, args.seed, "mtf_wide", plain_reps=5),
    }

    def texts_of(bed):
        return [tf.text for tf in api._parse_transform(bed)]

    bed2 = corpus.config2_bed(args.seed)
    bed3 = corpus.config3_bed()
    runs = [  # (label, texts, classes)
        ("config2", texts_of(bed2 + corpus.big_chrom_bed(args.seed + 1)), (4,)),
        ("config3", texts_of(bed3), (5,)),
        ("bits6", texts_of(corpus.bits6_bed()), (6,)),
        ("wide8", texts_of(corpus.wide8_bed()), (8,)),
    ]
    for (label, texts, (bits,)), n_max in zip(runs, (BUCKETS[1],) + (BUCKETS[0],) * 3):
        phase_step(device, texts, bits, n_max)
    launches = {"mtf_narrow": 0, "mtf_wide": 0}
    exact8 = 0
    for label, texts, classes in runs:
        narrow, wide, stats = phase_end_to_end(device, label, texts, classes)
        launches["mtf_narrow"] += narrow
        launches["mtf_wide"] += wide
        exact8 += stats["blocks_bits8"] - stats["tie_reencodes_bits8"]
    if exact8 == 0:
        raise AssertionError("no bits==8 block was tie-free on the device")
    phase_entry_points(device, "config2", bed2)
    phase_entry_points(device, "config3", bed3)

    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    replaces = {
        "mtf_narrow": "starch3_tpu/ops/mtf_narrow_pallas.py:95",
        "mtf_wide": "starch3_tpu/ops/mtf_pallas.py:112",
    }
    timed_at = {"mtf_narrow": BUCKETS[1], "mtf_wide": BUCKETS[0]}
    kernels = []
    for name, (max_err, times) in checks.items():
        k_ms, p_ms = times[timed_at[name]]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"starch3_tpu_torch/csrc/{name}.cu",
            "replaces": replaces[name],
            "launches": launches[name],
            "max_abs_err": max_err,
            "ms": k_ms,
            "plain_ms": p_ms,
        })
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
