#!/usr/bin/env python3
"""On-card smoke run of the PyTorch + CUDA port (``starch3_tpu_torch``).

Run from the root of the repository on a machine with one NVIDIA GPU
(Hopper, for the sm_90a kernels):

    python3 chip_smoke.py [--seed N]

It drives the port's main path, the bits==4 encode of whole-genome
3-column BED (BASELINE config 2), through the entry points a user calls,
and exits 0 only if every phase passes:

  1. the card: its name and power limit (nvidia-smi) and torch's name;
  2. the kernel build from ``starch3_tpu_torch/csrc`` (timed);
  3. the narrow-MTF kernel against its plain PyTorch version on the card,
     at widths 16/32/64 and the main path's shapes, exactly equal; median
     CUDA-event times of both at (3, 901,120) and (3, 458,752), width 16;
  4. ``step_ranks4`` on the card against the same step on the CPU, for one
     production batch of real transformed blocks: equal rows;
  5. device-only end to end: ``encode_streams(host_assist=False)`` over
     config 2 plus one ~400,000-interval chromosome (multi-block streams,
     901,120 bucket); every stream equals ``bz2.compress(text, 9)``, the
     kernel's launches equal the device batches and the device blocks
     equal all blocks; MB/s beside same-run libbz2 -9;
  6. the entry points: ``compress_bed_bytes(use_jax=True)`` equals the
     host path's archive and decodes back to the BED, and
     ``python -m starch3_tpu_torch.cli --jax FILE`` writes the same bytes.

The line before the last is one JSON object describing each kernel of
the path; the last line is ``{"ok": true, "device": {...}}``.  Without a
card, or without the rest of the repository, it fails before printing
any result.
"""

from __future__ import annotations

import argparse
import bz2
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
from starch3_tpu_torch.ops import mtf_narrow
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


def phase_kernel(device, seed: int, buckets=BUCKETS, short=8192, reps=20):
    """Phase 3: kernel vs plain version at the main path's shapes.
    Returns (max_abs_err, {n_max: (kernel_ms, plain_ms)} at width 16)."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    max_err = 0
    times = {}
    for width in mtf_narrow.WIDTHS:
        for n_max in buckets:
            seqs = torch.randint(0, width, (3, n_max), generator=gen, dtype=torch.int32).to(device)
            got = mtf_narrow.mtf_ranks_narrow_batch(seqs, width)
            want = mtf_narrow.mtf_ranks_narrow_reference(seqs, width)
            max_err = max(max_err, check_equal(f"w{width} (3, {n_max})", got, want))
            if width == 16 and device.type == "cuda":
                k = cuda_median_ms(lambda: mtf_narrow.mtf_ranks_narrow_batch(seqs, 16), reps)
                p = cuda_median_ms(lambda: mtf_narrow.mtf_ranks_narrow_reference(seqs, 16), reps)
                times[n_max] = (k, p)
                log(f"mtf_narrow (3, {n_max}) w16: kernel {k:.4f} ms, plain {p:.4f} ms")
            del seqs, got, want
        # short rows: the pad holds symbols outside [0, width)
        seqs = torch.randint(0, width, (2, short), generator=gen, dtype=torch.int32)
        seqs[0, 5000:] = width + 3
        seqs[1, 100:] = -1
        seqs = seqs.to(device)
        got = mtf_narrow.mtf_ranks_narrow_batch(seqs, width)
        want = mtf_narrow.mtf_ranks_narrow_reference(seqs, width)
        max_err = max(max_err, check_equal(f"w{width} short rows", got, want))
        # a rare symbol silent across many chunks
        n_max = buckets[0]
        seqs = torch.randint(0, 3, (1, n_max), generator=gen, dtype=torch.int32)
        seqs[0, 5] = width - 1
        seqs[0, 100] = width - 2
        seqs[0, n_max - 1] = width - 1
        seqs = seqs.to(device)
        got = mtf_narrow.mtf_ranks_narrow_batch(seqs, width)
        want = mtf_narrow.mtf_ranks_narrow_reference(seqs, width)
        max_err = max(max_err, check_equal(f"w{width} rare symbol", got, want))
        log(f"mtf_narrow width {width}: equal to plain at every shape")
    return max_err, times


def real_batch(texts, n_max: int, b: int = 3):
    """The first ``b`` bits==4 blocks of ``texts`` packed for bucket
    ``n_max``, as the dispatch packs them: (packed uint8, lens int32)."""
    blocks = []
    for t in texts:
        bl, cl = pipeline._split_classify(t, 9)
        blocks += [x.data for x, c in zip(bl, cl) if c == 4 and len(x.data) <= n_max]
        if len(blocks) >= b:
            break
    packed = np.zeros((b, n_max // 2), np.uint8)
    lens = np.zeros(b, np.int32)
    for i, data in enumerate(blocks[:b]):
        arr = np.frombuffer(data, np.uint8)
        lens[i] = arr.size
        pipeline._dense_pack4(arr, packed[i])
    return torch.from_numpy(packed), torch.from_numpy(lens)


def phase_step(device, texts, n_max: int = BUCKETS[1]):
    """Phase 4: the device step on ``device`` vs the CPU, real blocks."""
    packed, lens = real_batch(texts, n_max)
    got = pipeline.step_ranks4(packed.to(device), lens.to(device)).cpu()
    want = pipeline.step_ranks4(packed, lens)
    check_equal(f"step_ranks4 (3, {n_max})", got, want)
    log(f"step_ranks4: {device} rows equal CPU rows; lens {lens.tolist()}, "
        f"ptrs {got[:, 0].tolist()}, ties {got[:, 1].tolist()}")


def phase_end_to_end(device, texts):
    """Phase 5: device-only encode; returns the kernel's launch count."""
    total = sum(map(len, texts))
    mtf_narrow.launches = 0
    for k in pipeline.device_stats:
        pipeline.device_stats[k] = 0
    t0 = time.perf_counter()
    encs = pipeline.encode_streams(texts, device=device, host_assist=False)
    dt = time.perf_counter() - t0
    launches = mtf_narrow.launches
    stats = dict(pipeline.device_stats)
    t1 = time.perf_counter()
    want = [bz2.compress(t, 9) for t in texts]
    dt_bz2 = time.perf_counter() - t1
    for i, (e, w) in enumerate(zip(encs, want)):
        if e.data != w:
            raise AssertionError(f"stream {i}: device bytes != bz2.compress(text, 9)")
    n_blocks = sum(len(e.block_bit_offsets) for e in encs)
    if launches != stats["batches"] or launches == 0:
        raise AssertionError(f"kernel launches {launches} != device batches {stats['batches']}")
    if stats["blocks"] != n_blocks:
        raise AssertionError(f"device blocks {stats['blocks']} != all blocks {n_blocks}")
    log(f"end to end (device only): {len(texts)} streams, {total} bytes, {n_blocks} blocks, "
        f"{stats['batches']} batches, {launches} kernel launches, "
        f"{stats['tie_reencodes']} tie re-encodes; all streams == bz2.compress(text, 9)")
    log(f"end to end: {total / dt / 1e6:.3f} MB/s ({dt:.3f} s); "
        f"same-run libbz2 -9 one core: {total / dt_bz2 / 1e6:.3f} MB/s ({dt_bz2:.3f} s)")
    return launches


def phase_entry_points(device, bed: bytes):
    """Phase 6: the archive API and the CLI against the host path."""
    cfg = api.EncodeConfig(use_jax=True)
    t0 = time.perf_counter()
    got = api.compress_bed_bytes(bed, cfg, device=device)
    dt = time.perf_counter() - t0
    t1 = time.perf_counter()
    want = api.compress_bed_bytes(bed, api.EncodeConfig())
    dt_host = time.perf_counter() - t1
    if got != want:
        raise AssertionError("compress_bed_bytes: device archive != host archive")
    if api.decompress_starch_bytes(got) != bed:
        raise AssertionError("compress_bed_bytes: archive does not decode to the input")
    log(f"compress_bed_bytes: archive == host path's, decodes to the input; "
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
            raise AssertionError(f"CLI exit {proc.returncode}: {proc.stderr[-2000:]}")
        with open(out, "rb") as f:
            if f.read() != want:
                raise AssertionError("CLI --jax archive != host archive")
    log(f"cli --jax: same archive bytes ({dt:.3f} s with process start)")


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
    lib = build("mtf_narrow")
    log(f"build: {lib.name} in {time.perf_counter() - t0:.2f} s")
    ptxas = lib.with_suffix(".log")
    if ptxas.exists():
        for line in ptxas.read_text().splitlines():
            if "Used" in line or "spill" in line:
                log(f"  ptxas: {line.strip()}")

    max_err, times = phase_kernel(device, args.seed)

    bed2 = corpus.config2_bed(args.seed)
    big = corpus.big_chrom_bed(args.seed + 1)
    texts = [tf.text for tf in api._parse_transform(bed2 + big)]
    phase_step(device, texts)
    launches = phase_end_to_end(device, texts)
    phase_entry_points(device, bed2)

    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    k_ms, p_ms = times[BUCKETS[1]]
    print(json.dumps({"kernels": [{
        "name": "mtf_narrow",
        "route": "cuda",
        "source": "starch3_tpu_torch/csrc/mtf_narrow.cu",
        "replaces": "starch3_tpu/ops/mtf_narrow_pallas.py:95",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": k_ms,
        "plain_ms": p_ms,
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
