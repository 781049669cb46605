#!/usr/bin/env python3
"""On-card smoke run of the PyTorch + CUDA port (``starch3_tpu_torch``).

Run from the root of the repository on a machine with one NVIDIA GPU
(Hopper, for the sm_90a kernels):

    python3 chip_smoke.py [--seed N]

It drives the port's device paths through the entry points a user calls:
the bits==4 encode of whole-genome 3-column BED (BASELINE config 2) and
the remainder-column tiers, bits 5/6 (BASELINE config 3 and gene-id BED)
and bits 8 (BED6 with free-text names), and the device decode of their
streams and archives.  It exits 0 only if every phase passes:

  1. the card: its name and power limit (nvidia-smi) and torch's name;
  2. the builds, all started together (timed): each kernel source of
     ``starch3_tpu_torch/csrc`` with nvcc, and the port's own host runtime
     (``starch3_tpu_torch/runtime/runtime.cpp``) with g++; the native
     runtime must load from ``build/``, not fall back to NumPy;
  3. each MTF kernel against its plain PyTorch version on the card,
     exactly equal, at every width of each wrapper (narrow 16/32/64, where
     16 is csrc/mtf_narrow.cu and 32/64 the windowed kernel of
     csrc/mtf_wide.cu; wide 128/256, and the wide kernel at one row):
     uniform random rows at (3, 458,752) and (3, 901,120); the real MTF
     input of each tier, the BWT of three real blocks of its corpus; short
     rows whose pad holds out-of-range and negative symbols; a rare symbol
     silent across many chunks (on a mismatch the input and both outputs
     are saved under build/ and both sides run again, on the card and on
     the CPU).  Median CUDA-event times of kernel and
     plain version on the random rows and of the kernel on the real input
     and on one random row at (1, 901,120) (the one-row form), each beside
     its memory bound, and each CUDA kernel's device time by name under
     torch.profiler;
  4. each tier's device step on the card against the same step on the
     CPU, for one production batch of real transformed blocks: bits 4 at
     458,752, bits 5, 6 and 8 at 901,120.  Rows equal (a tied bits-8 row:
     columns ptr and ties);
  5. device-only end to end, ``encode_streams(host_assist=False)``, one
     run per corpus: config 2 plus one ~400,000-interval chromosome
     (bits 4, multi-block streams), config 3 (bits 5), the gene-id corpus
     (bits 6) and the free-text corpus (bits 8, multi-block streams).
     Every stream equals ``bz2.compress(text, 9)``, the device blocks
     equal all blocks, no batch was abandoned and the device was never
     benched (``scheduler_stats``), each corpus's class ran on the
     device, the narrow kernel's launches at widths 16, 32 and 64 equal the bits 4, 5 and 6
     batches and the wide kernel's the bits-8 batches, and at least one
     bits-8 block was tie-free;
     MB/s beside same-run libbz2 -9;
  6. the entry points, on config 2 and on config 3:
     ``compress_bed_bytes(use_jax=True)`` equals the host path's archive
     and decodes back to the BED, and ``python -m starch3_tpu_torch.cli
     --jax FILE`` writes the same bytes.  The hybrid abandons no batch;
     its demotions, repromotions and class skips, and its blocks on the
     device against those on the stealers, are printed;
  7. ``device_huffman`` (mode ``fast_huff``), device only, on the config 2,
     config 3 and free-text texts, each run between two runs of ``fast``
     mode on the same texts (fast, fast_huff, fast_huff, fast): every
     stream equals ``bz2.compress(text, 9)``, no batch was abandoned and
     the device never benched, the wide kernel launched at width 128 once
     per bits-4 batch and at width 256 once per other batch, the narrow
     kernel never; MB/s and the bytes read back per block of each mode are
     printed.  Then ``compress_bed_bytes(use_jax=True,
     device_huffman=True)`` and the CLI's ``--jax --device-huffman`` on
     config 2 equal the host path's archive;
  8. fault handling on the card, on config 2's texts: the first batch of
     an encode runs behind a ``torch.cuda._sleep`` spin on its stream
     (calibrated with CUDA events), with ``_ABANDON_S`` at 0.5 s.  (a) The
     hybrid abandons the batch and benches the device, and a clean
     encode after the stall puts blocks on the device again; (b) a
     device-only encode abandons to the driver and ends; (c) with
     ``STARCH3_TPU_NO_HOST_FALLBACK=1`` a device-only encode waits out a
     1.5 s stall, abandons nothing and takes every block from the device.
     Every stream equals ``bz2.compress(text, 9)``; each case's wall time
     is printed with the card's name and power limit;
  9. device decode on the card: ``step_decode`` on one production batch
     of 8 real blocks at 901,120 (config 2's big chromosome, then wide8,
     then config 3) equals the same step on the CPU, and each op and part
     of the step is timed by CUDA events (irle2; imtf pass 1, pass 2 and
     gathers; ibwt sort, jumping and placement); ``decode_streams(device=
     "cuda")`` of every phase-5 corpus's level-9 streams gives back every
     text, with ``device_stats["decode_batches"]`` and ``["decode_blocks"]``
     (set to 0 just before) equal to the batches and blocks dispatched and
     no MTF kernel launched; MB/s of text beside single-thread
     ``bz2.decompress``, and the host's ms per block for the symbol walk,
     ``rle1_decode`` and the CRC; on configs 2 and 3,
     ``decompress_starch_bytes(archive, use_jax=True)`` equals the native
     block-parallel decode and the BED, with the MB/s of BED of both.
  10. the exact modes (``fast_bwt=False``: ``ranks``, and ``rle2`` with
     ``device_rle2``), at full width: (a) the prefix-doubling BWT
     (``ops/bwt.py``) on the card equals the CPU at (3, 901,120) on real
     config-3 and wide8 blocks, periodic rows and a row of length 1, and
     the host sort on one block, with the CUDA-event and profiler ms of
     the whole sort and of one round; (b) ``step_exact`` and
     ``step_exact_rle2`` rows equal the CPU's on three config-3 blocks,
     with their ms; (c) device-only encodes of config 2 (with its
     400,000-interval chromosome), config 3 and wide8 in turns with fast
     mode (fast, ranks, rle2, rle2, ranks, fast): every stream equals
     ``bz2.compress(text, 9)``, K3 launched at width 256 once per exact
     batch, the narrow kernel never, no re-encode; MB/s of text and bytes
     read back per block of each mode; (d) ``compress_bed_bytes`` with
     ``fast_bwt=False``, with and without ``device_rle2``, and with
     ``device_rle2`` alone (fast mode) equals the host archive on config
     2; (e) a device-only ``ranks`` encode with its first batch stalled
     abandons, as phase 8 (b) does in fast mode.
  11. block meshes and two processes on the one card: (a) device-only
     fast-mode encodes of every phase-5 corpus in turns at mesh None, a
     mesh of ``cuda:0`` alone and a mesh that names ``cuda:0`` twice (two
     entries, two streams): every stream equals ``bz2.compress(text, 9)``
     and each batch's MTF kernel launched once per entry; MB/s of text of
     each; (b) ``device_huffman`` and ``rle2`` on config 2 under the
     two-entry mesh, the same checks; (c) ``decode_streams`` of configs 2
     and 3 and ``decompress_starch_bytes(use_jax=True)`` of their archives
     under the two-entry mesh equal the texts and the host decode; (d) two
     CLI processes, ``--jax --num-hosts=2``, on config 2, once over a gloo
     process group (``--coordinator``) and once through a manifest
     directory: host 0's archive equals the host path's and host 1 writes
     nothing; the wall time of both.

The port imports nothing of JAX and nothing of the JAX package
``starch3_tpu``; the run fails if either is loaded.  The line before the
card's name is one JSON object describing each kernel of the path (the
narrow wrapper's two kernels apart, each with the launches it counted);
the wide kernel's entry counts its launches by width too, phase 10's
included; the last line
is ``{"ok": true, "device": {...}}``.  Without
a card, or without the rest of the repository, it fails before printing
any result.
"""

from __future__ import annotations

import argparse
import bz2
import collections
import concurrent.futures
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from starch3_tpu_torch import api, corpus, runtime
from starch3_tpu_torch._build import BUILD_DIR, build
from starch3_tpu_torch.codec.crc32 import crc32_bytes
from starch3_tpu_torch.codec.rle1 import rle1_decode
from starch3_tpu_torch.ops import mtf_narrow, mtf_wide
from starch3_tpu_torch.parallel import host, pipeline
from starch3_tpu_torch.profile_kernels import (
    bound_ms,
    cuda_median_ms,
    device_us_by_kernel,
    real_batch,
    real_mtf_input,
)

ROOT = os.path.dirname(os.path.abspath(__file__))
BUCKETS = (901_120, 458_752)


def log(msg: str) -> None:
    print(msg, flush=True)


def check_equal(name: str, got: torch.Tensor, want: torch.Tensor, case=None) -> int:
    """Exact equality; returns the max absolute difference (0).

    ``case``, for a kernel's check: (input, kernel, plain), the last two
    functions of the input.  On a mismatch the input and both outputs are
    saved under ``build/``, and the kernel and the plain version run again
    on the same input, on the card and (the plain version) on the CPU, to
    tell which side was wrong."""
    err = int((got.long() - want.long()).abs().max().item()) if got.numel() else 0
    if got.shape == want.shape and err == 0:
        return err
    msg = f"{name}: kernel != plain (max |diff| {err}"
    if got.shape == want.shape:
        bad = (got != want).nonzero()[:5]
        at = [(pos, int(got[tuple(pos)]), int(want[tuple(pos)])) for pos in bad.tolist()]
        msg += f", {int((got != want).sum())} positions, first (position, kernel, plain) {at}"
    msg += ")"
    if case is not None:
        seqs, kernel, plain = case
        path = BUILD_DIR / ("mismatch-" + "".join(c if c.isalnum() else "_" for c in name) + ".pt")
        torch.save({"seqs": seqs.cpu(), "got": got.cpu(), "want": want.cpu()}, path)
        again, plain_again = kernel(seqs), plain(seqs)
        on_cpu = plain(seqs.cpu())
        msg += (
            f"; saved to {path}.  Again on the same input: kernel == its first output "
            f"{torch.equal(again, got)}, plain == its first output {torch.equal(plain_again, want)}, "
            f"kernel == plain {torch.equal(again, plain_again)}; plain on the CPU == first kernel "
            f"output {torch.equal(on_cpu, got.cpu())}, == first plain output {torch.equal(on_cpu, want.cpu())}"
        )
    raise AssertionError(msg)


def texts_of(bed: bytes) -> list[bytes]:
    """The transformed per-chromosome texts the archive API encodes."""
    return [tf.text for tf in api._parse_transform(bed)]


def count_blocks(texts) -> int:
    """The bzip2 blocks of ``texts`` at level 9, as the feeder splits them."""
    return sum(len(host._split_classify(t, 9)[0]) for t in texts)


def stats_since(stats: dict, before: dict) -> dict:
    """Each counter's change since the snapshot ``before``."""
    return {k: stats[k] - before[k] for k in before}


# name -> (module, kernel wrapper, plain version, main path's width and n_max)
KERNELS = {
    "mtf_narrow": (
        mtf_narrow, mtf_narrow.mtf_ranks_narrow_batch, mtf_narrow.mtf_ranks_narrow_reference,
        (16, 458_752),
    ),
    "mtf_wide": (
        mtf_wide, mtf_wide.mtf_ranks_wide_batch, mtf_wide.mtf_ranks_wide_reference,
        (256, 901_120),
    ),
}
# width -> the corpus of its real input, and its buckets
REAL_INPUT = {
    16: ("config2", BUCKETS), 32: ("config3", BUCKETS[:1]), 64: ("bits6", BUCKETS[:1]),
    128: ("config2", BUCKETS), 256: ("wide8", BUCKETS),
}


def timed_case(kind: str, name: str, width: int, seqs, reps: int, plain_reps: int,
               kernel=None) -> dict:
    """Kernel (and plain version, when ``plain_reps``) times of one case,
    beside its memory bound; each CUDA kernel's time by name, and their
    sum, the device time of one call.  ``kernel``: a wrapper other than
    the name's (the one-row form)."""
    _, wrapper, plain, _ = KERNELS[name]
    kernel = kernel or wrapper
    k = cuda_median_ms(lambda: kernel(seqs, width), reps)
    case = {
        "width": width, "input": kind, "shape": list(seqs.shape), "ms": k,
        "bound_ms": bound_ms(seqs.shape), "share_of_bound": bound_ms(seqs.shape) / k,
    }
    if plain_reps:
        case["plain_ms"] = cuda_median_ms(lambda: plain(seqs, width), plain_reps)
    case["kernels_us"] = device_us_by_kernel(lambda: kernel(seqs, width), reps)
    case["device_ms"] = sum(case["kernels_us"].values()) / 1e3
    log(f"{name} w{width} {kind} {tuple(seqs.shape)}: kernel {k:.5f} ms (median of {reps}), "
        f"device {case['device_ms']:.5f} ms, bound {case['bound_ms']:.5f} ms, "
        f"share {case['share_of_bound']:.4f}"
        + (f", plain {case['plain_ms']:.3f} ms (median of {plain_reps})" if plain_reps else "")
        + f"; by kernel (us per call): {json.dumps(case['kernels_us'])}")
    return case


def phase_kernel(device, seed: int, name: str, texts, buckets=BUCKETS, short=8192, reps=20,
                 plain_reps=3):
    """Phase 3: one kernel vs its plain version at every width, on random
    rows and on real MTF input.  Returns (max_abs_err, timed cases)."""
    mod, kernel, plain, _ = KERNELS[name]
    gen = torch.Generator(device="cpu").manual_seed(seed)
    max_err = 0
    cases = []

    def one_row(x, _):  # mtf_ranks_pallas's one-row form, on a [1, n] batch
        return mtf_wide.mtf_ranks_wide(x[0])[None, :]

    def check(label, seqs, run=kernel):
        case = (seqs, lambda x: run(x, width), lambda x: plain(x, width))
        return check_equal(f"{name} w{width} {label}", run(seqs, width), plain(seqs, width), case)

    for width in mod.WIDTHS:
        for n_max in buckets:
            seqs = torch.randint(0, width, (3, n_max), generator=gen, dtype=torch.int32).to(device)
            max_err = max(max_err, check(f"(3, {n_max})", seqs))
            cases.append(timed_case("random", name, width, seqs, reps, plain_reps))
            del seqs
        label, real_buckets = REAL_INPUT[width]
        for n_max in real_buckets:
            seqs = real_mtf_input(texts[label], width, n_max, device)
            max_err = max(max_err, check(f"real {label} (3, {n_max})", seqs))
            cases.append(timed_case(f"real {label}", name, width, seqs, reps, 0))
            del seqs
        # short rows: the pad holds symbols outside [0, width)
        seqs = torch.randint(0, width, (2, short), generator=gen, dtype=torch.int32)
        seqs[0, 5000:] = width + 3
        seqs[1, 100:] = -1
        max_err = max(max_err, check("short rows", seqs.to(device)))
        # a rare symbol silent across many chunks
        n_max = buckets[0]
        seqs = torch.randint(0, 3, (1, n_max), generator=gen, dtype=torch.int32)
        seqs[0, 5] = width - 1
        seqs[0, 100] = width - 2
        seqs[0, n_max - 1] = width - 1
        seqs = seqs.to(device)
        max_err = max(max_err, check("rare symbol", seqs))
        if name == "mtf_wide" and width == 256:
            max_err = max(max_err, check("one row", seqs, one_row))
            seqs = torch.randint(0, width, (1, n_max), generator=gen, dtype=torch.int32).to(device)
            max_err = max(max_err, check("one row random", seqs, one_row))
            cases.append(timed_case("one-row random", name, width, seqs, reps, 0, kernel=one_row))
        log(f"{name} width {width}: equal to plain at every shape and input")
    return max_err, cases


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


def counted_encode(device, label: str, texts, want, device_huffman: bool = False, fast_bwt: bool = True,
                   device_rle2: bool = False, mesh=None):
    """One device-only encode of ``texts`` in the mode of the flags (on
    ``mesh`` when one is given), with every launch counter and
    ``device_stats`` set to 0 just before it and read just after.  Every
    stream must equal ``want``, every block must have run on the device,
    and no batch may have been abandoned or the device benched.  Returns
    the run: seconds, launches (narrow and wide, in all and by width),
    ``device_stats``, blocks."""
    mtf_narrow.launches = mtf_wide.launches = 0
    for counts in (mtf_narrow.width_launches, mtf_wide.width_launches, pipeline.device_stats):
        for k in counts:
            counts[k] = 0
    sched = dict(host.scheduler_stats)
    t0 = time.perf_counter()
    encs = pipeline.encode_streams(texts, device=device, host_assist=False, device_huffman=device_huffman,
                                   fast_bwt=fast_bwt, device_rle2=device_rle2, mesh=mesh)
    run = {
        "seconds": time.perf_counter() - t0,
        "narrow": mtf_narrow.launches, "narrow_by_width": dict(mtf_narrow.width_launches),
        "wide": mtf_wide.launches, "wide_by_width": dict(mtf_wide.width_launches),
        "stats": dict(pipeline.device_stats),
    }
    mode = pipeline.encode_mode(fast_bwt, device_rle2, device_huffman)
    sched = stats_since(host.scheduler_stats, sched)
    if sched["abandoned_batches"] or sched["demotions"]:
        raise AssertionError(f"{label} {mode}: the device-only encode fell back to the host: {sched}")
    for i, (e, w) in enumerate(zip(encs, want)):
        if e.data != w:
            raise AssertionError(f"{label} {mode} stream {i}: device bytes != the host encoder's")
    run["blocks"] = sum(len(e.block_bit_offsets) for e in encs)
    if run["stats"]["blocks"] != run["blocks"]:
        raise AssertionError(f"{label} {mode}: device blocks {run['stats']['blocks']} != all blocks {run['blocks']}")
    return run


def phase_end_to_end(device, label: str, texts, classes):
    """Phase 5: device-only encode of one corpus whose blocks fall in
    ``classes``.  Returns (narrow launches by width, wide launches,
    device_stats) of the run."""
    total = sum(map(len, texts))
    t1 = time.perf_counter()
    want = [bz2.compress(t, 9) for t in texts]
    dt_bz2 = time.perf_counter() - t1
    run = counted_encode(device, label, texts, want)
    dt, narrow, by_width, wide, stats = (run[k] for k in ("seconds", "narrow", "narrow_by_width", "wide", "stats"))
    n_blocks = run["blocks"]
    for c in classes:
        if stats[f"blocks_bits{c}"] == 0:
            raise AssertionError(f"{label}: no bits=={c} block ran on the device")
    # each narrow width's kernel launched once per batch of its class, the
    # wide kernel once per bits-8 batch, at width 256
    mid = {w: stats[f"batches_bits{c}"] for w, c in ((16, 4), (32, 5), (64, 6))}
    if (narrow != sum(mid.values()) or by_width != mid or wide != stats["batches_bits8"]
            or run["wide_by_width"] != {128: 0, 256: wide}):
        raise AssertionError(
            f"{label}: launches narrow {narrow}, by width {by_width}, wide {run['wide_by_width']} != "
            f"batches of bits 4/5/6 {list(mid.values())}, bits 8 {stats['batches_bits8']}"
        )
    per_class = {c: (stats[f"blocks_bits{c}"], stats[f"batches_bits{c}"],
                     stats[f"tie_reencodes_bits{c}"]) for c in pipeline.CLASSES}
    log(f"{label} end to end (device only): {len(texts)} streams, {total} bytes, {n_blocks} blocks, "
        f"{stats['batches']} batches, 0 abandons and demotions, launches narrow {narrow} (by width {by_width}) wide {wide}, "
        f"{stats['tie_reencodes']} tie re-encodes; (blocks, batches, tie re-encodes) per class "
        f"{per_class}; all streams == bz2.compress(text, 9)")
    log(f"{label} end to end: {total / dt / 1e6:.3f} MB/s ({dt:.3f} s); "
        f"same-run libbz2 -9 one core: {total / dt_bz2 / 1e6:.3f} MB/s ({dt_bz2:.3f} s)")
    return by_width, wide, stats


def phase_fast_huff(device, label: str, texts) -> dict:
    """Phase 7: device-only ``device_huffman`` encodes of one corpus, each
    between two ``fast`` encodes of the same texts (fast, fast_huff,
    fast_huff, fast).  Every stream equals ``bz2.compress(text, 9)``; in
    ``fast_huff`` the wide kernel launches at width 128 once per bits-4
    batch and at 256 once per other batch, the narrow kernel never.
    Returns the wide kernel's ``fast_huff`` launches by width."""
    want = [bz2.compress(t, 9) for t in texts]
    total = sum(map(len, texts))
    launches = {128: 0, 256: 0}
    runs = {"fast": [], "fast_huff": []}
    for device_huffman in (False, True, True, False):
        run = counted_encode(device, label, texts, want, device_huffman)
        stats = run["stats"]
        if device_huffman:
            b4 = stats["batches_bits4"]
            if run["narrow"] or run["wide_by_width"] != {128: b4, 256: stats["batches"] - b4}:
                raise AssertionError(
                    f"{label} fast_huff: launches narrow {run['narrow']}, wide by width "
                    f"{run['wide_by_width']} != bits-4 batches {b4}, other batches {stats['batches'] - b4}"
                )
            for w in launches:
                launches[w] += run["wide_by_width"][w]
        runs["fast_huff" if device_huffman else "fast"].append(run)
    for mode, rs in runs.items():
        stats = rs[0]["stats"]
        log(f"{label} {mode} (device only): {total / rs[0]['seconds'] / 1e6:.3f} and "
            f"{total / rs[1]['seconds'] / 1e6:.3f} MB/s ({rs[0]['seconds']:.3f}, {rs[1]['seconds']:.3f} s); "
            f"{rs[0]['blocks']} blocks in {stats['batches']} batches (bits-4 {stats['batches_bits4']}); "
            f"read back {stats['d2h_bytes']} bytes, {stats['d2h_bytes'] / rs[0]['blocks']:.0f} per block; "
            f"tie re-encodes {stats['tie_reencodes']}, emit-overflow re-encodes {stats['huff_host_reencodes']}; "
            f"wide launches by width {rs[0]['wide_by_width']}, narrow {rs[0]['narrow']}; all streams == "
            f"bz2.compress(text, 9), 0 abandons and demotions")
    return launches


def phase_entry_points(device, label: str, bed: bytes, device_huffman: bool = False):
    """Phases 6 and 7: the archive API and the CLI against the host path."""
    cfg = api.EncodeConfig(use_jax=True, device_huffman=device_huffman)
    sched, dev_stats = dict(host.scheduler_stats), dict(pipeline.device_stats)
    t0 = time.perf_counter()
    got = api.compress_bed_bytes(bed, cfg, device=device)
    dt = time.perf_counter() - t0
    sched = stats_since(host.scheduler_stats, sched)
    dev_stats = stats_since(pipeline.device_stats, dev_stats)
    if sched["abandoned_batches"]:
        raise AssertionError(f"{label} compress_bed_bytes: a device batch was abandoned: {sched}")
    n_blocks = count_blocks(texts_of(bed))
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
    log(f"{label} compress_bed_bytes scheduler: demotions {sched['demotions']}, repromotions "
        f"{sched['repromotions']}, class_skips {sched['class_skips']}, abandoned 0; of {n_blocks} blocks "
        f"{dev_stats['blocks']} went to the device in {dev_stats['batches']} batches "
        f"({dev_stats['tie_reencodes']} re-encoded for ties) and {n_blocks - dev_stats['blocks']} to the "
        f"stealers; per-class device rates now {host._class_rate_cache}")
    with tempfile.TemporaryDirectory() as d:
        src, out = os.path.join(d, "in.bed"), os.path.join(d, "out.starch")
        with open(src, "wb") as f:
            f.write(bed)
        cmd = [sys.executable, "-m", "starch3_tpu_torch.cli", "--jax",
               f"--platform={device.type}", "-o", out, src]
        if device_huffman:
            cmd.insert(4, "--device-huffman")
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True)
        dt = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"{label} CLI exit {proc.returncode}: {proc.stderr[-2000:]}")
        with open(out, "rb") as f:
            if f.read() != want:
                raise AssertionError(f"{label} CLI --jax archive != host archive")
    log(f"{label} cli {' '.join(cmd[3:-3])}: same archive bytes ({dt:.3f} s with process start)")


def sleep_cycles_per_s() -> float:
    """Clock cycles per second of ``torch.cuda._sleep``'s spin on this
    card, timed with CUDA events."""
    torch.cuda._sleep(1_000)
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    cycles = 200_000_000
    a.record()
    torch.cuda._sleep(cycles)
    b.record()
    b.synchronize()
    return cycles / (a.elapsed_time(b) / 1e3)


class StalledDispatch:
    """``pipeline._dispatch_chunk`` whose first dispatch of the encode
    first enqueues a spin of ``cycles`` (if any) on the current stream:
    that batch's kernels, and every later one, run late on a really
    stalled stream.  Keeps the longest host time of a dispatch, which must
    stay short: a dispatch that waited on the stream would hide the
    stall, and the sum of them (with ``cycles`` 0, a dispatch timer)."""

    def __init__(self, dispatch, cycles: int):
        self.dispatch, self.cycles = dispatch, cycles
        self.calls = 0
        self.max_host_s = self.host_s = 0.0

    def __call__(self, block_datas, nm, device, pad_to=None, mode="fast"):
        t0 = time.perf_counter()
        if self.calls == 0 and self.cycles:
            torch.cuda._sleep(self.cycles)
        self.calls += 1
        out = self.dispatch(block_datas, nm, device, pad_to=pad_to, mode=mode)
        dt = time.perf_counter() - t0
        self.max_host_s = max(self.max_host_s, dt)
        self.host_s += dt
        return out


def fault_case(device, label: str, texts, want, stall_s: float, host_assist: bool, smi: str, **mode):
    """One encode of ``texts`` with the first batch stalled ``stall_s``
    seconds (0: no stall), in the mode of the flags ``mode``.  Every
    stream must equal ``want``.  Returns the changes of
    ``scheduler_stats`` and ``device_stats``, and the longest host time of
    a dispatch."""
    real = pipeline._dispatch_chunk
    stalled = StalledDispatch(real, int(stall_s * sleep_cycles_per_s()) if stall_s else 0)
    pipeline._dispatch_chunk = stalled
    sched, dev_stats = dict(host.scheduler_stats), dict(pipeline.device_stats)
    try:
        t0 = time.perf_counter()
        encs = pipeline.encode_streams(texts, device=device, host_assist=host_assist, **mode)
        dt = time.perf_counter() - t0
    finally:
        pipeline._dispatch_chunk = real
    torch.cuda.synchronize()  # the stall is over
    sched = stats_since(host.scheduler_stats, sched)
    dev_stats = stats_since(pipeline.device_stats, dev_stats)
    for i, (e, w) in enumerate(zip(encs, want)):
        if e.data != w:
            raise AssertionError(f"faults {label} stream {i}: bytes != bz2.compress(text, 9)")
    log(f"faults {label}: stall {stall_s} s, host_assist {host_assist}, _ABANDON_S {host._ABANDON_S}, "
        f"no-fallback {host._no_host_fallback()}, mode {pipeline.encode_mode(**mode)}: {dt:.3f} s wall on "
        f"{smi}; all streams == bz2.compress(text, 9); scheduler {sched}; device {dev_stats['blocks']} "
        f"blocks in {dev_stats['batches']} batches; longest dispatch {stalled.max_host_s:.4f} s")
    return sched, dev_stats, stalled.max_host_s


def phase_faults(device, texts, smi: str, abandon_s: float = 0.5, stall_s: float = 3.0) -> None:
    """Phase 8, fault handling on the card: encodes whose first batch runs
    late on a stalled stream, with ``host._ABANDON_S`` at ``abandon_s``.
    (a) the hybrid abandons and benches the device, and a clean encode
    after the stall puts blocks on the device again; (b) a device-only
    encode abandons to the driver and ends; (c) with
    ``STARCH3_TPU_NO_HOST_FALLBACK=1`` a device-only encode waits out a
    stall longer than ``_ABANDON_S`` and takes every block from the rows.
    The patched names are restored whatever happens."""
    want = [bz2.compress(t, 9) for t in texts]
    n_blocks = count_blocks(texts)
    saved_abandon = host._ABANDON_S
    saved_env = os.environ.pop("STARCH3_TPU_NO_HOST_FALLBACK", None)

    def expect(label, ok, sched, dev_stats):
        if not ok:
            raise AssertionError(f"faults {label}: scheduler {sched}, device {dev_stats}")

    try:
        host._ABANDON_S = abandon_s
        sched, dev, _ = fault_case(device, "(a) hybrid", texts, want, stall_s, True, smi)
        expect("(a)", sched["abandoned_batches"] >= 1 and sched["demotions"] >= 1, sched, dev)
        sched, dev, _ = fault_case(device, "(a) clean hybrid after the stall", texts, want, 0, True, smi)
        expect("(a) clean", sched["abandoned_batches"] == 0 and dev["blocks"] >= 1, sched, dev)
        sched, dev, _ = fault_case(device, "(b) device only", texts, want, stall_s, False, smi)
        expect("(b)", sched["abandoned_batches"] >= 1, sched, dev)
        os.environ["STARCH3_TPU_NO_HOST_FALLBACK"] = "1"
        sched, dev, _ = fault_case(device, "(c) device only, no fallback", texts, want, stall_s / 2, False, smi)
        expect("(c)", sched["abandoned_batches"] == 0 and sched["demotions"] == 0
               and dev["blocks"] == n_blocks, sched, dev)
    finally:
        host._ABANDON_S = saved_abandon
        os.environ.pop("STARCH3_TPU_NO_HOST_FALLBACK", None)
        if saved_env is not None:
            os.environ["STARCH3_TPU_NO_HOST_FALLBACK"] = saved_env


def phase_exact_fault(device, texts, smi: str, abandon_s: float = 0.5, stall_s: float = 3.0) -> None:
    """Phase 10 (e), run after the exact modes' kernels have loaded: a
    device-only encode in ``ranks`` mode with its first batch stalled,
    ``_ABANDON_S`` at ``abandon_s``, abandons as fast mode does (phase 8
    b).  So no exact-mode dispatch waits on the stream: a batch's clock
    starts when its dispatch returns, and the longest dispatch must stay
    below ``abandon_s``."""
    want = [bz2.compress(t, 9) for t in texts]
    saved_abandon = host._ABANDON_S
    saved_env = os.environ.pop("STARCH3_TPU_NO_HOST_FALLBACK", None)
    try:
        host._ABANDON_S = abandon_s
        sched, dev, host_s = fault_case(device, "(e) device only, ranks mode", texts, want, stall_s, False, smi,
                                        fast_bwt=False)
    finally:
        host._ABANDON_S = saved_abandon
        if saved_env is not None:
            os.environ["STARCH3_TPU_NO_HOST_FALLBACK"] = saved_env
    if not (sched["abandoned_batches"] >= 1 and host_s < abandon_s):
        raise AssertionError(f"faults (e) ranks mode: scheduler {sched}, device {dev}, longest dispatch {host_s} s")


DECODE_N_MAX = 901_120


def decode_batch(streams: dict, labels, n_max: int = DECODE_N_MAX, b: int = 8) -> list:
    """The first ``b`` blocks of bucket ``n_max`` in the streams of
    ``labels``, in order, as the host walk gives them."""
    metas = [m for label in labels for s in streams[label] for m in pipeline.read_stream_blocks(s)[0]
             if host._bucket_for(m[4]) == n_max]
    if len(metas) < b:
        raise AssertionError(f"only {len(metas)} blocks of bucket {n_max} in {labels}")
    return metas[:b]


def phase_decode_step(device, metas, smi: str, reps: int = 7) -> dict:
    """Phase 9, the step: ``step_decode`` on the card against the CPU on
    one production batch (blocks and n equal), then per batch, for each op
    and part of the step on the card, the CUDA-event median (which counts
    the host's launches where they hold the card back) and the device
    time summed over its CUDA kernels under ``torch.profiler``."""
    from starch3_tpu_torch.ops import ibwt, imtf, irle2

    n_max = DECODE_N_MAX
    args = pipeline.pack_decode_batch(metas, n_max)
    want_b, want_n = pipeline.step_decode(*args, n_max)
    syms, m, alphabet, ptr = (a.to(device) for a in args)
    got_b, got_n = pipeline.step_decode(syms, m, alphabet, ptr, n_max)
    check_equal(f"decode step n ({len(metas)}, {n_max})", got_n.cpu(), want_n)
    check_equal(f"decode step blocks ({len(metas)}, {n_max})", got_b.cpu(), want_b)
    if want_n.tolist() != [meta[4] for meta in metas]:
        raise AssertionError(f"decode step: n {want_n.tolist()} != the host's counts")
    # each part on its own input, made once by the part before it
    ranks, n = irle2.irle2_decode_padded(syms, m, n_max)
    q, fronts = imtf.tile_permutations(ranks, n, n_max)
    c_pre = imtf.compose_exclusive(q)
    last = imtf.gather_symbols(c_pre, fronts, alphabet).to(torch.uint8)
    lf = ibwt.lf_mapping(last, n, n_max)
    d, nxt = ibwt.jump(lf, ptr, n, n_max)
    parts = {
        "step": lambda: pipeline.step_decode(syms, m, alphabet, ptr, n_max),
        "irle2": lambda: irle2.irle2_decode_padded(syms, m, n_max),
        "imtf pass 1": lambda: imtf.tile_permutations(ranks, n, n_max),
        "imtf pass 2": lambda: imtf.compose_exclusive(q),
        "imtf gathers": lambda: imtf.gather_symbols(c_pre, fronts, alphabet),
        "ibwt sort": lambda: ibwt.lf_mapping(last, n, n_max),
        "ibwt jumping": lambda: ibwt.jump(lf, ptr, n, n_max),
        "ibwt placement": lambda: ibwt.place(last, d, nxt, ptr, n, n_max),
    }
    ms = {name: cuda_median_ms(fn, reps) for name, fn in parts.items()}
    device_ms = {name: sum(device_us_by_kernel(fn, 2).values()) / 1e3 for name, fn in parts.items()}
    log(f"decode step: card == CPU at ({len(metas)}, {n_max}), n {want_n.tolist()}; per batch on {smi}, "
        f"ms: CUDA-event median of {reps} {json.dumps(ms)}; device time (torch.profiler, mean of 2) "
        f"{json.dumps(device_ms)}")
    return {"ms": ms, "device_ms": device_ms}


def phase_device_decode(device, label: str, texts, streams, smi: str, rle1_blocks: int = 3) -> dict:
    """Phase 9, device-only decode of one corpus's level-9 streams: every
    text back, the decode counters (set to 0 just before, read just after)
    equal to the blocks and batches dispatched, and no MTF kernel
    launched.  MB/s of text beside same-run single-thread
    ``bz2.decompress``, and the host's ms per block for the symbol walk,
    ``rle1_decode`` (on ``rle1_blocks`` blocks) and the CRC."""
    total = sum(map(len, texts))
    t0 = time.perf_counter()
    walked = [pipeline.read_stream_blocks(s)[0] for s in streams]
    walk_s = time.perf_counter() - t0
    n_blocks = sum(map(len, walked))
    buckets = dict(collections.Counter(host._bucket_for(blk[4]) for blocks in walked for blk in blocks))
    n_batches = sum(-(-c // 8) for c in buckets.values())
    mtf_narrow.launches = mtf_wide.launches = 0
    pipeline.device_stats["decode_batches"] = pipeline.device_stats["decode_blocks"] = 0
    t0 = time.perf_counter()
    got = pipeline.decode_streams(streams, device=device)
    dt = time.perf_counter() - t0
    stats = {k: pipeline.device_stats[k] for k in ("decode_batches", "decode_blocks")}
    if got != texts:
        raise AssertionError(f"{label} device decode: a stream != its text")
    if stats != {"decode_batches": n_batches, "decode_blocks": n_blocks} or mtf_narrow.launches or mtf_wide.launches:
        raise AssertionError(f"{label} device decode: counters {stats}, MTF launches {mtf_narrow.launches} "
                             f"{mtf_wide.launches} != {n_batches} batches, {n_blocks} blocks, 0 launches")
    t0 = time.perf_counter()
    for s in streams:
        bz2.decompress(s)
    dt_bz2 = time.perf_counter() - t0
    rle1_in = [b.data for t in texts for b in host._split_classify(t, 9)[0]][:rle1_blocks]
    t0 = time.perf_counter()
    rle1_out = [rle1_decode(x) for x in rle1_in]
    rle1_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for x in rle1_out:
        crc32_bytes(x)
    crc_s = time.perf_counter() - t0
    run = {
        "mb_s": total / dt / 1e6, "seconds": dt, "bz2_mb_s": total / dt_bz2 / 1e6, "blocks": n_blocks,
        "batches": n_batches, "buckets": buckets, "walk_ms_per_block": walk_s / n_blocks * 1e3,
        "rle1_ms_per_block": rle1_s / len(rle1_in) * 1e3, "crc_ms_per_block": crc_s / len(rle1_in) * 1e3,
        "rle1_bytes_per_block": sum(map(len, rle1_in)) / len(rle1_in),
    }
    log(f"{label} device decode (decode_streams, device only): {len(streams)} streams, {total} bytes, "
        f"{n_blocks} blocks in {n_batches} batches {buckets}, all == text; {run['mb_s']:.3f} MB/s of text "
        f"({dt:.3f} s); same-run bz2.decompress one thread {run['bz2_mb_s']:.3f} MB/s; host per block: "
        f"walk {run['walk_ms_per_block']:.3f} ms, rle1_decode {run['rle1_ms_per_block']:.3f} ms "
        f"({run['rle1_bytes_per_block']:.0f} B in), CRC {run['crc_ms_per_block']:.3f} ms; on {smi}")
    return run


def phase_archive_decode(device, label: str, bed: bytes, smi: str) -> None:
    """Phase 9, the entry: ``decompress_starch_bytes(archive, use_jax=True)``
    equals the native block-parallel decode and the BED; MB/s of BED of
    both and of single-thread ``bz2.decompress`` of the archive's streams."""
    archive = api.compress_bed_bytes(bed, api.EncodeConfig())
    t0 = time.perf_counter()
    got = api.decompress_starch_bytes(archive, use_jax=True, device=device.type)
    dt = time.perf_counter() - t0
    t0 = time.perf_counter()
    native = api.decompress_starch_bytes(archive)
    dt_native = time.perf_counter() - t0
    if not got == native == bed:
        raise AssertionError(f"{label} decompress_starch_bytes(use_jax=True) != host decode or BED")
    streams = [s for _meta, s in api.StarchReader.from_bytes(archive).iter_streams()]
    t0 = time.perf_counter()
    for s in streams:
        bz2.decompress(s)
    dt_bz2 = time.perf_counter() - t0
    log(f"{label} decompress_starch_bytes(use_jax=True) == native == BED; MB/s of BED: device "
        f"{len(bed) / dt / 1e6:.3f} ({dt:.3f} s), native block-parallel ({os.cpu_count()} workers) "
        f"{len(bed) / dt_native / 1e6:.3f} ({dt_native:.3f} s), bz2.decompress of its streams, one thread "
        f"{len(bed) / dt_bz2 / 1e6:.3f} ({dt_bz2:.3f} s); on {smi}")


EXACT_N_MAX = 901_120


def first_blocks(texts, n_max: int, k: int) -> list[bytes]:
    """The first ``k`` post-RLE1 blocks of bucket ``n_max`` in ``texts``."""
    out = [blk.data for t in texts for blk in host._split_classify(t, 9)[0]
           if host._bucket_for(len(blk.data)) == n_max]
    if len(out) < k:
        raise AssertionError(f"only {len(out)} blocks of bucket {n_max}")
    return out[:k]


def profiled_ms(fn) -> float:
    """Device time of one call of ``fn``, summed over its CUDA kernels
    under ``torch.profiler`` (mean of 2 calls)."""
    return sum(device_us_by_kernel(fn, 2).values()) / 1e3


def device_ops(fn) -> int:
    """The kernels and copies that one call of ``fn`` enqueues on the
    card, counted by ``torch.profiler``."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(evt.count for evt in prof.key_averages()
               if getattr(evt, "device_type", None) == torch.autograd.DeviceType.CUDA)


def phase_exact_bwt(device, by_label, smi: str, reps: int = 5) -> dict:
    """Phase 10 (a): the prefix-doubling BWT on the card against the CPU
    at (3, 901,120), on two batches: real blocks of config 3 and wide8
    with a periodic row, then a second wide8 block, a row of length 1 and
    a periodic row of length 901,120; the first config-3 block against
    the host sort too.  Then the CUDA-event median and the device time of
    the whole sort and of one round on the first batch."""
    from starch3_tpu_torch.codec.bwt import bwt_encode as host_bwt
    from starch3_tpu_torch.ops import bwt

    n_max = EXACT_N_MAX
    c3, w8 = first_blocks(by_label["config3"], n_max, 1), first_blocks(by_label["wide8"], n_max, 2)
    batches = {
        "config3, wide8, periodic": [c3[0], w8[0], b"1723\n481\np100\n" * 40_000],
        "wide8, length 1, periodic of length n_max": [w8[1], b"\x07", b"ACGT" * (n_max // 4)],
    }
    first = None
    for label, datas in batches.items():
        raw, lens = pipeline.raw_batch(datas, n_max)
        lens = torch.from_numpy(lens)
        raw_d, lens_d = raw.to(device), lens.to(device)
        last, ptr = bwt.bwt_encode_padded(raw_d, lens_d)
        want_last, want_ptr = bwt.bwt_encode_padded(raw, lens)
        check_equal(f"exact bwt last ({label})", last.cpu(), want_last)
        check_equal(f"exact bwt orig_ptr ({label})", ptr.cpu(), want_ptr)
        log(f"exact bwt ({label}) {tuple(raw.shape)}: card == CPU; lens {lens.tolist()}, ptrs {ptr.tolist()}")
        first = first or (raw_d, lens_d, last, ptr)
    h_last, h_ptr = host_bwt(np.frombuffer(c3[0], np.uint8))
    if first[2][0, : len(c3[0])].cpu().numpy().tobytes() != h_last.tobytes() or int(first[3][0]) != h_ptr:
        raise AssertionError("exact bwt: the config-3 block != the host sort (codec.bwt.bwt_encode)")
    raw_d, lens_d = first[:2]
    state = bwt.initial_state(raw_d, lens_d)
    parts = {
        "whole sort": lambda: bwt.bwt_encode_padded(raw_d, lens_d),
        "one round (k=1)": lambda: bwt.doubling_round(*state[:2], 1, *state[2:]),
    }
    run = {name: {"ms": cuda_median_ms(fn, reps), "device_ms": profiled_ms(fn), "device_ops": device_ops(fn)}
           for name, fn in parts.items()}
    run["rounds"] = bwt.n_rounds(n_max)
    log(f"exact bwt: the config-3 block == host sort; at {tuple(raw_d.shape)}, {run['rounds']} rounds, on {smi}: "
        f"CUDA-event median of {reps}, device ms (torch.profiler, mean of 2) and kernels and copies enqueued "
        f"per call {json.dumps(run)}")
    return run


def phase_exact_steps(device, by_label, smi: str, reps: int = 5) -> dict:
    """Phase 10 (b): ``step_exact`` and ``step_exact_rle2`` rows on the card
    equal the CPU's on three config-3 blocks at 901,120, K3 launching once
    a call at width 256; CUDA-event median and device ms of each."""
    raw, lens = pipeline.raw_batch(first_blocks(by_label["config3"], EXACT_N_MAX, 3), EXACT_N_MAX)
    lens = torch.from_numpy(lens)
    raw_d, lens_d = raw.to(device), lens.to(device)
    run = {}
    for name in ("step_exact", "step_exact_rle2"):
        step = getattr(pipeline, name)
        before = mtf_wide.width_launches[256]
        got = step(raw_d, lens_d)
        torch.cuda.synchronize()
        if mtf_wide.width_launches[256] != before + 1:
            raise AssertionError(f"{name}: K3 did not launch once at width 256")
        check_equal(f"{name} rows {tuple(raw.shape)}", got.cpu(), step(raw, lens))
        fn = lambda step=step: step(raw_d, lens_d)  # noqa: E731
        run[name] = {"ms": cuda_median_ms(fn, reps), "device_ms": profiled_ms(fn), "device_ops": device_ops(fn)}
    log(f"exact steps: card rows == CPU rows at {tuple(raw.shape)} (config 3, lens {lens.tolist()}); on {smi}: "
        f"CUDA-event median of {reps}, device ms and kernels and copies enqueued per call {json.dumps(run)}")
    return run


def phase_exact_modes(device, label: str, texts, smi: str) -> int:
    """Phase 10 (c): device-only encodes of one corpus in the exact modes
    between fast-mode encodes of the same texts (fast, ranks, rle2, rle2,
    ranks, fast).  Every stream equals ``bz2.compress(text, 9)``; in the
    exact modes K3 launches at width 256 once per batch, the narrow kernel
    never, and no block is re-encoded.  Returns the exact runs' K3
    launches."""
    want = [bz2.compress(t, 9) for t in texts]
    total = sum(map(len, texts))
    order = [("fast", {}), ("ranks", {"fast_bwt": False}), ("rle2", {"fast_bwt": False, "device_rle2": True})]
    runs = {mode: [] for mode, _ in order}
    launches = 0
    for mode, flags in order + order[:0:-1] + order[:1]:
        run = counted_encode(device, label, texts, want, **flags)
        stats = run["stats"]
        if mode != "fast":
            if (run["narrow"] or run["wide_by_width"] != {128: 0, 256: stats["batches"]}
                    or stats["tie_reencodes"]):
                raise AssertionError(
                    f"{label} {mode}: launches narrow {run['narrow']}, wide by width {run['wide_by_width']}, "
                    f"tie re-encodes {stats['tie_reencodes']} != 0, {{256: {stats['batches']} batches}}, 0")
            launches += run["wide"]
        runs[mode].append(run)
    for mode, rs in runs.items():
        stats = rs[0]["stats"]
        log(f"{label} {mode} (device only, in turns with the other modes): {total / rs[0]['seconds'] / 1e6:.3f} "
            f"and {total / rs[1]['seconds'] / 1e6:.3f} MB/s of text ({rs[0]['seconds']:.3f}, "
            f"{rs[1]['seconds']:.3f} s); {rs[0]['blocks']} blocks in {stats['batches']} batches; read back "
            f"{stats['d2h_bytes']} bytes, {stats['d2h_bytes'] / rs[0]['blocks']:.0f} per block; tie re-encodes "
            f"{stats['tie_reencodes']}; launches narrow {rs[0]['narrow']}, wide by width {rs[0]['wide_by_width']}; "
            f"all streams == bz2.compress(text, 9), 0 abandons and demotions; on {smi}")
    return launches


def phase_exact_archives(device, bed: bytes, smi: str) -> None:
    """Phase 10 (d): ``compress_bed_bytes(use_jax=True)`` with
    ``fast_bwt=False``, with and without ``device_rle2``, and with
    ``device_rle2`` alone (fast mode, as in the reference) equals the host
    path's archive; no batch is abandoned, and the batches that went to
    the device ran the mode's kernels (config 2 is all bits 4: fast mode
    runs the narrow kernel, the exact modes K3 at width 256)."""
    t0 = time.perf_counter()
    want = api.compress_bed_bytes(bed, api.EncodeConfig())
    dt_host = time.perf_counter() - t0
    for flags in ({"fast_bwt": False}, {"fast_bwt": False, "device_rle2": True}, {"device_rle2": True}):
        mode = pipeline.encode_mode(**flags)
        sched, dev_stats = dict(host.scheduler_stats), dict(pipeline.device_stats)
        narrow, wide256 = mtf_narrow.launches, mtf_wide.width_launches[256]
        t0 = time.perf_counter()
        got = api.compress_bed_bytes(bed, api.EncodeConfig(use_jax=True, **flags), device=device)
        dt = time.perf_counter() - t0
        sched = stats_since(host.scheduler_stats, sched)
        dev_stats = stats_since(pipeline.device_stats, dev_stats)
        narrow, wide256 = mtf_narrow.launches - narrow, mtf_wide.width_launches[256] - wide256
        if got != want:
            raise AssertionError(f"config2 compress_bed_bytes {flags}: device archive != host archive")
        expected = (dev_stats["batches"], 0) if mode == "fast" else (0, dev_stats["batches"])
        if sched["abandoned_batches"] or (narrow, wide256) != expected:
            raise AssertionError(f"config2 compress_bed_bytes {flags}: scheduler {sched}, launches narrow {narrow}, "
                                 f"K3 at 256 {wide256}, device batches {dev_stats['batches']}")
        log(f"config2 compress_bed_bytes {flags} (mode {mode}): archive == host path's; {len(bed) / dt / 1e6:.3f} MB/s "
            f"of BED ({dt:.3f} s), host path {len(bed) / dt_host / 1e6:.3f} MB/s; {dev_stats['blocks']} blocks on "
            f"the device in {dev_stats['batches']} batches, launches narrow {narrow}, K3 at 256 {wide256}; on {smi}")


def mesh_launches_expected(stats: dict, n: int, mode: str) -> tuple[dict, dict]:
    """The launches by width that a device-only encode on a mesh of ``n``
    entries must count: each batch's kernel once per entry.  (narrow by
    width, wide by width)."""
    b = {c: stats[f"batches_bits{c}"] for c in pipeline.CLASSES}
    if mode == "fast":
        return {16: n * b[4], 32: n * b[5], 64: n * b[6]}, {128: 0, 256: n * b[8]}
    if mode == "fast_huff":
        return {16: 0, 32: 0, 64: 0}, {128: n * b[4], 256: n * (stats["batches"] - b[4])}
    return {16: 0, 32: 0, 64: 0}, {128: 0, 256: n * stats["batches"]}


def phase_mesh_encodes(device, runs, smi: str) -> dict:
    """Phase 11 (a) and (b): device-only encodes on block meshes of one
    card.  (a) Every corpus in fast mode, in turns at mesh None, a mesh of
    ``cuda:0`` alone and a mesh that names ``cuda:0`` twice (its two
    entries on two streams), then back (None, 1, 2, 2, 1, None); (b) on
    config 2, ``device_huffman`` and the exact mode ``rle2`` under the
    two-entry mesh.  Every stream equals ``bz2.compress(text, 9)``, every
    block ran on the device, and each batch's kernel launched once per
    entry.  Each run's host time per dispatch (pack, uploads, launches) is
    printed beside its MB/s.  Returns the runs' launches, narrow and wide
    by width."""
    from starch3_tpu_torch.parallel.mesh import make_block_mesh

    meshes = {0: None, 1: make_block_mesh(devices=[device]), 2: make_block_mesh(devices=[device, device])}
    two = meshes[2]
    if two.devices != (meshes[1].devices[0],) * 2 or (device.type == "cuda" and two.streams[0] == two.streams[1]):
        raise AssertionError(f"two-entry mesh: devices {two.devices}, streams {two.streams}")
    narrow_total = dict.fromkeys((16, 32, 64), 0)
    wide_total = dict.fromkeys(mtf_wide.WIDTHS, 0)

    def run(label, texts, want, n, mode, flags) -> dict:
        timed = StalledDispatch(pipeline._dispatch_chunk, 0)
        pipeline._dispatch_chunk = timed
        try:
            r = counted_encode(device, f"{label} mesh {n}", texts, want, mesh=meshes[n], **flags)
        finally:
            pipeline._dispatch_chunk = timed.dispatch
        r["dispatch_ms"] = timed.host_s / timed.calls * 1e3
        want_narrow, want_wide = mesh_launches_expected(r["stats"], max(n, 1), mode)
        if r["narrow_by_width"] != want_narrow or r["wide_by_width"] != want_wide:
            raise AssertionError(
                f"{label} {mode} mesh {n}: launches narrow {r['narrow_by_width']}, wide {r['wide_by_width']} != "
                f"once per entry per batch {want_narrow}, {want_wide} (batches {r['stats']})")
        for w, k in r["narrow_by_width"].items():
            narrow_total[w] += k
        for w, k in r["wide_by_width"].items():
            wide_total[w] += k
        return r

    for label, texts, _classes in runs:
        want = [bz2.compress(t, 9) for t in texts]
        total = sum(map(len, texts))
        by_n = {0: [], 1: [], 2: []}
        for n in (0, 1, 2, 2, 1, 0):
            by_n[n].append(run(label, texts, want, n, "fast", {}))
        for n, rs in by_n.items():
            log(f"{label} mesh {['None', 'cuda:0', 'cuda:0 twice'][n]} (fast, device only): "
                f"{total / rs[0]['seconds'] / 1e6:.3f} and {total / rs[1]['seconds'] / 1e6:.3f} MB/s of text "
                f"({rs[0]['seconds']:.3f}, {rs[1]['seconds']:.3f} s); host time per dispatch "
                f"{rs[0]['dispatch_ms']:.3f} and {rs[1]['dispatch_ms']:.3f} ms; {rs[0]['blocks']} blocks in "
                f"{rs[0]['stats']['batches']} batches; launches narrow {rs[0]['narrow_by_width']} wide "
                f"{rs[0]['wide_by_width']}; all streams == bz2.compress(text, 9); on {smi}")
    label, texts, _classes = runs[0]
    want = [bz2.compress(t, 9) for t in texts]
    total = sum(map(len, texts))
    for mode, flags in (("fast_huff", {"device_huffman": True}), ("rle2", {"fast_bwt": False, "device_rle2": True})):
        r = run(label, texts, want, 2, mode, flags)
        log(f"{label} mesh cuda:0 twice ({mode}, device only): {total / r['seconds'] / 1e6:.3f} MB/s of text "
            f"({r['seconds']:.3f} s); host time per dispatch {r['dispatch_ms']:.3f} ms; {r['blocks']} blocks in "
            f"{r['stats']['batches']} batches; launches wide "
            f"{r['wide_by_width']}; read back {r['stats']['d2h_bytes']} bytes; all streams == "
            f"bz2.compress(text, 9); on {smi}")
    return {"narrow": narrow_total, "wide": wide_total, "mesh": meshes[2]}


def phase_mesh_decode(mesh, by_label, beds, smi: str) -> None:
    """Phase 11 (c): decode under the two-entry mesh.  ``decode_streams``
    gives back the texts of configs 2 and 3, with one decode batch counted
    per batch of 8 whatever the mesh; ``decompress_starch_bytes(archive,
    use_jax=True, mesh=...)`` equals the host decode and the BED."""
    for label in ("config2", "config3"):
        texts = by_label[label]
        streams = [bz2.compress(t, 9) for t in texts]
        walked = [pipeline.read_stream_blocks(s)[0] for s in streams]
        buckets = collections.Counter(host._bucket_for(blk[4]) for blocks in walked for blk in blocks)
        n_batches = sum(-(-c // 8) for c in buckets.values())
        pipeline.device_stats["decode_batches"] = pipeline.device_stats["decode_blocks"] = 0
        t0 = time.perf_counter()
        got = pipeline.decode_streams(streams, mesh=mesh)
        dt = time.perf_counter() - t0
        if got != texts:
            raise AssertionError(f"{label} decode_streams(mesh=cuda:0 twice): a stream != its text")
        stats = {k: pipeline.device_stats[k] for k in ("decode_batches", "decode_blocks")}
        if stats != {"decode_batches": n_batches, "decode_blocks": sum(buckets.values())}:
            raise AssertionError(f"{label} mesh decode: counters {stats} != {n_batches} batches, {buckets}")
        archive = api.compress_bed_bytes(beds[label], api.EncodeConfig())
        t1 = time.perf_counter()
        arc = api.decompress_starch_bytes(archive, use_jax=True, mesh=mesh)
        dt_arc = time.perf_counter() - t1
        if not arc == api.decompress_starch_bytes(archive) == beds[label]:
            raise AssertionError(f"{label} decompress_starch_bytes(use_jax=True, mesh=...) != host decode or BED")
        log(f"{label} decode under mesh cuda:0 twice: decode_streams == texts, {stats}, "
            f"{sum(map(len, texts)) / dt / 1e6:.3f} MB/s of text ({dt:.3f} s); decompress_starch_bytes == host "
            f"decode == BED, {len(beds[label]) / dt_arc / 1e6:.3f} MB/s of BED ({dt_arc:.3f} s); on {smi}")


def phase_two_processes(device, bed: bytes, smi: str, timeout_s: float = 300.0) -> None:
    """Phase 11 (d): two processes on the one card, ``python -m
    starch3_tpu_torch.cli --jax --num-hosts=2 --host-id=i``, once over a
    gloo process group (``--coordinator``) and once through a manifest
    directory.  Host 0's archive equals the single-process host archive
    and host 1 writes nothing.  Both children are killed if either is
    still running when the case ends."""
    import socket

    want = api.compress_bed_bytes(bed, api.EncodeConfig())
    with tempfile.TemporaryDirectory() as d:
        src = os.path.join(d, "in.bed")
        with open(src, "wb") as f:
            f.write(bed)
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        for transport, how in (("gloo", f"--coordinator=127.0.0.1:{port}"),
                               ("manifest", f"--manifest-dir={os.path.join(d, 'manifest')}")):
            cmds = [[sys.executable, "-m", "starch3_tpu_torch.cli", "--jax", f"--platform={device.type}",
                     "--num-hosts=2", f"--host-id={h}", how, src] for h in range(2)]
            t0 = time.perf_counter()
            procs = [subprocess.Popen(c, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE) for c in cmds]
            try:
                outs = [p.communicate(timeout=timeout_s) for p in procs]
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
            dt = time.perf_counter() - t0
            for h, (p, (_out, err)) in enumerate(zip(procs, outs)):
                if p.returncode != 0:
                    raise AssertionError(f"two processes ({transport}) host {h} exit {p.returncode}: "
                                         f"{err.decode()[-2000:]}")
            if outs[0][0] != want or outs[1][0] != b"":
                raise AssertionError(f"two processes ({transport}): host 0 archive == host archive "
                                     f"{outs[0][0] == want}, host 1 wrote {len(outs[1][0])} bytes")
            log(f"config2 two processes on one card ({transport}, --jax --num-hosts=2): host 0 archive == "
                f"single-process host archive, host 1 wrote nothing; {dt:.3f} s wall for both, process "
                f"starts included ({len(bed) / dt / 1e6:.3f} MB/s of BED); on {smi}")


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
    with concurrent.futures.ThreadPoolExecutor(len(KERNELS) + 1) as ex:
        host = ex.submit(runtime.get_lib)
        libs = list(ex.map(build, KERNELS))
        if host.result() is None or runtime.lib_path.parent != BUILD_DIR:
            raise AssertionError("the port's native host runtime did not build and load from build/")
    log(f"build: {', '.join(lib.name for lib in libs + [runtime.lib_path])} in "
        f"{time.perf_counter() - t0:.2f} s")
    for lib in libs:
        ptxas = lib.with_suffix(".log")
        if ptxas.exists():
            for line in ptxas.read_text().splitlines():
                if "Used" in line or "spill" in line:
                    log(f"  ptxas {lib.stem}: {line.strip()}")

    bed2 = corpus.config2_bed(args.seed)
    bed3 = corpus.config3_bed()
    runs = [  # (label, texts, classes)
        ("config2", texts_of(bed2 + corpus.big_chrom_bed(args.seed + 1)), (4,)),
        ("config3", texts_of(bed3), (5,)),
        ("bits6", texts_of(corpus.bits6_bed()), (6,)),
        ("wide8", texts_of(corpus.wide8_bed()), (8,)),
    ]
    by_label = {label: t for label, t, _ in runs}
    checks = {name: phase_kernel(device, args.seed, name, by_label) for name in KERNELS}
    for (label, texts, (bits,)), n_max in zip(runs, (BUCKETS[1],) + (BUCKETS[0],) * 3):
        phase_step(device, texts, bits, n_max)
    # the narrow wrapper's launches as its two kernels counted them: width
    # 16 (csrc/mtf_narrow.cu), widths 32/64 (the windowed kernel)
    launches = {"mtf_narrow": 0, "mtf_narrow_windowed": 0, "mtf_wide": 0}
    wide_by_width = dict.fromkeys(mtf_wide.WIDTHS, 0)
    exact8 = 0
    for label, texts, classes in runs:
        by_width, wide, stats = phase_end_to_end(device, label, texts, classes)
        launches["mtf_narrow"] += by_width[16]
        launches["mtf_narrow_windowed"] += by_width[32] + by_width[64]
        launches["mtf_wide"] += wide
        wide_by_width[256] += wide
        exact8 += stats["blocks_bits8"] - stats["tie_reencodes_bits8"]
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"{name}: no launch in the device-only encodes")
    if exact8 == 0:
        raise AssertionError("no bits==8 block was tie-free on the device")
    phase_entry_points(device, "config2", bed2)
    phase_entry_points(device, "config3", bed3)
    huff_launches = {128: 0, 256: 0}
    for label in ("config2", "config3", "wide8"):
        for w, n in phase_fast_huff(device, label, by_label[label]).items():
            huff_launches[w] += n
    if not all(huff_launches.values()):
        raise AssertionError(f"fast_huff: the wide kernel did not launch at every width: {huff_launches}")
    for w, n in huff_launches.items():
        wide_by_width[w] += n
        launches["mtf_wide"] += n
    phase_entry_points(device, "config2 fast_huff", bed2, device_huffman=True)
    phase_faults(device, texts_of(bed2), smi)
    streams = {label: [bz2.compress(t, 9) for t in texts] for label, texts, _ in runs}
    phase_decode_step(device, decode_batch(streams, ("config2", "wide8", "config3")), smi)
    for label, texts, _ in runs:
        phase_device_decode(device, label, texts, streams[label], smi)
    phase_archive_decode(device, "config2", bed2, smi)
    phase_archive_decode(device, "config3", bed3, smi)
    phase_exact_bwt(device, by_label, smi)
    phase_exact_steps(device, by_label, smi)
    exact = sum(phase_exact_modes(device, label, by_label[label], smi) for label in ("config2", "config3", "wide8"))
    wide_by_width[256] += exact
    launches["mtf_wide"] += exact
    phase_exact_archives(device, bed2, smi)
    phase_exact_fault(device, texts_of(bed2), smi)
    mesh_run = phase_mesh_encodes(device, runs, smi)
    launches["mtf_narrow"] += mesh_run["narrow"][16]
    launches["mtf_narrow_windowed"] += mesh_run["narrow"][32] + mesh_run["narrow"][64]
    for w, n in mesh_run["wide"].items():
        wide_by_width[w] += n
        launches["mtf_wide"] += n
    phase_mesh_decode(mesh_run["mesh"], by_label, {"config2": bed2, "config3": bed3}, smi)
    phase_two_processes(device, bed2, smi)

    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    jax_pkg = sorted(m for m in sys.modules if m == "starch3_tpu" or m.startswith("starch3_tpu."))
    if jax_pkg:
        raise AssertionError(f"modules of the JAX package were imported: {jax_pkg}")
    # (name, wrapper, source, replaces, widths, main width and n_max)
    entries = [
        ("mtf_narrow", "mtf_narrow", "mtf_narrow.cu", "starch3_tpu/ops/mtf_narrow_pallas.py:95",
         (16,), KERNELS["mtf_narrow"][3]),
        ("mtf_narrow_windowed", "mtf_narrow", "mtf_wide.cu",
         "starch3_tpu/ops/mtf_narrow_pallas.py:95", (32, 64), (32, 901_120)),
        ("mtf_wide", "mtf_wide", "mtf_wide.cu", "starch3_tpu/ops/mtf_pallas.py:112",
         mtf_wide.WIDTHS, KERNELS["mtf_wide"][3]),
    ]
    kernels = []
    for name, wrapper, source, replaces, widths, (width, n_max) in entries:
        max_err, cases = checks[wrapper]
        cases = [c for c in cases if c["width"] in widths]
        main = next(c for c in cases
                    if c["input"] == "random" and c["width"] == width and c["shape"][1] == n_max)
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"starch3_tpu_torch/csrc/{source}",
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": max_err,
            "ms": main["ms"],
            "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"],
            "bound_by": "bytes",
            "library_ms": None,  # no single PyTorch call computes MTF ranks
            "device_ms": main["device_ms"],
            "share_of_bound": main["share_of_bound"],
            "widths": cases,
        })
        if name == "mtf_wide":
            kernels[-1]["launches_by_width"] = {str(w): n for w, n in wide_by_width.items()}
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
