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
     458,752, bits 5, 6 and 8 at 901,120, called directly, and through
     the launcher as a dispatch runs it, eagerly and as the fast step's
     CUDA graph (the first batch of a key warms it up, the second
     captures and replays it, the third replays it).  Rows equal (a tied
     bits-8 row: columns ptr and ties); the captures made, one per key,
     and the replays are printed, and the per-width launches of the
     replays equal the eager launches.  One more replay runs under
     ``torch.profiler``: the MTF kernels its trace shows, by width, equal
     what the counters add for it (the capture's tally), so the replays'
     counts in the kernels line are launches the card ran;
  5. device-only end to end, ``encode_streams(host_assist=False)``, one
     run per corpus: config 2 plus one ~400,000-interval chromosome
     (bits 4, multi-block streams), config 3 (bits 5), the gene-id corpus
     (bits 6) and the free-text corpus (bits 8, multi-block streams).
     Every stream equals ``bz2.compress(text, 9)``, the device blocks
     equal all blocks, no batch was abandoned and the device was never
     benched (``scheduler_stats``), each corpus's class ran on the
     device, the narrow kernel's launches at widths 16, 32 and 64 equal the bits 4, 5 and 6
     batches and the wide kernel's the bits-8 batches (most of them graph
     replays, which count what their capture launched; the captures and
     replays are printed), and at least one bits-8 block was tie-free;
     MB/s beside same-run libbz2 -9;
  6. the entry points with their defaults, the device path on the card,
     on config 2 and on config 3: ``compress_bed_bytes(bed)`` (no config,
     no device) equals the host path's archive, asked for with
     ``EncodeConfig(use_jax=False)``, and puts blocks on the card;
     ``decompress_starch_bytes(archive)`` (no flag: the device decode,
     every block on the card) and ``use_jax=False`` each give back the
     BED; and the CLI with no flag but its output, ``-o F FILE`` (its
     ``main`` with that argv in a process started anew, ``scale_run
     host``), writes the host path's bytes, abandons no batch and
     launches its MTF kernel once per device batch.  The hybrid abandons
     no batch; its demotions, repromotions and class skips, its blocks on
     the device against those on the stealers, and the graph captures and
     replays and per-width launches are printed, and one ``default
     entry`` line per entry point: its platform, its blocks on the card
     of all its blocks, and its MB/s beside the host path's;
  7. ``device_huffman`` (mode ``fast_huff``), device only, on the config 2,
     config 3 and free-text texts, each run between two runs of ``fast``
     mode on the same texts (fast, fast_huff, fast_huff, fast): every
     stream equals ``bz2.compress(text, 9)``, no batch was abandoned and
     the device never benched, the wide kernel launched at width 128 once
     per bits-4 batch and at width 256 once per other batch, the narrow
     kernel never; MB/s and the bytes read back per block of each mode are
     printed.  Then phase 6 again on config 2 with ``device_huffman``:
     ``compress_bed_bytes(bed, EncodeConfig(device_huffman=True))`` and
     the CLI's ``--device-huffman`` equal the host path's archive;
  8. fault handling on the card, on config 2's texts: the first batch of
     an encode runs behind a ``torch.cuda._sleep`` spin on its stream
     (calibrated with CUDA events), with ``_ABANDON_S`` at 0.5 s.  (a) The
     hybrid abandons the batch and benches the device, and a clean
     encode after the stall puts blocks on the device again; (b) a
     device-only encode abandons to the driver and ends, and no dispatch
     waits on the stalled stream (the longest stays below 0.5 s); (c) with
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
     abandons, as phase 8 (b) does in fast mode, with no dispatch longer
     than 0.5 s, here and again in a fresh child process (a cold CUDA
     context and host allocator, killed if it outlives its timeout).
  11. block meshes and two processes on the one card: (a) device-only
     fast-mode encodes of every phase-5 corpus in turns at mesh None, a
     mesh of ``cuda:0`` alone and a mesh that names ``cuda:0`` twice (two
     entries, two streams): every stream equals ``bz2.compress(text, 9)``
     and each batch's MTF kernel launched once per entry; MB/s of text of
     each; (b) ``device_huffman`` and ``rle2`` on config 2 under the
     two-entry mesh, the same checks; (c) ``decode_streams`` of configs 2
     and 3 and ``decompress_starch_bytes(use_jax=True)`` of their archives
     under the two-entry mesh equal the texts and the host decode; (d) two
     CLI processes, ``--num-hosts=2``, on config 2, once over a gloo
     process group (``--coordinator``) and once through a manifest
     directory: host 0's archive equals the host path's and host 1 writes
     nothing; the wall time of both.
  12. the rest of the JAX package's counterparts: (a) the delta
     transform's device ops (``ops/transform.py``) on every chromosome of
     config 2 plus the 400,000-interval chromosome, starts and stops from
     the port's BED parser as ``int32`` and as ``int64``: the card equals
     the CPU value for value and dtype for dtype, and ``untransform_core``
     gives back the starts and stops; CUDA-event ms of each op over the
     corpus beside the CPU's; (b) ``device_trace`` around a device-only
     config-2 encode in a ``StageTimer`` stage: the one trace file under
     ``build/trace-<pid>/`` names the stage and ``mtf16_kernel``, whose
     launches equal the bits-4 batches; its size and GPU kernel events;
     (c) the host helpers ``bwt_fast_host``, ``mtf_ranks_narrow_host`` and
     ``mtf_ranks_wide_host`` on one real block each, card equal to CPU,
     each helper's kernel launched once.
  13. the main path at the scale its users run (``phase_scale``), each
     leg a child process of ``python -m starch3_tpu_torch.scale_run``
     (killed with what it started when it fails or outlives its
     timeout), on the scale corpus ``corpus.gigabyte_bed`` at 1.1e9
     bytes of BED (``TestGigabyteScale``'s bytes, about 44M intervals in
     22 chromosomes) and its half at 5.5e8 bytes, a prefix, both in a
     temporary directory (the phase fails when the disk lacks room):
     (a) the host path, the CLI asked for it (``--platform=host``: its
     ``main`` in the leg, ``scale_run encode --cli``), gives the reference
     archive;
     (b) the CLI's default, the device path on the card beside the host
     stealers (``--output=F IN``, no other flag), on the half corpus and
     on the whole one: the whole archive equals (a)'s and puts at least
     one block on the card, the
     half's is (a)'s first streams with their metadata, byte for byte
     (``scale_run.is_prefix_archive``: the host path's archive of the
     half corpus), no batch abandoned and the
     device never benched (0 demotions in each run; its blocks on the
     device are printed), the MTF launches by width equal to the device
     batches by class;
     (c) ``cat half | python -m starch3_tpu_torch.cli`` on the half
     corpus writes (b)'s half archive (so the host path's); (d)
     device only under ``STARCH3_TPU_NO_HOST_FALLBACK=1``,
     each chromosome transformed whole and fed in order to
     ``encode_streams_iter(host_assist=False)``: every stream equals
     (a)'s, every block on the device and of the corpus's tier, nothing
     abandoned or benched, the MTF launches by width equal to the device
     batches by class, and the card's busy share over a traced window of
     at least 50 batches (``device_trace``), and the timed run's share
     derived from it; a differing stream's text, record and first
     differing block's MTF case go to ``build/``; (e)
     ``decompress_starch_file`` of (b)'s archive gives back the corpus;
     (f) from the half run to the whole one, the encode's own memory, its
     peak RSS (sampled every 20 ms: a child keeps ``ru_maxrss`` from this
     process) above the RSS its leg had before the encode, grows by at
     most 15% and ``max_memory_reserved`` by at most 10%.  The encode's
     memory climbs until its first streams are out, about 4-5 s in, then
     stays level; both corpora run past that point (the quarter corpus
     does not), so growth between them is a leak, not the climb; (h)
     BASELINE config 5, cut to the half corpus and one card: ``scale_run
     multihost``, two host processes of ``python -m
     starch3_tpu_torch.cli --num-hosts=2`` (through ``scale_run
     host``, which prints each host's counters) on the card, once over a
     gloo process group and once through a manifest directory: host 0's
     archive equals (b)'s half archive (so the host path's of the half
     corpus, metadata and all) and host 1 writes nothing, both exit 0 within
     their limit, and each host abandons no batch, puts blocks on the
     card and launches its MTF kernel once per device batch at its
     class's width; the wall time and MB/s of both, and each host's
     device blocks, demotions and class skips, own peak RSS a GB of BED,
     ``max_memory_reserved`` and stage seconds are printed.  Each leg
     prints its start, CUDA initialisation and work seconds, times,
     digests, memory peaks and series, and counters.  The legs are
     forked from one server that imported torch once
     (``starch3_tpu_torch.leg_fork``), each in a session of its own with
     its own CUDA context; the pipe's and (h)'s processes start anew, as
     a user's commands do.
  14. the BED6 tiers at scale, the same phase over the tiers of
     ``SCALE_RUNS`` with their corpora written together:
     ``corpus.config3_scale_bed`` (bits 5) cut to its first chromosome
     (8.8e7 bytes of BED), ``bits6_scale_bed`` (bits 6) at 2.75e8 and
     ``wide8_scale_bed`` (bits 8) at 2.75e8.  Each runs (a), (b), (d) (not
     on config3: cut for the run's time, ``ScaleTier.device_only``) and
     (e), with the gates of phase 13 (``scale_faults``), but no pipe leg
     and no half corpus; config3's (b) must put bits-5 blocks on the card
     whose rows come back untied from K1 w32; a demotion of the hybrid
     fails a tier only where (d) ran and its MB/s
     of text is at least (a)'s.  Each tier prints its MB/s of BED and of text,
     device blocks of all blocks, blocks, batches, tie re-encodes, graph
     captures and replays and class skips per class, the busy share and
     the memory peaks, beside the card's name and power limit.
  15. the other modes at scale, in the same phase (``ScaleTier.modes``
     and ``decode``), on the corpus and the host archive (a) of their
     tier, each leg with a deadline of its own: on the bits-4 corpus
     ``device_huffman`` (``fast_huff``: (b) the hybrid on the half corpus
     and the whole, with the memory bounds of (f), and (d) device only)
     and the exact modes ``ranks`` and ``rle2`` ((d) on the first 11 of its
     22 chromosomes; their hybrids are cut for the run's time, PERF.md
     §4) and (g) ``decompress_starch_bytes(use_jax=True)`` of (a)'s first
     stream (20 blocks, the fewest of any tier's first stream: a cut for
     the run's time, PERF.md §4), which must give back the corpus's first
     chromosome with every block decoded on the card; on the bits-8
     corpus ``fast_huff`` (d).
     Each hybrid first warms the card with a few blocks
     (``scale_run --warm-up``); each (d) runs untraced under
     ``STARCH3_TPU_NO_HOST_FALLBACK=1`` and must give (a)'s streams, with
     the MTF launches by width equal to the batches by class at the
     mode's widths and, in the exact modes, no tie re-encode; where the
     mode runs a hybrid, the host cores then encode the same texts
     (``scale_run device --host-rate``).  Every archive equals (a)'s, no
     leg abandons a batch, and a hybrid may bench the card only where
     that mode's (d) is slower than those host cores ((a) is bounded by
     its feed's one thread, PERF.md §6).  Each
     mode prints its MB/s, device blocks, batches and re-encodes per
     class, bytes read back a block and memory peaks; the decode its MB/s
     beside (e)'s native decode, the host's ms a block of its walk,
     ``rle1_decode`` and CRCs, and its peak RSS a GB of BED.
  16. BASELINE config 4 at its own shape, in the same phase (a tier of
     ``SCALE_RUNS`` as phase 14's are): ``corpus.config4_scale_bed``,
     variant BED whose indels were left-normalised with no re-sort after,
     so the starts go back and the transform writes negative deltas, cut
     to whole chromosomes to 1.2e9 bytes (chr1-chr9, the fewest whose (d)
     traces 50 batches), with (a), (b), (d) and (e) and phase 14's gates;
     (d) must count starts going back in every chromosome (the native
     transform's unsorted branch), and (e) gives the corpus back.  The
     transform's seconds a GB of (a) and (d) are printed beside bed3's.
  17. BASELINE config 3 at a public shape, in the same phase (a tier of
     ``SCALE_RUNS``): ``corpus.reads_scale_bed``, 20M single-end ChIP-seq
     reads as ``bedtools bamtobed`` writes them (Illumina read names,
     MAPQ, strand), cut to chr1-chr3 (3.0e8 bytes, the fewest whose (d)
     traces 50 batches), with (a), (b), (d) and (e) and phase 14's gates.
     Every block is bits 5 and ties in the fast sort (the names share a
     22-byte prefix), so (d) re-encodes each on the driver's thread; its
     tie re-encodes per class and their seconds by thread are printed.
     (d) is its traced run alone (``ScaleTier.timed``): the re-encodes
     bound it, and on an H100 a timed run after it took 21 s more at the
     traced run's rate (10.130 against 10.099 MB/s of text).
     Before the scale phases, BASELINE config 1 (``phase_config1``):
     ``corpus.chr21_bed()``, one block, encoded by the CLI with no flag
     (the device path on the card) in a process started anew and by the
     CLI's ``--platform=host``, byte for byte, and
     device only in a forked leg, its key's warm-up, capture and a replay,
     each equal to ``bz2.compress(text, 9)``, with each one's start, CUDA
     initialisation and encode seconds.

The port imports nothing of JAX and nothing of the JAX package
``starch3_tpu``; the run fails if either is loaded.  The line before the
card's name is one JSON object describing each kernel of the path (the
narrow wrapper's two kernels apart, each with the launches it counted);
the wide kernel's entry counts its launches by width too, phases 10,
12, 14 and 15 included (and the narrow kernel's, phases 16 and 17); the last line
is ``{"ok": true, "device": {...}}``.  Without
a card, or without the rest of the repository, it fails before printing
any result.
"""

from __future__ import annotations

import argparse
import bz2
import collections
import concurrent.futures
import hashlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import typing

import numpy as np
import torch

from starch3_tpu_torch import api, cli, corpus, leg_fork, runtime, scale_run
from starch3_tpu_torch._build import BUILD_DIR, build
from starch3_tpu_torch.bed.parser import parse_bed
from starch3_tpu_torch.codec.crc32 import crc32_bytes
from starch3_tpu_torch.codec.rle1 import rle1_decode
from starch3_tpu_torch.observability import StageTimer, device_trace
from starch3_tpu_torch.ops import mtf_narrow, mtf_wide, transform
from starch3_tpu_torch.ops.bwt_fast import bwt_fast_host
from starch3_tpu_torch.parallel import host, pipeline
from starch3_tpu_torch.profile_kernels import (
    bound_ms,
    cuda_median_ms,
    device_us_by_kernel,
    real_batch,
    real_mtf_input,
)
from starch3_tpu_torch.scale_run import hybrid_faults, is_prefix_archive, memory_growth

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


def launched_rows(device, inputs, bits: int, n_max: int, graphed: bool) -> torch.Tensor:
    """One batch through the launcher as a fast-mode dispatch launches it
    (``pipeline._launch``): eagerly, or through the step's CUDA graph;
    its rows once they have landed."""
    def step(*args):
        return pipeline.step_for_class(*args, bits, n_max), ()

    launched = pipeline._launch(device, inputs, step, (bits, n_max) if graphed else None)
    launched.synchronize()
    return launched.future.result()[0].clone()


def launch_counts() -> tuple:
    return dict(mtf_narrow.width_launches), dict(mtf_wide.width_launches)


def count_delta(before: tuple, after: tuple) -> dict:
    return {f"{name}{w}": a[w] - b[w] for name, b, a in zip(("narrow", "wide"), before, after) for w in a
            if a[w] - b[w]}


def traced_mtf_launches(fn) -> dict:
    """The MTF kernels that one call of ``fn`` ran on the card, by width,
    as ``torch.profiler`` traces them (a graph's replay too): one
    ``mtf16_kernel`` per width-16 launch, one ``carry_scan_kernel<W>`` per
    launch of the windowed kernel at width W."""
    import re

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    widths = collections.Counter()
    for evt in prof.key_averages():
        if getattr(evt, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        m = re.search(r"mtf16_kernel|carry_scan_kernel<(\d+)>", evt.key)
        if m:
            widths[int(m.group(1) or 16)] += evt.count
    return dict(widths)


def phase_step(device, texts, bits: int, n_max: int):
    """Phase 4: one tier's device step on ``device`` vs the CPU, real
    blocks: called directly, and through the launcher eagerly and as the
    fast step's graph (warm-up, capture and replay, replay).  A tied
    bits-8 row compares its ptr and ties columns only: the order of tied
    rotations is not defined there."""
    packed, lens, nsyms = real_batch(texts, bits, n_max)
    want = pipeline.step_for_class(packed, lens, nsyms, bits, n_max)
    got = {"direct": pipeline.step_for_class(
        packed.to(device), lens.to(device), nsyms.to(device), bits, n_max
    ).cpu()}
    stats = dict(pipeline.device_stats)
    c0 = launch_counts()
    got["eager"] = launched_rows(device, (packed, lens, nsyms), bits, n_max, graphed=False)
    c1 = launch_counts()
    for k in range(3):
        got[f"graphed {k}"] = launched_rows(device, (packed, lens, nsyms), bits, n_max, graphed=True)
    c2 = launch_counts()
    stats = stats_since(pipeline.device_stats, stats)
    eager, graphed = count_delta(c0, c1), count_delta(c1, c2)
    if stats["graph_replays"] < 2 or graphed != {k: 3 * n for k, n in eager.items()}:
        raise AssertionError(f"bits {bits} step: {stats['graph_replays']} replays in 3 graphed launches, "
                             f"launches {graphed} against 3 x eager {eager}")
    # one more replay under the profiler: the kernels the card ran are the
    # ones the capture recorded, which the counters add for each replay
    c3, traced_rows = launch_counts(), []
    traced = traced_mtf_launches(
        lambda: traced_rows.append(launched_rows(device, (packed, lens, nsyms), bits, n_max, graphed=True)))
    got["graphed traced"] = traced_rows[0]
    counted = {int("".join(filter(str.isdigit, k))): n for k, n in count_delta(c3, launch_counts()).items()}
    if not traced or traced != counted:
        raise AssertionError(f"bits {bits} step: a traced replay ran MTF kernels {traced} by width, "
                             f"its count says {counted}")
    tie_col = 2 if bits == 8 else 1
    for how, rows in got.items():
        for i in range(rows.shape[0]):
            cols = slice(None) if want[i, tie_col] == 0 or bits != 8 else [0, 2]
            check_equal(f"bits {bits} step row {i} (3, {n_max}) {how}", rows[i, cols], want[i, cols])
    log(f"bits {bits} step: {device} rows equal CPU rows at n_max {n_max}, called directly, launched eagerly and "
        f"as the graph ({stats['graph_captures']} captured, {stats['graph_replays']} replays); launches of one "
        f"eager batch {eager}, of the 3 graphed {graphed}; MTF kernels in a traced replay by width {traced}, "
        f"as counted; lens {lens.tolist()}, ptrs {got['direct'][:, 0].tolist()}, "
        f"ties {got['direct'][:, tie_col].tolist()}")


def zero_counts() -> None:
    """Set every kernel's launch counts and ``device_stats`` to 0."""
    mtf_narrow.launches = mtf_wide.launches = 0
    for counts in (mtf_narrow.width_launches, mtf_wide.width_launches, pipeline.device_stats):
        for k in counts:
            counts[k] = 0


def counted_encode(device, label: str, texts, want, device_huffman: bool = False, fast_bwt: bool = True,
                   device_rle2: bool = False, mesh=None):
    """One device-only encode of ``texts`` in the mode of the flags (on
    ``mesh`` when one is given), with every launch counter and
    ``device_stats`` set to 0 just before it and read just after.  Every
    stream must equal ``want``, every block must have run on the device,
    and no batch may have been abandoned or the device benched.  Returns
    the run: seconds, launches (narrow and wide, in all and by width),
    ``device_stats``, blocks."""
    zero_counts()
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
        f"{stats['batches']} batches, 0 abandons and demotions, graph captures {stats['graph_captures']} "
        f"(keys now {sum(map(len, pipeline._STEP_GRAPHS.values()))}) and replays {stats['graph_replays']}, "
        f"launches narrow {narrow} (by width {by_width}) wide {wide}, "
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


def log_default(entry: str, platform: str, on_card: int, blocks: int, mb_s: float, host_mb_s: float,
                smi: str) -> None:
    """One line per entry point run with its defaults: where it ran, its
    blocks on the card of all its blocks, and its MB/s beside the host
    path's (``use_jax=False``, ``--platform=host``) in the same run."""
    log(f"default entry {entry}: platform {platform}, {on_card} of {blocks} blocks on the card, "
        f"{mb_s:.3f} MB/s of BED; host path {host_mb_s:.3f} MB/s; on {smi}")


def phase_entry_points(label: str, bed: bytes, smi: str, device_huffman: bool = False, timeout_s: float = 120.0):
    """Phases 6 and 7: the archive API and the CLI with their defaults,
    the device path on the card (phase 7 adds ``device_huffman``), against
    the host path asked for (``EncodeConfig(use_jax=False)``); and the
    default decode (the device decode) against the host decode
    (``use_jax=False``)."""
    cfg = api.EncodeConfig(device_huffman=True) if device_huffman else None
    sched, dev_stats, counts = dict(host.scheduler_stats), dict(pipeline.device_stats), launch_counts()
    t0 = time.perf_counter()
    got = api.compress_bed_bytes(bed, cfg)
    dt = time.perf_counter() - t0
    sched = stats_since(host.scheduler_stats, sched)
    dev_stats = stats_since(pipeline.device_stats, dev_stats)
    counts = count_delta(counts, launch_counts())
    if sched["abandoned_batches"]:
        raise AssertionError(f"{label} compress_bed_bytes: a device batch was abandoned: {sched}")
    n_blocks = count_blocks(texts_of(bed))
    t1 = time.perf_counter()
    want = api.compress_bed_bytes(bed, api.EncodeConfig(use_jax=False))
    dt_host = time.perf_counter() - t1
    if got != want:
        raise AssertionError(f"{label} compress_bed_bytes: device archive != host archive")
    call = f"compress_bed_bytes(bed{', EncodeConfig(device_huffman=True)' if device_huffman else ''})"
    log(f"{label} {call}: archive == host path's (use_jax=False); "
        f"{len(bed) / dt / 1e6:.3f} MB/s of BED ({dt:.3f} s); host path "
        f"{len(bed) / dt_host / 1e6:.3f} MB/s ({dt_host:.3f} s)")
    log(f"{label} compress_bed_bytes scheduler: demotions {sched['demotions']}, repromotions "
        f"{sched['repromotions']}, class_skips {sched['class_skips']}, abandoned 0; of {n_blocks} blocks "
        f"{dev_stats['blocks']} went to the device in {dev_stats['batches']} batches "
        f"({dev_stats['tie_reencodes']} re-encoded for ties) and {n_blocks - dev_stats['blocks']} to the "
        f"stealers; graph captures {dev_stats['graph_captures']}, replays {dev_stats['graph_replays']}, "
        f"launches by width {counts}; per-class device rates now {host._class_rate_cache}")
    if not dev_stats["blocks"]:
        raise AssertionError(f"{label} {call}: no block went to the card")
    host_mb_s = len(bed) / dt_host / 1e6
    log_default(f"{label} {call}", "cuda", dev_stats["blocks"], n_blocks, len(bed) / dt / 1e6, host_mb_s, smi)
    # the default decode is the device decode; use_jax=False the native one
    decoded = dict(pipeline.device_stats)
    t0 = time.perf_counter()
    dec = api.decompress_starch_bytes(got)
    dt = time.perf_counter() - t0
    decoded = stats_since(pipeline.device_stats, decoded)
    t1 = time.perf_counter()
    dec_host = api.decompress_starch_bytes(got, use_jax=False)
    dt_host_dec = time.perf_counter() - t1
    if not dec == dec_host == bed:
        raise AssertionError(f"{label} decompress_starch_bytes: the default (device) decode == BED {dec == bed}, "
                             f"use_jax=False == BED {dec_host == bed}")
    if decoded["decode_blocks"] != n_blocks:
        raise AssertionError(f"{label} decompress_starch_bytes(archive): {decoded['decode_blocks']} of {n_blocks} "
                             "blocks decoded on the card")
    log_default(f"{label} decompress_starch_bytes(archive)", "cuda", decoded["decode_blocks"], n_blocks,
                len(bed) / dt / 1e6, len(bed) / dt_host_dec / 1e6, smi)
    # the CLI with no flag but the output, in a process started anew: the
    # CLI's main with that argv (scale_run host), with the counters it left
    with tempfile.TemporaryDirectory() as d:
        src, out = os.path.join(d, "in.bed"), os.path.join(d, "out.starch")
        with open(src, "wb") as f:
            f.write(bed)
        argv = [*scale_run.cli_flags("cuda", "fast_huff" if device_huffman else "fast"), "-o", out, src]
        t0 = time.perf_counter()
        try:
            run = leg_fork.spawn(["host", "--", *argv], timeout_s)
        except leg_fork.LegTimeout as e:
            raise AssertionError(f"{label} CLI: {e}") from None
        dt = time.perf_counter() - t0
        lines = run.stdout.decode().splitlines()
        if run.returncode != 0:
            raise AssertionError(f"{label} CLI exit {run.returncode}: {lines[-1:]} {run.stderr.decode()[-2000:]}")
        res = json.loads(lines[-1])
        with open(out, "rb") as f:
            if f.read() != want:
                raise AssertionError(f"{label} CLI archive != host archive")
        cli_blocks = scale_run.archive_blocks(out)
    st = res["device_stats"]  # a process's cold card may leave every block to the stealers (ROADMAP E1)
    if res["scheduler_stats"]["abandoned_batches"]:
        raise AssertionError(f"{label} CLI: abandoned batches: {res['scheduler_stats']}")
    shown = " ".join(argv[:-3] + ["-o", "F", "IN"])
    log(f"{label} cli {shown}: same archive bytes ({dt:.3f} s with process start, the CLI's work "
        f"{res['seconds']:.3f} s); launches by width {res['width_launches']}")
    log_default(f"{label} cli {shown}", res["device"], st["blocks"], cli_blocks, res["mb_per_s_bed"], host_mb_s, smi)


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
    # the stall is over once the launcher has enqueued the batches it held
    # up (in a fresh process each first launch loads its kernel's module,
    # which waits for the card) and the card has run them
    pipeline._launcher().submit(torch.cuda.synchronize).result()
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
    encode abandons to the driver and ends, and no dispatch of it waits
    on the stream (the longest stays below ``abandon_s``); (c) with
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
        sched, dev, host_s = fault_case(device, "(b) device only", texts, want, stall_s, False, smi)
        expect(f"(b) longest dispatch {host_s} s", sched["abandoned_batches"] >= 1 and host_s < abandon_s, sched, dev)
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


def phase_exact_fault_cold(seed: int, timeout_s: float = 300.0) -> None:
    """Phase 10 (e) again in a fresh child process: a cold CUDA context
    and a cold caching host allocator, the case that once made an
    exact-mode dispatch wait out the whole stall (ROADMAP C2).  The child
    runs ``phase_exact_fault`` on config 2's texts and is killed if it is
    still running when the phase ends."""
    code = ("import torch, chip_smoke\n"
            "from starch3_tpu_torch import corpus\n"
            f"texts = chip_smoke.texts_of(corpus.config2_bed({seed}))\n"
            "chip_smoke.phase_exact_fault(torch.device('cuda'), texts, chip_smoke.card_name())\n")
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        out, err = proc.communicate(timeout=timeout_s)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if proc.returncode != 0:
        raise AssertionError(f"faults (e) in a fresh process: exit {proc.returncode}: {err.decode()[-3000:]}")
    for line in out.decode().splitlines():
        log(f"fresh process: {line}")


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
    archive = api.compress_bed_bytes(bed, api.EncodeConfig(use_jax=False))
    t0 = time.perf_counter()
    got = api.decompress_starch_bytes(archive, use_jax=True, device=device.type)
    dt = time.perf_counter() - t0
    t0 = time.perf_counter()
    native = api.decompress_starch_bytes(archive, use_jax=False)
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
    want = api.compress_bed_bytes(bed, api.EncodeConfig(use_jax=False))
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
    narrow, wide = {16: 0, 32: 0, 64: 0}, {128: 0, 256: 0}
    for c in pipeline.CLASSES:
        w = scale_run.mode_width(mode, c)
        (narrow if w <= 64 else wide)[w] += n * stats[f"batches_bits{c}"]
    return narrow, wide


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
        archive = api.compress_bed_bytes(beds[label], api.EncodeConfig(use_jax=False))
        t1 = time.perf_counter()
        arc = api.decompress_starch_bytes(archive, use_jax=True, mesh=mesh)
        dt_arc = time.perf_counter() - t1
        if not arc == api.decompress_starch_bytes(archive, use_jax=False) == beds[label]:
            raise AssertionError(f"{label} decompress_starch_bytes(use_jax=True, mesh=...) != host decode or BED")
        log(f"{label} decode under mesh cuda:0 twice: decode_streams == texts, {stats}, "
            f"{sum(map(len, texts)) / dt / 1e6:.3f} MB/s of text ({dt:.3f} s); decompress_starch_bytes == host "
            f"decode == BED, {len(beds[label]) / dt_arc / 1e6:.3f} MB/s of BED ({dt_arc:.3f} s); on {smi}")


def phase_two_processes(device, bed: bytes, smi: str, timeout_s: float = 300.0) -> None:
    """Phase 11 (d): two processes on the one card, ``python -m
    starch3_tpu_torch.cli --platform=cuda --num-hosts=2 --host-id=i``, once
    over a gloo process group (``--coordinator``) and once through a
    manifest directory.  Host 0's archive equals the single-process host
    archive and host 1 writes nothing.  Both children are killed if either
    is still running when the case ends."""
    import socket

    want = api.compress_bed_bytes(bed, api.EncodeConfig(use_jax=False))
    with tempfile.TemporaryDirectory() as d:
        src = os.path.join(d, "in.bed")
        with open(src, "wb") as f:
            f.write(bed)
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        for transport, how in (("gloo", f"--coordinator=127.0.0.1:{port}"),
                               ("manifest", f"--manifest-dir={os.path.join(d, 'manifest')}")):
            cmds = [[sys.executable, "-m", "starch3_tpu_torch.cli", f"--platform={device.type}",
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
            log(f"config2 two processes on one card ({transport}, --num-hosts=2): host 0 archive == "
                f"single-process host archive, host 1 wrote nothing; {dt:.3f} s wall for both, process "
                f"starts included ({len(bed) / dt / 1e6:.3f} MB/s of BED); on {smi}")


def config1_faults(legs: dict, device: str = "cuda") -> list[str]:
    """Phase 16's gates on BASELINE config 1's legs: (i) the archive of
    the CLI's default encode (no flag: the device path on the card), a
    process started anew, equals the host path's from the same CLI
    (``--platform=host``), decodes back to the corpus, and its encode
    abandoned no batch and launched its MTF kernel once per device batch;
    (ii) in every device-only run of the block (at least its warm-up, its
    capture and a replay) the stream equals ``bz2.compress(text, 9)`` and
    the one block ran on the card in one batch of bits 4, with one launch
    of K1 at width 16 (none on the CPU, where the wrapper runs its plain
    version)."""
    cli, one = legs["cli"], legs["oneblock"]
    faults = []
    if cli["archive_digest"] != legs["host"]["archive_digest"]:
        faults.append(f"(i) the CLI's default archive {cli['archive_digest']} != the host path's "
                      f"{legs['host']['archive_digest']}")
    if (legs["decode"]["digest"], legs["decode"]["bytes"]) != (legs["corpus"]["digest"], legs["corpus"]["bytes"]):
        faults.append(f"(i) the archive decodes to {legs['decode']['digest']} of {legs['decode']['bytes']} bytes, "
                      f"not the corpus's {legs['corpus']['digest']} of {legs['corpus']['bytes']}")
    if cli["scheduler_stats"]["abandoned_batches"]:
        faults.append(f"(i) abandoned batches: {cli['scheduler_stats']}")
    faults += [f"(i) {f}" for f in scale_run.launch_faults(cli, device)]
    if len(one["runs"]) < 3:
        faults.append(f"(ii) {len(one['runs'])} device-only runs, not the warm-up, the capture and a replay")
    for k, run in enumerate(one["runs"]):
        st = run["device_stats"]
        if not run["equal"]:
            faults.append(f"(ii) run {k}: the stream != bz2.compress(text, 9)")
        got = (run["blocks"], st.get("blocks_bits4", 0), st.get("batches", 0), run["width_launches"]["16"])
        if got != (1, 1, 1, int(device.startswith("cuda"))):
            faults.append(f"(ii) run {k}: blocks, blocks on the card at bits 4, batches and K1 w16 launches {got}, "
                          f"not one each on {device}")
    return [f"config1 {f}" for f in faults]


def phase_config1(smi: str, forker, device: str = "cuda", timeout_s: float = 120.0) -> int:
    """Phase 16, BASELINE config 1: ``corpus.chr21_bed()`` (one chromosome
    of 100,000 intervals, one block at level 9) encoded as a user's one
    command.  The host path is the CLI's ``main`` with ``--platform=host``,
    in this process; (i) ``python -m starch3_tpu_torch.cli --output=F
    chr21.bed``, the CLI's default, in a process started anew, as
    ``scale_run host`` runs the CLI's ``main`` with that argv, timed by
    stage (its start, imports, CUDA's initialisation, the file entry and
    its feed's transform), and ``decompress_starch_file`` of its archive;
    (ii) ``scale_run oneblock`` forked under
    ``STARCH3_TPU_NO_HOST_FALLBACK=1``: the block device only, three times
    in one process (its key's warm-up, its graph capture, a replay), each
    timed.  Gates: ``config1_faults``.  Returns K1's width-16 launches of
    both.  ``device="cpu"`` runs it on the CPU, as the tests do."""
    bed = corpus.chr21_bed()
    legs = {"corpus": {"digest": hashlib.sha256(bed).hexdigest(), "bytes": len(bed)}}
    with tempfile.TemporaryDirectory(prefix="s3t-config1-") as d:
        src, host_out, jax_out = (os.path.join(d, n) for n in ("chr21.bed", "host.starch", "jax.starch"))
        with open(src, "wb") as f:
            f.write(bed)
        t0 = time.perf_counter()
        rc = cli.main(["--platform=host", f"--output={host_out}", src])
        legs["host"] = {"exit": rc, "seconds": time.perf_counter() - t0, "archive_digest": scale_run.file_digest(
            host_out)}
        if rc:
            raise AssertionError(f"config1: the host path's CLI exited {rc}")
        try:
            run = leg_fork.spawn(["host", "--", *scale_run.cli_flags(device), f"--output={jax_out}", src],
                                 timeout_s)
        except leg_fork.LegTimeout as e:
            raise AssertionError(f"config1 (i): {e}") from None
        lines = run.stdout.decode().splitlines()
        if run.returncode != 0:
            raise AssertionError(f"config1 (i): exit {run.returncode}: {lines[-1:]} {run.stderr.decode()[-3000:]}")
        legs["cli"] = one_cli = json.loads(lines[-1])
        one_cli.pop("memory_series", None)
        one_cli.update(times=leg_fork.leg_times(one_cli, run.launched_at),
                       archive_digest=scale_run.file_digest(jax_out), archive_blocks=scale_run.archive_blocks(jax_out))
        sink = scale_run._Hasher()
        api.decompress_starch_file(jax_out, sink)
        legs["decode"] = {"digest": sink.h.hexdigest(), "bytes": sink.n}
        legs["oneblock"] = scale_child("config1 (ii) device only, one block", ["oneblock", src, "--device", device],
                                       time.monotonic() + timeout_s, timeout_s, forker,
                                       {"STARCH3_TPU_NO_HOST_FALLBACK": "1"})
    faults = config1_faults(legs, device)
    c, one = legs["cli"], legs["oneblock"]
    t, st = c["times"], c["device_stats"]
    log(f"config1 (i) python -m starch3_tpu_torch.cli {' '.join(scale_run.cli_flags(device) + ['chr21.bed'])}, "
        f"{len(bed)} bytes of BED, "
        f"{c['archive_blocks']} block ({one['text_bytes']} bytes of text), in a process started anew: start "
        f"{t['start_s']:.3f} s (imports {c['timing']['imports_s']:.3f} s), CUDA init {t['cuda_init_s']:.3f} s, the "
        f"CLI's work {t['work_s']:.3f} s (file entry {c['stage_seconds']['file_entry']:.3f} s, its feed's "
        f"transform {c['stage_seconds']['feed_transform']:.3f} s); blocks on the card {st.get('blocks', 0)} in "
        f"{st.get('batches', 0)} batches, graph captures {st.get('graph_captures', 0)}, MTF launches by width "
        f"{c['width_launches']}; archive == the host path's ({legs['host']['seconds']:.3f} s in this process): "
        f"{c['archive_digest'] == legs['host']['archive_digest']}; decode == the corpus: "
        f"{legs['decode']['digest'] == legs['corpus']['digest']}; on {smi}")
    log_default(f"config1 cli {' '.join(scale_run.cli_flags(device) + ['chr21.bed'])}", device, st.get("blocks", 0),
                c["archive_blocks"], c["mb_per_s_bed"], len(bed) / legs["host"]["seconds"] / 1e6, smi)
    t = one["times"]
    runs = "; ".join(
        f"{label} {r['seconds']:.4f} s (captures {r['device_stats'].get('graph_captures', 0)}, replays "
        f"{r['device_stats'].get('graph_replays', 0)}, == bz2.compress(text, 9): {r['equal']})"
        for label, r in zip(("warm-up", "capture", *["replay"] * (len(one["runs"]) - 2)), one["runs"]))
    log(f"config1 (ii) device only, forked: start {t['start_s']:.3f} s (imports {one['timing']['imports_s']:.3f} s), "
        f"CUDA init {t['cuda_init_s']:.3f} s, the block's encodes: {runs}; K1 w16 launches "
        f"{[r['width_launches']['16'] for r in one['runs']]}; on {smi}")
    if faults:
        raise AssertionError("; ".join(faults))
    return c["width_launches"]["16"] + sum(r["width_launches"]["16"] for r in one["runs"])


def host_median_ms(fn, reps: int) -> float:
    """Median host-clock time of ``fn`` on the CPU, after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_transform_ops(device, bed: bytes, smi: str, reps: int = 10) -> None:
    """Phase 12 (a): the delta transform's device ops (``ops/transform.py``)
    on every chromosome of ``bed``, whose starts and stops come from the
    port's BED parser, as ``int32`` and as ``int64``: each op's result on
    the card equals its result on the CPU, value for value and dtype for
    dtype, and ``untransform_core`` of the deltas and differences gives
    back the starts and stops.  Prints each op's CUDA-event median over the
    whole corpus beside its CPU time."""
    chroms = parse_bed(bed)
    n = sum(c.n_records for c in chroms)
    for dtype in (torch.int32, torch.int64):
        cols = [(torch.from_numpy(c.starts).to(dtype), torch.from_numpy(c.stops).to(dtype)) for c in chroms]
        cores = [transform.transform_core(st, sp) for st, sp in cols]
        args = {  # op -> its arguments on each chromosome
            "transform_core": cols,
            "untransform_core": [(core[2], core[1]) for core in cores],
            "union_length_device": cols,
            "dec_len_device": [(core[2],) for core in cores],
        }
        times = []
        for name, cpu_args in args.items():
            op = getattr(transform, name)
            dev_args = [tuple(x.to(device) for x in a) for a in cpu_args]
            for (st, sp), a, a_d in zip(cols, cpu_args, dev_args):
                got, want = op(*a_d), op(*a)
                for g, w in zip(got if isinstance(got, tuple) else (got,), want if isinstance(want, tuple) else (want,)):
                    if g.dtype != w.dtype or g.shape != w.shape or not torch.equal(g.cpu(), w):
                        raise AssertionError(f"transform {name} {dtype}: card != CPU ({g.dtype}, {w.dtype})")
                if name == "untransform_core":
                    if not (torch.equal(got[0].cpu(), st) and torch.equal(got[1].cpu(), sp)):
                        raise AssertionError(f"transform {dtype}: untransform_core(transform_core) != starts, stops")
            ms = cuda_median_ms(lambda: [op(*a) for a in dev_args], reps)
            cpu_ms = host_median_ms(lambda: [op(*a) for a in cpu_args], 3)
            times.append(f"{name} {ms:.4f} ms (CPU {cpu_ms:.3f} ms)")
        log(f"transform ops {str(dtype).split('.')[1]}, {len(chroms)} chromosomes, {n} intervals: card == CPU, "
            f"dtypes equal, round trip exact; CUDA-event median over the corpus: {'; '.join(times)}; on {smi}")


def phase_device_trace(device, texts, smi: str) -> int:
    """Phase 12 (b): ``device_trace`` around one device-only fast-mode
    encode of ``texts`` in a ``StageTimer`` stage, its trace in
    ``build/trace-<pid>/``.  The one trace file must name the stage and
    ``mtf16_kernel``.  Returns the width-16 launches of the encode."""
    want = [bz2.compress(t, 9) for t in texts]
    log_dir = os.path.join(BUILD_DIR, f"trace-{os.getpid()}")
    timer = StageTimer()
    stage = "encode_streams (device only)"
    with device_trace(log_dir, device), timer.stage(stage, sum(map(len, texts))):
        run = counted_encode(device, "config2 traced", texts, want)
    files = [os.path.join(log_dir, f) for f in os.listdir(log_dir)]
    if len(files) != 1:
        raise AssertionError(f"device_trace wrote {len(files)} files in {log_dir}")
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    kernels = [e for e in events if e.get("cat") == "kernel"]
    if stage not in names or not any("mtf16_kernel" in e["name"] for e in kernels):
        raise AssertionError(f"the trace names the stage {stage in names}, mtf16_kernel "
                             f"{any('mtf16_kernel' in e['name'] for e in kernels)}")
    if run["narrow_by_width"][16] != run["stats"]["batches_bits4"] or run["narrow_by_width"][16] == 0:
        raise AssertionError(f"traced encode: width-16 launches {run['narrow_by_width']}, stats {run['stats']}")
    log(f"device_trace of config 2 device only ({run['seconds']:.3f} s, {run['stats']['batches']} batches): "
        f"{files[0]} {os.path.getsize(files[0])} bytes, {len(events)} events, {len(kernels)} GPU kernel events, "
        f"{sum('mtf16_kernel' in e['name'] for e in kernels)} of mtf16_kernel; names the stage; "
        f"stage report {timer.report()}; on {smi}")
    return run["narrow_by_width"][16]


def phase_host_helpers(device, texts2, texts8, smi: str) -> dict:
    """Phase 12 (c): the ops' host helpers on one real block each, on the
    card, equal to the CPU: ``bwt_fast_host`` on a config-2 block and a
    wide8 block, ``mtf_ranks_narrow_host`` on the config-2 block's BWT
    (dense symbols below 16), ``mtf_ranks_wide_host`` on the wide8 block's
    BWT bytes.  Each helper's kernel launches once on the card, counted
    from 0.  Returns the launches, narrow and wide."""
    zero_counts()
    out = {}
    for label, texts in (("config2", texts2), ("wide8", texts8)):
        block = np.frombuffer(host._split_classify(texts[0], 9)[0][0].data, dtype=np.uint8)
        got, want = bwt_fast_host(block, device), bwt_fast_host(block, "cpu")
        if got[1:] != want[1:] or not np.array_equal(got[0], want[0]):
            raise AssertionError(f"bwt_fast_host {label}: card != CPU")
        out[label] = (block, got[0])
    block2, last2 = out["config2"]
    seq = (np.cumsum(np.bincount(last2, minlength=256) > 0) - 1)[last2].astype(np.int32)
    if seq.max() >= 16:
        raise AssertionError("the config-2 block has more than 16 symbols")
    _, last8 = out["wide8"]
    cases = (("mtf_ranks_narrow_host", mtf_narrow.mtf_ranks_narrow_host, seq),
             ("mtf_ranks_wide_host", mtf_wide.mtf_ranks_wide_host, last8.astype(np.int32)))
    for name, fn, x in cases:
        got, want = fn(x, device), fn(x, "cpu")
        if got.dtype != want.dtype or not np.array_equal(got, want):
            raise AssertionError(f"{name}: card != CPU")
    launches = {"narrow": mtf_narrow.width_launches[16], "wide": mtf_wide.width_launches[256]}
    if launches != {"narrow": 1, "wide": 1} or mtf_narrow.launches != 1 or mtf_wide.launches != 1:
        raise AssertionError(f"host helpers: launches {launches}, narrow {mtf_narrow.launches}, "
                             f"wide {mtf_wide.launches}")
    log(f"host helpers on one real block each (config2 {block2.size} bytes, wide8 {out['wide8'][0].size} "
        f"bytes): bwt_fast_host, mtf_ranks_narrow_host, mtf_ranks_wide_host card == CPU; launches {launches}; "
        f"on {smi}")
    return launches


class ModeRun(typing.NamedTuple):
    """Phase 15: one encode mode of ``scale_run.MODES`` on a tier's corpus."""
    mode: str
    hybrid: tuple[str, ...]  # the corpora of its hybrid (b) legs: "half", "whole"
    streams: int = 0  # its (d) encodes the corpus's first ``streams`` chromosomes; 0: every one


class ScaleTier(typing.NamedTuple):
    target: int  # BED bytes of its corpus
    half: int | None  # BED bytes of its half corpus, a prefix of it, or None
    pipe: bool  # whether it runs (c), ``cat | cli``, on its half corpus
    keep_card: bool  # whether the fast-mode hybrid must never bench the card, whatever (d)'s rate
    modes: tuple[ModeRun, ...] = ()  # phase 15: its other modes, each with (d) device only, untraced
    decode: int = 0  # phase 15 (g): it decodes an archive of (a)'s first ``decode`` streams on the card, 0: none
    # (h) BASELINE config 5: the transports of its two-host encodes of its half corpus on the card
    multihost: tuple[str, ...] = ()
    device_only: bool = True  # whether it runs fast mode's (d); config3's is cut for the run's time (PERF.md §4)
    # config3: (b) must put blocks of its tier on the card whose rows come back
    # untied (the one scale run whose K1 w32 rows are used: every reads block ties)
    untied_on_card: bool = False
    # whether fast mode's (d) times a second, untraced encode after its traced
    # one; reads' (d) is its traced run alone, since the driver's re-encodes
    # bound it and tracing does not slow them (PERF.md §4)
    timed: bool = True


# the tiers at scale by ``corpus.SCALE_SHAPES``' shape: phase 13's bits 4
# (``TestGigabyteScale``'s bytes), phase 14's BED6 tiers, bits 5, 6 and 8,
# BASELINE config 4 (variant BED whose starts go back, bits 4) and config
# 3 as aligned reads (bits 5, every block tied), cut to chip_smoke's time
# (PERF.md §4): bed3's half corpus runs past the point where the encode's
# memory levels off; bits6, wide8 and reads hold 3 chromosomes each and
# config4 9, the fewest whose (d) traces 50 batches; config3 one, whose
# hybrid (b) puts untied bits-5 blocks on the card (its (d) and half are
# cut).  Phase 15 runs the other modes on bits 4 (``fast_huff`` half and
# whole, for its memory gate; the exact modes device only on the first 11
# of its 22 chromosomes, their hybrids cut) and bits 8 (``fast_huff``'s
# ``step_fast2`` with the bits-8 remap), and device decode of bits 4's
# first stream (20 blocks, the fewest of any tier's); (c), the pipe, and
# (h), BASELINE config 5, run on the bits-4 half corpus
SCALE_RUNS = {
    "bed3": ScaleTier(1_100_000_000, 550_000_000, pipe=True, keep_card=True, modes=(
        ModeRun("fast_huff", ("half", "whole")), ModeRun("ranks", (), streams=11),
        ModeRun("rle2", (), streams=11)), decode=1, multihost=("gloo", "manifest")),
    "config3": ScaleTier(80_000_000, None, pipe=False, keep_card=False, device_only=False, untied_on_card=True),
    "bits6": ScaleTier(275_000_000, None, pipe=False, keep_card=False),
    "wide8": ScaleTier(275_000_000, None, pipe=False, keep_card=False, modes=(ModeRun("fast_huff", ()),)),
    "config4": ScaleTier(1_200_000_000, None, pipe=False, keep_card=False),
    "reads": ScaleTier(250_000_000, None, pipe=False, keep_card=False, timed=False),
}
SCALE_ARCHIVE_ROOM = 1_350_000_000  # one tier's archives and texts beside its phase's corpora, with room to spare


def scale_child(label: str, args, deadline: float, limit_s: float, forker, env=None) -> dict:
    """One leg of ``starch3_tpu_torch.scale_run`` in a process and session
    of its own, forked by ``forker`` (``leg_fork.LegForker``, which has
    imported torch once); killed with everything it started when it fails
    or is still running after ``limit_s`` seconds or at ``deadline``.
    Returns its JSON line, with its start, CUDA initialisation and work
    seconds under ``times`` (``leg_fork.leg_times``); a non-zero exit fails
    the phase."""
    timeout_s = min(limit_s, deadline - time.monotonic())
    if timeout_s <= 0:
        raise AssertionError(f"scale {label}: no time left in the phase")
    try:
        run = forker.run(args, timeout_s, env)
    except leg_fork.LegTimeout as e:
        raise AssertionError(f"scale {label}: {e}") from None
    lines = run.stdout.decode().splitlines()
    if run.returncode != 0:
        raise AssertionError(f"scale {label}: exit {run.returncode}: {lines[-1:]} {run.stderr.decode()[-3000:]}")
    res = json.loads(lines[-1])
    res["times"] = t = leg_fork.leg_times(res, run.launched_at)
    log(f"scale {label}: start {t['start_s']:.3f} s, CUDA init {t['cuda_init_s']:.3f} s, work {t['work_s']:.3f} s; "
        f"{json.dumps(res)}")
    return res


def scale_faults(shape: str, legs: dict) -> list[str]:
    """The gates of phases 13 to 15 on one tier's legs: ``gen`` (the
    corpus) and ``a``; in fast mode ``b`` and ``d``, and ``b_half`` and
    ``c`` where the tier runs them; each mode of ``legs["modes"]``, its
    ``d`` and its hybrids; ``g``, the device decode of (a)'s first
    streams; ``h``, BASELINE config 5's two-host encode of each transport
    (``multihost_faults``), on the half corpus, held to (b)'s half
    archive.  Every hybrid's
    archive equals (a)'s, a half archive is (a)'s first streams with their
    metadata (the host path's archive of the half corpus), no
    hybrid abandons a batch, and from a mode's half run to its whole one
    the memory bounds of (f) (``hybrid_faults``); (c)'s archive equals
    (b)'s half archive (the pipe runs on the half corpus, and is so held
    to the host path's archive of it), (e) decodes to
    the corpus, fast mode's (d) holds at least 50
    batches in its traced window; (g) gives back the corpus's first
    chromosomes and decodes every block of their archive on the card; on
    a tier of unsorted input (config 4, ``corpus.SCALE_UNSORTED``) every
    chromosome's starts go back in (d)'s count, so that (e)'s decode
    shows the negative deltas restored; on config3
    (``ScaleTier.untied_on_card``) the hybrid puts blocks of its tier on
    the card whose rows come back untied; where the tier keeps the card
    (``ScaleTier.keep_card``, bits 4) the hybrid, the CLI's default, puts
    at least one block on it.  A hybrid must not bench a
    card that beats the host cores: in fast mode where the tier says so
    (``ScaleTier.keep_card``) or (d) encodes at least (a)'s MB/s of text;
    in another mode where its (d) encodes at least the host cores' MB/s
    on the same texts (``scale_run.host_run``): (a) is bounded by its
    feed's one thread, far below the cores at bits 4 (PERF.md §6).  The
    children gate the rest: each device leg its streams, tier, fallbacks,
    launches by width and (exact modes) ties, each hybrid its launches by
    width, the decode its output and blocks."""
    full, a = legs["gen"], legs["a"]
    faults = []
    if "b" in legs:  # fast mode, phases 13 and 14
        b, dv = legs["b"], legs.get("d")
        host_text = a["text_bytes"] / a["seconds"] / 1e6
        card_text = dv and dv["mb_per_s_text"]
        keep = SCALE_RUNS[shape].keep_card or (dv is not None and card_text >= host_text)
        faults += hybrid_faults("", legs, a, card_text, host_text, keep)
        if "c" in legs and legs["c"]["archive_digest"] != legs["b_half"]["archive_digest"]:
            faults.append(f"(c) archive {legs['c']['archive_digest']} != (b) half's {legs['b_half']['archive_digest']}")
        if b["decode"]["digest"] != full["digest"] or b["decode"]["bytes"] != full["bytes"]:
            faults.append(f"(e) decode {b['decode']} != the corpus {full['digest']} {full['bytes']}")
        batches = (dv.get("traced") or dv)["trace"].get("batches") or 0 if dv else 50
        if batches < 50:
            faults.append(f"(d) the traced window holds {batches} batches, fewer than 50")
        back = (dv or {}).get("starts_back") or {}
        if shape in corpus.SCALE_UNSORTED and not (back.get("of") and back.get("chroms") == back["of"]):
            faults.append(f"(d) the starts go back in {back.get('chroms')} chromosomes of {back.get('of')}, not "
                          "in every one: the transform's unsorted branch is not what the tier runs")
        if SCALE_RUNS[shape].keep_card and not b["device_stats"].get("blocks"):
            faults.append(f"(b) the default CLI put no block on the card, of its {b.get('blocks')}")
        on_card = b["per_class"][str(corpus.SCALE_TIERS[shape])]
        if SCALE_RUNS[shape].untied_on_card and on_card["blocks"] <= on_card["tie_reencodes"]:
            faults.append(f"(b) put no untied bits-{corpus.SCALE_TIERS[shape]} block on the card: "
                          f"{on_card['blocks']} blocks there, {on_card['tie_reencodes']} of them tied")
    for mode, run in legs.get("modes", {}).items():  # phase 15
        if "b" in run or "b_half" in run:
            card_text, host_text = run["d"]["mb_per_s_text"], run["d"]["host"]["mb_per_s_text"]
            faults += hybrid_faults(f"{mode} ", run, a, card_text, host_text, card_text >= host_text)
    for transport, h in legs.get("h", {}).items():  # BASELINE config 5
        faults += multihost_faults(transport, h, legs["b_half"])
    if "g" in legs:  # held to the corpus's first chromosomes, which the leg reads
        g, want = legs["g"], legs["g"]["corpus"]
        if (g["digest"], g["bytes"], g["streams"]) != (want["digest"], want["bytes"], SCALE_RUNS[shape].decode):
            faults.append(f"(g) device decode {g['digest']} {g['bytes']} of {g['streams']} streams != the corpus's "
                          f"{want['digest']} {want['bytes']} of {SCALE_RUNS[shape].decode}")
        if g["device_stats"].get("decode_blocks", 0) != g["archive_blocks"]:
            faults.append(f"(g) device decode of {g['device_stats'].get('decode_blocks', 0)} blocks != the "
                          f"archive's {g['archive_blocks']}")
    return [f"{shape} {f}" for f in faults]


def multihost_faults(transport: str, h: dict, half: dict) -> list[str]:
    """(h)'s gates on one transport's two-host encode of the half corpus,
    one message each, naming the transport and the host: host 0's archive
    is the bytes of (b)'s half archive ``half`` (the host path's archive
    of the half corpus, ``is_prefix_archive``) and the other hosts write
    nothing; each host exits 0 within its limit, abandons no batch, puts
    blocks on the card and launches its MTF kernel once per device batch
    at its class's width."""
    pre = f"(h) multihost {transport}"
    faults = []
    if (h["archive_digest"], h["archive_bytes"]) != (half["archive_digest"], half["archive_bytes"]):
        faults.append(f"{pre} host 0 archive {h['archive_digest']} of {h['archive_bytes']} bytes != (b) half's "
                      f"{half['archive_digest']} of {half['archive_bytes']}")
    for i, host in enumerate(h["host_lines"]):
        st = host.get("device_stats", {})
        if i and host["wrote_bytes"]:
            faults.append(f"{pre} host {i} wrote {host['wrote_bytes']} bytes, where only host 0 writes")
        if host["exit"] != 0:
            faults.append(f"{pre} host {i} exit {host['exit']}{' at its limit' if host.get('killed') else ''}")
        if host.get("scheduler_stats", {}).get("abandoned_batches"):
            faults.append(f"{pre} host {i} abandoned batches: {host['scheduler_stats']}")
        if not st.get("blocks"):
            faults.append(f"{pre} host {i} put no block on the card, of its {host.get('blocks')}")
        if "width_launches" in host:
            faults += [f"{pre} host {i} {f}" for f in scale_run.launch_faults(host, h["device"])]
    return faults


def tier_launches(legs: dict) -> dict:
    """The MTF launches by width of a tier's hybrids (b) and of both
    device-only runs (d) in fast mode (its one run where the tier's (d) is
    not timed), of each mode's hybrids and (d), and
    of (h)'s host processes, each counted in its own process."""
    runs = [legs[k] for k in ("b_half", "b") if k in legs]
    if "d" in legs:
        runs += [legs["d"], legs["d"]["traced"]] if "traced" in legs["d"] else [legs["d"]]
    for run in legs.get("modes", {}).values():
        runs += run.values()
    for h in legs.get("h", {}).values():
        runs += h["host_lines"]
    return {w: sum(r["width_launches"][w] for r in runs) for w in ("16", "32", "64", "128", "256")}


def phase_scale(smi: str, deadlines: dict, fast: bool = True, forker=None) -> dict:
    """Phases 13 to 15: the tiers of ``SCALE_RUNS`` that ``deadlines``
    names, at the scale their users run, their corpora written together in
    a temporary directory (the disk's room checked first), then tier by
    tier each leg in a child process (``scale_child``, forked by
    ``forker``, or by a fork server of the phase's own without one): (a),
    the fast-mode legs of phases 13 and 14 and (h), BASELINE config 5, by
    the tier's first deadline (none without ``fast``), then the tier's
    phase-15 legs by its second on the same corpus, held to the same (a);
    every gate of ``scale_faults``.  Returns each tier's MTF launches by
    width (``tier_launches``)."""
    if forker is None:
        with leg_fork.LegForker(ROOT) as own:
            return phase_scale(smi, deadlines, fast, own)
    import shutil

    ready = forker.wait_ready()
    log(f"scale: fork server ready, imports {ready['import_s']:.3f} s, {ready['threads']} threads after them")
    torch.cuda.empty_cache()
    launches, transforms = {}, {}
    no_fallback = {"STARCH3_TPU_NO_HOST_FALLBACK": "1"}
    faults = []
    with tempfile.TemporaryDirectory(prefix="s3t-scale-") as d:
        jobs = {(shape, part): (os.path.join(d, f"{shape}-{part}.bed"), t) for shape in deadlines
                for part, t in (("full", SCALE_RUNS[shape].target), ("half", SCALE_RUNS[shape].half)) if t}
        need, free = sum(t for _, t in jobs.values()) + SCALE_ARCHIVE_ROOM, shutil.disk_usage(d).free
        if free < need:
            raise AssertionError(f"scale: {free} bytes free in {d}, the phase needs {need}")
        t0 = time.monotonic()
        with concurrent.futures.ThreadPoolExecutor(len(jobs)) as ex:
            gens = {k: ex.submit(scale_child, f"{k[0]} corpus {t:.3g}", ["gen", path, t, "--shape", k[0]],
                                 min(fd for fd, _ in deadlines.values()), 240, forker)
                    for k, (path, t) in jobs.items()}
            corpora = {k: g.result() for k, g in gens.items()}
        log(f"scale: {len(jobs)} corpora written together in {time.monotonic() - t0:.3f} s")
        for shape, (deadline, mode_deadline) in deadlines.items():
            t0 = time.monotonic()
            tier, bed = SCALE_RUNS[shape], jobs[shape, "full"][0]
            legs = {"gen": corpora[shape, "full"]}
            if legs["gen"]["bytes"] < tier.target:
                raise AssertionError(f"scale {shape}: the corpus has {legs['gen']['bytes']} bytes")
            arc = {k: os.path.join(d, f"{shape}-{k}.starch") for k in ("a", "b_half", "b", "c")}
            if tier.half:
                part = corpora[shape, "half"]
                with open(bed, "rb") as f:
                    if hashlib.sha256(f.read(part["bytes"])).hexdigest() != part["digest"]:
                        raise AssertionError(f"scale {shape}: the half corpus is not a prefix of the corpus")
            src = {"half": tier.half and jobs[shape, "half"][0], "whole": bed}
            texts = ["--texts", os.path.join(d, f"{shape}.texts")] if tier.modes else []
            # (a) the reference bytes: the host path, the CLI asked for it (--platform=host)
            legs["a"] = scale_child(f"{shape} (a) host path, cli --platform=host", ["encode", bed, arc["a"], "--cli"],
                                    deadline, 300, forker)
            if fast:
                # (b) the hybrid, the CLI's default (no flag), half then whole; (e) decode
                if tier.half:
                    legs["b_half"] = scale_child(f"{shape} (b) hybrid, the default cli, half corpus", [
                        "encode", src["half"], arc["b_half"], "--jax", "--cli"], deadline, 200, forker)
                    legs["b_half"]["prefix_of_a"] = is_prefix_archive(arc["b_half"], arc["a"])
                legs["b"] = scale_child(f"{shape} (b) hybrid, the default cli + (e) decode",
                                        ["encode", bed, arc["b"], "--jax", "--cli", "--decode"], deadline, 300, forker)
                if tier.pipe:  # (c) the CLI through a real pipe, its processes started anew, on the half corpus
                    legs["c"] = scale_child(f"{shape} (c) cat | cli", ["pipe", src["half"], arc["c"]],
                                            deadline, 300, forker)
                # (d) device only, every stream against (a)'s; it leaves its
                # texts to the tier's phase-15 (d) legs
                if tier.device_only:
                    once = [] if tier.timed else ["--traced-only"]
                    legs["d"] = scale_child(f"{shape} (d) device only", ["device", bed, arc["a"], os.path.join(
                        d, f"trace-{shape}"), BUILD_DIR, "--shape", shape, *once, *texts], deadline, 300, forker,
                        no_fallback)
                # (h) BASELINE config 5: two host processes of the CLI, started
                # anew as a user starts them, on the one card, on the half
                # corpus held to (b)'s half archive, the host path's of the half corpus
                for transport in tier.multihost:
                    legs.setdefault("h", {})[transport] = scale_child(
                        f"{shape} (h) multihost {transport}", ["multihost", src["half"], arc["b_half"], "--transport",
                                                               transport, "--host-limit-s", 240], deadline, 300, forker)
            # phase 15: the other modes, each held to (a), and device decode
            for run in tier.modes:
                legs.setdefault("modes", {})[run.mode] = mode_legs = {}
                for part in run.hybrid:
                    key, out = "b" if part == "whole" else "b_half", os.path.join(d, f"{shape}-{run.mode}.starch")
                    mode_legs[key] = scale_child(f"{shape} {run.mode} (b) hybrid, {part} corpus", [
                        "encode", src[part], out, "--jax", "--mode", run.mode, "--warm-up"], mode_deadline, 200,
                        forker)
                    if key == "b_half":
                        mode_legs[key]["prefix_of_a"] = is_prefix_archive(out, arc["a"])
                    os.remove(out)
                host_rate = ["--host-rate"] if run.hybrid else []  # the cores a hybrid's card is held to
                first = ["--streams", run.streams] if run.streams else []
                mode_legs["d"] = scale_child(f"{shape} {run.mode} (d) device only", [
                    "device", bed, arc["a"], os.path.join(d, f"trace-{shape}"), BUILD_DIR, "--shape", shape,
                    "--mode", run.mode, "--untraced", *host_rate, *first, *texts], mode_deadline, 300, forker,
                    no_fallback)
            if tier.decode:  # (g) device decode of (a)'s first streams, a cut for the run's time
                legs["g"] = scale_child(f"{shape} (g) device decode", [
                    "decode", arc["a"], bed, "--streams", tier.decode], mode_deadline, 300, forker)
            faults += scale_faults(shape, legs)
            launches[shape] = tier_launches(legs)
            log_scale(shape, smi, legs)
            for key in ("b_half", "b"):
                if key in legs:
                    b = legs[key]
                    log_default(f"{shape} (b) cli {'half' if key == 'b_half' else 'whole'} corpus", b["device"],
                                b["device_stats"].get("blocks", 0), b["blocks"], b["mb_per_s_bed"],
                                legs["a"]["mb_per_s_bed"], smi)
            if "d" in legs:
                transforms[shape] = (legs["a"]["transform_seconds"], legs["d"]["transform_seconds"],
                                     legs["gen"]["bytes"] / 1e9)
            for path in [p for k, (p, _) in jobs.items() if k[0] == shape] + list(arc.values()) + texts[1:]:
                if os.path.exists(path):
                    os.remove(path)
            log(f"scale {shape}: the tier's legs took {time.monotonic() - t0:.3f} s")
    if transforms:
        log_transforms(smi, transforms)
    if faults:
        raise AssertionError("scale: " + "; ".join(faults))
    return launches


def _classes_run(per_class: dict) -> dict:
    """``per_class`` without the classes that counted nothing."""
    return {c: v for c, v in per_class.items() if any(v.values())}


def _memory_line(bh: dict | None, b: dict) -> str:
    """(f)'s figures from a mode's half hybrid to its whole one, or the
    whole one's alone."""
    if not bh:
        return (f"the encode's own peak RSS {b['peak_rss_mb'] - b['rss_start_mb']:.1f} MB, max_memory_reserved "
                f"{b['max_memory_reserved']}, page-locked bytes held {b.get('pinned_bytes')}")
    rss, reserved = memory_growth(bh, b)
    return (f"(f) the encode's own peak RSS, half -> whole, {bh['peak_rss_mb'] - bh['rss_start_mb']:.1f} -> "
            f"{b['peak_rss_mb'] - b['rss_start_mb']:.1f} MB (x{rss:.4f}; peak RSS {bh['peak_rss_mb']:.1f} -> "
            f"{b['peak_rss_mb']:.1f}, at the start {bh['rss_start_mb']:.1f} and {b['rss_start_mb']:.1f}; the C "
            f"heap's peak in use {bh.get('c_heap_in_use_peak_mb')} -> {b.get('c_heap_in_use_peak_mb')} and "
            f"held {bh.get('c_heap_held_peak_mb')} -> {b.get('c_heap_held_peak_mb')}; ru_maxrss, which a child "
            f"keeps from this process, {bh['ru_maxrss_mb']:.1f} -> {b['ru_maxrss_mb']:.1f}), "
            f"max_memory_reserved {bh['max_memory_reserved']} -> {b['max_memory_reserved']} (x{reserved:.4f}), "
            f"page-locked bytes held {bh.get('pinned_bytes')} -> {b.get('pinned_bytes')}")


def _log_hybrids(shape: str, mode: str, smi: str, hybrids: dict) -> None:
    for label, key in (("(b) half", "b_half"), ("(b) whole", "b")):
        if key not in hybrids:
            continue
        r = hybrids[key]
        st, sched = r["device_stats"], r["scheduler_stats"]
        log(f"scale {shape} {mode} {label}: {r['mb_per_s_bed']:.3f} MB/s of BED, blocks on the device "
            f"{st.get('blocks', 0)} ({st.get('batches', 0)} batches) of {r['blocks']}, scheduler {sched}, the "
            f"feed's transform {r['transform_seconds']:.3f} s, per class {_classes_run(r['per_class'])}, bytes "
            f"read back a block {r['d2h_bytes_per_block']}; on {smi}")


def log_scale(shape: str, smi: str, legs: dict) -> None:
    """One tier's figures, each beside the card's name and power limit."""
    full, a = legs["gen"], legs["a"]
    log(f"scale {shape}, {full['bytes']} bytes of BED ({full['seconds']:.3f} s to generate): (a) host "
        f"{a['mb_per_s_bed']:.3f} MB/s of BED, transform {a['transform_seconds']:.3f} s; MTF launches by width "
        f"{tier_launches(legs)}; on {smi}")
    if "b" in legs:
        log_fast(shape, smi, legs)
    for mode, run in legs.get("modes", {}).items():
        _log_hybrids(shape, mode, smi, run)
        dv = run["d"]
        b = run.get("b")
        hybrid = (f"(b) hybrid {b['mb_per_s_bed']:.3f} MB/s of BED, blocks on the device "
                  f"{b['device_stats'].get('blocks', 0)} of {b['blocks']}" if b else "(b) on the whole corpus not run")
        half = run.get("b_half")
        if half:
            hybrid += (f"; half {half['mb_per_s_bed']:.3f} MB/s of BED, blocks on the device "
                       f"{half['device_stats'].get('blocks', 0)} of {half['blocks']}")
        cores = f", the host cores' {dv['host']['mb_per_s_text']:.3f} on the same texts" if "host" in dv else ""
        log(f"scale {shape} {mode} summary: {hybrid}; (d) device only, untraced, {dv['mb_per_s_text']:.3f} MB/s of "
            f"text against the host path's {dv['text_bytes'] / a['seconds'] / 1e6:.3f}{cores} ({dv['blocks']} blocks, "
            f"{dv['device_stats'].get('batches', 0)} batches in {dv['seconds']:.3f} s; per class "
            f"{_classes_run(dv['per_class'])}; bytes read back a block {dv['d2h_bytes_per_block']}; "
            f"max_memory_reserved {dv['max_memory_reserved']}, peak RSS {dv['peak_rss_mb']:.1f} MB); "
            f"{_memory_line(half if b else None, b or half) if b or half else 'no hybrid'}; on {smi}")
    for transport, h in legs.get("h", {}).items():
        log_multihost(shape, transport, smi, h, legs)
    if "g" in legs:
        g = legs["g"]
        native = f"{legs['b']['decode']['mb_per_s_bed']:.3f}" if "b" in legs else "not run"
        gb = g["bytes"] / 1e9
        log(f"scale {shape} (g) device decode of (a)'s archive, {g['streams']} streams: "
            f"{g['mb_per_s_bed']:.3f} MB/s of BED "
            f"({g['seconds']:.3f} s for {g['bytes']} bytes, {g['archive_blocks']} blocks in "
            f"{g['device_stats'].get('decode_batches', 0)} batches) against (e)'s native decode {native}; host "
            f"ms a block {g['host_ms_per_block']}; peak RSS {g['peak_rss_mb']:.1f} MB ({g['peak_rss_mb'] / gb:.1f} "
            f"a GB of BED; the decode's own {(g['peak_rss_mb'] - g['rss_start_mb']) / gb:.1f} a GB), "
            f"max_memory_reserved {g['max_memory_reserved']}; on {smi}")


def log_multihost(shape: str, transport: str, smi: str, h: dict, legs: dict) -> None:
    """(h)'s figures: the wall time and MB/s of BED for both hosts beside
    (a)'s and (b)'s single-process hybrid on the half corpus, and each
    host's share, device blocks,
    demotions and class skips (printed, not gated), memory and stages."""
    a, b = legs["a"], legs["b_half"]
    hosts = []
    for i, x in enumerate(h["host_lines"]):
        st, sched, t = x["device_stats"], x["scheduler_stats"], leg_fork.leg_times(x, x["launched_at"])
        hosts.append(
            f"host {i}: {x['chromosomes']} chromosomes, blocks on the card {st.get('blocks', 0)} of {x['blocks']} "
            f"({st.get('batches', 0)} batches, per class {_classes_run(x['per_class'])}), demotions "
            f"{sched['demotions']}, class skips {sched['class_skips']}, own peak RSS {x['own_peak_rss_mb']:.1f} MB "
            f"({x['own_peak_rss_mb_per_gb']:.1f} a GB of BED; {x['rss_start_mb']:.1f} at its start), "
            f"max_memory_reserved {x['max_memory_reserved']}, seconds {json.dumps(x['stage_seconds'])}, start "
            f"{t['start_s']:.3f} s, CUDA init {t['cuda_init_s']:.3f} s, work {t['work_s']:.3f} s")
    log(f"scale {shape} (h) multihost {transport}, {h['hosts']} processes on one card, the half corpus "
        f"({h['bytes_in']} bytes): {h['seconds']:.3f} s wall for both, process starts included, "
        f"{h['mb_per_s_bed']:.3f} MB/s of BED against (a)'s {a['mb_per_s_bed']:.3f} on the corpus and (b)'s "
        f"single-process hybrid {b['mb_per_s_bed']:.3f} on the half corpus; host 0's archive == (b) half's "
        f"({h['archive_bytes']} bytes), the other hosts wrote "
        f"{h['other_hosts_bytes']} bytes, gloo ports retried {len(h['port_retries'])}; {'; '.join(hosts)}; on {smi}")


def log_fast(shape: str, smi: str, legs: dict) -> None:
    """Fast mode's figures, phases 13 and 14."""
    full, a, b, dv = legs["gen"], legs["a"], legs["b"], legs.get("d")
    bh, text = legs.get("b_half"), a["text_bytes"]
    _log_hybrids(shape, "fast", smi, legs)
    pipe = (f"(c) cat | cli {legs['c']['mb_per_s_bed']:.3f} MB/s of BED ({legs['c']['bytes_in']} bytes); "
            if "c" in legs else "")
    device = "(d) not run (PERF.md §4)"
    if dv:
        traced = dv.get("traced", dv)  # a tier's (d) that is not timed is its traced run
        trace = traced["trace"]
        device = (
            f"(d) device only, timed {dv['mb_per_s_text']:.3f} MB/s of text ({dv['blocks']} blocks, "
            f"{dv['device_stats'].get('batches', 0)} batches in {dv['seconds']:.3f} s, per class "
            f"{_classes_run(dv['per_class'])}; the tied blocks' host re-encodes {dv['reencode']['calls']} in "
            f"{dv['reencode']['seconds']:.3f} s, by thread {dv['reencode']['by_thread']}); traced run "
            f"{traced['mb_per_s_text']:.3f} MB/s of text, busy share {trace.get('busy_share')} over "
            f"{trace.get('batches')} steady batches ({trace.get('batches_per_s')} batches/s, "
            f"{trace.get('device_ms_per_batch')} device ms a batch); max_memory_reserved "
            f"{dv['max_memory_reserved']}, page-locked bytes {dv.get('pinned_bytes')}, its transform on every core "
            f"{dv['transform_seconds']:.3f} s, chromosomes whose starts go back {_starts_back(dv)}")
    log(f"scale {shape} summary, {full['bytes']} bytes of BED, {text} of text ({full['seconds']:.3f} s to "
        f"generate): (a) host {a['mb_per_s_bed']:.3f} MB/s of BED ({text / a['seconds'] / 1e6:.3f} of text), "
        f"transform {a['transform_seconds']:.3f} s; (b) hybrid {b['mb_per_s_bed']:.3f} MB/s of BED "
        f"({text / b['seconds'] / 1e6:.3f} of text), blocks on the device {b['device_stats'].get('blocks', 0)} of "
        f"{b['blocks']}; {pipe}(e) decode {b['decode']['mb_per_s_bed']:.3f} MB/s of BED; {_memory_line(bh, b)}; "
        f"{device}; on {smi}")


def _starts_back(dv: dict) -> str:
    back = dv.get("starts_back")
    if not back:
        return "not counted"
    return f"{back['chroms']} of {back['of']} ({back['chroms'] / back['of']:.3f}; {back['lines']} lines)"


def log_transforms(smi: str, seen: dict) -> None:
    """The transform's seconds of each tier's (a) (the feed, one thread)
    and (d) (each chromosome once, every core), a GB of BED: config 4's
    unsorted starts beside bed3's sorted ones."""
    per_gb = {shape: f"(a) {a / gb:.3f} s, (d) {d / gb:.3f} s a GB of BED ({gb:.3f} GB)"
              for shape, (a, d, gb) in seen.items()}
    log(f"scale transform seconds: {'; '.join(f'{k} {v}' for k, v in per_gb.items())}; on {smi}")


def card_name() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=5)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: chip_smoke needs a CUDA card")
    device = torch.device("cuda")
    t_start = time.monotonic()
    # the scale legs' fork server imports torch while phases 1-12 run; it
    # ends at the end of its input, also when this process fails before
    # the ``with`` below
    forker = leg_fork.LegForker(ROOT)
    smi = card_name()
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
    phase_entry_points("config2", bed2, smi)
    phase_entry_points("config3", bed3, smi)
    huff_launches = {128: 0, 256: 0}
    for label in ("config2", "config3", "wide8"):
        for w, n in phase_fast_huff(device, label, by_label[label]).items():
            huff_launches[w] += n
    if not all(huff_launches.values()):
        raise AssertionError(f"fast_huff: the wide kernel did not launch at every width: {huff_launches}")
    for w, n in huff_launches.items():
        wide_by_width[w] += n
        launches["mtf_wide"] += n
    phase_entry_points("config2 fast_huff", bed2, smi, device_huffman=True)
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
    phase_exact_fault_cold(args.seed)
    mesh_run = phase_mesh_encodes(device, runs, smi)
    launches["mtf_narrow"] += mesh_run["narrow"][16]
    launches["mtf_narrow_windowed"] += mesh_run["narrow"][32] + mesh_run["narrow"][64]
    for w, n in mesh_run["wide"].items():
        wide_by_width[w] += n
        launches["mtf_wide"] += n
    phase_mesh_decode(mesh_run["mesh"], by_label, {"config2": bed2, "config3": bed3}, smi)
    phase_two_processes(device, bed2, smi)
    phase_transform_ops(device, bed2 + corpus.big_chrom_bed(args.seed + 1), smi)
    launches["mtf_narrow"] += phase_device_trace(device, texts_of(bed2), smi)
    helpers = phase_host_helpers(device, texts_of(bed2), by_label["wide8"], smi)
    launches["mtf_narrow"] += helpers["narrow"]
    launches["mtf_wide"] += helpers["wide"]
    wide_by_width[256] += helpers["wide"]
    # phase 16's config 1, then phases 13, (h) and 15 on bits 4, config 4,
    # phase 17's reads, then 14 and 15 on the BED6 tiers, every corpus
    # written at once; each tier's phase-15 legs (the other modes, device
    # decode) have a deadline of their own.  On an H100 phases 1-12 took
    # 347-482 s, and config 1 and the scale phases 481 s on a machine whose
    # phases 1-12 took 370 s, before (g), the pipe and reads' (d) were cut
    # (PERF.md §5); slower machines take up to a quarter longer.  Each
    # deadline leaves room for a slower machine, and the last ends the
    # phase by 1,170 s, inside the 1,200 s.
    t_scale = time.monotonic()
    with forker:
        launches["mtf_narrow"] += phase_config1(smi, forker)
        by_tier = phase_scale(smi, {"bed3": (t_start + 780, t_start + 890), "config4": (t_start + 980,) * 2,
                                    "reads": (t_start + 1080,) * 2, "config3": (t_start + 1120,) * 2,
                                    "bits6": (t_start + 1140,) * 2, "wide8": (t_start + 1140, t_start + 1170)},
                              forker=forker)
    log(f"times: phases 1-12 {t_scale - t_start:.3f} s, config 1 and the scale phases "
        f"{time.monotonic() - t_scale:.3f} s; on {smi}")
    bits4 = {w: by_tier["bed3"][w] + by_tier["config4"][w] for w in by_tier["bed3"]}
    bed6 = {w: sum(by_tier[t][w] for t in ("config3", "bits6", "wide8", "reads")) for w in bits4}
    if not (all(bits4[w] for w in ("16", "128", "256")) and all(bed6[w] for w in ("32", "64", "256"))
            and by_tier["config4"]["16"] and by_tier["config3"]["32"] and by_tier["reads"]["32"]):
        raise AssertionError(f"scale: an MTF width of a tier or mode did not launch: bits 4 {bits4}, BED6 {bed6}, "
                             f"config4 {by_tier['config4']}, config3 {by_tier['config3']}, reads {by_tier['reads']}")
    scale = {w: bits4[w] + bed6[w] for w in bits4}
    launches["mtf_narrow"] += scale["16"]
    launches["mtf_narrow_windowed"] += scale["32"] + scale["64"]
    for w in mtf_wide.WIDTHS:
        wide_by_width[w] += scale[str(w)]
        launches["mtf_wide"] += scale[str(w)]

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
