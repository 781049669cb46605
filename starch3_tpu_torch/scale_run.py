"""The port at the scale its users run: one leg of a streaming encode or
decode of a scale corpus (``corpus.SCALE_SHAPES``: 3-column BED, the BED6
shapes of the bits 5, 6 and 8 tiers, BASELINE config 4's variant BED and
config 3's aligned reads) per process, for ``chip_smoke.py`` phases 13 to
17 and ``tests/test_torch_scale.py``; BASELINE config 5, one multi-host
encode in several processes; configs 4 and 3 at their stated scale; and
config 1's one block device only.

    python -m starch3_tpu_torch.scale_run gen OUT TARGET [--shape S] [--n-per N | --n-total N]
    python -m starch3_tpu_torch.scale_run encode IN OUT [--jax [--mode M] [--warm-up]] [--cli] [--decode]
    python -m starch3_tpu_torch.scale_run pipe IN OUT
    python -m starch3_tpu_torch.scale_run device IN REF TRACE_DIR MISMATCH_DIR [--shape S] [--mode M]
        [--untraced | --traced-only] [--host-rate] [--bz2] [--texts FILE] [--streams K]
    python -m starch3_tpu_torch.scale_run decode ARCHIVE CORPUS [--streams K]
    python -m starch3_tpu_torch.scale_run multihost IN REF --transport {gloo,manifest} [--device D] [--host-limit-s S]
    python -m starch3_tpu_torch.scale_run host -- CLI_ARGS
    python -m starch3_tpu_torch.scale_run config5 DIR [--target BYTES]
    python -m starch3_tpu_torch.scale_run {config4,reads} DIR [--target BYTES] [--n-total N] [--device D]
    python -m starch3_tpu_torch.scale_run oneblock IN [--device D]

``gen`` writes the corpus of shape S (``bed3``, the default, is
``corpus.gigabyte_bed``; ``config3``, ``bits6`` and ``wide8`` the BED6
tiers; ``config4`` ``corpus.config4_scale_bed`` and ``reads``
``corpus.reads_scale_bed``, sized by ``--n-total``).  ``encode`` is
``api.compress_bed_file`` with ``EncodeConfig(use_jax=False)`` (the host
path) or, with ``--jax``, the device path beside the host stealers on
``--device``, in the encode mode M
(``MODES``: ``fast``, the default, ``fast_huff``, ``ranks`` or
``rle2``), after a warm-up on the card with ``--warm-up``
(``warm_up``); with ``--cli`` the same encode is a user's command,
the CLI's ``main`` with ``--output=OUT IN`` and the flags of
``cli_flags``: none for the device path on the card (the CLI's default),
``--platform=host`` for the host path, ``--platform=cpu`` for the plain
versions.  ``--decode`` then decodes the archive with
``api.decompress_starch_file`` and hashes what comes out.  It also gives
the archive's blocks and the feed's transform seconds.
``pipe`` runs ``cat IN | python -m starch3_tpu_torch.cli > OUT`` (with
``--platform=D`` off the card), a real pipe into the CLI's stdin.
``device`` transforms each chromosome of IN whole with the native
transform (on every core, while the profiler
starts; or reads them from ``--texts``, where an earlier leg wrote
them), feeds the texts in order to
``pipeline.encode_streams_iter(host_assist=False)`` and holds every
stream to the stream of the same chromosome in the archive REF, in mode
M, twice: first under ``observability.device_trace`` into TRACE_DIR,
where it reads the card's busy share, then timed (``--untraced``: the
timed run alone; ``--traced-only``: the traced one alone); every block
must be of the tier of shape S, and it
counts each chromosome's lines whose start goes back (``starts_back``)
and times the host re-encodes of tied blocks by thread (``reencode``).
With ``--host-rate`` the host cores then encode the same texts, without
the feed (``host_run``); with ``--bz2`` every stream is held to
``bz2.compress`` of its text (``bz2_run``); with ``--streams K`` it
encodes the first K chromosomes only.  A stream that differs leaves its text and its
first differing block in MISMATCH_DIR, with that block's MTF input and
the kernel's and the plain version's ranks on it (``mismatch-*.pt``).
``decode`` is ``api.decompress_starch_bytes(use_jax=True)`` of ARCHIVE
(or of an archive of its first K streams) on ``--device``, whose output
must be the bytes of CORPUS (of its first K chromosomes), with
``decode_blocks`` equal to the decoded archive's blocks; it times the
host's share per block (the Huffman walk, ``rle1_decode``, the CRCs)
around the functions ``decode_streams`` calls.
``multihost`` starts two ``host`` legs together, each the port's CLI
with a user's argv, ``--num-hosts=2 --host-id=I`` (and ``--platform=D``
off the card) over a
gloo process group on a free localhost port or a manifest directory:
host 0's archive must be REF's bytes and the others write nothing
(``multihost_faults``).  ``host`` runs ``cli.main(CLI_ARGS)`` timed
around its stages (``HOST_STAGES``; ``ONE_HOST_STAGES`` without
``--num-hosts``) and prints its counters.
``config5`` is BASELINE config 5 at its stated scale: it checks the room
(memory and disk, ``config5_target``, with a host's memory as
``multihost`` measured it), then runs ``gen``, the host
path's ``encode`` and ``multihost --transport manifest`` in DIR.
``config4`` is BASELINE config 4 at its stated 100M intervals and
``reads`` config 3 as 20M aligned single-end reads (``STATED``): each
checks the room (``stated_target``), then runs in DIR ``gen``, (a), (b)
on a 1.1e9-byte prefix and on the whole with (e), (d) held to
``bz2.compress`` too, and on config 4 (a) and (d) on ``gigabyte_bed``'s
sorted bytes of the same size (``leg_stated``).
``oneblock`` is BASELINE config 1's one block device only, three times
in one process: its key's warm-up, its graph capture and a replay.

Each leg prints one JSON line, its last: its seconds (``timing``: when
``main`` began, the seconds of its imports, of CUDA's initialisation on
the card it uses itself, and of its work), digests, peak RSS
(sampled: ``PeakRss``; ``ru_maxrss`` beside it) and the resident set
before the encode, a series of the resident set and of the C heap's bytes
in use and held over the leg, on a card the caching allocator's peaks and
the page-locked bytes the process holds, and the counters it read
(``pipeline.device_stats``, ``host.scheduler_stats``, the MTF kernels'
launches by width), each set to 0 just before the leg, with each class's
share of them (``per_class``) and each class's bytes read back a block.
The ``encode --jax`` and ``device`` legs hold the launches by width to
the device batches by class at the mode's widths, and in the exact modes
want no tie re-encode (``counter_faults``); a leg that finds a fault or
a mismatch exits non-zero.
"""

from __future__ import annotations

import argparse
import bisect
import concurrent.futures
import contextlib
import ctypes
import hashlib
import importlib
import json
import os
import resource
import shutil
import socket
import subprocess
import sys
import tempfile
import time
import typing

import numpy as np

from starch3_tpu_torch.corpus import SCALE_SHAPES, SCALE_TIERS, SCALE_UNSORTED
from starch3_tpu_torch.leg_fork import LEG_MODULES, spawn


class _Hasher:
    """A write-only file object that keeps the SHA-256 and the length of
    what is written to it."""

    def __init__(self):
        self.h = hashlib.sha256()
        self.n = 0

    def write(self, b) -> int:
        self.h.update(b)
        self.n += len(b)
        return len(b)


def archive_metadata(path: str):
    """An archive's metadata, read from its end alone."""
    from starch3_tpu_torch.format.archive import FOOTER_LEN
    from starch3_tpu_torch.format.metadata import ArchiveMetadata

    with open(path, "rb") as f:
        f.seek(-FOOTER_LEN, os.SEEK_END)
        end = f.tell()
        offset = int(f.read(20))
        f.seek(offset)
        return ArchiveMetadata.from_json_bytes(f.read(end - offset))


def archive_blocks(path: str) -> int:
    """The blocks of an archive's streams, read from its metadata alone."""
    return sum(len(s.block_bit_offsets) for s in archive_metadata(path).streams)


def is_prefix_archive(half_path: str, whole_path: str) -> bool:
    """Whether the half corpus's archive is the whole one's first streams
    with their metadata, byte for byte (``prefix_archive``): where the
    whole archive is the host path's, the host path's archive of the half
    corpus, to which an archive held to the half one is held too."""
    from starch3_tpu_torch.format.archive import StarchReader

    with open(half_path, "rb") as fh, open(whole_path, "rb") as fw:
        half, whole = fh.read(), fw.read()
    return half == prefix_archive(whole, len(StarchReader.from_bytes(half).metadata.streams))


@contextlib.contextmanager
def timed_calls(module, *names):
    """Sums, into the dict it yields, the wall time of every call of each
    function ``module.<name>`` made inside it by code that looks the name
    up in ``module`` when it calls it: the file entry's feed
    (``runtime.bed_transform_native``, whose one thread bounds a
    streaming encode), the host's share of ``pipeline.decode_streams``, or
    the tie re-encodes of a device-only encode (``encoder``'s
    ``encode_block_fragment``).  ``<name>_calls`` counts the calls and
    ``<name>_threads`` splits the seconds by the name of the thread that
    made them."""
    import threading

    real = {n: getattr(module, n) for n in names}
    spent = dict.fromkeys(names, 0.0) | {f"{n}_calls": 0 for n in names} | {f"{n}_threads": {} for n in names}

    def timed(name):
        def call(*args, **kw):
            t0 = time.perf_counter()
            try:
                return real[name](*args, **kw)
            finally:
                dt = time.perf_counter() - t0
                by_thread = spent[f"{name}_threads"]
                thread = threading.current_thread().name
                by_thread[thread] = by_thread.get(thread, 0.0) + dt
                spent[name] += dt
                spent[f"{name}_calls"] += 1

        return call

    for n in names:
        setattr(module, n, timed(n))
    try:
        yield spent
    finally:
        for n in names:
            setattr(module, n, real[n])


def file_digest(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while chunk := f.read(16 << 20):
            h.update(chunk)
    return h.hexdigest()


def ru_maxrss_mb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024


def rss_mb() -> float:
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") / 2**20


class _MallInfo2(ctypes.Structure):
    _fields_ = [(f, ctypes.c_size_t) for f in (
        "arena", "ordblks", "smblks", "hblks", "hblkhd", "usmblks", "fsmblks", "uordblks", "fordblks", "keepcost")]


def c_heap_mb() -> tuple[float, float] | None:
    """glibc's heap over all arenas, in MB: the bytes in use (allocated
    chunks and mmapped blocks) and the bytes held from the system, which
    also counts freed chunks the allocator keeps.  None without
    ``mallinfo2`` (glibc before 2.33, or another C library)."""
    fn = getattr(ctypes.CDLL(None), "mallinfo2", None)
    if fn is None:
        return None
    fn.restype = _MallInfo2
    m = fn()
    return (m.uordblks + m.hblkhd) / 2**20, (m.arena + m.hblkhd) / 2**20


class PeakRss:
    """The largest resident set of this process seen by a thread of its
    own, every ``every_s`` seconds, from ``start()`` to ``stop()``.  A
    child keeps ``ru_maxrss`` from the parent it was forked from, across
    exec, so a leg started by a large process would read the parent's
    peak there; and ``VmHWM`` is not in ``/proc/self/status`` on every
    kernel (gVisor's lacks it).  Every ``series_s`` seconds it also keeps
    a point ``[seconds, RSS, C heap in use, C heap held, progress()]``
    (MB; the heap's are None without ``c_heap_mb``): whether a leg's
    memory levels off or keeps growing, and whether what grows is live
    data or freed memory the allocator holds."""

    def __init__(self, every_s: float = 0.02, series_s: float = 0.5, progress=lambda: 0):
        import threading

        self.every_s, self.series_s, self.progress = every_s, series_s, progress
        self.mb, self.series = rss_mb(), []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name="peak-rss", daemon=True)

    def _point(self, t0: float) -> None:
        heap = c_heap_mb() or (None, None)
        self.series.append([round(time.perf_counter() - t0, 3), round(rss_mb(), 1),
                            *(h if h is None else round(h, 1) for h in heap), self.progress()])

    def _run(self) -> None:
        t0 = next_point = time.perf_counter()
        while not self._stop.wait(self.every_s):
            with self._lock:  # read under the lock: a sample from before a reset never lands after it
                self.mb = max(self.mb, rss_mb())
            if time.perf_counter() >= next_point:
                self._point(t0)
                next_point += self.series_s
        self._point(t0)

    def start(self) -> "PeakRss":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._thread.join()

    def peak_mb(self) -> float:
        with self._lock:
            self.mb = max(self.mb, rss_mb())
            return self.mb

    def reset(self) -> None:
        """Forget the peak so far: the peak from here on (the series goes on)."""
        with self._lock:
            self.mb = rss_mb()


def _zero_counters() -> None:
    from starch3_tpu_torch.ops import mtf_narrow, mtf_wide
    from starch3_tpu_torch.parallel import host, pipeline

    for counts in (pipeline.device_stats, host.scheduler_stats, mtf_narrow.width_launches, mtf_wide.width_launches):
        for k in counts:
            counts[k] = 0


# the MTF width of each class's fast-mode step (narrow 16/32/64, wide 256)
WIDTH_OF_CLASS = {4: 16, 5: 32, 6: 64, 8: 256}
# each encode mode's ``EncodeConfig`` fields and ``encode_streams_iter``
# arguments, as ``pipeline.encode_mode`` reads them
MODES = {
    "fast": {},
    "fast_huff": {"device_huffman": True},
    "ranks": {"fast_bwt": False},
    "rle2": {"fast_bwt": False, "device_rle2": True},
}
PER_CLASS = ("blocks", "batches", "tie_reencodes", "huff_host_reencodes", "d2h_bytes", "graph_captures",
             "graph_replays", "class_skips")


def mode_width(mode: str, bits: int) -> int:
    """The MTF width a batch of class ``bits`` runs at in ``mode``: fast
    mode's ``WIDTH_OF_CLASS``; in ``fast_huff`` the wide kernel, 128 at
    bits 4 and 256 otherwise; in the exact modes 256 for every class."""
    if mode == "fast":
        return WIDTH_OF_CLASS[bits]
    if mode == "fast_huff":
        return 128 if bits == 4 else 256
    return 256


def _counters() -> dict:
    """The counters, with the MTF launches of both wrappers by width (the
    narrow wrapper's 16/32/64, the wide one's 128/256), each class's share
    of ``PER_CLASS`` and the bytes read back a block of each class that
    ran on the device."""
    from starch3_tpu_torch.ops import mtf_narrow, mtf_wide
    from starch3_tpu_torch.parallel import host, pipeline

    st = dict(pipeline.device_stats)
    return {
        "device_stats": {k: v for k, v in st.items() if v},
        "scheduler_stats": dict(host.scheduler_stats),
        "class_rate_cache": dict(host._class_rate_cache),
        "width_launches": {str(w): n for w, n in (mtf_narrow.width_launches | mtf_wide.width_launches).items()},
        "per_class": {str(c): {k: st[f"{k}_bits{c}"] for k in PER_CLASS} for c in WIDTH_OF_CLASS},
        "d2h_bytes_per_block": {str(c): st[f"d2h_bytes_bits{c}"] / st[f"blocks_bits{c}"]
                                for c in WIDTH_OF_CLASS if st[f"blocks_bits{c}"]},
    }


def launch_faults(counters: dict, device: str, mode: str = "fast") -> list[str]:
    """Each device batch launches one MTF kernel, at its class's width in
    ``mode`` (``mode_width``); on the CPU the wrappers run their plain
    versions and count nothing.  Returns what differs."""
    st, on_card = counters["device_stats"], device.startswith("cuda")
    want = dict.fromkeys(("16", "32", "64", "128", "256"), 0)
    for c in WIDTH_OF_CLASS:
        want[str(mode_width(mode, c))] += st.get(f"batches_bits{c}", 0) if on_card else 0
    got = counters["width_launches"]
    if got == want:
        return []
    return [f"{mode}: MTF launches by width {got} != device batches by class, at their widths, {want} on {device}"]


def counter_faults(counters: dict, device: str, mode: str) -> list[str]:
    """``launch_faults``, and in the exact modes no tie re-encode: their
    prefix-doubling BWT sorts every rotation whole, so no row ties."""
    faults = launch_faults(counters, device, mode)
    ties = counters["device_stats"].get("tie_reencodes", 0)
    if mode in ("ranks", "rle2") and ties:
        faults.append(f"{mode}: {ties} tie re-encodes, where the exact BWT has none")
    return faults


def _memory(device: str, peak: PeakRss) -> dict:
    """Peak RSS and the C heap's peaks, and on a card the caching
    allocator's peaks and the page-locked bytes of the caching host
    allocator, where torch has ``host_memory_stats``."""
    import torch

    out = {"peak_rss_mb": peak.peak_mb(), "ru_maxrss_mb": ru_maxrss_mb()}
    heap = [p[2:4] for p in list(peak.series) if p[2] is not None]
    if heap:  # at the series' points so far
        out["c_heap_in_use_peak_mb"] = max(h[0] for h in heap)
        out["c_heap_held_peak_mb"] = max(h[1] for h in heap)
    if device.startswith("cuda"):
        out["max_memory_reserved"] = torch.cuda.max_memory_reserved()
        out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        stats = getattr(torch.cuda, "host_memory_stats", None)
        if stats is not None:  # the caching host allocator's page-locked bytes
            held = stats()
            out["pinned_bytes"] = held.get("allocated_bytes.current")
            out["pinned_peak_bytes"] = held.get("allocated_bytes.peak")
    return out


def memory_growth(half: dict, whole: dict) -> tuple[float, float]:
    """From the half corpus's encode to the whole one's: the growth of the
    encode's own peak RSS (above the RSS its leg had before it, about 4.5
    GB of ``import torch`` on the card's host) and of
    ``max_memory_reserved`` (None on the CPU, which has no caching
    allocator); phase 13 (f) bounds them at x1.15 and x1.10."""
    own = (whole["peak_rss_mb"] - whole["rss_start_mb"]) / (half["peak_rss_mb"] - half["rss_start_mb"])
    if "max_memory_reserved" not in whole:
        return own, None
    return own, whole["max_memory_reserved"] / half["max_memory_reserved"]


def hybrid_faults(pre: str, hybrids: dict, a: dict, card_text: float | None, host_text: float,
                  keep_card: bool, memory: bool = True) -> list[str]:
    """The gates of one mode's hybrids, ``b_half`` and ``b`` where it runs
    them: the whole archive equals (a)'s, the half archive is (a)'s first
    streams with their metadata (``prefix_of_a``), no batch abandoned, no demotion where
    ``keep_card`` (the card alone, (d), at ``card_text`` MB/s of text where
    it ran, against the host's ``host_text``), and with ``memory``, from
    half to whole, the memory bounds of (f)."""
    faults = []
    if "b" in hybrids and hybrids["b"]["archive_digest"] != a["archive_digest"]:
        faults.append(f"{pre}(b) archive {hybrids['b']['archive_digest']} != host path's {a['archive_digest']}")
    if "b_half" in hybrids and not hybrids["b_half"]["prefix_of_a"]:
        faults.append(f"{pre}(b) the half archive's streams are not the host archive's first streams with "
                      "their metadata")
    for label, key in (("(b) half", "b_half"), ("(b)", "b")):
        sched = hybrids[key]["scheduler_stats"] if key in hybrids else {}
        if sched.get("abandoned_batches"):
            faults.append(f"{pre}{label} abandoned batches: {sched}")
        if keep_card and sched.get("demotions"):
            alone = "not run" if card_text is None else f"{card_text:.3f}"
            faults.append(f"{pre}{label} benched the device, which alone encodes {alone} MB/s of text against "
                          f"the host's {host_text:.3f}: {sched}")
    if memory and "b_half" in hybrids and "b" in hybrids:
        rss, reserved = memory_growth(hybrids["b_half"], hybrids["b"])
        if rss > 1.15 or (reserved or 0) > 1.10:
            faults.append(f"{pre}(f) memory grew with the corpus: the encode's peak RSS above its start "
                          f"x{rss:.4f} (bound 1.15), max_memory_reserved x{reserved or 0:.4f} (bound 1.10)")
    return faults


def leg_gen(args, peak: PeakRss) -> dict:
    size = {k: v for k, v in (("n_per", args.n_per), ("n_total", args.n_total)) if v is not None}
    t0 = time.perf_counter()
    digest, n = SCALE_SHAPES[args.shape](args.out, args.target, **size)
    return {"leg": "gen", "shape": args.shape, "tier": SCALE_TIERS[args.shape], "digest": digest,
            "bytes": n, "seconds": time.perf_counter() - t0}


def warm_up(args, bed_bytes: int = 8 << 20) -> dict:
    """A device-only encode in ``args.mode`` of the text of the first
    ``bed_bytes`` of the input's lines (a few blocks of its first
    chromosome), so that what follows runs on a warm card: its context,
    kernels and libraries loaded, as in a process that has encoded before
    (the card's start is ROADMAP E1).  The class rates it leaves are
    dropped, so the scheduler starts as in a fresh process."""
    import torch

    from starch3_tpu_torch.parallel import host, pipeline
    from starch3_tpu_torch.runtime import bed_transform_native

    with open(args.inp, "rb") as f:
        head = f.read(bed_bytes)
    text = bed_transform_native(head[: head.rfind(b"\n") + 1])[0][1]
    t0 = time.perf_counter()
    pipeline.encode_streams([text], level=args.level, device=args.device, host_assist=False, **MODES[args.mode])
    if args.device.startswith("cuda"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    host._class_rate_cache.clear()
    return {"text_bytes": len(text), "seconds": time.perf_counter() - t0}


def cli_flags(device: str | None, mode: str = "fast") -> list[str]:
    """The CLI's flags for an encode on ``device``, None for the host path:
    none on the card, the CLI's default; ``--platform=...`` otherwise; and
    ``--device-huffman`` in mode ``fast_huff``."""
    flags = [] if device == "cuda" else [f"--platform={device or 'host'}"]
    return flags + (["--device-huffman"] if mode == "fast_huff" else [])


def leg_encode(args, peak: PeakRss) -> dict:
    from starch3_tpu_torch import api, cli, runtime
    from starch3_tpu_torch.config import EncodeConfig

    cfg = EncodeConfig(use_jax=args.jax, block_size_100k=args.level, **MODES[args.mode])
    argv = [*cli_flags(args.device if args.jax else None, args.mode), f"--output={args.out}", args.inp]
    warm = warm_up(args) if args.warm_up else None
    peak.reset()
    _zero_counters()
    n_in = os.path.getsize(args.inp)
    rss0 = rss_mb()
    t0 = time.perf_counter()
    with timed_calls(runtime, "bed_transform_native") as spent:
        if args.cli:
            rc = cli.main(argv)
            if rc:
                raise SystemExit(f"encode: the CLI exited {rc} on {argv}")
        else:
            with open(args.out, "wb") as fh:
                api.compress_bed_file(args.inp, fh, cfg, chunk_bytes=args.chunk_bytes, device=args.device)
    dt = time.perf_counter() - t0
    streams = archive_metadata(args.out).streams
    text = sum(s.uncompressed_size for s in streams)
    res = {
        "leg": "encode", "jax": args.jax, "mode": args.mode, "device": args.device if args.jax else None,
        "cli": argv if args.cli else None,
        "bytes_in": n_in, "seconds": dt, "mb_per_s_bed": n_in / dt / 1e6, "text_bytes": text,
        "mb_per_s_text": text / dt / 1e6, "transform_seconds": spent["bed_transform_native"],
        "archive_digest": file_digest(args.out), "archive_bytes": os.path.getsize(args.out),
        "blocks": sum(len(s.block_bit_offsets) for s in streams), "rss_start_mb": rss0, "warm_up": warm,
    }
    res.update(_memory(args.device if args.jax else "cpu", peak))
    res.update(_counters())
    res["faults"] = counter_faults(res, args.device, args.mode) if args.jax else []
    if args.decode:
        sink = _Hasher()
        t0 = time.perf_counter()
        api.decompress_starch_file(args.out, sink)
        dt = time.perf_counter() - t0
        res["decode"] = {"seconds": dt, "bytes": sink.n, "digest": sink.h.hexdigest(),
                         "mb_per_s_bed": sink.n / dt / 1e6, "peak_rss_mb": peak.peak_mb()}
    return res


def leg_pipe(args, peak: PeakRss) -> dict:
    """``cat IN | python -m starch3_tpu_torch.cli > OUT``, the device path
    on ``args.device`` (``cli_flags``); the CLI's ``ru_maxrss`` is read
    from this process's waited-for children."""
    n_in = os.path.getsize(args.inp)
    cli = [sys.executable, "-m", "starch3_tpu_torch.cli", *cli_flags(args.device)]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, [root, os.environ.get("PYTHONPATH")])))
    t0 = time.perf_counter()
    procs = []
    try:
        with open(args.out, "wb") as out:
            procs.append(subprocess.Popen(["cat", args.inp], stdout=subprocess.PIPE))
            procs.append(subprocess.Popen(cli, stdin=procs[0].stdout, stdout=out, stderr=subprocess.PIPE, env=env))
            procs[0].stdout.close()  # the CLI holds the read end alone
            err = procs[1].communicate()[1]
            procs[0].wait()
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    cat, enc = procs
    dt = time.perf_counter() - t0
    if enc.returncode != 0 or cat.returncode != 0:
        raise SystemExit(f"pipe: cat exit {cat.returncode}, cli exit {enc.returncode}: {err.decode()[-3000:]}")
    return {
        "leg": "pipe", "device": args.device, "bytes_in": n_in, "seconds": dt, "mb_per_s_bed": n_in / dt / 1e6,
        "archive_digest": file_digest(args.out), "archive_bytes": os.path.getsize(args.out),
        "cli_ru_maxrss_mb": resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss / 1024,
    }


def _line_name(buf: bytes, start: int) -> bytes:
    return buf[start : buf.index(b"\t", start)]


def iter_chromosome_raw(fh, chunk_bytes: int = 64 << 20):
    """Each chromosome of sorted BED from ``fh`` as ``(name, raw lines)``,
    split at the lines where the first column changes: independent of
    ``api.compress_bed_stream``'s carry.  The last line may lack its
    newline.  A chunk's lines are views of it until a chromosome's are
    joined: one copy of each byte."""
    name, parts, partial = None, [], b""
    while True:
        chunk = fh.read(chunk_bytes)
        buf = partial + chunk
        cut = buf.rfind(b"\n") + 1 if chunk else len(buf)
        view, partial = memoryview(buf)[:cut], buf[cut:]
        if cut:
            ends = np.flatnonzero(np.frombuffer(buf, dtype=np.uint8, count=cut) == 10) + 1
            starts = np.concatenate(([0], ends[ends < cut]))
            i = 0
            while i < starts.size:
                nm = _line_name(buf, int(starts[i]))
                # chromosomes are contiguous: the lines of nm end at the
                # first later line of another name
                j = bisect.bisect_left(range(starts.size), True, lo=i,
                                       key=lambda k: _line_name(buf, int(starts[k])) != nm)
                stop = int(starts[j]) if j < starts.size else cut
                if nm != name:
                    if name is not None:
                        yield name.decode(), b"".join(parts)
                    name, parts = nm, []
                parts.append(view[int(starts[i]) : stop])
                i = j
        if not chunk:
            break
    if name is not None:
        yield name.decode(), b"".join(parts)


def starts_back(raw) -> int:
    """The lines of one chromosome's BED whose start is below the start of
    the line before it.  Where this is not 0 the native transform takes
    its unsorted branch: ``close_chrom`` parses the chromosome's lines
    again and sorts them by start for its union length."""
    from starch3_tpu_torch.runtime import parse_ints_native

    arr = np.frombuffer(raw, dtype=np.uint8)
    heads = np.concatenate(([0], np.flatnonzero(arr == 10) + 1))
    heads = heads[heads < arr.size]
    tabs = np.flatnonzero(arr == 9)
    first = np.searchsorted(tabs, heads)  # each line's first tab
    starts = parse_ints_native(arr, tabs[first] + 1, tabs[first + 1])
    return int(np.count_nonzero(starts[1:] < starts[:-1]))


def first_differing_block(got: bytes, got_offs, want: bytes, want_offs) -> int:
    """The index of the first bzip2 block whose bits differ between two
    streams, from their block bit offsets."""
    bits_g = np.unpackbits(np.frombuffer(got, dtype=np.uint8))
    bits_w = np.unpackbits(np.frombuffer(want, dtype=np.uint8))
    ends_g = list(got_offs[1:]) + [bits_g.size]
    ends_w = list(want_offs[1:]) + [bits_w.size]
    for i, (g0, g1, w0, w1) in enumerate(zip(got_offs, ends_g, want_offs, ends_w)):
        if not np.array_equal(bits_g[g0:g1], bits_w[w0:w1]):
            return i
    return min(len(got_offs), len(want_offs))


# one kernel of each MTF launch, so one per fast-mode batch of any class:
# the width-16 kernel, or the carry scan of the windowed kernel (widths
# 32-256)
_BATCH_MARK = ("mtf16_kernel", "carry_scan_kernel")


def gpu_busy_share(trace_path: str, skip: int = 10) -> dict:
    """The card's busy share in a ``device_trace`` file, over the steady
    state: from the ``skip``-th MTF launch (``_BATCH_MARK``, one per
    batch) to the ``skip``-th from the last, the union of the card's
    kernels, copies and sets over that span."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    gpu = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in events
                 if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    marks = sorted(e["ts"] for e in events if e.get("cat") == "kernel"
                   and any(m in e.get("name", "") for m in _BATCH_MARK))
    marks = marks[skip : len(marks) - skip]
    if len(marks) < 2:
        return {"batches": 0, "busy_share": None, "gpu_events": len(gpu)}
    lo, hi = marks[0], marks[-1]
    busy, cur0, cur1 = 0.0, None, None
    for a, b in gpu:
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if cur1 is None or a > cur1:
            if cur1 is not None:
                busy += cur1 - cur0
            cur0, cur1 = a, b
        else:
            cur1 = max(cur1, b)
    if cur1 is not None:
        busy += cur1 - cur0
    n = len(marks) - 1
    return {"batches": n, "window_ms": (hi - lo) / 1e3, "busy_ms": busy / 1e3, "busy_share": busy / (hi - lo),
            "batches_per_s": n / (hi - lo) * 1e6, "device_ms_per_batch": busy / 1e3 / n, "gpu_events": len(gpu)}


def save_block_case(text: bytes, k: int, level: int, device: str, path: str, mode: str = "fast") -> dict:
    """Block ``k`` of ``text`` at ``level`` through the BWT of ``mode``'s
    device step on ``device`` (the exact modes' ``bwt_remap``, or the fast
    sort of the class ``mode`` packs the block as), then the MTF kernel at
    the mode's width and its plain version on the same input: the input
    and both outputs go to ``path`` (a ``.pt``, as
    ``chip_smoke.check_equal`` saves a kernel's mismatch).  Returns the
    block's class and width and whether the two agree, or, where ``text``
    has no block ``k`` (the streams differ in their count of blocks),
    says so and saves nothing."""
    import torch

    from starch3_tpu_torch.ops import mtf_narrow, mtf_wide
    from starch3_tpu_torch.parallel import host, pipeline

    blocks, classes = host._split_classify(text, level)
    if k >= len(blocks):
        return {"skipped": f"block {k} of {len(blocks)}"}
    data, bits = blocks[k].data, classes[k]
    n_max = host._bucket_for(len(data))
    width = mode_width(mode, bits)
    dev = torch.device(device)
    if mode in ("ranks", "rle2"):
        raw, lens = pipeline.raw_batch([data], n_max)
        _, _, seqs = pipeline.bwt_remap(raw.to(dev), torch.from_numpy(lens).to(dev))
    else:  # fast_huff packs bits 4 as nibbles and every other class as bytes
        step_bits = bits if mode == "fast" else (4 if bits == 4 else 8)
        packed, lens, _, _ = pipeline.pack_batch([data], n_max, step_bits)
        seqs, _, _ = pipeline.bwt_of_batch(packed.to(dev), torch.from_numpy(lens).to(dev), step_bits, n_max,
                                           wide=width >= 128)
    seqs = seqs.contiguous()
    if width >= 128:
        got, want = mtf_wide.mtf_ranks_wide_batch(seqs, width), mtf_wide.mtf_ranks_wide_reference(seqs, width)
    else:
        got, want = mtf_narrow.mtf_ranks_narrow_batch(seqs, width), mtf_narrow.mtf_ranks_narrow_reference(seqs, width)
    n = len(data)
    torch.save({"block": data, "bits": bits, "mode": mode, "width": width, "seqs": seqs.cpu(), "got": got.cpu(),
                "want": want.cpu()}, path)
    return {"bits": bits, "mode": mode, "width": width, "n": n,
            "kernel_equals_plain": bool(torch.equal(got[:, :n], want[:, :n]))}


def _device_run(texts, chroms, want, args) -> dict:
    """One device-only encode of ``texts`` in ``args.mode``, counters set
    to 0 just before it and read just after, every stream held to
    ``want``, REF's ``(metadata, stream)`` of the same chromosome.  A
    differing stream's text and record (``.json``) go to
    ``args.mismatch_dir`` as it is found; after the counters are read, its
    first differing block's MTF case (``save_block_case``) joins the
    record.  The host re-encodes of tied blocks (``encode_block_fragment``,
    which the drain calls on the driver's thread) are timed by thread
    (``reencode``)."""
    from starch3_tpu_torch.codec import encoder
    from starch3_tpu_torch.parallel import pipeline

    _zero_counters()
    bad, blocks, n = [], 0, 0
    t0 = time.perf_counter()
    with timed_calls(encoder, "encode_block_fragment") as spent:
        for i, enc in enumerate(pipeline.encode_streams_iter(
                iter(texts), level=args.level, device=args.device, host_assist=False, **MODES[args.mode])):
            meta, stream = want[i]
            n, blocks = i + 1, blocks + len(enc.block_bit_offsets)
            if meta.chromosome == chroms[i] and enc.data == stream and list(enc.block_bit_offsets) == list(
                    meta.block_bit_offsets):
                continue
            k = first_differing_block(enc.data, enc.block_bit_offsets, stream, meta.block_bit_offsets)
            bad.append({"stream": i, "chrom": chroms[i], "ref_chrom": meta.chromosome, "first_block": k})
            os.makedirs(args.mismatch_dir, exist_ok=True)
            base = os.path.join(args.mismatch_dir, f"scale-mismatch-{chroms[i]}")
            with open(base + ".text", "wb") as f:
                f.write(texts[i])
            with open(base + ".json", "w") as f:
                json.dump(bad[-1], f)
    dt = time.perf_counter() - t0
    run = {"mode": args.mode, "seconds": dt, "mb_per_s_text": sum(map(len, texts)) / dt / 1e6, "streams": n,
           "blocks": blocks, "mismatches": bad,
           "reencode": {"seconds": spent["encode_block_fragment"], "calls": spent["encode_block_fragment_calls"],
                        "by_thread": spent["encode_block_fragment_threads"]}}
    run.update(_counters())
    for rec in bad:  # its launches come after the counters were read
        i, k = rec["stream"], rec["first_block"]
        try:
            rec["mtf"] = save_block_case(texts[i], k, args.level, args.device, os.path.join(
                args.mismatch_dir, f"mismatch-scale-{args.mode}-{chroms[i]}-block{k}.pt"), args.mode)
        except Exception as e:  # the stream's mismatch fails the leg all the same
            rec["mtf"] = {"error": repr(e)}
        with open(os.path.join(args.mismatch_dir, f"scale-mismatch-{chroms[i]}.json"), "w") as f:
            json.dump(rec, f)
    st, sched = run["device_stats"], run["scheduler_stats"]
    faults = []
    if bad or n != len(want):
        faults.append(f"{len(bad)} streams differ from REF's, {n} streams of {len(want)}")
    if st.get("blocks", 0) != blocks:
        faults.append(f"device blocks {st.get('blocks', 0)} != all blocks {blocks}")
    tier = SCALE_TIERS[args.shape]
    if st.get(f"blocks_bits{tier}", 0) != blocks:
        faults.append(f"bits-{tier} blocks {st.get(f'blocks_bits{tier}', 0)} != all blocks {blocks}: "
                      f"a block of the {args.shape} corpus is not of its tier")
    if sched["abandoned_batches"] or sched["demotions"]:
        faults.append(f"the device-only encode fell back: {sched}")
    run["faults"] = faults + counter_faults(run, args.device, args.mode)
    return run


def host_run(texts, want, level: int) -> dict:
    """The host path's encode of the same texts, every core on the blocks
    of one stream after another (``bz2_compress_ex``), without the feed
    that bounds ``encode``'s host path: the rate of the host cores that a
    device-only run is held to.  Every stream must equal REF's."""
    from starch3_tpu_torch.codec.encoder import bz2_compress_ex

    differ = 0
    t0 = time.perf_counter()
    for text, (_meta, stream) in zip(texts, want):
        differ += bz2_compress_ex(text, level, workers=os.cpu_count()).data != stream
    dt = time.perf_counter() - t0
    return {"seconds": dt, "mb_per_s_text": sum(map(len, texts)) / dt / 1e6, "streams_differ": differ,
            "workers": os.cpu_count()}


def bz2_run(texts, want, level: int) -> dict:
    """``bz2.compress(text, level)`` of every text on every core (libbz2
    leaves the GIL), each held to REF's stream of the same chromosome,
    which the device-only streams equal: the device path against libbz2
    itself."""
    import bz2

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(os.cpu_count()) as pool:
        got = pool.map(lambda text: bz2.compress(text, level), texts)
        differ = sum(g != stream for g, (_meta, stream) in zip(got, want))
    return {"seconds": time.perf_counter() - t0, "streams_differ": differ}


def write_texts(path: str, chroms, texts) -> None:
    """A corpus's transformed texts in one file: a JSON line of the
    chromosomes and the texts' lengths, then the texts."""
    with open(path + ".tmp", "wb") as f:
        f.write(json.dumps({"chroms": chroms, "lens": [len(t) for t in texts]}).encode() + b"\n")
        for t in texts:
            f.write(t)
    os.replace(path + ".tmp", path)


def read_texts(path: str) -> tuple[list, list]:
    """``write_texts``' chromosomes and texts (views of one buffer)."""
    with open(path, "rb") as f:
        head = json.loads(f.readline())
        buf = memoryview(f.read())
    ends = np.cumsum([0] + head["lens"]).tolist()
    return head["chroms"], [buf[a:b] for a, b in zip(ends, ends[1:])]


def leg_device(args, peak: PeakRss) -> dict:
    """Device only in ``args.mode``, twice: an encode traced by
    ``device_trace``, which also warms the process, then the timed one
    (with ``args.untraced`` the timed one alone; with ``args.traced_only``
    the traced one alone, whose figures are then the leg's: for a corpus
    whose rate the driver's host re-encodes bound, which tracing does not
    slow).
    In each, every stream equals REF's stream of its chromosome, every
    block ran on the device and is of the tier of ``args.shape``, nothing
    was abandoned and the device was never benched, and the MTF kernels
    launched once per batch at the width of its class in the mode.  With
    ``args.host_rate`` the host cores then encode the same texts
    (``host_run``); with ``args.bz2`` every stream is held to
    ``bz2.compress`` of its text (``bz2_run``)."""
    from starch3_tpu_torch.format.archive import StarchReader
    from starch3_tpu_torch.observability import device_trace
    from starch3_tpu_torch.runtime import bed_transform_native

    k = args.streams  # the first k chromosomes, or None: every one
    with open(args.ref, "rb") as f:
        want = list(StarchReader.from_bytes(f.read()).iter_streams())[:k]

    def transform() -> tuple[list, list, list | None, float]:
        """Every chromosome's text, made on every core (the native transform
        leaves the GIL), with the lines whose start goes back in each
        (``starts_back``, counted beside it); or the texts alone, read from
        ``args.texts`` where an earlier leg wrote them; and the seconds
        it took.  With ``args.streams``, the first chromosomes' alone."""
        t0 = time.perf_counter()
        if args.texts and os.path.exists(args.texts):
            chroms, texts = read_texts(args.texts)
            return chroms[:k], texts[:k], None, time.perf_counter() - t0
        chroms, texts = [], []
        with open(args.inp, "rb") as f, concurrent.futures.ThreadPoolExecutor(os.cpu_count()) as pool:
            jobs = [(chrom, pool.submit(bed_transform_native, raw), pool.submit(starts_back, raw))
                    for chrom, raw in iter_chromosome_raw(f, args.chunk_bytes)]
            for chrom, job, _ in jobs:
                groups = job.result()
                if groups is None or len(groups) != 1:
                    raise SystemExit(f"{chrom}: the native transform gave {groups and len(groups)} groups")
                chroms.append(chrom)
                texts.append(groups[0][1])
            back = [b.result() for _, _, b in jobs]
        if args.texts:
            write_texts(args.texts, chroms, texts)
        return chroms[:k], texts[:k], back[:k], time.perf_counter() - t0

    # every text is made before the encodes, whose rate is the device
    # path's, while the profiler starts
    traced = None
    with concurrent.futures.ThreadPoolExecutor(1) as bg:
        made = bg.submit(transform)
        if not args.untraced:
            t0 = time.perf_counter()
            with device_trace(args.trace_dir, args.device):
                trace_start_s = time.perf_counter() - t0  # the profiler's own start
                chroms, texts, _, _ = made.result()
                traced = _device_run(texts, chroms, want, args)
            traced["trace_start_seconds"] = trace_start_s
            traced["trace"] = gpu_busy_share(os.path.join(args.trace_dir, sorted(os.listdir(args.trace_dir))[0]))
        chroms, texts, back, transform_s = made.result()
    res = {"leg": "device", "device": args.device, "streams": len(texts), "ref_streams": len(want),
           "text_bytes": sum(map(len, texts)), "transform_seconds": transform_s,
           # the chromosomes whose starts go back (the transform's unsorted branch) and their lines that do
           "starts_back": back and {"chroms": sum(map(bool, back)), "of": len(back), "lines": sum(back)}}
    if args.traced_only:  # the one run, traced, is the leg's
        res.update(traced)
    else:
        if traced is not None:
            res["traced"] = traced
        res.update(_device_run(texts, chroms, want, args))
        if traced is not None:
            res["faults"] = res["faults"] + [f"traced: {f}" for f in traced["faults"]]
    res.update(_memory(args.device, peak))
    if args.host_rate:
        res["host"] = host_run(texts, want, args.level)
        if res["host"]["streams_differ"]:
            res["faults"] = res["faults"] + [f"host path: {res['host']['streams_differ']} streams differ from REF's"]
    if args.bz2:
        res["bz2"] = bz2_run(texts, want, args.level)
        if res["bz2"]["streams_differ"]:
            res["faults"] = res["faults"] + [f"{res['bz2']['streams_differ']} streams differ from bz2.compress"]
    return res


def prefix_archive(data: bytes, k: int) -> bytes:
    """An archive of the first ``k`` streams of the archive ``data``, its
    streams and their metadata as they are, written by the port's
    ``StarchWriter``: the archive of the corpus's first ``k`` chromosomes."""
    from starch3_tpu_torch.format.archive import StarchReader, StarchWriter

    reader = StarchReader.from_bytes(data)
    meta = reader.metadata
    writer = StarchWriter(note=meta.note, compression=meta.compression_format)
    for sm, stream in list(reader.iter_streams())[:k]:
        writer.add_stream(sm.chromosome, stream, uncompressed_size=sm.uncompressed_size, line_count=sm.line_count,
                          base_count_nonunique=sm.base_count_nonunique, base_count_unique=sm.base_count_unique,
                          block_bit_offsets=sm.block_bit_offsets)
    return writer.finish()


def corpus_prefix(path: str, k: int | None, chunk_bytes: int = 64 << 20) -> dict:
    """The SHA-256 and length of the corpus's first ``k`` chromosomes
    (``iter_chromosome_raw``; every chromosome with None), and how many
    there are."""
    h, n, streams = hashlib.sha256(), 0, 0
    with open(path, "rb") as f:
        for _chrom, raw in iter_chromosome_raw(f, chunk_bytes):
            if k is not None and streams == k:
                break
            h.update(raw)
            n, streams = n + len(raw), streams + 1
    return {"digest": h.hexdigest(), "bytes": n, "streams": streams}


def leg_decode(args, peak: PeakRss) -> dict:
    """``api.decompress_starch_bytes(use_jax=True)`` of the archive (with
    ``args.streams``, of ``prefix_archive`` of its first streams) on
    ``args.device``: the output must be the bytes of the corpus's same
    chromosomes (``corpus_prefix``) and ``decode_blocks`` the decoded
    archive's blocks.  The host's share, the Huffman walk
    (``read_stream_blocks``), ``rle1_decode`` and the CRCs, is timed
    around the functions ``decode_streams`` calls; the device decode holds
    the whole archive, every block and the whole output, so its memory
    grows with the archive."""
    from starch3_tpu_torch import api
    from starch3_tpu_torch.format.archive import StarchReader
    from starch3_tpu_torch.parallel import pipeline

    with open(args.archive, "rb") as f:
        data = f.read()
    if args.streams is not None:
        data = prefix_archive(data, args.streams)
    metas = StarchReader.from_bytes(data).metadata.streams
    blocks = sum(len(m.block_bit_offsets) for m in metas)
    want = corpus_prefix(args.corpus, args.streams)
    _zero_counters()
    rss0 = rss_mb()
    t0 = time.perf_counter()
    with timed_calls(pipeline, "read_stream_blocks", "rle1_decode", "crc32_bytes") as host_s:
        out = api.decompress_starch_bytes(data, use_jax=True, device=args.device)
    dt = time.perf_counter() - t0
    res = {
        "leg": "decode", "device": args.device, "streams": len(metas), "archive_bytes": len(data),
        "archive_blocks": blocks, "seconds": dt, "bytes": len(out), "digest": hashlib.sha256(out).hexdigest(),
        "mb_per_s_bed": len(out) / dt / 1e6, "corpus": want, "rss_start_mb": rss0,
        "host_ms_per_block": {k: host_s[k] / blocks * 1e3 for k in ("read_stream_blocks", "rle1_decode",
                                                                     "crc32_bytes")},
        "host_calls": {k: host_s[f"{k}_calls"] for k in ("read_stream_blocks", "rle1_decode", "crc32_bytes")},
    }
    del out
    res.update(_memory(args.device, peak))
    res.update(_counters())
    st = res["device_stats"]
    faults = []
    if (res["digest"], res["bytes"], res["streams"]) != (want["digest"], want["bytes"], want["streams"]):
        faults.append(f"the output {res['digest']} {res['bytes']} of {res['streams']} streams != the corpus's "
                      f"{want}")
    if st.get("decode_blocks", 0) != blocks or not st.get("decode_batches"):
        faults.append(f"decode blocks {st.get('decode_blocks', 0)} in {st.get('decode_batches', 0)} batches "
                      f"!= the archive's {blocks} blocks")
    res["faults"] = faults
    return res


@contextlib.contextmanager
def counted_streams(pipeline):
    """Counts the streams and blocks that ``pipeline.encode_streams``
    returns inside it, for code that looks the name up when it calls it
    (the multi-host encode of a host's share)."""
    real = pipeline.encode_streams
    seen = {"streams": 0, "blocks": 0}

    def call(*args, **kw):
        out = real(*args, **kw)
        seen["streams"] += len(out)
        seen["blocks"] += sum(len(e.block_bit_offsets) for e in out)
        return out

    pipeline.encode_streams = call
    try:
        yield seen
    finally:
        pipeline.encode_streams = real


# the multi-host entry's stages, each the function the entry calls by name
HOST_STAGES = {
    "read": ("starch3_tpu_torch.cli", ("_read_input",)),
    "parse": ("starch3_tpu_torch.bed.parser", ("parse_bed",)),
    "transform": ("starch3_tpu_torch.transform.delta", ("transform_chrom",)),
    "encode": ("starch3_tpu_torch.parallel.pipeline", ("encode_streams",)),
    "gather": ("starch3_tpu_torch.parallel.distributed", ("gather_results_dist", "gather_results_manifest")),
}
# the one-host entry's: the file entry, and its feed's native transform within it
ONE_HOST_STAGES = {
    "file_entry": ("starch3_tpu_torch.api", ("compress_bed_file",)),
    "feed_transform": ("starch3_tpu_torch.runtime", ("bed_transform_native",)),
}


def leg_host(args, peak: PeakRss) -> dict:
    """One host process of a multi-host encode: the port's CLI entry,
    ``cli.main(ARGV)`` with a user's argv (``--num-hosts``, ``--host-id``,
    ``--coordinator`` or ``--manifest-dir``), timed around the functions it
    calls (``HOST_STAGES``), then the counters its encode left.  Its share's
    chromosomes are the transform's calls, its streams and blocks what
    ``encode_streams`` returned; its own peak RSS is above the RSS before
    the entry, also per GB of the BED it read (each host reads it whole).
    Without ``--num-hosts`` it is the one-host CLI (BASELINE config 1's
    command), timed around ``ONE_HOST_STAGES``."""
    from starch3_tpu_torch import cli
    from starch3_tpu_torch.parallel import pipeline

    opts = cli._parse_args(args.cli)
    device, host_id = opts["platform"], opts["host_id"] or 0
    n_in = os.path.getsize(opts["input"])
    peak.reset()
    _zero_counters()
    rss0 = rss_mb()
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        share = stack.enter_context(counted_streams(pipeline))
        stages = HOST_STAGES if (opts["num_hosts"] or 0) > 1 else ONE_HOST_STAGES
        spent = {stage: [stack.enter_context(timed_calls(importlib.import_module(m), *names)), names]
                 for stage, (m, names) in stages.items()}
        rc = cli.main(args.cli)
    dt = time.perf_counter() - t0
    res = {
        "leg": "host", "host_id": host_id, "device": device, "cli_exit": rc, "bytes_in": n_in, "seconds": dt,
        "mb_per_s_bed": n_in / dt / 1e6,
        "chromosomes": spent["transform"][0]["transform_chrom_calls"] if "transform" in spent else None,
        "streams": share["streams"], "blocks": share["blocks"], "rss_start_mb": rss0,
        "stage_seconds": {stage: sum(d[n] for n in names) for stage, (d, names) in spent.items()},
        "output_bytes": os.path.getsize(opts["output"]) if opts["output"] and os.path.exists(opts["output"]) else 0,
    }
    res.update(_memory(device if opts["jax"] else "cpu", peak))
    res["own_peak_rss_mb"] = res["peak_rss_mb"] - rss0
    res["own_peak_rss_mb_per_gb"] = res["own_peak_rss_mb"] / (n_in / 1e9)
    res.update(_counters())
    mode = "fast_huff" if opts["device_huffman"] else "fast"
    faults = [f"the CLI exited {rc}"] if rc else []
    if opts["jax"]:
        faults += launch_faults(res, device, mode)
    res["faults"] = [f"host {host_id}: {f}" for f in faults]
    return res


ONEBLOCK_RUNS = 3  # the block's encodes in one process: its key's warm-up, capture and a replay


def leg_oneblock(args, peak: PeakRss) -> dict:
    """BASELINE config 1's one block on the card: the input's one
    chromosome transformed by the native transform, then encoded device
    only (``encode_streams(host_assist=False)``) ``args.runs`` times in
    this process (``ONEBLOCK_RUNS``): its batch key's warm-up (eager), its
    graph capture, then a replay.  Each run is timed, with the counters set to 0 just before it
    and read just after; each run's stream must equal ``bz2.compress(text,
    9)``, its one block and batch must be on the device, of bits 4, and its
    MTF kernel launched once per batch at width 16 on a card
    (``launch_faults``), with nothing abandoned or benched."""
    import bz2

    from starch3_tpu_torch.parallel import pipeline
    from starch3_tpu_torch.runtime import bed_transform_native

    with open(args.inp, "rb") as f:
        groups = bed_transform_native(f.read())
    if groups is None or len(groups) != 1:
        raise SystemExit(f"{args.inp}: the native transform gave {groups and len(groups)} groups, not one")
    text = groups[0][1]
    want = bz2.compress(bytes(text), 9)
    runs, faults = [], []
    for k in range(ONEBLOCK_RUNS):
        _zero_counters()
        t0 = time.perf_counter()
        enc = pipeline.encode_streams([text], level=9, device=args.device, host_assist=False)[0]
        run = {"seconds": time.perf_counter() - t0, "equal": enc.data == want,
               "blocks": len(enc.block_bit_offsets)}
        run.update(_counters())
        st, sched = run["device_stats"], run["scheduler_stats"]
        pre = f"run {k}"
        if not run["equal"]:
            faults.append(f"{pre}: the stream != bz2.compress(text, 9)")
        if (run["blocks"], st.get("blocks_bits4", 0), st.get("batches", 0)) != (1, 1, 1):
            faults.append(f"{pre}: {run['blocks']} blocks, {st.get('blocks_bits4', 0)} on the device at bits 4 in "
                          f"{st.get('batches', 0)} batches, not one block in one batch")
        if sched["abandoned_batches"] or sched["demotions"]:
            faults.append(f"{pre}: the device-only encode fell back: {sched}")
        faults += [f"{pre}: {f}" for f in launch_faults(run, args.device)]
        runs.append(run)
    return {"leg": "oneblock", "device": args.device, "bed_bytes": os.path.getsize(args.inp),
            "text_bytes": len(text), "runs": runs, "faults": faults}


def free_port() -> int:
    """A localhost port that was free a moment ago."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


PORT_TRIES = 3  # gloo rendezvous ports tried, where another process took the first
HOSTS = 2  # config 5's N >= 2 hosts, as processes on one machine


def _run_hosts(args, how: str, d: str, attempt: int) -> dict:
    """``HOSTS`` host legs started together, each
    ``scale_run host -- [--platform=D] --num-hosts=2 --host-id=I HOW
    --output=FILE BED`` (``cli_flags``: no flag on the card), in this
    leg's process group; when one fails or the
    limit passes, every host still running is killed.  Returns the wall
    time for all and each host's record: its exit, its JSON line, the
    bytes it wrote besides its line, and the end of its standard error."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, [root, os.environ.get("PYTHONPATH")])))
    base = [os.path.join(d, f"host{h}-{attempt}") for h in range(HOSTS)]
    cmds = [[sys.executable, "-m", "starch3_tpu_torch.scale_run", "host", "--", *cli_flags(args.device),
             f"--num-hosts={HOSTS}", f"--host-id={h}", how, f"--output={base[h]}.starch", args.inp]
            for h in range(HOSTS)]
    procs = []
    launched = time.time()
    t0 = time.perf_counter()
    try:
        for b, cmd in zip(base, cmds):
            with open(b + ".out", "wb") as fo, open(b + ".err", "wb") as fe:
                procs.append(subprocess.Popen(cmd, cwd=root, env=env, stdout=fo, stderr=fe))
        deadline = time.monotonic() + args.host_limit_s
        while any(p.poll() is None for p in procs) and time.monotonic() < deadline:
            if any(p.returncode for p in procs):  # one failed: the others would wait for it
                break
            time.sleep(0.05)
        wall = time.perf_counter() - t0
    finally:
        alive = [p.poll() is None for p in procs]
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    hosts = []
    for h, (b, p) in enumerate(zip(base, procs)):
        with open(b + ".out", "rb") as f:
            lines = f.read().splitlines()
        with open(b + ".err", "rb") as f:
            err = f.read().decode(errors="replace")
        line = {}
        if lines:
            try:
                line = json.loads(lines[-1])
            except ValueError:
                lines.append(b"")
        out = b + ".starch"
        hosts.append(dict(line, exit=p.returncode, killed=alive[h], launched_at=launched,
                          wrote_bytes=(os.path.getsize(out) if os.path.exists(out) else 0) + sum(map(len, lines[:-1])),
                          stderr_tail=err[-3000:] if p.returncode else ""))
    return {"seconds": wall, "hosts": hosts, "archive": base[0] + ".starch"}


def multihost_faults(res: dict) -> list[str]:
    """The multi-host leg's gates, each naming the transport and the host:
    every host exits 0 within its limit, abandons no batch and launches
    its MTF kernels once per device batch at its class's width (the host
    leg's own faults); host 0's archive is REF's bytes and the other hosts
    write nothing."""
    pre = f"multihost {res['transport']}"
    faults = []
    for h, host in enumerate(res["host_lines"]):
        if host["exit"] != 0:
            why = " (killed at its limit)" if host["killed"] else ""
            faults.append(f"{pre} host {h}: exit {host['exit']}{why}: {host['stderr_tail'][-1500:]}")
        abandoned = host.get("scheduler_stats", {}).get("abandoned_batches", 0)
        if abandoned:
            faults.append(f"{pre} host {h}: {abandoned} abandoned batches")
        faults += [f"{pre} {f}" for f in host.get("faults", [])]
        if h and host["wrote_bytes"]:
            faults.append(f"{pre} host {h} wrote {host['wrote_bytes']} bytes, where only host 0 writes")
    if (res["archive_digest"], res["archive_bytes"]) != (res["ref_digest"], res["ref_bytes"]):
        faults.append(f"{pre} host 0: archive {res['archive_digest']} of {res['archive_bytes']} bytes != REF's "
                      f"{res['ref_digest']} of {res['ref_bytes']}")
    return faults


def leg_multihost(args, peak: PeakRss) -> dict:
    """BASELINE config 5 on one machine: ``HOSTS`` processes of one
    multi-host encode of BED (``host`` legs, the CLI with a user's argv)
    on ``args.device``, over a gloo process group on a free localhost port
    or through a manifest directory beside REF.  Host 0's archive must be
    REF's bytes, and the other hosts write nothing.  Where host 0 finds its
    gloo port taken between the choice and its bind, the hosts run again
    on another port (``port_retries``)."""
    n_in = os.path.getsize(args.inp)
    retries = []
    with tempfile.TemporaryDirectory(prefix="s3t-hosts-", dir=os.path.dirname(os.path.abspath(args.ref))) as d:
        for attempt in range(PORT_TRIES):
            how = (f"--coordinator=127.0.0.1:{free_port()}" if args.transport == "gloo"
                   else f"--manifest-dir={os.path.join(d, f'manifest{attempt}')}")
            run = _run_hosts(args, how, d, attempt)
            taken = args.transport == "gloo" and any(
                h["exit"] and "Address already in use" in h["stderr_tail"] for h in run["hosts"])
            if not taken or attempt == PORT_TRIES - 1:
                break
            retries.append(how)
        arc = run["archive"]
        got = (file_digest(arc), os.path.getsize(arc)) if os.path.exists(arc) else (None, 0)
    res = {
        "leg": "multihost", "transport": args.transport, "hosts": HOSTS, "device": args.device, "bytes_in": n_in,
        "seconds": run["seconds"], "mb_per_s_bed": n_in / run["seconds"] / 1e6, "archive_digest": got[0],
        "archive_bytes": got[1], "ref_digest": file_digest(args.ref), "ref_bytes": os.path.getsize(args.ref),
        "other_hosts_bytes": sum(h["wrote_bytes"] for h in run["hosts"][1:]), "port_retries": retries,
        "host_lines": run["hosts"],
    }
    res["faults"] = multihost_faults(res)
    return res


def mem_available() -> int:
    """``MemAvailable`` of ``/proc/meminfo``, in bytes."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("no MemAvailable in /proc/meminfo")


def config5_target(target: int, mem: int, free: int, host_mb_per_gb: float, start_mb: float,
                   archive_ratio: float, margin: float = 0.8, chrom_bytes: int = 60_000_000) -> dict:
    """The largest corpus that BASELINE config 5's run can hold, up to
    ``target`` bytes of BED: two hosts, each ``host_mb_per_gb`` MB of its
    own a GB of BED above its start of ``start_mb``, within ``margin`` of
    ``mem`` bytes available; the corpus and three archives of
    ``archive_ratio`` of it within ``margin`` of ``free`` bytes of disk.
    Less the most a last whole chromosome adds (``chrom_bytes``), since the
    writer appends whole ones until it reaches its target."""
    by_mem = (margin * mem / 2 - start_mb * 1e6) / (host_mb_per_gb * 1e6) * 1e9
    by_disk = margin * free / (1 + 3 * archive_ratio)
    fit = int(min(by_mem, by_disk)) - chrom_bytes
    return {"target": min(target, fit), "asked": target, "by_memory": int(by_mem), "by_disk": int(by_disk),
            "cut_by": None if fit >= target else ("memory" if by_mem <= by_disk else "disk")}


CONFIG5_ARCHIVE_RATIO = 0.15  # an archive's bytes a byte of BED, at most (bits 4: 0.099)
# a host's own peak RSS a GB of BED, and its RSS before its encode, as
# ``multihost`` measured them on an H100's host at 1.1e9 bytes (PERF.md §6)
CONFIG5_HOST_MB_PER_GB = 6369.0
CONFIG5_START_MB = 4744.0
CONFIG5_LIMIT_S = 900.0  # each of config 5's legs


def leg_config5(args, peak: PeakRss) -> dict:
    """BASELINE config 5 at its stated scale, once: the room checked first
    (``config5_target``: ``MemAvailable`` and the free disk of
    ``args.dir``), then in child processes ``gen`` of the 3-column scale
    corpus at the target that fits, the host path's archive (``encode``)
    and ``multihost`` over a manifest directory, each leg's line kept."""
    os.makedirs(args.dir, exist_ok=True)
    room = config5_target(args.target, mem_available(), shutil.disk_usage(args.dir).free, CONFIG5_HOST_MB_PER_GB,
                          CONFIG5_START_MB, CONFIG5_ARCHIVE_RATIO)
    room.update(mem_available=mem_available(), disk_free=shutil.disk_usage(args.dir).free)
    print(json.dumps({"room": room}), flush=True)
    bed, ref = os.path.join(args.dir, "config5.bed"), os.path.join(args.dir, "config5-a.starch")
    res = {"leg": "config5", "room": room, "legs": {}}
    t0 = time.perf_counter()
    try:
        for name, leg in (("gen", ["gen", bed, room["target"]]), ("a", ["encode", bed, ref]),
                          ("multihost", ["multihost", bed, ref, "--transport", "manifest", "--host-limit-s",
                                         CONFIG5_LIMIT_S])):
            run = spawn(leg, CONFIG5_LIMIT_S)
            lines = run.stdout.decode().splitlines()
            res["legs"][name] = json.loads(lines[-1]) if lines else {"exit": run.returncode}
            print(json.dumps({name: res["legs"][name]}), flush=True)
            if run.returncode:
                res["faults"] = [f"{name}: exit {run.returncode}: {run.stderr.decode()[-3000:]}"]
                break
        else:
            res["faults"] = res["legs"]["multihost"]["faults"]
    finally:
        for path in (bed, ref):
            if os.path.exists(path):
                os.remove(path)
    res["seconds"] = time.perf_counter() - t0
    return res


STATED_PREFIX = 1_100_000_000  # (b)'s prefix corpus: whole chromosomes to phase 13's 1.1e9 bytes
STATED_LIMIT_S = 900.0  # each leg of a stated-scale run


class Stated(typing.NamedTuple):
    """A BASELINE config that ``leg_stated`` runs at its stated scale, by
    its shape in ``corpus.SCALE_SHAPES`` (whose writer's ``n_total`` is
    that scale)."""
    # what its device-only leg holds a byte of BED above ``CONFIG5_START_MB``:
    # every chromosome's raw lines while it transforms them, and every text
    # after (0.15 of the BED at config 4, 0.72 at reads)
    mem_per_byte: float
    largest_chrom: int  # its largest chromosome's bytes (chr1's), at most


# on a shape of ``corpus.SCALE_UNSORTED`` (config 4) the leg also runs (a)
# and (d) on ``gigabyte_bed``'s sorted bytes of the same size, its twin
STATED = {"config4": Stated(1.5, 200_000_000), "reads": Stated(2.0, 120_000_000)}


def stated_target(shape: str, target: int, mem: int, free: int, margin: float = 0.8) -> dict:
    """The largest corpus of ``shape`` that its stated-scale run can hold,
    up to ``target`` bytes of BED: the device-only leg's memory
    (``Stated.mem_per_byte`` above ``CONFIG5_START_MB``) within ``margin``
    of ``mem`` bytes available, and the corpus (with config 4's sorted
    twin), the 1.1e9-byte prefix and the archives (a), (b) half and whole
    (and the twin's (a)) of ``CONFIG5_ARCHIVE_RATIO`` within ``margin`` of
    ``free`` bytes of disk.  Less the largest chromosome, since the writer
    appends whole ones."""
    st = STATED[shape]
    beds, archives = (2, 4) if shape in SCALE_UNSORTED else (1, 3)
    by_mem = (margin * mem - CONFIG5_START_MB * 1e6) / st.mem_per_byte
    by_disk = (margin * free - STATED_PREFIX) / (beds + archives * CONFIG5_ARCHIVE_RATIO)
    fit = int(min(by_mem, by_disk)) - st.largest_chrom
    return {"target": min(target, fit), "asked": target, "by_memory": int(by_mem), "by_disk": int(by_disk),
            "cut_by": None if fit >= target else ("memory" if by_mem <= by_disk else "disk")}


def _leg_summary(line: dict) -> dict:
    """A stated-scale leg's figures: MB/s of BED and of text, device blocks
    of all blocks, blocks and tie re-encodes by class and the seconds of
    those re-encodes by thread, the transform's seconds, the busy share of
    (d)'s traced run and its hold to ``bz2.compress``, and the starts that
    go back."""
    out = {k: line[k] for k in ("seconds", "mb_per_s_bed", "mb_per_s_text", "text_bytes", "blocks",
                                "transform_seconds", "starts_back", "bytes", "digest",
                                "reencode", "bz2")
           if k in line}
    st = line.get("device_stats")
    if st is not None:
        out["device_blocks"] = st.get("blocks", 0)
        ran = {c: v for c, v in line["per_class"].items() if v["blocks"]}
        out["blocks_by_class"] = {c: v["blocks"] for c, v in ran.items()}
        out["tie_reencodes"] = {c: v["tie_reencodes"] for c, v in ran.items()}
        out["scheduler_stats"] = line["scheduler_stats"]
        out["width_launches"] = line["width_launches"]
    traced = line.get("traced", line)  # a traced-only leg's one run is the leg
    if "trace" in traced:
        out["traced_busy_share"] = traced["trace"].get("busy_share")
        out["traced_batches"] = traced["trace"].get("batches")
    if "decode" in line:
        out["decode"] = {k: line["decode"][k] for k in ("seconds", "mb_per_s_bed", "digest", "bytes")}
    for k in ("max_memory_reserved", "peak_rss_mb", "rss_start_mb"):
        if k in line:
            out[k] = line[k]
    out["times"] = line.get("times")
    return out


def stated_faults(shape: str, legs: dict) -> list[str]:
    """The gates of a stated-scale run on its legs (each leg's own gates
    failed it already: streams against (a)'s and ``bz2.compress``, tiers,
    launches by width, fallbacks): the hybrids' (``hybrid_faults``: (b)'s
    archive equals (a)'s, the prefix's streams are (a)'s first, nothing
    abandoned, memory from prefix to whole within (f)'s bounds, and no
    demotion where (d) beats (a)'s MB/s of text); (e) gives back the
    corpus; on config 4 some chromosome's starts go back.  The memory bounds hold where the prefix
    is the 1.1e9-byte one, which runs past the point where the encode's
    memory levels off (phase 13 (f)); a smaller one, as on the CPU, does
    not, and its growth is only printed."""
    a, dv, full = legs["a"], legs["d"], legs["gen"]
    host_text = dv["text_bytes"] / a["seconds"] / 1e6
    faults = hybrid_faults("", legs, a, dv["mb_per_s_text"], host_text, dv["mb_per_s_text"] >= host_text,
                           memory=legs["gen_prefix"]["bytes"] >= STATED_PREFIX)
    dec = legs["b"]["decode"]
    if (dec["digest"], dec["bytes"]) != (full["digest"], full["bytes"]):
        faults.append(f"(e) decode {dec['digest']} of {dec['bytes']} bytes != the corpus's {full['digest']} of "
                      f"{full['bytes']}")
    if shape in SCALE_UNSORTED and not (dv.get("starts_back") or {}).get("chroms"):
        faults.append(f"(d) no chromosome's starts go back: {dv.get('starts_back')}")
    return [f"{shape} {f}" for f in faults]


def leg_stated(args, peak: PeakRss) -> dict:
    """A BASELINE config at its stated scale (``STATED``, by the leg's
    name: ``config4``, ``reads``), once: the room checked first
    (``stated_target``: ``MemAvailable`` and the free disk of
    ``args.dir``), then in child processes forked by a
    ``leg_fork.LegForker``: ``gen`` of the corpus at the target that fits
    and of its prefix, whole chromosomes to 1.1e9 bytes (to half the
    target where that is less; written together); (a) the host path's
    archive; (b) the hybrid on the prefix and on the whole corpus, with (e)
    the decode of the whole one's archive; (d) device only under
    ``STARCH3_TPU_NO_HOST_FALLBACK=1``, traced then timed, then held to
    ``bz2.compress`` (``--bz2``).  On config 4 then, one leg at a time as
    before, the sorted twin: ``gen`` of ``gigabyte_bed``'s bytes of the
    corpus's size, ``args.n_total / 50`` intervals a chromosome (its
    default 2,000,000 without ``--n-total``: config 4's default 100M / 50),
    its (a), and its (d) timed alone.  Every
    leg's figures (``_leg_summary``) are printed as it ends; the gates are
    ``stated_faults``.  What it wrote in ``args.dir`` is removed."""
    import threading

    from starch3_tpu_torch.leg_fork import LegForker, LegTimeout, leg_times

    shape = args.leg
    os.makedirs(args.dir, exist_ok=True)
    mem, free = mem_available(), shutil.disk_usage(args.dir).free
    room = dict(stated_target(shape, args.target, mem, free), mem_available=mem, disk_free=free)
    print(json.dumps({"room": room}), flush=True)
    path = {k: os.path.join(args.dir, f"{shape}-{k}") for k in (
        "corpus.bed", "prefix.bed", "sorted.bed", "a.starch", "b_half.starch", "b.starch", "sorted-a.starch")}
    traces = [os.path.join(args.dir, f"{shape}-trace{i}") for i in range(2)]
    no_fallback = {"STARCH3_TPU_NO_HOST_FALLBACK": "1"}
    res = {"leg": shape, "room": room, "legs": {}, "faults": []}
    printing = threading.Lock()  # the two gen legs end on threads of their own
    t0 = time.perf_counter()

    def leg(forker, name, argv, env=None) -> dict:
        run = forker.run(argv, STATED_LIMIT_S, env)
        lines = run.stdout.decode().splitlines()
        line = json.loads(lines[-1]) if lines else {}
        line.pop("memory_series", None)
        if "timing" in line:
            line["times"] = leg_times(line, run.launched_at)
        res["legs"][name] = line
        with printing:
            print(json.dumps({name: _leg_summary(line)}), flush=True)
        if run.returncode:
            raise RuntimeError(f"{name}: exit {run.returncode}: {line.get('faults')} "
                               f"{run.stderr.decode()[-3000:]}")
        return line

    try:
        with LegForker() as forker, concurrent.futures.ThreadPoolExecutor(2) as ex:
            size = [] if args.n_total is None else ["--n-total", args.n_total]
            gens = [ex.submit(leg, forker, name, ["gen", path[f], t, "--shape", shape, *size])
                    for name, f, t in (("gen", "corpus.bed", room["target"]),
                                       ("gen_prefix", "prefix.bed", min(STATED_PREFIX, room["target"] // 2)))]
            full, _ = (g.result() for g in gens)
            legs = res["legs"]
            leg(forker, "a", ["encode", path["corpus.bed"], path["a.starch"]])
            on = ["--device", args.device]
            leg(forker, "b_half", ["encode", path["prefix.bed"], path["b_half.starch"], "--jax", *on])
            legs["b_half"]["prefix_of_a"] = is_prefix_archive(path["b_half.starch"], path["a.starch"])
            leg(forker, "b", ["encode", path["corpus.bed"], path["b.starch"], "--jax", "--decode", *on])
            leg(forker, "d", ["device", path["corpus.bed"], path["a.starch"], traces[0], args.dir, "--shape",
                              shape, "--bz2", *on], no_fallback)
            if shape in SCALE_UNSORTED:
                per = [] if args.n_total is None else ["--n-per", args.n_total // 50]
                leg(forker, "gen_sorted", ["gen", path["sorted.bed"], full["bytes"], *per])
                leg(forker, "sorted_a", ["encode", path["sorted.bed"], path["sorted-a.starch"]])
                leg(forker, "sorted_d", ["device", path["sorted.bed"], path["sorted-a.starch"], traces[1], args.dir,
                                         "--untraced", *on], no_fallback)
        res["faults"] = stated_faults(shape, res["legs"])
        res["memory_growth"] = memory_growth(legs["b_half"], legs["b"])
        if shape in SCALE_UNSORTED:
            # the feed's transform in (a), one thread, and (d)'s, every core: unsorted against sorted bytes
            res["transform_seconds"] = {k: {shape: legs[k]["transform_seconds"],
                                            "sorted": legs[f"sorted_{k}"]["transform_seconds"]} for k in ("a", "d")}
    except (RuntimeError, LegTimeout) as e:
        res["faults"] = [f"{shape} {e}"]
    finally:
        for p in path.values():
            if os.path.exists(p):
                os.remove(p)
        for d in traces:
            shutil.rmtree(d, ignore_errors=True)
    res["seconds"] = time.perf_counter() - t0
    res["summary"] = {name: _leg_summary(line) for name, line in res["legs"].items()}
    del res["legs"]  # printed as each leg ended
    return res


def _card_of(args) -> str | None:
    """The card this leg's own process uses, if any: it initialises CUDA
    there before its work, so that the leg's times split the start."""
    if args.leg == "host":
        from starch3_tpu_torch.cli import _parse_args

        opts = _parse_args(args.cli)
        device = opts["platform"] if opts["jax"] else None
    else:
        device = getattr(args, "device", None) if args.leg in ("device", "decode", "oneblock") \
            or getattr(args, "jax", False) else None
    return device if device and device.startswith("cuda") else None


def _disk_bytes(*paths: str) -> int:
    """The bytes of the files at ``paths`` that exist now."""
    n = 0
    for path in paths:
        with contextlib.suppress(OSError):
            n += os.path.getsize(path)
    return n


def cuda_init(device: str) -> float:
    """Seconds to initialise CUDA and make the card's context."""
    import torch

    t0 = time.perf_counter()
    torch.cuda.init()
    torch.cuda.synchronize(device)
    return time.perf_counter() - t0



def main(argv=None) -> int:
    main_at = time.time()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="leg", required=True)
    g = sub.add_parser("gen")
    g.add_argument("out")
    g.add_argument("target", type=lambda s: int(float(s)))
    g.add_argument("--n-per", type=int, help="intervals a chromosome (the shape's default without it)")
    g.add_argument("--n-total", type=int, help="config4 and reads: intervals of all their chromosomes (the "
                   "shape's default without it)")
    g.add_argument("--shape", choices=sorted(SCALE_SHAPES), default="bed3")
    for name in ("encode", "pipe", "device"):
        p = sub.add_parser(name)
        p.add_argument("inp")
        p.add_argument("ref" if name == "device" else "out")
        p.add_argument("--device", default="cuda")
        if name != "pipe":  # the CLI encodes at level 9 in 64 MB chunks, in fast mode
            p.add_argument("--level", type=int, default=9)
            p.add_argument("--chunk-bytes", type=int, default=64 << 20)
            p.add_argument("--mode", choices=sorted(MODES), default="fast", help="the device path's encode mode")
    enc = sub.choices["encode"]
    enc.add_argument("--jax", action="store_true")
    enc.add_argument("--decode", action="store_true")
    enc.add_argument("--cli", action="store_true", help="encode through the CLI's main with a user's flags "
                     "(cli_flags)")
    enc.add_argument("--warm-up", action="store_true", help="warm the card first with a device-only encode of a "
                     "few blocks of the input (warm_up)")
    dev = sub.choices["device"]
    dev.add_argument("trace_dir")
    dev.add_argument("mismatch_dir")
    dev.add_argument("--shape", choices=sorted(SCALE_SHAPES), default="bed3", help="the corpus's shape, for its tier")
    once = dev.add_mutually_exclusive_group()
    once.add_argument("--untraced", action="store_true", help="the timed encode alone, without the traced one")
    once.add_argument("--traced-only", action="store_true", help="the traced encode alone, without the timed one")
    dev.add_argument("--host-rate", action="store_true", help="then the host cores on the same texts (host_run)")
    dev.add_argument("--texts", help="the corpus's texts: written here when missing, read from here when not")
    dev.add_argument("--bz2", action="store_true", help="then hold every stream to bz2.compress(text) (bz2_run)")
    dev.add_argument("--streams", type=int, help="encode the corpus's first STREAMS chromosomes only")
    dec = sub.add_parser("decode")
    dec.add_argument("archive")
    dec.add_argument("corpus")
    dec.add_argument("--device", default="cuda")
    dec.add_argument("--streams", type=int, help="decode an archive of the first STREAMS streams only")
    mh = sub.add_parser("multihost")
    mh.add_argument("inp")
    mh.add_argument("ref")
    mh.add_argument("--transport", choices=("gloo", "manifest"), required=True)
    mh.add_argument("--device", default="cuda")
    mh.add_argument("--host-limit-s", type=float, default=600.0, help="the hosts still running then are killed")
    sub.add_parser("host").add_argument("cli", nargs="*", help="after --: the CLI's arguments")
    c5 = sub.add_parser("config5")
    c5.add_argument("dir")
    c5.add_argument("--target", type=lambda s: int(float(s)), default=10_000_000_000)
    for shape in STATED:
        st = sub.add_parser(shape)
        st.add_argument("dir")
        st.add_argument("--target", type=lambda s: int(float(s)), default=10_000_000_000,
                        help="BED bytes at most (the whole corpus without it)")
        st.add_argument("--n-total", type=int, help="the corpus's intervals (the writer's default without it)")
        st.add_argument("--device", default="cuda")
    ob = sub.add_parser("oneblock")
    ob.add_argument("inp")
    ob.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.leg == "encode" and (args.mode != "fast" or args.warm_up) and not args.jax:
        ap.error("--mode and --warm-up are for the device path: give --jax")
    if args.leg == "encode" and args.cli and ((args.level, args.chunk_bytes) != (9, 64 << 20)
                                              or args.mode not in ("fast", "fast_huff")):
        ap.error("--cli encodes as the CLI does: level 9, 64 MB chunks, mode fast or fast_huff")
    # the start a leg pays before its work: its imports, then CUDA's
    t0 = time.perf_counter()
    if args.leg != "gen":
        for name in LEG_MODULES:
            importlib.import_module(name)
    imports_s = time.perf_counter() - t0
    card = _card_of(args)
    cuda_init_s = cuda_init(card) if card else 0.0
    t_work = time.perf_counter()
    # progress: the archive's bytes on disk, in the legs that write one (the
    # CLI writes OUT.tmp, renamed to OUT at its end)
    out = getattr(args, "out", None)
    peak = PeakRss(progress=lambda: _disk_bytes(out, out + ".tmp") if out else 0).start()
    legs = {"gen": leg_gen, "encode": leg_encode, "pipe": leg_pipe, "device": leg_device, "decode": leg_decode,
            "multihost": leg_multihost, "host": leg_host, "config5": leg_config5, "oneblock": leg_oneblock}
    legs.update(dict.fromkeys(STATED, leg_stated))
    try:
        res = legs[args.leg](args, peak)
    finally:
        peak.stop()
    res["memory_series"] = peak.series
    res["timing"] = {"main_at": main_at, "imports_s": imports_s, "cuda_init_s": cuda_init_s,
                     "work_s": time.perf_counter() - t_work}
    print(json.dumps(res), flush=True)
    return 1 if res.get("faults") else 0


if __name__ == "__main__":
    sys.exit(main())
