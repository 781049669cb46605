"""The host tier of the block-encode pipeline: the port's own copy.

Copied from ``starch3_tpu/parallel/pipeline.py`` with the package prefix
rewritten, so the two packages schedule and encode alike (the known
faults of these pieces, listed in ROADMAP.md C, are kept).  The port's
only change is what it counts: ``scheduler_stats`` is a locked
``observability.Stats``, and the stealers' encodes and the tail's tasks
(``_submit_tail``) are spans in it.

  - classing and geometry: ``_split_classify``, ``_bits_class``,
    ``_bucket_for``;
  - the scheduler: its constants, ``scheduler_stats``,
    ``_no_host_fallback``, the two-ended ``_BlockQueue`` and the host
    stealers ``_start_host_stealers``;
  - the tail: ``_tail_pool`` and the row decoders
    ``_fragment_from_ranks_row`` (bits 4-6) and ``_fragment_from_row``
    (bits 8);
  - ``_assemble_stream``, which joins a stream's block fragments.

The device side (steps, dispatch, drain, driver) is ``pipeline.py``.
"""

from __future__ import annotations

import threading
import time

import numpy as np

from starch3_tpu_torch.codec.bitio import BitWriter
from starch3_tpu_torch.codec.crc32 import combine_block_crc
from starch3_tpu_torch.codec.encoder import (
    STREAM_END_MAGIC,
    write_block_from_device_syms,
    write_block_from_ranks,
)
from starch3_tpu_torch.codec.rle1 import rle1_split_blocks
from starch3_tpu_torch.observability import Stats, span, span_keys

# padded device block size: fits any level-9 block (nblockMAX 899_981 + 4
# overshoot), multiple of the MTF tile (512)
N_MAX_BLOCK = 901_120

# geometry buckets: one compiled program per bucket, shared by every
# stream/chromosome (a per-input n_max would recompile per geometry).
# 448 kB sits between "small chromosome" and "full block": typical
# whole-genome per-chromosome transformed texts are 300-600 kB, and
# padding those to 901k would double the device work
_N_MAX_BUCKETS = (16_384, 131_072, 458_752, N_MAX_BLOCK)


def _split_classify(text: bytes, level: int):
    """RLE1-segment one stream and classify each block's alphabet so
    batches stay homogeneous — a single wide block never demotes its
    batch.  The distinct-byte count runs natively (one table store per
    byte, runtime.cpp s3_count_distinct; the NumPy bincount fallback
    was ~45% of the serial feed cost).  Pure function of the text: safe
    on the feed prefetch pool (the natives release the GIL)."""
    from starch3_tpu_torch.runtime import count_distinct_native

    blocks = rle1_split_blocks(text, level)
    classes = []
    for blk in blocks:
        n_syms = count_distinct_native(blk.data)
        if n_syms is None:
            n_syms = int((np.bincount(
                np.frombuffer(blk.data, np.uint8), minlength=256
            ) > 0).sum())
        classes.append(_bits_class(n_syms))
    return blocks, classes


def _bits_class(n_syms: int) -> int:
    """Device-path alphabet class for a block with ``n_syms`` distinct
    bytes.  Blocks are classified individually at feed time and batched
    per class, so one wide block never demotes its batch-mates: 3-column
    BED rides bits==4, config-3 remainder-column BED (typically ~21
    symbols) rides bits==5, and only >64-symbol content pays the generic
    bits==8 path (whose 16-symbol sort context would tie ~470x per block
    on the config-3 corpus — see ops/bwt_fast.bwt_sort_fast_mid)."""
    if n_syms <= 16:
        return 4
    if n_syms <= 32:
        return 5
    if n_syms <= 64:
        return 6
    return 8


def _bucket_for(size: int) -> int:
    for b in _N_MAX_BUCKETS:
        if size <= b:
            return b
    raise ValueError(f"block size {size} exceeds {N_MAX_BLOCK}")

def _assemble_stream(blocks, results, si: int, level: int):
    """Concatenate one stream's finished block fragments in block order
    (deterministic: partitioning is input-derived, never topology- or
    schedule-derived).

    Production path (all results are prebuilt BitWriter fragments, the
    native lib present): ONE exact-size allocation, each fragment
    bit-spliced into place natively (runtime.cpp s3_append_shifted) —
    the growing-bytearray concat's realloc copies were the measured
    serial-assembly ceiling (docs/PERF.md "Orchestration ceiling").
    Legacy/device-tuple results take the incremental BitWriter path;
    bytes are identical either way (tested)."""
    resolved = []
    for bi in range(len(blocks)):
        res = results[(si, bi)]
        if hasattr(res, "result"):  # tail-pool future -> fragment
            res = res.result()
        resolved.append(res)
    from starch3_tpu_torch.codec.encoder import EncodedStream

    if all(isinstance(r, BitWriter) for r in resolved):
        from starch3_tpu_torch.runtime import append_shifted_at, get_lib

        if get_lib() is not None:
            total_bits = (
                32
                + sum(f.bit_length for f in resolved)
                + 48
                + 32
            )
            out = bytearray((total_bits + 7) // 8)
            out[0:3] = b"BZh"
            out[3] = 0x30 + level
            pos, acc, L = 4, 0, 0
            combined = 0
            offsets = []
            crcs = []
            ok = True
            for blk, f in zip(blocks, resolved):
                offsets.append(pos * 8 + L)
                crcs.append(blk.crc)
                combined = combine_block_crc(combined, blk.crc)
                src = f._out
                n = len(src)
                if n:
                    if L == 0:
                        out[pos : pos + n] = src
                        acc = src[-1]  # unused at L==0; keep well-defined
                    else:
                        acc = append_shifted_at(out, pos, src, L, acc)
                        if acc is None:
                            ok = False
                            break
                    pos += n
                if f._nbits:
                    acc = ((acc if L else 0) << f._nbits) | f._acc
                    L += f._nbits
                    if L >= 8:
                        L -= 8
                        out[pos] = (acc >> L) & 0xFF
                        pos += 1
                        acc &= (1 << L) - 1
            if ok:
                tail = BitWriter()
                tail._acc, tail._nbits = acc, L
                tail.write(STREAM_END_MAGIC, 48)
                tail.write(combined, 32)
                tb = tail.getvalue()
                out[pos : pos + len(tb)] = tb
                assert pos + len(tb) == len(out)
                return EncodedStream(
                    data=bytes(out),
                    block_bit_offsets=tuple(offsets),
                    block_crcs=tuple(crcs),
                    combined_crc=combined,
                )

    bw = BitWriter()
    bw.write_bytes_msb(b"BZh")
    bw.write(0x30 + level, 8)
    combined = 0
    offsets = []
    crcs = []
    for bi, blk in enumerate(blocks):
        res = resolved[bi]
        offsets.append(bw.bit_length)
        crcs.append(blk.crc)
        combined = combine_block_crc(combined, blk.crc)
        if isinstance(res, BitWriter):  # pre-built fragment
            bw.append_writer(res)
        elif len(res) == 4:  # device-RLE2: (used, ptr, symbols, freq)
            in_use, ptr, syms, freq = res
            write_block_from_device_syms(bw, blk.crc, ptr, syms, freq, in_use)
        else:
            in_use, ptr, ranks = res
            write_block_from_ranks(bw, blk.crc, ptr, ranks, in_use)
    bw.write(STREAM_END_MAGIC, 48)
    bw.write(combined, 32)
    return EncodedStream(
        data=bw.getvalue(),
        block_bit_offsets=tuple(offsets),
        block_crcs=tuple(crcs),
        combined_crc=combined,
    )


# scheduler knobs (see encode_streams_feed): blocks held back for the
# stealer cores per stealer at the queue tail, and how many device
# batches stay in flight (re-swept this round with the 3x-faster device
# step: depth 2 / reserve 1 / batch 3 wins — the shallower pipeline
# shrinks the end-of-corpus straggler now that batches turn around
# faster; 134 vs 120 MB/s at depth 3 on the bench corpus)
_TAIL_RESERVE_PER_STEALER = 1
_PIPELINE_DEPTH = 2

# Rate-aware device demotion (see _device_driver): bench the device when
# its drain throughput EMA falls below this fraction of the stealers'
# aggregate, and re-probe with one batch this many seconds later.
_DEMOTE_FRACTION = 0.5
_DEMOTE_PROBE_S = 15.0
_DEMOTE_MIN_SAMPLES = 3
# per-class routing (claim loop): a class needs this many drain samples
# before its tier rate can veto device claims — fewer than the global
# demotion threshold because a single slow-tier batch (bits==8 measured
# 28.6 MB/s/chip vs two ~127 MB/s host cores) is already informative
_CLASS_MIN_SAMPLES = 2
# a dispatched batch not transfer-ready after this long is abandoned:
# its blocks go back to the queue for the stealers and the device is
# benched (observed failure mode: mid-encode interconnect outage where
# a D2H fetch hangs for minutes-to-hours — without this the encode
# hangs on blocks the device claimed but can never deliver)
_ABANDON_S = 30.0

# observability: cumulative scheduler events for this process (tests and
# the bench read these; encode results never depend on them), and the
# host tier's spans (``observability.span``): the stealers' block encodes
# (``steal``, with their blocks' bytes) and the tail pool's tasks
# (``tail``) with their waits in its queue (``tail_wait_s``)
scheduler_stats = Stats(
    {
        "demotions": 0,
        "repromotions": 0,
        "abandoned_batches": 0,
        "class_skips": 0,
        "tail_wait_s": 0.0,
    }
    | span_keys("steal", nbytes=True)
    | span_keys("tail")
)

# process-lifetime per-class device tier rates (bits -> EMA bytes/s):
# a fresh encode's queue is seeded from the last encode's measurements,
# so per-class routing is effective from the first batch instead of
# re-learning each call (the tier rates are properties of the chip and
# corpus class, not of one encode).  Scheduling only; the probe claims
# re-measure every _DEMOTE_PROBE_S regardless.
_class_rate_cache: dict[int, float] = {}


def _no_host_fallback() -> bool:
    """STARCH3_TPU_NO_HOST_FALLBACK=1 keeps device-only encodes pure:
    stuck batches are never abandoned to driver-inline host encodes and
    the final drain blocks on the device (the pre-round-5 semantics,
    for device-lane benches that must never silently time host work).
    Default off: a mid-run link outage in a ``host_assist=False``
    encode abandons stuck batches to the driver thread instead of
    hanging (the observed outages last hours)."""
    import os

    return os.environ.get("STARCH3_TPU_NO_HOST_FALLBACK") == "1"


class _BlockQueue:
    """The shared two-ended block queue behind one encode call.

    Blocks arrive over time (``feed``, appended at the back) grouped
    into geometry buckets; the device driver claims batches from the
    FRONT of a bucket, host stealers claim single blocks from the BACK
    (the freshest — any unclaimed block is equivalent: output bytes are
    per-block deterministic), and they meet in the middle.  All state
    transitions happen under one condition variable — consumers sleep
    on it instead of polling."""

    def __init__(self):
        import collections

        self.cond = threading.Condition()
        # key: (geometry n_max, alphabet bits class)
        self.buckets: dict[tuple[int, int], "collections.deque"] = {}
        self._deque = collections.deque
        self.per_stream_blocks: list[list] = []
        self.feeding = True
        # blocks the device driver has claimed so far; until its
        # software pipeline is primed, stealers leave it first pick
        # (see _start_host_stealers)
        self.device_claimed = 0
        self.device_low_water = 0
        self.steal_holdback = 0  # blocks stealers leave while gated
        # incremental-assembly backpressure (encode_streams_iter):
        # bytes of block data fed but not yet yielded; feed() blocks
        # while over window_bytes (None = unbounded, the list forms)
        self.window_bytes: int | None = None
        self.inflight_bytes = 0
        self.feed_blocked = False  # feeder parked on the window
        self.cancelled = False
        # rate-aware demotion (see _device_driver): throughput EMAs let
        # the scheduler bench a device whose effective rate has
        # collapsed (sick chip, degraded interconnect) instead of
        # letting its claimed batches straggle the whole corpus.
        # Scheduling only — archive bytes are claim-order invariant.
        self.n_stealers = 0
        self.live_stealers = 0  # still-running stealer threads
        self.stealer_rate = None  # EMA bytes/s per stealer core
        self.device_rate = None  # EMA bytes/s (drain-to-drain)
        self.device_rate_samples = 0
        self.device_demoted = False
        self.device_probe_at = 0.0  # monotonic time of next probe
        # per-alphabet-class device tier rates: a class whose measured
        # on-chip rate trails the stealer aggregate is routed to the
        # host cores without benching the device (bits -> EMA bytes/s)
        self.class_rate: dict[int, float] = {}
        self.class_samples: dict[int, int] = {}
        self.class_probe_at: dict[int, float] = {}

    def active_feeding(self) -> bool:
        """True while more blocks may arrive SOON.  A window-blocked
        feeder cannot add blocks until a stream is yielded, so consumers
        must treat that state like end-of-feed (take partial batches,
        drop steal holdbacks) or the scheduler deadlocks: feeder waits
        on the window, device waits for a full batch, stealers hold
        back."""
        return self.feeding and not self.feed_blocked

    def feed(self, text: bytes, level: int) -> None:
        self.feed_blocks(*_split_classify(text, level))

    def feed_blocks(self, blocks: list, classes: list[int]) -> None:
        total = sum(len(blk.data) for blk in blocks)
        with self.cond:
            if self.window_bytes is not None:
                # backpressure: keep a bounded window of undelivered
                # work (never deadlocks: one stream may exceed the
                # window alone when nothing else is in flight, and
                # feed_blocked releases the workers' batch/holdback
                # gates while we sleep)
                while (
                    not self.cancelled
                    and self.inflight_bytes > 0
                    and self.inflight_bytes + total > self.window_bytes
                ):
                    if not self.feed_blocked:
                        self.feed_blocked = True
                        self.cond.notify_all()
                    self.cond.wait(0.05)
                self.feed_blocked = False
            self.inflight_bytes += total
            si = len(self.per_stream_blocks)
            self.per_stream_blocks.append(blocks)
            for bi, blk in enumerate(blocks):
                key = (_bucket_for(len(blk.data)), classes[bi])
                self.buckets.setdefault(key, self._deque()).append((si, bi))
            self.cond.notify_all()

    def finish_feeding(self) -> None:
        with self.cond:
            self.feeding = False
            self.cond.notify_all()

    def claim_priority(self, nm) -> tuple:
        """Device claim order across geometry buckets: unmeasured
        classes first (optimistic — one batch measures them), then by
        measured per-class device rate descending, then bigger
        geometry.  The old plain bucket-key sort preferred the WIDEST
        alphabet at equal geometry — i.e. the slowest tier (bits==8 at
        ~29 MB/s/chip) ahead of the fastest (bits==4 at ~130) — so a
        mixed corpus parked the chip on its worst work while narrow
        blocks queued.  Scheduling only: bytes are claim-order
        invariant.  STARCH3_TPU_NO_CLASS_ROUTING=1 restores the plain
        descending bucket-key order (the round-4 behavior, for A/B)."""
        import os

        if isinstance(nm, tuple):
            n_max, bits_c = nm
            rate = self.class_rate.get(bits_c)
        else:
            n_max, bits_c = nm, 0
            rate = None
        if os.environ.get("STARCH3_TPU_NO_CLASS_ROUTING") == "1":
            return (-n_max, -bits_c)
        return (
            -(rate if rate is not None else float("inf")),
            -n_max,
            bits_c,
        )

    def class_gated(self, bits_c, now: float) -> bool:
        """True when the device should NOT claim from this alphabet
        class right now: its measured tier rate (per-class drain EMA)
        loses to the stealer aggregate — e.g. the bits==8 generic tier
        at ~29 MB/s/chip behind two ~127 MB/s host cores — and the
        class's probe window hasn't opened.  Returning False when the
        window IS open also re-arms it: that claim is the class's
        probe, re-measuring the tier in case the corpus or link
        changed.  Caller holds ``self.cond``.  Scheduling only: bytes
        are claim-order invariant.  STARCH3_TPU_NO_CLASS_ROUTING=1
        disables the gate (the pre-round-5 behavior, kept for A/B
        measurement)."""
        if bits_c is None or self.n_stealers <= 0 or not self.stealer_rate:
            return False
        import os

        if os.environ.get("STARCH3_TPU_NO_CLASS_ROUTING") == "1":
            return False
        if self.class_samples.get(bits_c, 0) < _CLASS_MIN_SAMPLES:
            return False
        if self.class_rate.get(bits_c, 0.0) >= (
            _DEMOTE_FRACTION * self.stealer_rate * self.n_stealers
        ):
            return False
        if now < self.class_probe_at.get(bits_c, 0.0):
            return True
        self.class_probe_at[bits_c] = now + _DEMOTE_PROBE_S
        return False


def _start_host_stealers(q: _BlockQueue, results, errors, host_assist):
    """Host stealer threads: claim one block at a time from the back of
    the biggest-block bucket (one steal = one native block encode, so
    stealing big blocks moves the most bytes per claim)."""
    if not host_assist:
        return []
    import os

    from starch3_tpu_torch.codec.encoder import encode_block_fragment

    def steal():
        with q.cond:
            q.live_stealers += 1
        registered = True
        try:
            while True:
                claim = None
                with q.cond:
                    while True:
                        # While blocks are still arriving and the device
                        # pipeline isn't primed, the device has first
                        # pick: it turns blocks around with ~100 ms of
                        # dispatch latency, so it must claim EARLY or it
                        # idles through the whole corpus (measured: the
                        # stealers otherwise drain the queue faster than
                        # the feeder fills it and the device gets one
                        # late batch).  Stealers then only take blocks
                        # beyond one buildable batch.
                        hold_back = (
                            q.steal_holdback
                            if q.active_feeding()
                            and q.device_claimed < q.device_low_water
                            and not q.device_demoted
                            else 0
                        )
                        for nm in sorted(q.buckets, reverse=True):
                            dq = q.buckets[nm]
                            if len(dq) > hold_back:
                                claim = dq.pop()
                                break
                        if (
                            claim is not None
                            or not q.feeding
                            or errors
                            or q.cancelled
                        ):
                            if claim is None:
                                # exit decision: deregister INSIDE the same
                                # critical section, so _abandon_batch can
                                # never observe this thread as live after
                                # it has decided to stop consuming (it
                                # would re-enqueue blocks nobody revisits
                                # and the assembler would hang)
                                q.live_stealers -= 1
                                registered = False
                                q.cond.notify_all()
                            break
                        q.cond.wait(0.05 if not hold_back else 0.002)
                if claim is None:
                    return
                si, bi = claim
                blk = q.per_stream_blocks[si][bi]
                with span(scheduler_stats, "steal", len(blk.data)) as timed:
                    results[(si, bi)] = encode_block_fragment(blk)
                dt = timed.dt
                with q.cond:  # wake the incremental assembler
                    if dt > 0:
                        r = len(blk.data) / dt
                        q.stealer_rate = (
                            r
                            if q.stealer_rate is None
                            else 0.7 * q.stealer_rate + 0.3 * r
                        )
                    q.cond.notify_all()
        except BaseException as e:  # surface in the caller
            errors.append(e)
        finally:
            with q.cond:
                if registered:  # abnormal exit (normal exits deregister
                    q.live_stealers -= 1  # in the claim loop, atomically)
                q.cond.notify_all()

    # every core can steal (the native encode releases the GIL and the
    # device driver thread mostly blocks on transfers), unless the caller
    # set fewer in q.n_stealers
    n_workers = q.n_stealers or os.cpu_count() or 2
    q.n_stealers = n_workers
    threads = [
        threading.Thread(target=steal, name=f"s3steal{i}", daemon=True)
        for i in range(n_workers)
    ]
    for t in threads:
        t.start()
    return threads

_TAIL_POOL = None



def _tail_pool():
    """Shared executor for per-block tail encodes (the native entry
    releases the GIL, so these overlap device transfers).  Width
    defaults to 2; STARCH3_TPU_TAIL_WORKERS overrides it — both to scale
    up on big hosts and to throttle to 1 for the chips-outnumber-cores
    crossover experiment (benchmarks/profile_device.py, docs/PERF.md)."""
    global _TAIL_POOL
    if _TAIL_POOL is None:
        import os
        from concurrent.futures import ThreadPoolExecutor

        width = max(1, int(os.environ.get("STARCH3_TPU_TAIL_WORKERS", "2") or 2))
        _TAIL_POOL = ThreadPoolExecutor(width, thread_name_prefix="s3tail")
    return _TAIL_POOL


def _submit_tail(fn, *args):
    """``fn(*args)`` on the tail pool; its future.  ``scheduler_stats``
    adds the task's wait from the submit to its start to ``tail_wait_s``
    and times its work as the span ``tail``."""
    return _tail_pool().submit(_tail_task, time.perf_counter(), fn, args)


def _tail_task(submitted: float, fn, args):
    scheduler_stats.add(tail_wait_s=time.perf_counter() - submitted)
    with span(scheduler_stats, "tail"):
        return fn(*args)

def _fragment_from_ranks_row(row, used, crc, n, bits=4):
    """One block's bitstream fragment from a packed-ranks result row:
    [ptr, ties, packed ranks] — nibble-packed for bits==4
    (_jitted_fused_step_ranks4), 30//bits ranks per word for bits 5/6
    (_jitted_fused_step_ranks_mid).  RLE2 + Huffman + serialization run
    natively here (tail pool)."""
    from starch3_tpu_torch.codec.encoder import write_block_from_device_syms
    from starch3_tpu_torch.codec.mtf import mtf_rle2_from_ranks

    ptr = int(row[0])
    if bits == 4:
        by = np.ascontiguousarray(row[2:], dtype="<i4").view(np.uint8)
        ranks = np.empty(by.size * 2, dtype=np.uint8)
        ranks[0::2] = by & 0xF
        ranks[1::2] = by >> 4
    else:
        spw = 30 // bits
        mask = (1 << bits) - 1
        packed = np.ascontiguousarray(row[2:], dtype="<i4").view(np.uint32)
        ranks = np.empty(packed.size * spw, dtype=np.uint8)
        for k in range(spw):
            ranks[k::spw] = (packed >> (bits * k)) & mask
    mtf = mtf_rle2_from_ranks(ranks[:n], used)
    frag = BitWriter()
    write_block_from_device_syms(frag, crc, ptr, mtf.symbols, mtf.freq, used)
    return frag


def _fragment_from_row(row, bits, used, crc):
    """One block's bitstream fragment from a packed result row:
    [ptr, m, ties, freq[260], packed syms] (see _jitted_fused_step_fast)."""
    from starch3_tpu_torch.codec.encoder import write_block_from_device_syms

    ptr, m = int(row[0]), int(row[1])
    freq = row[3:263]
    packed = row[263:]
    spw, sb, mask = (6, 5, 31) if bits == 4 else (2, 16, 0xFFFF)
    syms = np.empty(packed.size * spw, dtype=np.int32)
    for k in range(spw):
        syms[k::spw] = (packed >> (sb * k)) & mask
    frag = BitWriter()
    write_block_from_device_syms(frag, crc, ptr, syms[:m], freq, used)
    return frag
