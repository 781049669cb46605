"""RLE1: bzip2's first-stage run-length encoding + block segmentation.

bzip2 applies a byte-level RLE *while filling each block*: runs of 4..255
identical bytes become ``4 literals + (len-4)``; a block holds at most
``100_000*level - 19`` post-RLE bytes, and the pending run is flushed into
the block being closed.  Because block boundaries depend on this stateful
filling, segmentation of a long stream into blocks must replicate the exact
char-consumption discipline:

  - one input byte is consumed per step; before each consumption the block
    is closed if it already holds >= nblockMAX bytes (a flush can push the
    block a few bytes past nblockMAX, hence the -19 margin);
  - a run saturates at 255 consumed bytes, after which the next identical
    byte flushes a 255-chunk and starts a new pending run;
  - at a *non-final* block close the pending run is NOT flushed: it stays
    pending and becomes the first run of the next block (so the close
    always happens with exactly one pending byte — the byte whose
    consumption triggered the flush that filled the block);
  - only at EOF is the pending run flushed into the current block.

Each block's CRC covers the original bytes *flushed* into it (the pending
byte at a non-final close is charged to the next block).

This module simulates that discipline run-by-run (vectorized run detection,
O(#runs + #chunks) Python, not O(#bytes)), producing identical block
boundaries, block bytes, and CRC ranges to libbz2.  Validated bit-exactly in
tests/test_bitexact.py, including multi-block streams.

The per-block *content* transform (RLE1 within one block) is trivially
parallel; segmentation is the only sequential part and runs on the host,
mirroring how the reference keeps stream chopping on the CPU
(reference include/starch3api.hpp:819-888 drives libbz2 sequentially).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from starch3_tpu_torch.codec.crc32 import crc32_bytes


@dataclass(frozen=True)
class Rle1Block:
    """One bzip2 block's worth of post-RLE1 data."""

    data: bytes  # post-RLE1 block contents
    crc: int  # CRC32 of the original bytes consumed into this block
    src_start: int  # original-byte range [src_start, src_end) consumed
    src_end: int


def find_runs(data: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Return (values, lengths) of maximal equal-byte runs (vectorized)."""
    n = data.size
    if n == 0:
        return np.empty(0, dtype=np.uint8), np.empty(0, dtype=np.int64)
    boundaries = np.flatnonzero(data[1:] != data[:-1]) + 1
    starts = np.concatenate(([0], boundaries))
    ends = np.concatenate((boundaries, [n]))
    return data[starts], (ends - starts).astype(np.int64)


def rle1_split_blocks(data: bytes, block_size_100k: int = 9) -> list[Rle1Block]:
    """Split ``data`` into bzip2 blocks with exact libbz2 boundaries.

    Dispatches to the native runtime when built (identical discipline in
    C, runtime/runtime.cpp s3_rle1_split); this Python implementation is
    the behavioral reference and fallback.
    """
    from starch3_tpu_torch.runtime import rle1_split_native

    native = rle1_split_native(data, block_size_100k)
    if native is not None:
        out, offsets, bounds = native
        blocks = []
        prev_src = 0
        for i in range(len(bounds)):
            blk = out[offsets[i] : offsets[i + 1]].tobytes()
            src_end = int(bounds[i])
            blocks.append(
                Rle1Block(
                    blk,
                    crc32_bytes(data[prev_src:src_end]),
                    src_start=prev_src,
                    src_end=src_end,
                )
            )
            prev_src = src_end
        return blocks

    nblock_max = 100_000 * block_size_100k - 19
    arr = np.frombuffer(data, dtype=np.uint8)
    values, lengths = find_runs(arr)

    blocks: list[Rle1Block] = []
    cur = bytearray()
    consumed = 0  # original bytes consumed so far (pending included)
    crc_start = 0
    pend_ch = -1
    pend_len = 0
    n_runs = values.size

    def flush_pending() -> None:
        nonlocal pend_len
        if pend_len == 0:
            return
        if pend_len >= 4:
            cur.extend(bytes([pend_ch]) * 4)
            cur.append(pend_len - 4)
        else:
            cur.extend(bytes([pend_ch]) * pend_len)
        pend_len = 0

    def end_block() -> None:
        """Close the current block; pending bytes stay for the next one."""
        nonlocal crc_start
        crc_end = consumed - pend_len
        crc = crc32_bytes(data[crc_start:crc_end])
        blocks.append(
            Rle1Block(bytes(cur), crc, src_start=crc_start, src_end=crc_end)
        )
        cur.clear()
        crc_start = crc_end

    for ri, (ch, run_len) in enumerate(zip(values.tolist(), lengths.tolist())):
        rem = run_len
        # first byte of this run: flushes the previous run's pending tail
        flush_pending()
        pend_ch, pend_len = ch, 1
        rem -= 1
        consumed += 1
        # the block-full check runs before every byte consumption, but the
        # block size only changes at flushes — so checking right after each
        # flush (provided another byte exists to trigger it) is equivalent
        if (rem > 0 or ri < n_runs - 1) and len(cur) >= nblock_max:
            end_block()
        while rem:
            take = min(rem, 255 - pend_len)
            pend_len += take
            rem -= take
            consumed += take
            if rem:
                # pending saturated at 255; the next byte flushes it
                flush_pending()
                pend_ch, pend_len = ch, 1
                rem -= 1
                consumed += 1
                if (rem > 0 or ri < n_runs - 1) and len(cur) >= nblock_max:
                    end_block()
    # EOF: the pending run joins the current (final) block
    flush_pending()
    if cur:
        end_block()
    return blocks


def rle1_decode(data: bytes) -> bytes:
    """Inverse of RLE1 for one block (decoder side), vectorized.

    A run of 4 identical bytes is always followed by a count byte (possibly
    zero).  Count bytes can themselves equal the run byte, so decoding scans
    run boundaries left-to-right; we vectorize by processing maximal equal
    runs and resolving the 4+count grammar per run.
    """
    arr = np.frombuffer(data, dtype=np.uint8)
    out = bytearray()
    i = 0
    n = arr.size
    data_m = memoryview(data)
    while i < n:
        c = arr[i]
        # length of equal run starting at i (bounded scan)
        j = i + 1
        while j < n and j < i + 4 and arr[j] == c:
            j += 1
        run = j - i
        if run == 4:
            if j >= n:
                raise ValueError("truncated RLE1 run")
            count = int(arr[j])
            out += bytes([c]) * (4 + count)
            i = j + 1
        else:
            out += data_m[i:j]
            i = j
    return bytes(out)
