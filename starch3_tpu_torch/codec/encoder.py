"""bzip2 stream/block assembly: the full encoder, NumPy oracle tier.

Stream layout (all fields MSB-first):
    'B' 'Z' 'h' ('0'+level)
    per block:
        0x314159265359 (48b)  blockCRC (32b)  randomised=0 (1b)
        origPtr (24b)
        used-map: 16b group mask + 16b per used group
        nGroups (3b)  nSelectors (15b)
        selectors, MTF-coded, unary (j ones + zero)
        per table: 5b first length, then per symbol {10=+1, 11=-1}* 0
        coded symbols
    0x177245385090 (48b)  combinedCRC (32b)  zero-pad to byte

Validated byte-for-byte against libbz2 (stdlib bz2) in
tests/test_bitexact.py.  The reference drives exactly this format through
its bundled patched libbz2 at level 9 (reference include/starch3api.hpp:
835-837); the patch's block-close callback (bzlib.h:66-67 in the bundled
tarball) exists to expose per-block boundaries, which this encoder returns
directly as ``block_bit_offsets``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from starch3_tpu_torch.codec import huffman
from starch3_tpu_torch.codec.bitio import BitWriter
from starch3_tpu_torch.codec.bwt import bwt_best, bwt_encode
from starch3_tpu_torch.codec.crc32 import combine_block_crc
from starch3_tpu_torch.codec.mtf import mtf_rle2
from starch3_tpu_torch.codec.rle1 import Rle1Block, rle1_split_blocks

BLOCK_MAGIC = 0x314159265359
STREAM_END_MAGIC = 0x177245385090


@dataclass(frozen=True)
class EncodedStream:
    data: bytes
    #: absolute bit offset of each block's 48-bit magic (the information the
    #: reference's patched block-close callback was designed to recover)
    block_bit_offsets: tuple[int, ...]
    block_crcs: tuple[int, ...]
    combined_crc: int


def write_block(bw: BitWriter, rle_block: Rle1Block) -> None:
    """Encode one post-RLE1 block into the bit stream (host path)."""
    block = np.frombuffer(rle_block.data, dtype=np.uint8)
    last, orig_ptr = bwt_best(block)
    write_block_from_bwt(bw, rle_block.crc, last, orig_ptr)


def write_block_from_bwt(
    bw: BitWriter,
    crc: int,
    last: np.ndarray,
    orig_ptr: int,
    ranks: np.ndarray | None = None,
) -> None:
    """Encode a block given its BWT last column (and optionally MTF ranks)."""
    _write_block_tail(bw, crc, orig_ptr, mtf_rle2(last, ranks=ranks))


def write_block_from_ranks(
    bw: BitWriter,
    crc: int,
    orig_ptr: int,
    ranks: np.ndarray,
    in_use: np.ndarray,
) -> None:
    """Encode a block from device-kernel outputs only (MTF ranks +
    used-byte map + origPtr) — the BWT last column stays on the device."""
    from starch3_tpu_torch.codec.mtf import mtf_rle2_from_ranks

    _write_block_tail(bw, crc, orig_ptr, mtf_rle2_from_ranks(ranks, in_use))


def write_block_from_device_syms(
    bw: BitWriter,
    crc: int,
    orig_ptr: int,
    symbols: np.ndarray,
    freq: np.ndarray,
    in_use: np.ndarray,
) -> None:
    """Encode a block from the fully-on-device pipeline's outputs
    (ops/rle2_jax.py): the RLE2 symbol stream and its histogram arrive
    from HBM; only Huffman planning + bit emission remain.  That tail
    runs in the native runtime when built (~90 ms -> a few ms per 900 kB
    block, GIL released); the NumPy path below is the behavioral oracle."""
    from starch3_tpu_torch.runtime import encode_tail_native

    native = encode_tail_native(symbols, freq, in_use, orig_ptr, crc)
    if native is not None:
        frag = BitWriter()
        out, tail, tail_nbits = native
        frag._out += out
        frag._acc = tail
        frag._nbits = tail_nbits
        bw.append_writer(frag)
        return
    from starch3_tpu_torch.codec.mtf import MtfResult

    n_in_use = int(in_use.sum())
    alpha = n_in_use + 2
    mtf = MtfResult(
        symbols=symbols.astype(np.int32),
        freq=freq[:alpha].astype(np.int64),
        in_use=in_use,
        alpha_size=alpha,
    )
    _write_block_tail(bw, crc, orig_ptr, mtf)


def _write_block_tail(bw: BitWriter, crc: int, orig_ptr: int, mtf) -> None:
    plan = huffman.build_plan(mtf.symbols, mtf.freq, mtf.alpha_size)
    write_block_header(
        bw, crc, orig_ptr, mtf.in_use, plan.n_groups, plan.lengths,
        plan.selectors_mtf,
    )
    # coded data: gather (code, len) per symbol by its group's table
    syms = mtf.symbols.astype(np.int64)
    gids = plan.group_ids
    codes = plan.codes[gids, syms]
    lens = plan.lengths[gids, syms]
    bw.write_array(codes, lens)


def write_block_header(
    bw: BitWriter,
    crc: int,
    orig_ptr: int,
    in_use: np.ndarray,
    n_groups: int,
    lengths: np.ndarray,
    selectors_mtf: np.ndarray,
    randomised: bool = False,
) -> None:
    """Everything before a block's coded data: magics, used map,
    MTF+unary selectors, delta-coded tables.  Shared by the host tail
    and the device-Huffman path (which appends device-packed words).

    ``randomised`` exists only so tests can construct legacy-format
    fixtures; the production encoder never sets it (matching the 1.0.x
    compressor)."""
    bw.write(BLOCK_MAGIC, 48)
    bw.write(crc, 32)
    bw.write(1 if randomised else 0, 1)
    bw.write(orig_ptr, 24)

    # used-byte map
    group_used = in_use.reshape(16, 16).any(axis=1)
    bw.write(int("".join("1" if g else "0" for g in group_used), 2), 16)
    for g in range(16):
        if group_used[g]:
            bits = in_use[g * 16 : (g + 1) * 16]
            bw.write(int("".join("1" if b else "0" for b in bits), 2), 16)

    n_sel = selectors_mtf.size
    bw.write(n_groups, 3)
    bw.write(n_sel, 15)
    # selectors: unary
    for j in selectors_mtf.tolist():
        bw.write(((1 << j) - 1) << 1, j + 1)  # j ones then a zero
    # tables: delta-coded lengths
    for t in range(n_groups):
        lens = lengths[t]
        curr = int(lens[0])
        bw.write(curr, 5)
        for l in lens.tolist():
            while curr < l:
                bw.write(0b10, 2)
                curr += 1
            while curr > l:
                bw.write(0b11, 2)
                curr -= 1
            bw.write(0, 1)


def bz2_compress(data: bytes, level: int = 9, workers: int | None = None) -> bytes:
    return bz2_compress_ex(data, level, workers=workers).data


def encode_block_fragment(blk: Rle1Block) -> BitWriter:
    """One block's bitstream as an unaligned fragment (thread-safe unit
    of parallelism: the native stages release the GIL, so a thread pool
    over blocks gets real multi-core scaling; fragments are spliced with
    BitWriter.append_writer)."""
    from starch3_tpu_torch.runtime import encode_block_native

    native = encode_block_native(blk.data, blk.crc)
    frag = BitWriter()
    if native is not None:
        out, tail, tail_nbits = native
        frag._out += out
        frag._acc = tail
        frag._nbits = tail_nbits
        return frag
    write_block(frag, blk)
    return frag


def encode_streams_host(
    texts: list[bytes], level: int = 9, workers: int | None = None
) -> list[EncodedStream]:
    """Compress many independent streams with one shared thread pool over
    all their blocks (the host-path counterpart of
    parallel/pipeline.encode_streams)."""
    if workers and workers > 1:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(workers) as ex:
            if len(texts) > 1:
                per_stream = list(
                    ex.map(lambda t: rle1_split_blocks(t, level), texts)
                )
            else:
                per_stream = [rle1_split_blocks(texts[0], level)]
            flat = [blk for blocks in per_stream for blk in blocks]
            if len(flat) > 1:
                frags = list(ex.map(encode_block_fragment, flat))
            else:
                frags = [encode_block_fragment(blk) for blk in flat]
    else:
        per_stream = [rle1_split_blocks(t, level) for t in texts]
        flat = [blk for blocks in per_stream for blk in blocks]
        frags = [encode_block_fragment(blk) for blk in flat]
    out = []
    it = iter(frags)
    for blocks in per_stream:
        bw = BitWriter()
        bw.write_bytes_msb(b"BZh")
        bw.write(0x30 + level, 8)
        combined = 0
        offsets = []
        crcs = []
        for blk in blocks:
            offsets.append(bw.bit_length)
            crcs.append(blk.crc)
            combined = combine_block_crc(combined, blk.crc)
            bw.append_writer(next(it))
        bw.write(STREAM_END_MAGIC, 48)
        bw.write(combined, 32)
        out.append(
            EncodedStream(
                data=bw.getvalue(),
                block_bit_offsets=tuple(offsets),
                block_crcs=tuple(crcs),
                combined_crc=combined,
            )
        )
    return out


def bz2_compress_ex(
    data: bytes, level: int = 9, workers: int | None = None
) -> EncodedStream:
    """Compress ``data`` into a complete bzip2 stream (with block index).

    ``workers``: thread count for parallel block encoding (None = serial;
    blocks are independent, output is identical regardless).
    """
    if not 1 <= level <= 9:
        raise ValueError("level must be 1..9")
    blocks = rle1_split_blocks(data, level)
    if workers and workers > 1 and len(blocks) > 1:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(workers) as ex:
            frags = list(ex.map(encode_block_fragment, blocks))
    else:
        frags = None
    bw = BitWriter()
    bw.write_bytes_msb(b"BZh")
    bw.write(0x30 + level, 8)
    combined = 0
    offsets = []
    crcs = []
    for i, blk in enumerate(blocks):
        offsets.append(bw.bit_length)
        crcs.append(blk.crc)
        combined = combine_block_crc(combined, blk.crc)
        bw.append_writer(frags[i] if frags is not None else encode_block_fragment(blk))
    bw.write(STREAM_END_MAGIC, 48)
    bw.write(combined, 32)
    return EncodedStream(
        data=bw.getvalue(),
        block_bit_offsets=tuple(offsets),
        block_crcs=tuple(crcs),
        combined_crc=combined,
    )
