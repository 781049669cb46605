"""bzip2 stream decoder (NumPy oracle tier).

Parses the container described in encoder.py, Huffman-decodes the symbol
stream with canonical limit/base tables, inverts RLE2+MTF, the BWT and
RLE1, and verifies both block CRCs and the stream CRC.  Legacy
``randomised`` blocks (emitted by bzip2 <= 0.9.0, never by 1.0.x) are
de-randomised after the inverse BWT (codec/randtable.py) — full decode
parity with the reference's bundled libbz2 (decompress.c:545-575 via the
tarball).

This is the behavioral counterpart of the decompression half of the
reference's bundled libbz2 (decompress.c in third-party/bzip2-1.0.6.tar.gz)
— reimplemented from the format, not translated.
"""

from __future__ import annotations

import numpy as np

from starch3_tpu_torch.codec.bitio import BitReader
from starch3_tpu_torch.codec.bwt import bwt_decode
from starch3_tpu_torch.codec.crc32 import combine_block_crc, crc32_bytes
from starch3_tpu_torch.codec.encoder import BLOCK_MAGIC, STREAM_END_MAGIC
from starch3_tpu_torch.codec.mtf import mtf_rle2_decode
from starch3_tpu_torch.codec.rle1 import rle1_decode
from starch3_tpu_torch.errors import FormatError

GROUP_SIZE = 50


def _decode_huffman_tables(br: BitReader, n_groups: int, alpha_size: int) -> np.ndarray:
    lengths = np.zeros((n_groups, alpha_size), dtype=np.int64)
    for t in range(n_groups):
        curr = br.read(5)
        for s in range(alpha_size):
            while br.read_bit():
                if br.read_bit():
                    curr -= 1
                else:
                    curr += 1
            lengths[t, s] = curr
    return lengths


def _limit_base_perm(lengths: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Canonical-decode tables: (limit, base, perm, min_len).

    limit[l] = largest code value of length l; base[l] offsets the code to
    a rank; perm maps rank -> symbol in (length, symbol) order.
    """
    alpha = lengths.size
    min_len = int(lengths.min())
    max_len = int(lengths.max())
    perm = np.concatenate(
        [np.flatnonzero(lengths == l) for l in range(min_len, max_len + 1)]
    )
    limit = np.zeros(max_len + 2, dtype=np.int64)
    base = np.zeros(max_len + 2, dtype=np.int64)
    count = np.bincount(lengths, minlength=max_len + 2)
    vec = 0
    rank = 0
    for l in range(min_len, max_len + 1):
        base[l] = vec - rank
        rank += int(count[l])
        vec += int(count[l])
        limit[l] = vec - 1
        vec <<= 1
    return limit, base, perm, min_len


def _decode_symbols(
    br: BitReader,
    lengths: np.ndarray,
    selectors: np.ndarray,
    alpha_size: int,
) -> np.ndarray:
    """Huffman-decode until EOB; returns symbols *without* the EOB."""
    eob = alpha_size - 1
    tables = [_limit_base_perm(lengths[t]) for t in range(lengths.shape[0])]
    out: list[int] = []
    g = -1
    gpos = 0
    while True:
        if gpos == 0:
            g += 1
            if g >= selectors.size:
                raise FormatError("bzip2: ran out of selectors")
            limit, base, perm, min_len = tables[int(selectors[g])]
            gpos = GROUP_SIZE
        gpos -= 1
        l = min_len
        v = br.read(min_len)
        while v > limit[l]:
            v = (v << 1) | br.read_bit()
            l += 1
            if l > 23:
                raise FormatError("bzip2: corrupt code")
        sym = int(perm[v - base[l]])
        if sym == eob:
            return np.asarray(out, dtype=np.int64)
        out.append(sym)


def read_block_symbols(br: BitReader):
    """Parse one block's bit stream (magic already consumed) down to the
    Huffman-decoded symbol stream — the host-sequential half of block
    decode.  Returns (block_crc, orig_ptr, in_use, symbols, randomised);
    the remaining stages (RLE2/MTF/BWT/RLE1 inversion) are vectorizable
    and have device kernels (ops/irle2_jax.py, imtf_jax.py,
    ibwt_jax.py)."""
    block_crc = br.read(32)
    randomised = bool(br.read_bit())
    orig_ptr = br.read(24)
    group_mask = br.read(16)
    in_use = np.zeros(256, dtype=bool)
    for g in range(16):
        if (group_mask >> (15 - g)) & 1:
            bits = br.read(16)
            for b in range(16):
                if (bits >> (15 - b)) & 1:
                    in_use[g * 16 + b] = True
    n_in_use = int(in_use.sum())
    if n_in_use == 0:
        raise FormatError("bzip2: empty symbol map")
    alpha_size = n_in_use + 2
    n_groups = br.read(3)
    if not 2 <= n_groups <= 6:
        raise FormatError("bzip2: bad group count")
    n_sel = br.read(15)
    sel_mtf = [0] * n_sel
    for i in range(n_sel):
        j = 0
        while br.read_bit():
            j += 1
        sel_mtf[i] = j
    pos = list(range(n_groups))
    selectors = np.empty(n_sel, dtype=np.int64)
    for i, j in enumerate(sel_mtf):
        s = pos.pop(j)
        pos.insert(0, s)
        selectors[i] = s
    lengths = _decode_huffman_tables(br, n_groups, alpha_size)
    symbols = _decode_symbols(br, lengths, selectors, alpha_size)
    return block_crc, orig_ptr, in_use, symbols, randomised


def read_block(br: BitReader) -> bytes:
    """Decode one block (magic already consumed); returns original bytes."""
    block_crc, orig_ptr, in_use, symbols, randomised = read_block_symbols(br)
    bwt_last = mtf_rle2_decode(symbols, in_use)
    if orig_ptr >= bwt_last.size:
        raise FormatError("bzip2: origPtr out of range")
    block = bwt_decode(bwt_last, orig_ptr)
    if randomised:
        from starch3_tpu_torch.codec.randtable import derandomize

        block = derandomize(block)
    data = rle1_decode(block.tobytes())
    if crc32_bytes(data) != block_crc:
        raise FormatError("bzip2: block CRC mismatch")
    return data


def bz2_decompress(stream: bytes) -> bytes:
    """Decode a complete (single) bzip2 stream, verifying all CRCs."""
    if len(stream) < 4 or stream[:3] != b"BZh":
        raise FormatError("bzip2: bad stream header")
    level = stream[3] - 0x30
    if not 1 <= level <= 9:
        raise FormatError("bzip2: bad block-size digit")
    br = BitReader(stream)
    br.read(32)
    out = bytearray()
    combined = 0
    while True:
        magic = br.read(48)
        if magic == STREAM_END_MAGIC:
            stored = br.read(32)
            if stored != combined:
                raise FormatError("bzip2: stream CRC mismatch")
            return bytes(out)
        if magic != BLOCK_MAGIC:
            raise FormatError("bzip2: bad block magic")
        data = read_block(br)
        combined = combine_block_crc(combined, crc32_bytes(data))
        out += data
