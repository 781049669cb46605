"""bzip2's CRC-32 (MSB-first / non-reflected, poly 0x04c11db7).

bzip2 does not use the zlib CRC: it feeds bytes in most-significant-bit-first
order with polynomial 0x04c11db7, initial value 0xFFFFFFFF and a final
inversion, and combines per-block CRCs into a stream CRC with a rotate-xor.
This module derives the table from the polynomial (no table copied) and
provides a NumPy-vectorized byte-at-a-time update.

Behavioral spec source: the public bzip2 stream format as exercised by the
reference's bundled libbz2 1.0.6; validated against stdlib ``bz2`` output in
tests/test_bitexact.py.
"""

from __future__ import annotations

import numpy as np

_POLY = 0x04C11DB7


def _build_table() -> np.ndarray:
    table = np.zeros(256, dtype=np.uint32)
    for i in range(256):
        c = i << 24
        for _ in range(8):
            if c & 0x80000000:
                c = ((c << 1) ^ _POLY) & 0xFFFFFFFF
            else:
                c = (c << 1) & 0xFFFFFFFF
        table[i] = c
    return table


CRC_TABLE: np.ndarray = _build_table()


def crc32_update(crc: int, data: bytes | np.ndarray) -> int:
    """Update a running (already-inverted) CRC register with ``data``.

    The register convention matches bzip2's BZ_UPDATE_CRC:
    ``crc = (crc << 8) ^ table[(crc >> 24) ^ byte]``.
    """
    buf = np.frombuffer(data, dtype=np.uint8) if isinstance(data, (bytes, bytearray, memoryview)) else data
    c = np.uint32(crc)
    table = CRC_TABLE
    # Byte-serial dependency; keep the inner loop tight.  For bulk hashing,
    # crc32_bytes below slices via the 8-bit state-transition trick.
    for b in buf.tolist():
        c = np.uint32((int(c) << 8) & 0xFFFFFFFF) ^ table[(int(c) >> 24) ^ b]
    return int(c)


def crc32_begin() -> int:
    return 0xFFFFFFFF


def crc32_final(crc: int) -> int:
    return crc ^ 0xFFFFFFFF


_BITREV8 = np.array(
    [int(f"{i:08b}"[::-1], 2) for i in range(256)], dtype=np.uint8
)


def _bitrev32(x: int) -> int:
    return int(f"{x:032b}"[::-1], 2)


def crc32_bytes(data: bytes) -> int:
    """CRC of a whole buffer (init 0xFFFFFFFF, final inversion).

    Hot path: the native slice-by-8 table CRC (runtime.cpp s3_crc32).
    Fallback: bzip2's MSB-first CRC is the bit-reversal conjugate of the
    reflected (zlib) CRC over bit-reversed bytes — verified against the
    table implementation in tests — so the heavy lifting runs in zlib's C
    at GB/s with one vectorized byte-reversal pass.
    """
    from starch3_tpu_torch.runtime import crc32_native

    native = crc32_native(data)
    if native is not None:
        return native

    import zlib

    rev = _BITREV8[np.frombuffer(data, dtype=np.uint8)].tobytes()
    return _bitrev32(zlib.crc32(rev))


def _crc32_fast(crc: int, data: bytes) -> int:
    """Vectorized CRC via per-byte GF(2) linear maps.

    The CRC update is linear over GF(2): process the buffer in chunks by
    composing 32x32 bit-matrices would be overkill; instead use the classic
    slice-by-8 layout built from CRC_TABLE.
    """
    buf = np.frombuffer(data, dtype=np.uint8)
    c = crc & 0xFFFFFFFF
    t = CRC_TABLE
    # Python-level loop at 1 byte/iter is too slow for GB inputs; use
    # slice-by-8 with MSB-first ordering.
    t0 = t
    tables = [t0]
    for _ in range(7):
        prev = tables[-1]
        nxt = ((prev << np.uint32(8)) & np.uint32(0xFFFFFFFF)) ^ t0[(prev >> np.uint32(24)).astype(np.int64)]
        tables.append(nxt)
    n8 = (len(buf) // 8) * 8
    for i in range(0, n8, 8):
        b = buf[i : i + 8]
        x = c ^ ((int(b[0]) << 24) | (int(b[1]) << 16) | (int(b[2]) << 8) | int(b[3]))
        c = int(
            tables[7][(x >> 24) & 0xFF]
            ^ tables[6][(x >> 16) & 0xFF]
            ^ tables[5][(x >> 8) & 0xFF]
            ^ tables[4][x & 0xFF]
            ^ tables[3][int(b[4])]
            ^ tables[2][int(b[5])]
            ^ tables[1][int(b[6])]
            ^ tables[0][int(b[7])]
        )
    for b in buf[n8:].tolist():
        c = ((c << 8) & 0xFFFFFFFF) ^ int(t0[((c >> 24) ^ b) & 0xFF])
    return c


def combine_block_crc(combined: int, block_crc: int) -> int:
    """Stream-CRC combiner: rotate-left-1 then xor the block CRC."""
    combined = ((combined << 1) | (combined >> 31)) & 0xFFFFFFFF
    return combined ^ block_crc
