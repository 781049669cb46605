"""MSB-first bit stream writer/reader for the bzip2 container.

bzip2 writes all fields most-significant-bit first and pads the final
partial byte with zero bits.  The writer below buffers into a Python int
register; the vectorized bulk path (pack_bits) packs an array of
(value, nbits) pairs via cumulative offsets, which is the same two-pass
formulation the TPU bit-pack kernel uses.
"""

from __future__ import annotations

import numpy as np


class BitWriter:
    __slots__ = ("_out", "_acc", "_nbits")

    def __init__(self) -> None:
        self._out = bytearray()
        self._acc = 0  # bit accumulator, MSB-first
        self._nbits = 0

    def write(self, value: int, nbits: int) -> None:
        if nbits == 0:
            return
        self._acc = (self._acc << nbits) | (value & ((1 << nbits) - 1))
        self._nbits += nbits
        while self._nbits >= 8:
            self._nbits -= 8
            self._out.append((self._acc >> self._nbits) & 0xFF)
        self._acc &= (1 << self._nbits) - 1

    def write_bytes_msb(self, data: bytes) -> None:
        for b in data:
            self.write(b, 8)

    def write_array(self, values: np.ndarray, nbits: np.ndarray) -> None:
        """Append many (value, nbits) fields at once (vectorized)."""
        packed_bytes, tail_acc, tail_nbits = pack_bits(
            values, nbits, self._acc, self._nbits
        )
        self._out += packed_bytes
        self._acc = tail_acc
        self._nbits = tail_nbits

    @property
    def bit_length(self) -> int:
        return len(self._out) * 8 + self._nbits

    def append_writer(self, other: "BitWriter") -> None:
        """Splice another writer's bit stream onto this one (vectorized).

        Lets independent workers build block bitstreams in parallel and
        the assembler join them at arbitrary bit offsets: each of the
        other's whole bytes is shifted by this writer's live bit count
        with one numpy pass.
        """
        L = self._nbits
        if L == 0:
            self._out += other._out
        elif len(other._out):
            from starch3_tpu_torch.runtime import append_shifted_into

            new_acc = append_shifted_into(self._out, other._out, L, self._acc)
            if new_acc is not None:
                self._acc = new_acc
            else:
                arr = np.frombuffer(bytes(other._out), dtype=np.uint8)
                mask = (1 << L) - 1
                prev = np.empty(arr.size, dtype=np.uint8)
                prev[0] = self._acc & mask
                prev[1:] = arr[:-1] & mask
                merged = (
                    (prev.astype(np.uint16) << (8 - L)) | (arr >> L)
                ).astype(np.uint8)
                self._out += merged.tobytes()
                self._acc = int(arr[-1]) & mask
        if other._nbits:
            self.write(other._acc, other._nbits)

    def getvalue(self) -> bytes:
        """Zero-pad the final partial byte and return the stream."""
        out = bytes(self._out)
        if self._nbits:
            out += bytes([(self._acc << (8 - self._nbits)) & 0xFF])
        return out


def pack_bits(
    values: np.ndarray, nbits: np.ndarray, acc: int = 0, acc_nbits: int = 0
) -> tuple[bytes, int, int]:
    """Pack arrays of MSB-first bit fields into bytes (vectorized).

    Word-based two-pass algorithm (the same formulation the TPU bit-pack
    kernel uses): cumulative bit offsets place each field; a field lands in
    at most two 64-bit big-endian words, contributed with two scatter-adds
    (fields never overlap, so add == or).

    Returns (whole_bytes, tail_accumulator, tail_bit_count).
    """
    values = np.asarray(values, dtype=np.uint64)
    nbits = np.asarray(nbits, dtype=np.int64)
    if values.size == 0:
        return b"", acc, acc_nbits
    from starch3_tpu_torch.runtime import pack_bits_native

    native = pack_bits_native(values, nbits, acc, acc_nbits)
    if native is not None:
        return native
    if acc_nbits:
        values = np.concatenate(([np.uint64(acc)], values))
        nbits = np.concatenate(([acc_nbits], nbits))
    ends = np.cumsum(nbits)
    starts = ends - nbits
    total_bits = int(ends[-1])
    nwords = (total_bits + 63) // 64
    words = np.zeros(nwords + 1, dtype=np.uint64)
    w = (starts >> 6).astype(np.int64)
    off = starts & 63
    rs = 64 - off - nbits  # right shift to place the field's LSB
    fits = rs >= 0
    np.add.at(words, w[fits], values[fits] << rs[fits].astype(np.uint64))
    spans = ~fits
    if spans.any():
        hi_shift = (off[spans] + nbits[spans] - 64).astype(np.uint64)
        lo_shift = (128 - off[spans] - nbits[spans]).astype(np.uint64)
        np.add.at(words, w[spans], values[spans] >> hi_shift)
        np.add.at(words, w[spans] + 1, values[spans] << lo_shift)
    all_bytes = words.byteswap().tobytes()  # big-endian byte order
    nbytes = total_bits // 8
    tail_nbits = total_bits - nbytes * 8
    tail = all_bytes[nbytes] >> (8 - tail_nbits) if tail_nbits else 0
    return all_bytes[:nbytes], tail, tail_nbits


class BitReader:
    __slots__ = ("_data", "_pos")

    def __init__(self, data: bytes) -> None:
        self._data = data
        self._pos = 0  # absolute bit position

    def read(self, nbits: int) -> int:
        v = 0
        pos = self._pos
        data = self._data
        for _ in range(nbits):
            v = (v << 1) | ((data[pos >> 3] >> (7 - (pos & 7))) & 1)
            pos += 1
        self._pos = pos
        return v

    def read_bit(self) -> int:
        pos = self._pos
        b = (self._data[pos >> 3] >> (7 - (pos & 7))) & 1
        self._pos = pos + 1
        return b

    @property
    def bit_pos(self) -> int:
        return self._pos

    @property
    def bits_remaining(self) -> int:
        return len(self._data) * 8 - self._pos
