"""A Starch archive of sorted BED, as ``starch3_tpu_torch/format/SPEC.md``
(version 1.1) defines it, from the BED bytes alone:

- the transform: each chromosome's lines as text, a line ``p<stop -
  start>`` where the length differs from the line before (the first
  line's "before" is 0), then ``<start - previous stop>`` (the first
  line's previous stop is 0), a tab and the line's remainder after its
  third column where it has one, and a newline;
- each chromosome's stream: ``bz2.compress(text, 9)``, libbz2 at level 9;
- the archive: magic, the streams in input order, the metadata (canonical
  JSON: sorted keys, no spaces) with each stream's offsets, sizes,
  counts, SHA-256 and the bit offset of each bzip2 block, and the
  128-byte footer.

Written with NumPy and the standard library only, for inputs of any
size: each chromosome is worked out on its own thread (NumPy and libbz2
let the interpreter lock go)."""

from __future__ import annotations

import base64
import bz2
import hashlib
import json
import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np

MAGIC = bytes([0xCA, 0x5C, 0xAD, 0x1A])
FOOTER_BYTES = 128
FORMAT_TAG = b"starch3-tpu/1.1"
FORMAT_VERSION = {"major": 1, "minor": 1, "revision": 0}
BLOCK_MAGIC = bytes.fromhex("314159265359")  # a bzip2 block's 48-bit start
_NL, _TAB, _ZERO = 10, 9, 48


@dataclass
class Chromosome:
    name: str
    text: bytes
    line_count: int
    base_count_nonunique: int
    base_count_unique: int


@dataclass
class Archive:
    data: bytes
    streams: list  # (chromosome, first byte, end byte) of each stream
    metadata: tuple  # (first byte, end byte) of the metadata
    blocks: int  # bzip2 blocks of all streams


def chromosome_spans(bed: bytes) -> list[tuple[str, int, int]]:
    """``(name, first byte, end byte)`` of each chromosome's lines, in
    input order.  A chromosome ends before the first line that does not
    start with its name and a tab, found by bisection (its lines are
    contiguous in sorted BED); ``transform`` checks every line of it."""
    if not bed.endswith(b"\n"):
        raise ValueError("the reference takes BED whose last line ends with a newline")
    spans, pos, n = [], 0, len(bed)
    while pos < n:
        name = bed[pos : bed.index(b"\t", pos)]
        head = name + b"\t"
        lo, hi = pos, n  # the line at lo starts with head; hi is past the chromosome
        while hi - lo > 1:
            mid = (lo + hi) // 2
            start = bed.rfind(b"\n", 0, mid) + 1
            if bed.startswith(head, start):
                lo = mid
            else:
                hi = start if start > lo else mid
        end = bed.index(b"\n", lo) + 1
        spans.append((name.decode(), pos, end))
        pos = end
    names = [s[0] for s in spans]
    if len(set(names)) != len(names):
        raise ValueError("a chromosome's lines are not contiguous: the input is not sorted")
    return spans


def _parse_decimal(arr: np.ndarray, first: np.ndarray, end: np.ndarray) -> np.ndarray:
    """The non-negative decimal numbers ``arr[first:end]`` of each line."""
    width = end - first
    if width.size and (width.min() < 1 or width.max() > 18):
        raise ValueError("a coordinate with no digit or more than 18")
    vals = np.zeros(first.size, dtype=np.int64)
    for k in range(int(width.max()) if width.size else 0):
        live = width > k
        d = arr[np.where(live, first + k, 0)].astype(np.int64) - _ZERO
        if ((d < 0) | (d > 9))[live].any():
            raise ValueError("a coordinate that is not a decimal number")
        vals = np.where(live, vals * 10 + d, vals)
    return vals


def _decimal_width(vals: np.ndarray) -> np.ndarray:
    """Characters of each value as Python's ``str`` writes it."""
    mag = np.abs(vals)
    width = np.ones(vals.size, dtype=np.int64)
    for k in range(1, 19):
        width += mag >= 10**k
    return width + (vals < 0)


def _write_decimal(out: np.ndarray, at: np.ndarray, vals: np.ndarray, width: np.ndarray) -> None:
    """Write each value's ``str`` at ``out[at:at + width]``."""
    neg = vals < 0
    out[at[neg]] = ord("-")
    mag = np.abs(vals)
    last = at + width - 1
    for k in range(int(width.max()) if width.size else 0):
        live = width - neg > k
        out[(last - k)[live]] = (mag[live] // 10**k) % 10 + _ZERO


def transform(bed: bytes, name: str, first: int, end: int) -> Chromosome:
    """The transformed text and counts of the chromosome ``name``, whose
    lines are ``bed[first:end]``."""
    arr = np.frombuffer(bed, dtype=np.uint8, count=end - first, offset=first)
    line_end = np.flatnonzero(arr == _NL)
    line_first = np.concatenate(([0], line_end[:-1] + 1))
    tabs = np.flatnonzero(arr == _TAB)
    at = np.searchsorted(tabs, line_first)
    padded = np.concatenate((tabs, np.full(3, arr.size)))
    tab1, tab2, tab3 = padded[at], padded[at + 1], padded[at + 2]
    if (tab2 >= line_end).any():
        raise ValueError(f"{name}: a line with fewer than three columns")
    head = np.frombuffer(name.encode(), dtype=np.uint8)
    if (tab1 - line_first != head.size).any() or (
            arr[line_first[:, None] + np.arange(head.size)] != head).any():
        raise ValueError(f"{name}: a line of another chromosome among its lines")
    has_rest = tab3 < line_end
    starts = _parse_decimal(arr, tab1 + 1, tab2)
    stops = _parse_decimal(arr, tab2 + 1, np.where(has_rest, tab3, line_end))
    rest_first = np.where(has_rest, tab3 + 1, line_end)
    rest_len = line_end - rest_first  # an empty remainder writes no tab

    length = stops - starts
    new_length = length != np.concatenate(([0], length[:-1]))
    delta = starts - np.concatenate(([0], stops[:-1]))
    p_width, d_width = _decimal_width(length), _decimal_width(delta)
    p_bytes = np.where(new_length, p_width + 2, 0)
    line_bytes = p_bytes + d_width + np.where(rest_len > 0, rest_len + 1, 0) + 1
    line_at = np.concatenate(([0], np.cumsum(line_bytes)))
    out = np.empty(int(line_at[-1]), dtype=np.uint8)

    p_at = line_at[:-1][new_length]
    out[p_at] = ord("p")
    _write_decimal(out, p_at + 1, length[new_length], p_width[new_length])
    out[p_at + 1 + p_width[new_length]] = _NL
    d_at = line_at[:-1] + p_bytes
    _write_decimal(out, d_at, delta, d_width)
    with_rest = rest_len > 0
    tab_at = (d_at + d_width)[with_rest]
    out[tab_at] = _TAB
    n_rest = rest_len[with_rest]
    if n_rest.size:
        offset_in = np.repeat(np.cumsum(n_rest) - n_rest, n_rest)
        step = np.arange(int(n_rest.sum()), dtype=np.int64) - offset_in
        out[np.repeat(tab_at + 1, n_rest) + step] = arr[np.repeat(rest_first[with_rest], n_rest) + step]
    out[line_at[1:] - 1] = _NL

    order = np.argsort(starts, kind="stable")
    s, e = starts[order], stops[order]
    covered = np.concatenate(([s[0]], np.maximum.accumulate(e)[:-1]))
    unique = int(np.maximum(e - np.maximum(s, covered), 0).sum())
    return Chromosome(name, out.tobytes(), int(starts.size), int(length.sum()), unique)


def block_bit_offsets(stream: bytes) -> list[int]:
    """The bit offset of each bzip2 block's 48-bit magic in ``stream``,
    found at every bit alignment."""
    raw = np.frombuffer(stream, dtype=np.uint8).astype(np.uint16)
    found = []
    for shift in range(8):
        seen = ((raw[:-1] << shift) | (raw[1:] >> (8 - shift))).astype(np.uint8).tobytes() if shift else stream
        at = seen.find(BLOCK_MAGIC)
        while at >= 0:
            found.append(8 * at + shift)
            at = seen.find(BLOCK_MAGIC, at + 1)
    return sorted(found)


def _stream(bed: bytes, span, level: int) -> tuple[Chromosome, bytes, list[int]]:
    chrom = transform(bed, *span)
    stream = bz2.compress(chrom.text, level)
    return chrom, stream, block_bit_offsets(stream)


def metadata_bytes(entries: list[dict], note: str = "", final_newline: bool = True) -> bytes:
    doc = {"compressionFormat": "bzip2", "note": note, "streams": entries, "type": "starch3-tpu",
           "version": FORMAT_VERSION}
    if not final_newline:
        doc["finalNewline"] = False
    return json.dumps(doc, sort_keys=True, separators=(",", ":")).encode()


def footer(metadata_at: int, meta: bytes) -> bytes:
    return (str(metadata_at).rjust(20, "0").encode() + base64.b64encode(hashlib.sha256(meta).digest())
            + FORMAT_TAG.ljust(16, b"\0") + bytes(44) + MAGIC)


def archive(bed: bytes, level: int = 9, workers: int | None = None, offsets: bool = True) -> Archive:
    """The archive of ``bed``.  ``level`` and ``offsets`` exist for the
    controls only, which break its guarantee: streams at another bzip2
    level, or metadata without the blocks' bit offsets."""
    spans = chromosome_spans(bed)
    with ThreadPoolExecutor(workers or os.cpu_count() or 1) as pool:
        done = list(pool.map(lambda span: _stream(bed, span, level), spans))
    parts, entries, streams, at, blocks = [MAGIC], [], [], len(MAGIC), 0
    for chrom, stream, bit_offsets in done:
        entry = {"base_count_nonunique": chrom.base_count_nonunique,
                 "base_count_unique": chrom.base_count_unique,
                 "block_bit_offsets": bit_offsets if offsets else [],
                 "byte_offset": at, "chromosome": chrom.name, "filename": f"{chrom.name}.bz2",
                 "line_count": chrom.line_count, "signature": hashlib.sha256(stream).hexdigest(),
                 "size": len(stream), "uncompressed_size": len(chrom.text)}
        entries.append(entry)
        streams.append((chrom.name, at, at + len(stream)))
        parts.append(stream)
        at += len(stream)
        blocks += len(bit_offsets)
    meta = metadata_bytes(entries)
    parts += [meta, footer(at, meta)]
    return Archive(b"".join(parts), streams, (at, at + len(meta)), blocks)
