"""Vectorised formatting of BED columns (copied from
``starch3_tpu_torch/corpus.py``): numbers as rows of ASCII digits and
lines of tab-separated fields, a bounded run of lines at a time."""

from __future__ import annotations

import itertools
from concurrent.futures import ThreadPoolExecutor

import numpy as np

LINES = 250_000  # lines formatted at a time: a bounded buffer

# the five ASCII digits of every number below 100,000, zero-padded
_DIGITS5 = ((np.arange(100_000)[:, None] // 10 ** np.arange(4, -1, -1)) % 10 + 48).astype(np.uint8)
_POW10 = 10 ** np.arange(1, 10, dtype=np.int64)

# GRCh38's primary assembly, chr1..chr22, chrX and chrY: their lengths
# (UCSC ``hg38.chrom.sizes``; NCBI GCA_000001405.15) and their sum
GRCH38_LENGTHS = {
    "chr1": 248_956_422, "chr2": 242_193_529, "chr3": 198_295_559, "chr4": 190_214_555,
    "chr5": 181_538_259, "chr6": 170_805_979, "chr7": 159_345_973, "chr8": 145_138_636,
    "chr9": 138_394_717, "chr10": 133_797_422, "chr11": 135_086_622, "chr12": 133_275_309,
    "chr13": 114_364_328, "chr14": 107_043_718, "chr15": 101_991_189, "chr16": 90_338_345,
    "chr17": 83_257_441, "chr18": 80_373_285, "chr19": 58_617_616, "chr20": 64_444_167,
    "chr21": 46_709_983, "chr22": 50_818_468, "chrX": 156_040_895, "chrY": 57_227_415,
}
GRCH38_TOTAL = 3_088_269_832


def decimal_columns(values: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Each ``values[i]`` (non-negative, below 10**10) as a row of ASCII
    digits, zero-padded on the left to the widest, and the mask of the
    digits that print."""
    if values.size and int(values.max()) >= 10**10:
        raise ValueError("a value of 10**10 or more")
    hi, lo = np.divmod(values, 100_000)
    ndig = 1 + np.searchsorted(_POW10, values, side="right")
    width = int(ndig.max())
    digits = np.concatenate([_DIGITS5[hi], _DIGITS5[lo]], axis=1)[:, 10 - width :]
    return digits, np.arange(width)[None, :] >= (width - ndig)[:, None]


def tab_rows(fields) -> bytes:
    """Lines of tab-separated fields, each ``(cols, keep)``: a uint8 row
    of bytes per line, padded, and the mask of the bytes that print."""
    m = fields[0][0].shape[0]
    sep = (np.full((m, 1), 9, np.uint8), np.ones((m, 1), bool))
    cols, keep = [], []
    for i, (c, k) in enumerate(fields):
        cols += [sep[0], c] if i else [c]
        keep += [sep[1], k] if i else [k]
    cols.append(np.full((m, 1), 10, np.uint8))
    keep.append(np.ones((m, 1), bool))
    return np.concatenate(cols, axis=1)[np.concatenate(keep, axis=1)].tobytes()


def const(m: int, text: bytes):
    row = np.frombuffer(text, dtype=np.uint8)
    return np.broadcast_to(row, (m, row.size)), np.ones((m, row.size), bool)


def joined(*fields):
    """One field made of several, side by side (``peak_`` and a number)."""
    return np.concatenate([c for c, _ in fields], axis=1), np.concatenate([k for _, k in fields], axis=1)


def strands(st: np.ndarray):
    return np.where(st, 43, 45).astype(np.uint8)[:, None], np.ones((st.size, 1), bool)


def chromosomes(target: int | None, chromosome, names=None, workers: int = 8):
    """The chunks of the chromosomes ``names`` (``chr1``, ``chr2``, ...
    without end by default) until at least ``target`` bytes are yielded or
    the names run out (all of them where ``target`` is None).
    ``chromosome(name)`` makes a chromosome's draws, in their order, and
    returns its runs of lines as callables that format them; the runs
    are formatted on ``workers`` threads (NumPy lets the interpreter lock
    go while it copies) and yielded in order, so the bytes are those of
    formatting them one after another."""
    written = 0
    with ThreadPoolExecutor(workers) as pool:
        for name in names or (f"chr{c}" for c in itertools.count(1)):
            if target is not None and written >= target:
                break
            for chunk in pool.map(lambda run: run(), chromosome(name.encode())):
                written += len(chunk)
                yield chunk
