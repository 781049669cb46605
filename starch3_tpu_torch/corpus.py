"""Seeded BED corpora for on-card runs (``chip_smoke.py``,
``profile_step.py``), in the shape of ``bench.py``'s generators (gaps
1..2000, lengths 20..500), one per alphabet tier of the device path:

  - ``config2_bed``: BASELINE config 2, 3-column BED (bits 4);
  - ``config3_bed``: BASELINE config 3, BED6 with peak ids, scores and
    strands (about 21 symbols: bits 5);
  - ``bits6_bed``: gene-style ids and decimal scores (about 43 symbols:
    bits 6);
  - ``wide8_bed``: BED6 with mixed-case free-text names (more than 64
    symbols: bits 8).
"""

from __future__ import annotations

import numpy as np

GENOME_CHROMS = tuple(f"chr{c}" for c in list(range(1, 23)) + ["X", "Y"])


def _intervals(rng, n_per: int):
    starts = 10_000 + np.cumsum(rng.integers(1, 2000, n_per))
    stops = starts + rng.integers(20, 500, n_per)
    return starts.tolist(), stops.tolist()


def make_bed(chroms, n_per: int, seed: int) -> bytes:
    """Sorted 3-column BED, ``n_per`` intervals per chromosome."""
    rng = np.random.default_rng(seed)
    parts = []
    for name in chroms:
        starts, stops = _intervals(rng, n_per)
        parts.append(
            b"\n".join(b"%s\t%d\t%d" % (name.encode(), s, e) for s, e in zip(starts, stops))
        )
    return b"\n".join(parts) + b"\n"


def config2_bed(seed: int) -> bytes:
    """BASELINE config 2: 24 chromosomes of 45,000 intervals (~25 MB)."""
    return make_bed(GENOME_CHROMS, 45_000, seed)


def big_chrom_bed(seed: int) -> bytes:
    """One chromosome of 400,000 intervals (~3.7 MB of transformed text):
    multi-block streams and the 901,120 geometry bucket."""
    return make_bed(["chrBig"], 400_000, seed)


def config3_bed(seed: int = 7, n_per: int = 25_000) -> bytes:
    """BASELINE config 3 (``bench.py`` ``make_genome_bed_wide``): 24
    chromosomes of ``n_per`` intervals with ``peak_<i>`` ids, scores
    0..999 and strands.  The transform keeps the remainder columns
    verbatim, so each block has about 21 distinct bytes: bits 5."""
    rng = np.random.default_rng(seed)
    parts = []
    for name in GENOME_CHROMS:
        starts, stops = _intervals(rng, n_per)
        scores = rng.integers(0, 1000, n_per).tolist()
        strands = rng.integers(0, 2, n_per).tolist()
        parts.append(
            b"\n".join(
                b"%s\t%d\t%d\tpeak_%d\t%d\t%s"
                % (name.encode(), s, e, i, sc, b"+" if st else b"-")
                for i, (s, e, sc, st) in enumerate(zip(starts, stops, scores, strands))
            )
        )
    return b"\n".join(parts) + b"\n"


_SYLLABLES = (
    b"lo", b"ra", b"mek", b"tin", b"vas", b"pol", b"dur", b"sen",
    b"cab", b"fog", b"hex", b"jaw", b"zyg", b"qub", b"wix", b"byr",
)


def bits6_bed(seed: int = 13, n_per: int = 25_000) -> bytes:
    """The bits==6 corpus of ``bench.py`` (``make_genome_bed_bits6``):
    24 chromosomes of ``n_per`` intervals with lowercase gene-style ids,
    decimal scores and strands, about 43 distinct bytes per block."""
    rng = np.random.default_rng(seed)
    parts = []
    for name in GENOME_CHROMS:
        starts, stops = _intervals(rng, n_per)
        picks = rng.integers(0, len(_SYLLABLES), (n_per, 3)).tolist()
        scores = rng.integers(0, 100000, n_per).tolist()
        strands = rng.integers(0, 2, n_per).tolist()
        lines = []
        for i, (s, e, pk, sc, st) in enumerate(zip(starts, stops, picks, scores, strands)):
            gene = b"".join(_SYLLABLES[j] for j in pk) + b"_%d.%d" % (i % 97, sc % 10)
            lines.append(
                b"%s\t%d\t%d\t%s\t%d.%02d\t%s"
                % (name.encode(), s, e, gene, sc // 100, sc % 100, b"+" if st else b"-")
            )
        parts.append(b"\n".join(lines))
    return b"\n".join(parts) + b"\n"


_NAME_CHARS = np.frombuffer(
    b"ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789._", dtype=np.uint8
)


def wide8_bed(seed: int = 17, chroms=("chr1", "chr2", "chr3"), n_per: int = 40_000) -> bytes:
    """BED6 whose name column holds seeded mixed-case identifiers of 12-20
    characters over ``[A-Za-z0-9._]``, with scores 0..999 and strands.

    Every block of its transformed text has more than 64 distinct bytes
    (bits 8; checked here).  At the default size each chromosome's stream
    is two blocks, a full one in the 901,120 bucket and one in the
    458,752 bucket.  Names this long keep most 16-symbol contexts unique,
    so the bits==8 sort is mostly tie-free."""
    from starch3_tpu_torch.api import _parse_transform
    from starch3_tpu_torch.parallel.host import _split_classify

    rng = np.random.default_rng(seed)
    parts = []
    for name in chroms:
        starts, stops = _intervals(rng, n_per)
        lens = rng.integers(12, 21, n_per)
        chars = _NAME_CHARS[rng.integers(0, _NAME_CHARS.size, (n_per, 20))]
        scores = rng.integers(0, 1000, n_per).tolist()
        strands = rng.integers(0, 2, n_per).tolist()
        parts.append(
            b"\n".join(
                b"%s\t%d\t%d\t%s\t%d\t%s"
                % (name.encode(), s, e, chars[i, : lens[i]].tobytes(), sc, b"+" if st else b"-")
                for i, (s, e, sc, st) in enumerate(zip(starts, stops, scores, strands))
            )
        )
    bed = b"\n".join(parts) + b"\n"
    for tf in _parse_transform(bed):
        blocks, classes = _split_classify(tf.text, 9)
        assert set(classes) == {8}, (tf.chrom, classes)
    return bed



# the five ASCII digits of every number below 100,000, zero-padded
_DIGITS5 = ((np.arange(100_000)[:, None] // 10 ** np.arange(4, -1, -1)) % 10 + 48).astype(np.uint8)
_POW10 = 10 ** np.arange(1, 10, dtype=np.int64)


def _decimal_columns(values: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
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


def gigabyte_bed(path, target: int, seed: int = 11, n_per: int = 2_000_000) -> tuple[str, int]:
    """Write the scale corpus to ``path`` in chunks and return its SHA-256
    hex digest and byte count.

    Sorted 3-column BED: ``chr1``, ``chr2``, ... of ``n_per`` intervals
    each, start gaps 1..1499 after 10,000 and lengths 20..399 from
    ``np.random.default_rng(seed)``, whole chromosomes appended until at
    least ``target`` bytes are written.  At the default ``n_per`` these are
    the bytes of ``TestGigabyteScale.GEN`` in ``tests/test_archive.py``
    (the same draws, formatted here with NumPy instead of a line loop);
    at ``target = 1.1e9`` about 44M intervals in 20 chromosomes, the
    shape of BASELINE config 4 (a WGS BED of many blocks per
    chromosome).  A smaller ``target`` gives a prefix of a larger one."""
    import hashlib

    gen = np.random.default_rng(seed)
    digest = hashlib.sha256()
    written = 0
    c = 0
    with open(path, "wb") as f:
        while written < target:
            c += 1
            name = np.frombuffer(f"chr{c}".encode(), dtype=np.uint8)
            starts = 10_000 + np.cumsum(gen.integers(1, 1500, n_per))
            stops = starts + gen.integers(20, 400, n_per)
            for lo in range(0, n_per, 250_000):  # GEN's chunks, a bounded buffer
                s, e = starts[lo : lo + 250_000], stops[lo : lo + 250_000]
                # the lines as rows of "name \t start \t stop \n", each
                # number padded on the left; the mask drops the padding
                cols, keep = [np.broadcast_to(name, (s.size, name.size))], [np.ones((s.size, name.size), bool)]
                for v in (s, e):
                    d, k = _decimal_columns(v)
                    cols += [np.full((s.size, 1), 9, np.uint8), d]
                    keep += [np.ones((s.size, 1), bool), k]
                cols.append(np.full((s.size, 1), 10, np.uint8))
                keep.append(np.ones((s.size, 1), bool))
                out = np.concatenate(cols, axis=1)[np.concatenate(keep, axis=1)]
                chunk = out.tobytes()
                f.write(chunk)
                digest.update(chunk)
                written += len(chunk)
    return digest.hexdigest(), written
