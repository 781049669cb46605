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


_LINES = 250_000  # lines formatted at a time: a bounded buffer


def _tab_rows(fields) -> bytes:
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


def _const(m: int, text: bytes):
    row = np.frombuffer(text, dtype=np.uint8)
    return np.broadcast_to(row, (m, row.size)), np.ones((m, row.size), bool)


def _joined(*fields):
    """One field made of several, side by side (``peak_`` and a number)."""
    return np.concatenate([c for c, _ in fields], axis=1), np.concatenate([k for _, k in fields], axis=1)


def _strands(st: np.ndarray):
    return np.where(st, 43, 45).astype(np.uint8)[:, None], np.ones((st.size, 1), bool)


def _write_chromosomes(path, target: int, chromosome) -> tuple[str, int]:
    """Write ``chr1``, ``chr2``, ... to ``path`` until at least ``target``
    bytes are written, each chromosome's lines the ``bytes`` chunks of
    ``chromosome(name)``; returns the SHA-256 hex digest and byte count."""
    import hashlib

    digest = hashlib.sha256()
    written = 0
    c = 0
    with open(path, "wb") as f:
        while written < target:
            c += 1
            for chunk in chromosome(f"chr{c}".encode()):
                f.write(chunk)
                digest.update(chunk)
                written += len(chunk)
    return digest.hexdigest(), written


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
    gen = np.random.default_rng(seed)

    def chromosome(name):
        starts = 10_000 + np.cumsum(gen.integers(1, 1500, n_per))
        stops = starts + gen.integers(20, 400, n_per)
        for lo in range(0, n_per, _LINES):  # GEN's chunks
            s, e = starts[lo : lo + _LINES], stops[lo : lo + _LINES]
            yield _tab_rows([_const(s.size, name), _decimal_columns(s), _decimal_columns(e)])

    return _write_chromosomes(path, target, chromosome)


def _bed6_scale(path, target: int, seed: int, n_per: int, remainder) -> tuple[str, int]:
    """The chunked writer of the BED6 scale shapes: ``chr1``, ``chr2``, ...
    of ``n_per`` intervals each, whole chromosomes until at least
    ``target`` bytes.  For each run of up to 250,000 lines of a
    chromosome, ``np.random.default_rng(seed)`` draws the start gaps
    (1..1999, after 10,000 and the run before), the lengths (20..499),
    then ``remainder(gen, first, m)``'s columns of lines ``first`` to
    ``first + m - 1``.  A smaller ``target`` gives a prefix of a larger
    one."""
    gen = np.random.default_rng(seed)

    def chromosome(name):
        last = 10_000
        for lo in range(0, n_per, _LINES):
            m = min(_LINES, n_per - lo)
            starts = last + np.cumsum(gen.integers(1, 2000, m))
            stops = starts + gen.integers(20, 500, m)
            last = int(starts[-1])
            yield _tab_rows([_const(m, name), _decimal_columns(starts), _decimal_columns(stops),
                             *remainder(gen, lo, m)])

    return _write_chromosomes(path, target, chromosome)


def config3_scale_bed(path, target: int, seed: int = 7, n_per: int = 2_000_000) -> tuple[str, int]:
    """``config3_bed``'s shape (BASELINE config 3: ``peak_<i>`` ids
    numbered from 0 in each chromosome, scores 0..999, strands; bits 5)
    at scale, written by ``_bed6_scale``: each run draws its scores, then
    its strands."""

    def remainder(gen, lo, m):
        scores, strands = gen.integers(0, 1000, m), gen.integers(0, 2, m)
        peak = _joined(_const(m, b"peak_"), _decimal_columns(np.arange(lo, lo + m)))
        return [peak, _decimal_columns(scores), _strands(strands)]

    return _bed6_scale(path, target, seed, n_per, remainder)


_SYLLABLE_ROWS = np.array([list(s.ljust(3)) for s in _SYLLABLES], dtype=np.uint8)
_SYLLABLE_LENS = np.array([len(s) for s in _SYLLABLES])


def bits6_scale_bed(path, target: int, seed: int = 13, n_per: int = 2_000_000) -> tuple[str, int]:
    """``bits6_bed``'s shape (gene ids of three syllables and
    ``_<i % 97>.<score % 10>``, scores ``%d.%02d`` of 0..99,999, strands;
    bits 6) at scale, written by ``_bed6_scale``: each run draws its
    syllables (three a line), then its scores, then its strands."""

    def remainder(gen, lo, m):
        picks = gen.integers(0, len(_SYLLABLES), (m, 3))
        scores, strands = gen.integers(0, 100_000, m), gen.integers(0, 2, m)
        gene = _joined(*((_SYLLABLE_ROWS[picks[:, j]], np.arange(3)[None, :] < _SYLLABLE_LENS[picks[:, j], None])
                         for j in range(3)),
                       _const(m, b"_"), _decimal_columns(np.arange(lo, lo + m) % 97),
                       _const(m, b"."), _decimal_columns(scores % 10))
        hundredths = _DIGITS5[scores % 100][:, 3:], np.ones((m, 2), bool)
        score = _joined(_decimal_columns(scores // 100), _const(m, b"."), hundredths)
        return [gene, score, _strands(strands)]

    return _bed6_scale(path, target, seed, n_per, remainder)


def wide8_scale_bed(path, target: int, seed: int = 17, n_per: int = 2_000_000) -> tuple[str, int]:
    """``wide8_bed``'s shape (names of 12-20 characters over
    ``[A-Za-z0-9._]``, scores 0..999, strands; bits 8) at scale, written
    by ``_bed6_scale``: each run draws its name lengths, then 20
    characters a line, then its scores, then its strands."""

    def remainder(gen, lo, m):
        lens = gen.integers(12, 21, m)
        chars = _NAME_CHARS[gen.integers(0, _NAME_CHARS.size, (m, 20))]
        scores, strands = gen.integers(0, 1000, m), gen.integers(0, 2, m)
        return [(chars, np.arange(20)[None, :] < lens[:, None]), _decimal_columns(scores), _strands(strands)]

    return _bed6_scale(path, target, seed, n_per, remainder)


# the scale corpora by shape, each ``(path, target, seed=..., n_per=...)``
# -> (SHA-256 hex digest, bytes), and the tier of every block of each
SCALE_SHAPES = {"bed3": gigabyte_bed, "config3": config3_scale_bed, "bits6": bits6_scale_bed,
                "wide8": wide8_scale_bed}
SCALE_TIERS = {"bed3": 4, "config3": 5, "bits6": 6, "wide8": 8}
