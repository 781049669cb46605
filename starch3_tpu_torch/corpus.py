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


def _write_chromosomes(path, target: int, chromosome, names=None) -> tuple[str, int]:
    """Write the chromosomes ``names`` (``chr1``, ``chr2``, ... without
    end by default) to ``path`` until at least ``target`` bytes are
    written or the names run out, each chromosome's lines the ``bytes``
    chunks of ``chromosome(name)``; returns the SHA-256 hex digest and
    byte count."""
    import hashlib
    import itertools

    digest = hashlib.sha256()
    written = 0
    with open(path, "wb") as f:
        for name in names or (f"chr{c}" for c in itertools.count(1)):
            if written >= target:
                break
            for chunk in chromosome(name.encode()):
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


def config4_scale_bed(path, target: int, seed: int = 19, n_total: int = 100_000_000) -> tuple[str, int]:
    """BASELINE config 4, "Large unsorted-input stress: 100M-interval WGS
    variant BED", in chunks: 3-column BED of ``chr1``..``chr22``, ``chrX``,
    ``chrY`` (``GRCH38_LENGTHS``' order), ``round(n_total * length /
    GRCH38_TOTAL)`` intervals each, whole chromosomes until at least
    ``target`` bytes or the last one.  A smaller ``target`` gives a prefix
    of a larger one.

    For each run of up to ``_LINES`` lines of a chromosome,
    ``np.random.default_rng(seed)`` draws the site gaps (1..60, after
    10,000 and the run before), then which lines are indels (1 in 10),
    their lengths (2..50) and their shifts (1..100), each for every line
    of the run.  A site is an SNV, ``stop = start + 1``, or an indel of
    its length whose start and stop move left by its shift: indels left
    normalised with no re-sort after (``bcftools norm``'s realignment
    moves records out of order; its ``--site-win`` re-sort is not done),
    so the starts go back and the transform's deltas are negative."""
    gen = np.random.default_rng(seed)

    def chromosome(name):
        n = round(n_total * GRCH38_LENGTHS[name.decode()] / GRCH38_TOTAL)
        last = 10_000
        for lo in range(0, n, _LINES):
            m = min(_LINES, n - lo)
            sites = last + np.cumsum(gen.integers(1, 61, m))
            last = int(sites[-1])
            indel = gen.integers(0, 10, m) == 0
            lens, shifts = gen.integers(2, 51, m), gen.integers(1, 101, m)
            starts = np.where(indel, sites - shifts, sites)
            stops = starts + np.where(indel, lens, 1)
            yield _tab_rows([_const(m, name), _decimal_columns(starts), _decimal_columns(stops)])

    return _write_chromosomes(path, target, chromosome, GRCH38_LENGTHS)


# the read names of ``reads_scale_bed``: the instrument, run and flowcell
# of one library on two NovaSeq flowcells, and NovaSeq S4's tile numbers
# (surfaces 1-2, swaths 1-2, tiles 01-78 of each)
_READ_RUNS = np.array([list(b"A00123:45:HHKJ3DSXY:"), list(b"A00123:47:HGV2FDSXY:")], dtype=np.uint8)
_S4_TILES = (np.array([1101, 1201, 2101, 2201])[:, None] + np.arange(78)).ravel()


def reads_scale_bed(path, target: int, seed: int = 23, n_total: int = 20_000_000) -> tuple[str, int]:
    """BASELINE config 3, "BED with extra id/score/strand columns", as the
    BED6 that Starch users archive most: aligned single-end ChIP-seq
    reads, as ``bedtools bamtobed`` writes them (name the SAM QNAME, score
    the MAPQ, strand), ``n_total`` reads, the usable fragments the ENCODE
    ChIP-seq standards ask of a replicate.  GRCh38's 24 chromosomes in
    ``GRCH38_LENGTHS``' order, ``round(n_total * length / GRCH38_TOTAL)``
    reads each, whole chromosomes until at least ``target`` bytes or the
    last one; a smaller ``target`` gives a prefix of a larger one.

    For each run of up to ``_LINES`` lines of a chromosome,
    ``np.random.default_rng(seed)`` draws, each for every line of the
    run: the start gaps, geometric with a mean of the chromosome's length
    over its reads (after 10,000 and the run before); which gaps are 0 (1
    in 20, duplicate starts; never a run's first, so the order holds
    across runs); which reads hold an indel (1 in 50), its size (1..3) and
    whether it is a deletion (51..53 bp) or an insertion (47..49 bp; 50 bp
    otherwise); the flowcell (``45:HHKJ3DSXY`` or ``47:HGV2FDSXY``), the
    lane (1..4), the S4 tile, x (1000..32000) and y (1000..37000) of the
    Illumina name ``A00123:<run>:<flowcell>:<lane>:<tile>:<x>:<y>``;
    whether the MAPQ is 42 (4 in 5, bowtie2's unique hits) and the rest's
    (30..41, what ``samtools view -q 30`` keeps); the strand.  The lines
    are ordered by start, then end, as ``sort-bed`` orders them: the
    spans of a start's duplicates sorted among them, the names in draw
    order, so that names are not ordered by position."""
    gen = np.random.default_rng(seed)

    def chromosome(name):
        length = GRCH38_LENGTHS[name.decode()]
        n = round(n_total * length / GRCH38_TOTAL)
        last = 10_000
        for lo in range(0, n, _LINES):
            m = min(_LINES, n - lo)
            gaps = gen.geometric(n / length, m)
            dup = gen.integers(0, 20, m) == 0
            dup[0] = False
            starts = last + np.cumsum(np.where(dup, 0, gaps))
            last = int(starts[-1])
            indel, size, deletion = gen.integers(0, 50, m) == 0, gen.integers(1, 4, m), gen.integers(0, 2, m) == 1
            stops = starts + 50 + np.where(indel, np.where(deletion, size, -size), 0)
            stops = stops[np.lexsort((stops, starts))]  # starts are in order: the duplicates' spans sort
            flowcell, lane = gen.integers(0, 2, m), gen.integers(1, 5, m)
            tile = _S4_TILES[gen.integers(0, _S4_TILES.size, m)]
            x, y = gen.integers(1000, 32001, m), gen.integers(1000, 37001, m)
            mapq = np.where(gen.integers(0, 5, m) != 0, 42, gen.integers(30, 42, m))
            strands = gen.integers(0, 2, m)
            colon = _const(m, b":")
            qname = _joined((_READ_RUNS[flowcell], np.ones((m, _READ_RUNS.shape[1]), bool)), _decimal_columns(lane),
                            colon, _decimal_columns(tile), colon, _decimal_columns(x), colon, _decimal_columns(y))
            yield _tab_rows([_const(m, name), _decimal_columns(starts), _decimal_columns(stops), qname,
                             _decimal_columns(mapq), _strands(strands)])

    return _write_chromosomes(path, target, chromosome, GRCH38_LENGTHS)


def chr21_bed(n_intervals: int = 100_000, seed: int = 21) -> bytes:
    """BASELINE config 1, "Single-chromosome sorted BED (chr21, ~100K
    intervals, 3-column)": the bytes of ``make_chr21_bed`` in the
    repository's ``bench.py`` (gaps 1..899 after 5,010,000, lengths
    20..399).  Its transformed text is one block at level 9."""
    rng = np.random.default_rng(seed)
    starts = 5_010_000 + np.cumsum(rng.integers(1, 900, n_intervals))
    stops = starts + rng.integers(20, 400, n_intervals)
    return b"\n".join(b"chr21\t%d\t%d" % (s, e) for s, e in zip(starts.tolist(), stops.tolist())) + b"\n"


# the scale corpora by shape, each ``(path, target, seed=..., <size>=...)``
# -> (SHA-256 hex digest, bytes), where the size is ``n_per``, the
# intervals a chromosome, or for config4 and reads ``n_total``, the
# intervals of all their chromosomes; the tier of every block of each;
# and the shapes whose starts go back within a chromosome (config 4's
# variant BED, which ``sort-bed`` has not ordered), so that the transform
# takes its unsorted branch
SCALE_SHAPES = {"bed3": gigabyte_bed, "config3": config3_scale_bed, "bits6": bits6_scale_bed,
                "wide8": wide8_scale_bed, "config4": config4_scale_bed, "reads": reads_scale_bed}
SCALE_TIERS = {"bed3": 4, "config3": 5, "bits6": 6, "wide8": 8, "config4": 4, "reads": 5}
SCALE_UNSORTED = frozenset({"config4"})
