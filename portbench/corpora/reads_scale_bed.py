"""Aligned single-end ChIP-seq reads as ``bedtools bamtobed`` writes them
(BED6: the SAM QNAME, the MAPQ, the strand): the bytes of
``starch3_tpu_torch.corpus.reads_scale_bed`` for the same target, seed
and ``n_total``.

GRCh38's 24 chromosomes in ``GRCH38_LENGTHS``' order,
``round(n_total * length / GRCH38_TOTAL)`` reads each, whole chromosomes
until at least ``target`` bytes or the last one.  For each run of up to
``LINES`` lines of a chromosome, ``np.random.default_rng(seed)`` draws
the start gaps (geometric, mean the chromosome's length over its reads),
the duplicate starts (1 in 20, never a run's first), the indels (1 in 50,
1..3 bp, deletion or insertion), the flowcell, lane, S4 tile, x and y of
the Illumina name, the MAPQ (42 four times in five, else 30..41) and the
strand.  Lines are ordered by start, then end, as ``sort-bed`` orders
them."""

from __future__ import annotations

import functools

import numpy as np

from portbench.corpora.columns import (
    GRCH38_LENGTHS, GRCH38_TOTAL, LINES, chromosomes, const, decimal_columns, joined, strands, tab_rows,
)

# the instrument, run and flowcell of one library on two NovaSeq
# flowcells, and NovaSeq S4's tile numbers (surfaces 1-2, swaths 1-2,
# tiles 01-78 of each)
_READ_RUNS = np.array([list(b"A00123:45:HHKJ3DSXY:"), list(b"A00123:47:HGV2FDSXY:")], dtype=np.uint8)
_S4_TILES = (np.array([1101, 1201, 2101, 2201])[:, None] + np.arange(78)).ravel()


def _run(name: bytes, starts, stops, flowcell, lane, tile, x, y, mapq, strand) -> bytes:
    m = starts.size
    colon = const(m, b":")
    qname = joined((_READ_RUNS[flowcell], np.ones((m, _READ_RUNS.shape[1]), bool)), decimal_columns(lane),
                   colon, decimal_columns(tile), colon, decimal_columns(x), colon, decimal_columns(y))
    return tab_rows([const(m, name), decimal_columns(starts), decimal_columns(stops), qname,
                     decimal_columns(mapq), strands(strand)])


def chunks(target: int, seed, n_total: int = 20_000_000):
    gen = np.random.default_rng(seed)

    def chromosome(name):
        length = GRCH38_LENGTHS[name.decode()]
        n = round(n_total * length / GRCH38_TOTAL)
        last = 10_000
        runs = []
        for lo in range(0, n, LINES):
            m = min(LINES, n - lo)
            gaps = gen.geometric(n / length, m)
            dup = gen.integers(0, 20, m) == 0
            dup[0] = False
            starts = last + np.cumsum(np.where(dup, 0, gaps))
            last = int(starts[-1])
            indel, size, deletion = gen.integers(0, 50, m) == 0, gen.integers(1, 4, m), gen.integers(0, 2, m) == 1
            stops = starts + 50 + np.where(indel, np.where(deletion, size, -size), 0)
            stops = stops[np.lexsort((stops, starts))]
            flowcell, lane = gen.integers(0, 2, m), gen.integers(1, 5, m)
            tile = _S4_TILES[gen.integers(0, _S4_TILES.size, m)]
            x, y = gen.integers(1000, 32001, m), gen.integers(1000, 37001, m)
            mapq = np.where(gen.integers(0, 5, m) != 0, 42, gen.integers(30, 42, m))
            strand = gen.integers(0, 2, m)
            runs.append(functools.partial(_run, name, starts, stops, flowcell, lane, tile, x, y, mapq, strand))
        return runs

    return chromosomes(target, chromosome, GRCH38_LENGTHS)
