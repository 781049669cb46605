"""Sorted whole-genome 3-column BED in the shape of ENCODE's registry of
candidate cis-regulatory elements (cCREs) on GRCh38, as ``cut -f1-3`` of
its BED and ``sort-bed`` give it: ``n_total`` intervals on GRCh38's 24
chromosomes in ``GRCH38_LENGTHS``' order, ``round(n_total * length /
GRCH38_TOTAL)`` each, whole chromosomes until at least ``target`` bytes
or the last one (every chromosome where ``target`` is None).

For each chromosome of ``n`` intervals and length ``L``,
``np.random.default_rng(seed)`` draws ``n`` positions (0..L - SPAN * n,
then sorted) and then ``n`` lengths (``lengths``, both ends included).
The ``i``-th interval starts at its position plus ``SPAN * i``, so no two
intervals overlap, every stop lies inside its chromosome, and the lines
are in ``sort-bed`` order."""

from __future__ import annotations

import functools

import numpy as np

from portbench.corpora.columns import (
    GRCH38_LENGTHS, GRCH38_TOTAL, LINES, chromosomes, const, decimal_columns, tab_rows,
)

SPAN = 350  # no interval is longer: the room each one takes


def _run(name: bytes, starts: np.ndarray, stops: np.ndarray) -> bytes:
    return tab_rows([const(starts.size, name), decimal_columns(starts), decimal_columns(stops)])


def counts(n_total: int) -> dict[str, int]:
    """The intervals of each chromosome."""
    return {name: round(n_total * length / GRCH38_TOTAL) for name, length in GRCH38_LENGTHS.items()}


def chunks(target: int | None, seed, n_total: int = 926_535, lengths=(150, SPAN)):
    if not 1 <= lengths[0] <= lengths[1] <= SPAN:
        raise ValueError(f"interval lengths {lengths} outside 1..{SPAN}")
    gen = np.random.default_rng(seed)
    per = counts(n_total)

    def chromosome(name):
        n, length = per[name.decode()], GRCH38_LENGTHS[name.decode()]
        starts = np.sort(gen.integers(0, length - SPAN * n + 1, n)) + SPAN * np.arange(n)
        stops = starts + gen.integers(lengths[0], lengths[1] + 1, n)
        return [functools.partial(_run, name, starts[lo : lo + LINES], stops[lo : lo + LINES])
                for lo in range(0, n, LINES)]

    return chromosomes(target, chromosome, GRCH38_LENGTHS)
