"""Seeded BED corpora for on-card runs (``chip_smoke.py``,
``profile_step.py``): BASELINE config 2, whole-genome 3-column BED, in the
shape of ``bench.py``'s ``make_genome_bed`` (gaps 1..2000, lengths
20..500)."""

from __future__ import annotations

import numpy as np

GENOME_CHROMS = tuple(f"chr{c}" for c in list(range(1, 23)) + ["X", "Y"])


def make_bed(chroms, n_per: int, seed: int) -> bytes:
    """Sorted 3-column BED, ``n_per`` intervals per chromosome."""
    rng = np.random.default_rng(seed)
    parts = []
    for name in chroms:
        starts = 10_000 + np.cumsum(rng.integers(1, 2000, n_per))
        stops = starts + rng.integers(20, 500, n_per)
        parts.append(
            b"\n".join(
                b"%s\t%d\t%d" % (name.encode(), s, e)
                for s, e in zip(starts.tolist(), stops.tolist())
            )
        )
    return b"\n".join(parts) + b"\n"


def config2_bed(seed: int) -> bytes:
    """BASELINE config 2: 24 chromosomes of 45,000 intervals (~25 MB)."""
    return make_bed(GENOME_CHROMS, 45_000, seed)


def big_chrom_bed(seed: int) -> bytes:
    """One chromosome of 400,000 intervals (~3.7 MB of transformed text):
    multi-block streams and the 901,120 geometry bucket."""
    return make_bed(["chrBig"], 400_000, seed)
