"""The benchmark's writers: the copy of ``reads_scale_bed`` gives
``starch3_tpu_torch.corpus``'s bytes for the same seed and target, and
``genome_bed3`` writes the sorted whole-genome BED3 its docstring
states."""

import hashlib

import numpy as np
import pytest

from portbench.corpora import genome_bed3, reads_scale_bed
from portbench.corpora.columns import GRCH38_LENGTHS
from starch3_tpu_torch import corpus


@pytest.mark.parametrize("shape", [{"n_total": 3_000_000}, {"n_total": 300_000}], ids=["reads", "reads-small"])
@pytest.mark.parametrize("seed, target", [(11, 1), (2_200_000_123, 9_000_000)])
def test_copy_gives_corpus_bytes(tmp_path, shape, seed, target):
    got = b"".join(reads_scale_bed.chunks(target, seed, **shape))
    digest, size = corpus.reads_scale_bed(tmp_path / "c.bed", target, seed, **shape)
    assert len(got) == size >= target
    assert hashlib.sha256(got).hexdigest() == digest


def _lines(bed: bytes):
    rows = [line.split(b"\t") for line in bed.split(b"\n")[:-1]]
    return [r[0].decode() for r in rows], np.array([[int(r[1]), int(r[2])] for r in rows])


@pytest.mark.parametrize("shape", [{"n_total": 926_535}, {"n_total": 40_000, "lengths": (20, 200)}],
                         ids=["registry", "other-lengths"])
@pytest.mark.parametrize("seed", [11, 2_200_000_123])
def test_genome_bed3_is_what_it_states(shape, seed):
    bed = b"".join(genome_bed3.chunks(None, seed, **shape))
    assert bed == b"".join(genome_bed3.chunks(None, seed, **shape))
    names, spans = _lines(bed)
    want = genome_bed3.counts(shape["n_total"])
    order = [n for n in GRCH38_LENGTHS if want[n]]
    assert list(dict.fromkeys(names)) == order
    assert {n: names.count(n) for n in order} == {n: want[n] for n in order}
    lo, hi = shape.get("lengths", (150, 350))
    at = 0
    for name in order:
        s = spans[at : at + want[name]]
        at += want[name]
        assert s[0, 0] >= 0 and s[-1, 1] <= GRCH38_LENGTHS[name]
        assert (lo <= s[:, 1] - s[:, 0]).all() and (s[:, 1] - s[:, 0] <= hi).all()
        assert (s[1:, 0] >= s[:-1, 1]).all()  # sorted, none overlapping
    assert b"".join(genome_bed3.chunks(None, seed + 1, **shape)) != bed


def test_genome_bed3_target_gives_a_prefix():
    whole = b"".join(genome_bed3.chunks(None, 5, n_total=100_000))
    part = b"".join(genome_bed3.chunks(200_000, 5, n_total=100_000))
    assert 200_000 <= len(part) < len(whole) and whole.startswith(part)
    assert part.endswith(b"\n") and part.split(b"\n")[-2].startswith(b"chr2\t")


@pytest.mark.parametrize("lengths", [(0, 100), (200, 100), (150, 351)])
def test_genome_bed3_refuses_lengths_it_cannot_place(lengths):
    with pytest.raises(ValueError):
        next(genome_bed3.chunks(None, 1, n_total=1_000, lengths=lengths))
