"""The plain reference's archive equals the port's host path's
(``EncodeConfig(use_jax=False)``) at small sizes: the test's own
comparison; the reference never calls the port."""

import bz2

import pytest

from portbench.corpora import genome_bed3, reads_scale_bed
from portbench.reference import starch
from starch3_tpu_torch import api
from starch3_tpu_torch.config import EncodeConfig


def host_archive(bed: bytes) -> bytes:
    return api.compress_bed_bytes(bed, EncodeConfig(use_jax=False))


HANDMADE = {
    "one-line": b"chr1\t5\t10\n",
    "lengths-repeat": b"chr1\t10\t20\nchr1\t30\t40\nchr1\t45\t55\nchr2\t0\t10\n",
    "starts-go-back": b"chr3\t1000\t1001\nchr3\t900\t950\nchr3\t905\t906\nchr3\t2000\t2100\n",
    "overlaps": b"chrX\t100\t500\nchrX\t200\t300\nchrX\t450\t900\nchrX\t900\t901\n",
    "bed6": b"chr1\t1\t51\tr1:a\t42\t+\nchr1\t1\t52\tr2\t30\t-\nchr10\t7\t57\tr3\t42\t+\n",
    "rest-with-tabs": b"c\t1\t2\tx\t\ty\nc\t3\t9\t\t\nc\t10\t12\tz\n",
    "not-lexical": b"chr2\t5\t6\nchr10\t5\t6\nchr1\t5\t6\n",
}


@pytest.mark.parametrize("name", sorted(HANDMADE))
def test_handmade(name):
    assert starch.archive(HANDMADE[name]).data == host_archive(HANDMADE[name])


@pytest.mark.parametrize("writer, shape, target", [
    (genome_bed3, {"n_total": 3_000_000}, 4_000_000),
    (genome_bed3, {"n_total": 20_000}, None),
    (reads_scale_bed, {"n_total": 1_500_000}, 4_000_000),
], ids=["bed3-multi-block", "bed3-many-chromosomes", "reads-multi-block"])
def test_writer_corpus(writer, shape, target):
    bed = b"".join(writer.chunks(target, 2_200_000_321, **shape))
    ref = starch.archive(bed, workers=3)
    assert ref.data == host_archive(bed)
    assert ref.blocks > len(ref.streams) or target is None


def test_streams_and_layout():
    bed = b"".join(genome_bed3.chunks(5_000_000, 5, n_total=1_000_000))
    ref = starch.archive(bed)
    texts = [starch.transform(bed, *span).text for span in starch.chromosome_spans(bed)]
    assert [name for name, _, _ in ref.streams] == ["chr1", "chr2", "chr3"]
    for (name, lo, hi), text in zip(ref.streams, texts):
        assert bz2.decompress(ref.data[lo:hi]) == text
    assert ref.metadata[1] == len(ref.data) - starch.FOOTER_BYTES


@pytest.mark.parametrize("bed", [b"chr1\t5\t10", b"chr1\tx\t10\n", b"chr1\t5\n",
                                 b"chr1\t5\t6\nchr2\t1\t2\nchr1\t9\t10\n"],
                         ids=["no-final-newline", "not-a-number", "two-columns", "not-contiguous"])
def test_refuses_what_it_does_not_define(bed):
    with pytest.raises(ValueError):
        starch.archive(bed)


def test_controls_differ():
    bed = b"".join(genome_bed3.chunks(1_500_000, 9, n_total=600_000))
    ref = starch.archive(bed).data
    assert starch.archive(bed, level=8).data != ref
    assert starch.archive(bed, offsets=False).data != ref
