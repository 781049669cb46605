"""The port's pipeline (starch3_tpu_torch/parallel/pipeline.py) on the CPU
device: streams byte-identical to libbz2 -9 (``bz2.compress``), to the
host encoder and to the JAX package's ``encode_streams``."""

import bz2

import numpy as np
import pytest
import torch

from starch3_tpu.codec.encoder import bz2_compress
from starch3_tpu.parallel import pipeline as jax_pipeline
from starch3_tpu_torch.parallel import pipeline

torch.set_num_threads(2)


def _texts(rng, sizes):
    return [bytes(rng.integers(0, 16, int(n), dtype=np.uint8)) for n in sizes]


def _reset_stats():
    for k in pipeline.device_stats:
        pipeline.device_stats[k] = 0


@pytest.mark.parametrize("host_assist", [False, True])
def test_streams_match_bz2_and_jax(rng, host_assist):
    texts = _texts(rng, rng.integers(2_000, 20_000, 5))
    _reset_stats()
    got = pipeline.encode_streams(texts, device="cpu", host_assist=host_assist)
    want = jax_pipeline.encode_streams(texts, host_assist=False)
    assert [g.data for g in got] == [bz2.compress(t, 9) for t in texts]
    assert [g.data for g in got] == [w.data for w in want]
    assert [g.block_bit_offsets for g in got] == [w.block_bit_offsets for w in want]
    if not host_assist:  # every block went through the device step
        assert pipeline.device_stats["blocks"] == len(texts)
        assert pipeline.device_stats["batches"] == 2  # 5 blocks, batch_size 3


def test_multi_block_stream_level1(rng):
    text = _texts(rng, [250_000])[0]
    _reset_stats()
    got = pipeline.encode_streams([text], level=1, device="cpu", host_assist=False)[0]
    assert got.data == bz2.compress(text, 1)
    assert len(got.block_bit_offsets) == 3
    assert pipeline.device_stats["blocks"] == 3


def test_periodic_block_reencodes_on_host():
    """A periodic block's prefix sort ties: the drain re-encodes it
    exactly on the host and counts it."""
    text = b"1723\n481\np100\n" * 1000
    _reset_stats()
    got = pipeline.encode_streams([text], device="cpu", host_assist=False)[0]
    assert pipeline.device_stats["tie_reencodes"] == 1
    assert got.data == bz2_compress(text, 9)


def test_feed_and_iter_equal_list(rng):
    texts = _texts(rng, rng.integers(2_000, 10_000, 4))
    want = [bz2.compress(t, 9) for t in texts]
    got = pipeline.encode_streams_feed(iter(texts), device="cpu", host_assist=False)
    assert [g.data for g in got] == want
    it = pipeline.encode_streams_iter(iter(texts), device="cpu", window_bytes=12_000)
    assert [g.data for g in it] == want


def test_iter_early_close_releases_workers(rng):
    texts = _texts(rng, [20_000] * 6)
    it = pipeline.encode_streams_iter(iter(texts), device="cpu", window_bytes=50_000)
    next(it)
    it.close()  # GeneratorExit -> cancel, join feeder/driver/stealers


def test_feeder_error_propagates(rng):
    class Boom(Exception):
        pass

    def gen():
        yield _texts(rng, [2_000])[0]
        raise Boom()

    with pytest.raises(Boom):
        pipeline.encode_streams_feed(gen(), device="cpu")


def test_wide_alphabet_block_raises(rng):
    """Blocks of 17+ distinct bytes no longer raise: a 40-symbol and a
    60-symbol block (bits 6), a 24-symbol block (bits 5) and a 200-symbol
    block (bits 8) each encode on the device path, equal to libbz2 -9,
    counted per alphabet class."""
    texts = [
        bytes(rng.integers(0, 40, 5_000, dtype=np.uint8)),
        bytes(rng.integers(0, 24, 6_000, dtype=np.uint8)),
        bytes(rng.integers(0, 60, 7_000, dtype=np.uint8)),
        bytes(rng.integers(0, 200, 9_000, dtype=np.uint8)),
    ]
    _reset_stats()
    got = pipeline.encode_streams(texts, device="cpu", host_assist=False)
    assert [g.data for g in got] == [bz2.compress(t, 9) for t in texts]
    stats = pipeline.device_stats
    assert (stats["blocks_bits5"], stats["blocks_bits6"], stats["blocks_bits8"]) == (1, 2, 1)
    assert stats["batches"] == stats["batches_bits5"] + stats["batches_bits6"] + stats["batches_bits8"] == 3
    assert stats["blocks"] == 4 and stats["tie_reencodes"] == 0


def test_remainder_corpora_match_bz2_and_jax():
    """Small cuts of the three remainder-column corpora, device only and
    with host stealers: the bytes of libbz2 -9 and of the JAX pipeline."""
    from starch3_tpu.api import _parse_transform
    from starch3_tpu_torch import corpus

    beds = [
        corpus.config3_bed(n_per=300),
        corpus.bits6_bed(n_per=200),
        corpus.wide8_bed(seed=2, chroms=("chrA", "chrB"), n_per=400),
    ]
    texts = [tf.text for bed in beds for tf in _parse_transform(bed)[:2]]
    want = [bz2.compress(t, 9) for t in texts]
    _reset_stats()
    got = pipeline.encode_streams(texts, device="cpu", host_assist=False)
    assert [g.data for g in got] == want
    assert all(pipeline.device_stats[f"blocks_bits{c}"] == 2 for c in (5, 6, 8))
    got = pipeline.encode_streams(texts, device="cpu", host_assist=True)
    assert [g.data for g in got] == want
    jax_got = jax_pipeline.encode_streams(texts, host_assist=False)
    assert [g.data for g in jax_got] == want


def test_periodic_wide_block_reencodes_on_host():
    """A periodic bits==8 block ties (the tie flag is column 2 of its
    rows): the drain re-encodes it exactly on the host and counts it."""
    text = bytes(range(1, 90)) * 200
    _reset_stats()
    got = pipeline.encode_streams([text], device="cpu", host_assist=False)[0]
    assert pipeline.device_stats["tie_reencodes_bits8"] == 1
    assert got.data == bz2_compress(text, 9)


def test_wide8_corpus_is_multi_block():
    """At its default size each stream of the bits==8 corpus is two
    blocks, the first in the 901,120 bucket."""
    from starch3_tpu.api import _parse_transform
    from starch3_tpu.parallel.pipeline import _bucket_for, _split_classify
    from starch3_tpu_torch import corpus

    for tf in _parse_transform(corpus.wide8_bed()):
        blocks, classes = _split_classify(tf.text, 9)
        assert classes == [8, 8]
        assert _bucket_for(len(blocks[0].data)) == 901_120


@pytest.mark.parametrize(
    "kwargs,item",
    [
        ({"fast_bwt": False}, "A13"),
        ({"device_rle2": True}, "A13"),
    ],
)
def test_unported_modes_raise(kwargs, item):
    with pytest.raises(NotImplementedError, match=item):
        pipeline.encode_streams([b"12\n"], device="cpu", **kwargs)


def _huff_texts(rng):
    """Blocks of every fast_huff route in the smallest bucket: bits 4,
    class 5 and bits 8 (the byte remap), a periodic bits-4 block whose
    sort ties, and a high-entropy bits-8 block whose coded bits overflow
    the emit's capacity (16,000 random bytes need about 8 bits a symbol,
    the capacity of the 16,384 bucket is about 5.5)."""
    return [
        bytes(rng.integers(0, 16, 12_000, dtype=np.uint8)),
        bytes(rng.integers(0, 24, 6_000, dtype=np.uint8)),
        bytes(rng.integers(0, 200, 9_000, dtype=np.uint8)),
        b"1723\n481\np100\n" * 1000,
        bytes(rng.integers(0, 256, 16_000, dtype=np.uint8)),
    ]


@pytest.mark.parametrize("host_assist", [False, True])
def test_device_huffman_matches_bz2(rng, host_assist):
    """``device_huffman=True`` (mode fast_huff) on the CPU device: every
    stream equals libbz2 -9; device only, every class ran through the
    finisher, and both of its host re-encodes fired (ties, overflow)."""
    texts = _huff_texts(rng)
    _reset_stats()
    got = pipeline.encode_streams(texts, device="cpu", host_assist=host_assist, device_huffman=True)
    assert [g.data for g in got] == [bz2.compress(t, 9) for t in texts]
    stats = pipeline.device_stats
    if not host_assist:
        assert stats["blocks"] == 5 and stats["batches"] == 3  # one batch per class
        assert (stats["blocks_bits4"], stats["blocks_bits5"], stats["blocks_bits8"]) == (2, 1, 2)
        assert stats["tie_reencodes"] == stats["tie_reencodes_bits4"] == 1
        assert stats["huff_host_reencodes"] == stats["huff_host_reencodes_bits8"] == 1
        # 263-column small rows per padded row, plus the finisher's reads
        assert stats["d2h_bytes"] > stats["batches"] * 3 * 263 * 4


def test_device_huffman_finisher_error_raises(rng, monkeypatch):
    """A failing finisher raises through its blocks' futures: the encode
    raises, and nothing falls back to fast mode or the host."""

    class Boom(Exception):
        pass

    def emit(*args, **kwargs):
        raise Boom()

    monkeypatch.setattr(pipeline, "emit_coded_padded", emit)
    with pytest.raises(Boom):
        pipeline.encode_streams(_huff_texts(rng)[:1], device="cpu", host_assist=False, device_huffman=True)


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        pipeline.encode_streams([b"12\n"], device="cuda")


def test_torch_bz2_compress(rng):
    text = _texts(rng, [3_000])[0]
    assert pipeline.torch_bz2_compress(text, device="cpu") == bz2.compress(text, 9)
