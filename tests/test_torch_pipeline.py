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


def _mode_texts(rng):
    """Streams of every class for the mode tests: bits 4 (two of them),
    class 5, bits 8, and an exactly periodic bits-4 text whose one-sort
    prefix ties in fast mode."""
    return [
        bytes(rng.integers(0, 16, 7_000, dtype=np.uint8)),
        bytes(rng.integers(0, 24, 6_000, dtype=np.uint8)),
        bytes(rng.integers(0, 200, 9_000, dtype=np.uint8)),
        bytes(rng.integers(0, 16, 2_000, dtype=np.uint8)),
        b"1723\n481\np100\n" * 1000,
    ]


@pytest.mark.parametrize(
    "kwargs,mode",
    [
        ({"fast_bwt": False}, "ranks"),
        ({"device_rle2": True}, "fast"),  # device_rle2 matters only without fast_bwt
    ],
)
def test_mode_kwargs_match_bz2_and_jax(rng, kwargs, mode):
    """The kwargs that raised before the exact modes were ported: each
    encode runs the reference's mode for them and writes the JAX
    package's bytes (the host encoder's; libbz2's but for the periodic
    text, whose exact sort differs from libbz2 in origPtr only)."""
    texts = _mode_texts(rng)
    assert pipeline.encode_mode(**kwargs) == mode
    _reset_stats()
    got = pipeline.encode_streams(texts, device="cpu", host_assist=False, **kwargs)
    want = jax_pipeline.encode_streams(texts, host_assist=False, **kwargs)
    assert [g.data for g in got] == [w.data for w in want]
    assert [g.data for g in got] == [bz2_compress(t, 9) for t in texts]
    assert [g.data for g in got[:4]] == [bz2.compress(t, 9) for t in texts[:4]]
    stats = pipeline.device_stats
    assert stats["blocks"] == 5 and stats["batches"] == 3  # one batch per class
    assert (stats["blocks_bits4"], stats["blocks_bits5"], stats["blocks_bits8"]) == (3, 1, 1)
    # fast mode re-encodes the tied periodic block on the host; the exact
    # sort never ties
    assert stats["tie_reencodes"] == (1 if mode == "fast" else 0)


@pytest.mark.parametrize("device_rle2", [False, True])
def test_exact_modes_multi_block_level1(rng, device_rle2):
    """Level-1 multi-block streams through the exact modes, on the device
    only: libbz2 -1's bytes, every block on the device, no re-encode,
    and each class's rows read back."""
    texts = _texts(rng, [250_000, 40_000]) + [bytes(rng.integers(0, 100, 120_000, dtype=np.uint8))]
    _reset_stats()
    got = pipeline.encode_streams(texts, level=1, device="cpu", host_assist=False, fast_bwt=False,
                                  device_rle2=device_rle2)
    assert [g.data for g in got] == [bz2.compress(t, 1) for t in texts]
    assert [len(g.block_bit_offsets) for g in got] == [3, 1, 2]
    stats = pipeline.device_stats
    assert stats["blocks"] == 6 and stats["tie_reencodes"] == 0
    assert stats["blocks_bits4"] == 4 and stats["blocks_bits8"] == 2
    # rows of 16,384 or 131,072 bytes' worth, 3 rows a batch
    per_row = {False: lambda n: 4 * (257 + n // 4), True: lambda n: 4 * (518 + (n + 3) // 2)}[device_rle2]
    assert stats["d2h_bytes"] == stats["d2h_bytes_bits4"] + stats["d2h_bytes_bits8"]
    assert stats["d2h_bytes"] == 3 * per_row(131_072) * stats["batches"]


@pytest.mark.parametrize("host_assist", [False, True])
def test_exact_rle2_feed_matches_jax(rng, host_assist):
    """``encode_streams_feed`` in ``rle2`` mode, with and without the
    stealers: the JAX package's bytes."""
    texts = _mode_texts(rng)[:3]
    got = pipeline.encode_streams_feed(iter(texts), device="cpu", host_assist=host_assist,
                                       fast_bwt=False, device_rle2=True)
    want = jax_pipeline.encode_streams(texts, host_assist=False, fast_bwt=False, device_rle2=True)
    assert [g.data for g in got] == [w.data for w in want] == [bz2.compress(t, 9) for t in texts]


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


def test_launched_batch_is_ready_after_its_launcher():
    """An exact-mode batch on a card is ready only once the launcher
    thread has enqueued it and its event has passed, and its rows are the
    ones the launcher made; a launch error raises from ``_batch_ready``
    and from the drain's wait."""
    from concurrent.futures import Future

    class Event:
        def __init__(self):
            self.done, self.waited = False, False

        def query(self):
            return self.done

        def synchronize(self):
            self.waited = True

    fut, event = Future(), Event()
    handle = (None, pipeline._Launched(fut))
    assert not pipeline._batch_ready(handle)
    rows = torch.zeros((2, 3), dtype=torch.int32)
    fut.set_result((rows, event))
    assert not pipeline._batch_ready(handle)
    event.done = True
    assert pipeline._batch_ready(handle)
    handle[1].synchronize()
    assert event.waited
    assert pipeline._landed(handle)[0] is rows
    failed = Future()
    failed.set_exception(RuntimeError("launch failed"))
    with pytest.raises(RuntimeError, match="launch failed"):
        pipeline._batch_ready((None, pipeline._Launched(failed)))
    with pytest.raises(RuntimeError, match="launch failed"):
        pipeline._Launched(failed).synchronize()


@pytest.mark.parametrize("mode,bits", [("fast", 4), ("fast", 5), ("fast", 6), ("fast", 8), ("ranks", 4),
                                       ("rle2", 8)])
def test_counted_bytes_are_the_rows_the_drain_reads(rng, mode, bits):
    """``aux["d2h"]``, which the driver counts before the launcher has
    made the rows on a card, is the size of the rows the step returns."""
    alphabet = {4: 12, 5: 24, 6: 50, 8: 200}[bits]
    datas = [bytes(rng.integers(0, alphabet, n, dtype=np.uint8)) for n in (3_000, 4_096, 700)]
    (rows, event), aux = pipeline._dispatch_one(datas, (4_096, bits), torch.device("cpu"), 4, mode)
    assert event is None and rows.shape[0] == 4
    assert aux["d2h"] == rows.nbytes


def test_torch_bz2_compress_exact_mode(rng, monkeypatch):
    """The config's ``fast_bwt=False`` and ``device_rle2`` reach the
    driver as the ``rle2`` mode."""
    from starch3_tpu_torch.config import EncodeConfig

    modes = []
    driver = pipeline._device_driver

    def spy(*args):
        modes.append(args[6])  # (q, results, errors, device, batch_size, reserve, mode, huff)
        return driver(*args)

    monkeypatch.setattr(pipeline, "_device_driver", spy)
    text = _texts(rng, [3_000])[0]
    cfg = EncodeConfig(use_jax=True, fast_bwt=False, device_rle2=True)
    assert pipeline.torch_bz2_compress(text, cfg, device="cpu") == bz2.compress(text, 9)
    assert modes == ["rle2"]


def test_finisher_streams_are_taken_and_given_back(monkeypatch):
    """``device_huffman``'s finishers take a CUDA stream from the idle ones
    of their card and give it back: batches finished one after another
    share one stream, two at once make a second, and each card keeps its
    own (a fresh stream a batch made the caching allocator keep a pool of
    freed blocks per stream).  ``torch.cuda.Stream`` is stood in for, as
    this runs without a card."""
    made = []

    class Stream:
        def __init__(self, dev):
            self.dev = dev
            made.append(self)

    monkeypatch.setattr(torch.cuda, "Stream", Stream)
    monkeypatch.setattr(pipeline, "_finisher_streams", {})
    card0, card1 = torch.device("cuda", 0), torch.device("cuda", 1)
    for _ in range(40):
        pipeline._give_finisher_stream(card0, pipeline._take_finisher_stream(card0))
    assert len(made) == 1
    first, second = pipeline._take_finisher_stream(card0), pipeline._take_finisher_stream(card0)
    assert first is made[0] and second is made[1]
    pipeline._give_finisher_stream(card0, first)
    pipeline._give_finisher_stream(card0, second)
    assert {pipeline._take_finisher_stream(card0), pipeline._take_finisher_stream(card0)} == {first, second}
    other = pipeline._take_finisher_stream(card1)
    assert other.dev == card1 and len(made) == 3
