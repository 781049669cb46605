"""The port's device decode against the JAX package's, on the CPU, with
zero tolerance: the batched ops ``ops/irle2.py``, ``ops/imtf.py`` and
``ops/ibwt.py`` row by row against ``irle2_jax``, ``imtf_jax`` and
``ibwt_jax`` (the cases of ``TestDeviceInverseMtfRle2`` and
``TestDeviceInverseBwt`` in tests/test_jax_ops.py), ``step_decode``
against ``_jitted_device_decode_step``, ``decode_streams`` against the
JAX ``decode_streams`` and the texts (multi-block, mixed buckets, legacy
randomised blocks, corrupt streams), and the archive entry
``decompress_starch_bytes(use_jax=True)``.  The buckets stay at 16,384
and 131,072 so that the JAX step compiles small; no thread is started."""

import bz2
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from starch3_tpu import api as jax_api
from starch3_tpu.codec.bwt import bwt_encode
from starch3_tpu.codec.mtf import encode_zero_run, mtf_ranks, mtf_rle2, symbol_map
from starch3_tpu.errors import FormatError as JaxFormatError
from starch3_tpu.ops.ibwt_jax import ibwt_padded as jax_ibwt
from starch3_tpu.ops.imtf_jax import imtf_decode_jax
from starch3_tpu.ops.imtf_jax import imtf_decode_padded as jax_imtf
from starch3_tpu.ops.irle2_jax import irle2_decode_jax
from starch3_tpu.ops.irle2_jax import irle2_decode_padded as jax_irle2
from starch3_tpu.parallel import pipeline as jax_pipe
from starch3_tpu_torch import api
from starch3_tpu_torch.errors import FormatError
from starch3_tpu_torch.ops.ibwt import ibwt_padded
from starch3_tpu_torch.ops.imtf import imtf_decode, imtf_decode_padded
from starch3_tpu_torch.ops.irle2 import irle2_decode, irle2_decode_padded
from starch3_tpu_torch.parallel import pipeline
from tests.conftest import make_bed_text

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parent.parent


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------- irle2


def test_irle2_rows_equal_jax(rng):
    """The real RLE2 symbols of blocks of 1, 17, 500 and 4096 bytes in one
    batch, garbage past each row's ``m``: every row's ranks and ``n`` equal
    the JAX op's, and its valid prefix the MTF ranks."""
    n_max = 4096
    syms = rng.integers(0, 258, (4, n_max)).astype(np.int32)
    ms, wants = [], []
    for i, n in enumerate((1, 17, 500, 4096)):
        blk = rng.integers(0, 16, n, dtype=np.uint8)  # zero-run heavy
        s = mtf_rle2(blk).symbols[:-1]  # strip EOB
        syms[i, : s.size] = s
        ms.append(s.size)
        _, u2s, n_in = symbol_map(blk)
        wants.append(mtf_ranks(u2s[blk], n_in))
    ms = np.array(ms, np.int32)
    ranks, n = irle2_decode_padded(_t(syms), _t(ms), n_max)
    for i in range(4):
        jr, jn = jax_irle2(jnp.asarray(syms[i]), np.int32(ms[i]), n_max, n_max)
        assert int(n[i]) == int(jn) == wants[i].size
        assert ranks[i].tolist() == np.asarray(jr).tolist()
        assert ranks[i, : int(n[i])].tolist() == wants[i].tolist()


@pytest.mark.parametrize("z", [1, 2, 3, 4, 7, 8, 255, 256, 257, 4095, 4096])
def test_irle2_extreme_runs(z):
    """Pure RUNA/RUNB digit sequences around powers of two: the host
    wrapper equals ``irle2_decode_jax`` (all zeros, length z)."""
    syms = np.asarray(encode_zero_run(z), dtype=np.int32)
    got = irle2_decode(syms, n_hint=8192)
    assert got.tolist() == irle2_decode_jax(syms, n_hint=8192).tolist() == [0] * z


def test_irle2_overflow_raises_like_jax():
    syms = np.asarray(encode_zero_run(300), dtype=np.int32)
    for fn in (irle2_decode, irle2_decode_jax):
        with pytest.raises(ValueError, match="exceeds block capacity"):
            fn(syms, n_hint=256)


# ----------------------------------------------------------------- imtf


@pytest.mark.parametrize("n_sym", [1, 2, 17, 256])
def test_imtf_rows_equal_jax(rng, n_sym):
    """Rows of 1, 100, 511, 512, 513 and 3000 bytes over an alphabet of
    ``n_sym`` symbols in one batch, ranks past each row's length out of
    range: every row equals the JAX op and its valid prefix the block."""
    n_max = 3072
    lens = (1, 100, 511, 512, 513, 3000)
    ranks = rng.integers(-5, 300, (len(lens), n_max)).astype(np.int32)
    alphabet = np.zeros((len(lens), 256), np.int32)
    blocks = []
    for i, n in enumerate(lens):
        symbols = np.sort(rng.choice(256, n_sym, replace=False)).astype(np.uint8)
        blk = rng.choice(symbols, n).astype(np.uint8)
        in_use, u2s, n_in = symbol_map(blk)
        ranks[i, :n] = mtf_ranks(u2s[blk], n_in)
        used = np.flatnonzero(in_use)
        alphabet[i, : used.size] = used
        blocks.append(blk)
    ns = np.array(lens, np.int32)
    out = imtf_decode_padded(_t(ranks), _t(ns), _t(alphabet), n_max)
    assert out.dtype == torch.int32 and out.shape == (len(lens), n_max)
    for i, n in enumerate(lens):
        want = jax_imtf(jnp.asarray(ranks[i]), np.int32(n), jnp.asarray(alphabet[i]), n_max)
        assert out[i].tolist() == np.asarray(want).tolist()
        assert out[i, :n].tolist() == blocks[i].tolist()


def test_imtf_worst_case_ranks_equal_jax():
    """Round robin over all 256 bytes: every rank reorders the deep end of
    the list (the host wrappers)."""
    blk = np.tile(np.arange(256, dtype=np.uint8), 8)
    in_use, u2s, n_in = symbol_map(blk)
    ranks = mtf_ranks(u2s[blk], n_in).astype(np.int32)
    got = imtf_decode(ranks, in_use)
    assert got.tolist() == imtf_decode_jax(ranks, in_use).tolist() == blk.tolist()


def test_imtf_rejects_unaligned_n_max():
    with pytest.raises(ValueError, match="multiple of 512"):
        imtf_decode_padded(torch.zeros((1, 1000), dtype=torch.int32), torch.tensor([5]),
                           torch.zeros((1, 256), dtype=torch.int32), 1000)


# ----------------------------------------------------------------- ibwt


def _ibwt_block(rng, kind: str, n_max: int) -> np.ndarray:
    if kind == "n1":
        return rng.integers(0, 256, 1, dtype=np.uint8)
    if kind == "full":
        return rng.integers(0, 4, n_max, dtype=np.uint8)
    n = int(rng.integers(2, n_max))
    if kind == "same":
        return np.full(n, 65, np.uint8)  # all-same: n 1-cycles
    if kind.startswith("period"):
        pat = rng.integers(0, 256, int(kind[-1]), dtype=np.uint8)
        return np.tile(pat, n // len(pat) + 1)[:n]  # exactly periodic
    return rng.integers(0, 256, n, dtype=np.uint8)


@pytest.mark.parametrize("kinds", [
    ("same", "period1", "period2", "period3", "period4"),
    ("random", "random", "n1", "full"),
])
def test_ibwt_rows_equal_jax(rng, kinds):
    """All-same, periodic (period 1-4, several LF cycles), random, n = 1
    and n = n_max rows in one batch, garbage past each row's length: each
    row equals the JAX op's and its valid prefix the block."""
    n_max = 1024
    last = rng.integers(0, 256, (len(kinds), n_max), dtype=np.uint8)
    ptrs, ns, blocks = [], [], []
    for i, kind in enumerate(kinds):
        blk = _ibwt_block(rng, kind, n_max)
        col, ptr = bwt_encode(blk)
        last[i, : blk.size] = col
        ptrs.append(ptr)
        ns.append(blk.size)
        blocks.append(blk)
    ptrs, ns = np.array(ptrs, np.int32), np.array(ns, np.int32)
    out = ibwt_padded(_t(last), _t(ptrs), _t(ns), n_max)
    assert out.dtype == torch.uint8
    for i in range(len(kinds)):
        want = jax_ibwt(jnp.asarray(last[i]), np.int32(ptrs[i]), np.int32(ns[i]), n_max)
        assert out[i].tolist() == np.asarray(want).tolist()
        assert out[i, : ns[i]].tolist() == blocks[i].tolist()


# ------------------------------------------------------ step and streams


def _streams(rng):
    """Seeded bzip2 streams: a level-9 one-block stream (bucket 16,384)
    and a level-1 three-block stream (bucket 131,072)."""
    small = bytes(make_bed_text(rng, n=600))
    multi = bytes(make_bed_text(rng, n=8_000, with_remainder=True))
    return [small, multi], [bz2.compress(small, 9), bz2.compress(multi, 1)]


def test_step_equals_jax_step(rng):
    """One batch of real blocks at 16,384: the blocks and ``n`` of
    ``step_decode`` equal ``_jitted_device_decode_step``'s, padding
    included, and ``_rle2_decoded_len`` equals the reference's."""
    n_max = 16_384
    metas = []
    for n in (600, 150, 300):
        text = bytes(make_bed_text(rng, n=n))
        blocks, _stored = pipeline.read_stream_blocks(bz2.compress(text, 9))
        metas += blocks
    for meta in metas:
        assert pipeline._rle2_decoded_len(meta[3]) == jax_pipe._rle2_decoded_len(meta[3]) == meta[4]
    args = pipeline.pack_decode_batch(metas, n_max)
    blocks, n = pipeline.step_decode(*args, n_max)
    jb, jn = jax_pipe._jitted_device_decode_step(n_max)(*(a.numpy() for a in args))
    assert n.tolist() == np.asarray(jn).tolist() == [m[4] for m in metas]
    assert np.array_equal(blocks.numpy(), np.asarray(jb))


def test_decode_streams_equals_jax(rng):
    """A level-9 stream and a level-1 multi-block stream, alone and mixed
    in one call (two buckets): texts equal, as do the JAX decodes; the
    counters show every block in its batch."""
    texts, streams = _streams(rng)
    for idx in ([0], [1], [0, 1]):
        want = [texts[i] for i in idx]
        before = dict(pipeline.device_stats)
        got = pipeline.decode_streams([streams[i] for i in idx], device="cpu")
        assert got == want == jax_pipe.decode_streams([streams[i] for i in idx])
        n_blocks = sum(len(pipeline.read_stream_blocks(streams[i])[0]) for i in idx)
        assert pipeline.device_stats["decode_blocks"] - before["decode_blocks"] == n_blocks
        assert pipeline.device_stats["decode_batches"] - before["decode_batches"] == len(idx)
    assert n_blocks == 4


def test_decode_streams_two_deep_batches(rng):
    """Batches of 2 in one bucket: 3 blocks take two batches, the first
    drained after the second is dispatched."""
    texts, streams = _streams(rng)
    before = pipeline.device_stats["decode_batches"]
    assert pipeline.decode_streams([streams[1]], device="cpu", batch_size=2) == [texts[1]]
    assert pipeline.device_stats["decode_batches"] - before == 2


def test_randomised_block_decodes_like_jax(rng):
    """A legacy randomised block (bzip2 <= 0.9.0), built as in
    tests/test_golden.py: both packages de-randomise it."""
    from tests.test_golden import TestRandomisedBlocks

    data = bytes(make_bed_text(rng, n=500))
    stream = TestRandomisedBlocks._make_randomised_stream(data)
    assert pipeline.decode_streams([stream], device="cpu") == [data] == jax_pipe.decode_streams([stream])


def _flip(stream: bytes, bit: int) -> bytes:
    arr = bytearray(stream)
    arr[bit // 8] ^= 0x80 >> (bit % 8)
    return bytes(arr)


def _stream_crc_bit(stream: bytes) -> int:
    """The first bit of the stored stream CRC: the 32 bits after the last
    end-of-stream magic."""
    bits = np.unpackbits(np.frombuffer(stream, np.uint8))
    magic = np.unpackbits(np.frombuffer((0x177245385090).to_bytes(6, "big"), np.uint8))
    at = max(p for p in range(bits.size - 48 - 32 + 1) if np.array_equal(bits[p : p + 48], magic))
    return at + 48


@pytest.mark.parametrize("corruption", ["payload_bit", "block_crc", "stream_crc"])
def test_corrupt_stream_raises_like_jax(rng, corruption):
    """A flipped payload bit, a wrong stored block CRC (bits 80-111) and a
    wrong stored stream CRC: both packages raise ``FormatError``."""
    _, streams = _streams(rng)
    stream = streams[0]
    bit = {"payload_bit": len(stream) * 4 + 3, "block_crc": 85,
           "stream_crc": _stream_crc_bit(stream) + 7}[corruption]
    bad = _flip(stream, bit)
    with pytest.raises(FormatError):
        pipeline.decode_streams([bad], device="cpu")
    with pytest.raises(JaxFormatError):
        jax_pipe.decode_streams([bad])


def test_decode_streams_refuses_a_mesh(rng):
    """Under a mesh of 2 ``cpu`` entries the level-9 and level-1 streams
    decode to their texts, as the JAX package's decode does, and a corrupt
    stream raises; an empty list decodes to an empty list.  The name dates
    from when the port refused a mesh."""
    from starch3_tpu_torch.parallel.mesh import make_block_mesh

    mesh = make_block_mesh(devices=["cpu", "cpu"])
    texts, streams = _streams(rng)
    assert pipeline.decode_streams(streams, mesh=mesh) == jax_pipe.decode_streams(streams) == texts
    assert pipeline.decode_streams([], mesh=mesh) == []
    with pytest.raises(FormatError):
        pipeline.decode_streams([_flip(streams[0], 85)], mesh=mesh)


# -------------------------------------------------------------- the entry


@pytest.mark.parametrize("path", sorted((ROOT / "tests").glob("golden*.starch")), ids=lambda p: p.name)
def test_archive_device_decode_equals_host_and_jax(path):
    """``decompress_starch_bytes(use_jax=True, device="cpu")`` on every
    golden archive equals the host decode and the JAX package's device
    decode (the gzip archive takes the host branch in both)."""
    data = path.read_bytes()
    got = api.decompress_starch_bytes(data, use_jax=True, device="cpu")
    assert got == api.decompress_starch_bytes(data, use_jax=False) == jax_api.decompress_starch_bytes(data, use_jax=True)


def test_archive_decode_refuses_a_mesh():
    """``decompress_starch_bytes(use_jax=True, mesh=...)`` of the golden
    archive over 3 ``cpu`` entries equals the host decode and the JAX
    package's device decode.  The name dates from when the port refused
    a mesh."""
    from starch3_tpu_torch.parallel.mesh import make_block_mesh

    data = (ROOT / "tests" / "golden.starch").read_bytes()
    mesh = make_block_mesh(devices=["cpu"] * 3)
    got = api.decompress_starch_bytes(data, use_jax=True, mesh=mesh)
    assert got == api.decompress_starch_bytes(data, use_jax=False) == jax_api.decompress_starch_bytes(data, use_jax=True)


def test_archive_device_decode_needs_a_card(monkeypatch):
    """``use_jax=True`` on ``cuda`` without a card raises; nothing falls
    back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = (ROOT / "tests" / "golden.starch").read_bytes()
    with pytest.raises(RuntimeError, match="is_available"):
        api.decompress_starch_bytes(data, use_jax=True)
