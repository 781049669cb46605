"""The port's device steps (starch3_tpu_torch/parallel/pipeline.py)
against the JAX steps they mirror, on real transformed blocks of each
alphabet tier plus pad rows.  Tolerance: zero.

- ``step_ranks4`` vs ``_jitted_fused_step_ranks4(n_max, False)`` (the
  step that __graft_entry__.entry() compiles), rows ``[orig_ptr, ties,
  packed ranks]``: columns 0-1 equal on every row, the whole row where
  ties == 0.
- ``step_ranks_mid`` vs ``_jitted_fused_step_ranks_mid(n_max, bits,
  False)``: every row equal (the JAX sort takes every operand as a key).
- ``step_fast`` vs ``_jitted_fused_step_fast(n_max, bits, False)``, rows
  ``[ptr, m, ties, freq[260], packed]``: the whole row where ties == 0,
  columns 0 and 2 elsewhere (the JAX sort's payload order among tied
  rotations is unstable).
- ``step_fast2`` vs ``_jitted_fused_step_fast2(n_max, bits, False)`` at
  bits 4 and 8: the small rows ``[ptr, m, ties, freq[260]]`` and the
  symbol streams whole where ties == 0, columns 0 and 2 elsewhere.
- The exact modes at 16,384: ``bwt_remap`` vs ``_bwt_remap``;
  ``step_exact`` vs ``_jitted_fused_step(n_max, False)``, rows
  ``[orig_ptr, used[256], ranks]``, the ranks over each row's length only
  (JAX on the CPU takes the XLA scan, which does not zero past it);
  ``step_exact_rle2`` vs ``_jitted_fused_step_rle2(n_max, False)``, whole
  rows; ``device_encode_blocks`` vs the JAX one."""

import ctypes

import numpy as np
import pytest
import torch

from starch3_tpu.parallel import pipeline as jax_pipeline
from starch3_tpu.parallel.pipeline import (
    _jitted_fused_step,
    _jitted_fused_step_fast,
    _jitted_fused_step_fast2,
    _jitted_fused_step_ranks4,
    _jitted_fused_step_ranks_mid,
    _jitted_fused_step_rle2,
)
from starch3_tpu_torch import corpus
from starch3_tpu_torch.parallel.pipeline import (
    _dense_pack4,
    bwt_remap,
    device_encode_blocks,
    raw_batch,
    step_exact,
    step_exact_rle2,
    pack_batch,
    step_fast,
    step_fast2,
    step_ranks4,
    step_ranks_mid,
)

from tests.conftest import make_bed_text
from tests.test_torch_isolation import _jax_runtime_lib

torch.set_num_threads(2)


def _batch(rng, n_max: int):
    """Three rows: random 14 symbols (full length), real transformed BED
    (short row, zero pad), and a periodic text whose sort ties."""
    from starch3_tpu.api import _parse_transform

    packed = np.zeros((3, n_max // 2), np.uint8)
    lens = np.zeros(3, np.int32)
    seqs = rng.integers(0, 14, n_max, dtype=np.uint8)
    packed[0] = seqs[0::2] | (seqs[1::2] << 4)
    lens[0] = n_max
    text = _parse_transform(make_bed_text(rng, n=300))[0].text[: n_max - 100]
    periodic = (b"1723\n481\np100\n" * n_max)[: n_max // 3]
    for i, data in ((1, text), (2, periodic)):
        arr = np.frombuffer(data, np.uint8)
        lens[i] = arr.size
        _dense_pack4(arr, packed[i])
    return packed, lens


@pytest.mark.parametrize("n_max", [4096, 8192])
def test_rows_match_jax_step(rng, n_max):
    packed, lens = _batch(rng, n_max)
    want = np.asarray(_jitted_fused_step_ranks4(n_max, False)(packed, lens))
    got = step_ranks4(torch.from_numpy(packed), torch.from_numpy(lens)).numpy()
    assert got.shape == want.shape == (3, 2 + n_max // 8)
    assert got[:, :2].tolist() == want[:, :2].tolist()
    assert want[2, 1] > 0  # the periodic row ties
    for i in range(3):
        if want[i, 1] == 0:
            assert got[i].tolist() == want[i].tolist()


def test_ranks_past_length_are_zero(rng):
    packed, lens = _batch(rng, 4096)
    rows = step_ranks4(torch.from_numpy(packed), torch.from_numpy(lens)).numpy()
    by = rows[1, 2:].view(np.uint8)
    nibbles = np.stack([by & 0xF, by >> 4], axis=1).reshape(-1)
    assert not nibbles[lens[1]:].any()


def _tier_text(bits: int, n_max: int) -> bytes:
    """Real transformed BED of the ``bits`` tier, two blocks' worth."""
    from starch3_tpu.api import _parse_transform

    bed = {
        5: lambda: corpus.config3_bed(n_per=400),
        6: lambda: corpus.bits6_bed(n_per=300),
        8: lambda: corpus.wide8_bed(seed=5, chroms=("chr1",), n_per=600),
    }[bits]()
    text = _parse_transform(bed)[0].text
    assert len(text) > 2 * n_max - 500
    return text


def _tier_rows(bits: int, n_max: int):
    """Four rows packed as the dispatch packs them (``pack_batch``): a
    full-length real block, a short real block, a periodic block whose
    sort ties, and a pad row (length 1, symbol 0, one symbol in use)."""
    text = _tier_text(bits, n_max)
    periodic = (text[:9] * n_max)[: n_max // 3]
    datas = [text[:n_max], text[n_max : 2 * n_max - 500], periodic]
    host, lens, nsyms, _ = pack_batch(datas, n_max, bits, b_pad=4)
    assert (nsyms[:2] > {5: 16, 6: 32, 8: 64}[bits]).all()
    return host.numpy(), lens, nsyms


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("bits", [4, 5, 6])
def test_pack_batch_rows_equal_jax_runtime(rng, monkeypatch, bits, native):
    """``pack_batch`` packs each block with the native runtime (through
    its GIL-keeping handle), or in NumPy without the native lib: either
    way each row, its distinct-byte count and its used table equal the
    JAX runtime's packer on the block, and the pad row stays zero."""
    from starch3_tpu import runtime as jax_runtime
    from starch3_tpu_torch import runtime

    _jax_runtime_lib()
    n_max = 4096
    if bits == 4:
        text = b"".join(_parse_transform_text(make_bed_text(rng, n=1500)))
    else:
        text = _tier_text(bits, n_max)
    assert len(text) >= 2 * n_max - 700
    datas = [text[:n_max], text[n_max : 2 * n_max - 700], text[:1]]
    if not native:
        monkeypatch.setattr(runtime, "dense_pack4_native", lambda *a: None)
        monkeypatch.setattr(runtime, "dense_pack_words_native", lambda *a: None)
    else:
        assert runtime.get_lib() is not None and isinstance(runtime._gil_lib, ctypes.PyDLL)
    packed, lens, nsyms, useds = pack_batch(datas, n_max, bits, b_pad=4)
    rows = packed.numpy().view(np.uint8 if bits == 4 else np.uint32)
    assert lens.tolist() == [len(d) for d in datas] + [1] and nsyms[3] == 1 and not rows[3].any()
    for i, data in enumerate(datas):
        arr = np.frombuffer(data, np.uint8)
        want = np.zeros_like(rows[i])
        if bits == 4:
            n_in_use, used = jax_runtime.dense_pack4_native(arr, want)
        else:
            n_in_use, used = jax_runtime.dense_pack_words_native(arr, bits, want)
        assert nsyms[i] == n_in_use and useds[i].dtype == bool and (useds[i] == used).all()
        assert (rows[i] == want).all()


def _parse_transform_text(bed: bytes) -> list:
    from starch3_tpu.api import _parse_transform

    return [t.text for t in _parse_transform(bed)]


@pytest.mark.parametrize("bits", [5, 6])
def test_mid_rows_match_jax_step(bits):
    n_max = 4096
    words, lens, _ = _tier_rows(bits, n_max)
    want = np.asarray(_jitted_fused_step_ranks_mid(n_max, bits, False)(words, lens))
    got = step_ranks_mid(torch.from_numpy(words), torch.from_numpy(lens), bits, n_max).numpy()
    assert got.shape == want.shape == (4, 2 + words.shape[1])
    assert want[2, 1] > 0 and not want[[0, 1, 3], 1].any()
    assert got.tolist() == want.tolist()


@pytest.mark.parametrize("n_max", [4096, 8192])
def test_fast_bits8_rows_match_jax_step(n_max):
    seqs, lens, nsyms = _tier_rows(8, n_max)
    want = np.asarray(_jitted_fused_step_fast(n_max, 8, False)(seqs, lens, nsyms))
    got = step_fast(
        torch.from_numpy(seqs), torch.from_numpy(lens), torch.from_numpy(nsyms), 8
    ).numpy()
    assert got.shape == want.shape == (4, 263 + (n_max + 2 + 1) // 2)
    assert want[2, 2] > 0 and not want[[0, 1, 3], 2].any()
    for i in range(4):
        if want[i, 2] == 0:
            assert got[i].tolist() == want[i].tolist(), i
        else:
            assert got[i, [0, 2]].tolist() == want[i, [0, 2]].tolist(), i


def test_fast_bits4_rows_match_jax_step(rng):
    """``step_fast`` at bits 4 (the step ``device_huffman`` will build on):
    nibble-packed input, wide MTF at width 128, 5-bit symbol words."""
    n_max = 4096
    packed, lens = _batch(rng, n_max)
    nib = np.stack([packed & 0xF, packed >> 4], axis=2).reshape(3, n_max)
    nsyms = np.array([np.unique(nib[i, : lens[i]]).size for i in range(3)], np.int32)
    want = np.asarray(_jitted_fused_step_fast(n_max, 4, False)(packed, lens, nsyms))
    got = step_fast(
        torch.from_numpy(packed), torch.from_numpy(lens), torch.from_numpy(nsyms), 4
    ).numpy()
    assert got.shape == want.shape
    for i in range(3):
        cols = slice(None) if want[i, 2] == 0 else [0, 2]
        assert got[i, cols].tolist() == want[i, cols].tolist(), i


@pytest.mark.parametrize("bits", [4, 8])
def test_fast2_rows_and_syms_match_jax_step(rng, bits):
    """``fast_huff``'s step: K3 at width 128 on nibble-packed bits-4 rows,
    at width 256 on byte-remapped rows; the symbols stay on the device."""
    n_max = 4096
    if bits == 4:
        seqs, lens = _batch(rng, n_max)
        nib = np.stack([seqs & 0xF, seqs >> 4], axis=2).reshape(3, n_max)
        nsyms = np.array([np.unique(nib[i, : lens[i]]).size for i in range(3)], np.int32)
    else:
        seqs, lens, nsyms = _tier_rows(8, n_max)
    want_small, want_syms = map(np.asarray, _jitted_fused_step_fast2(n_max, bits, False)(seqs, lens, nsyms))
    small, syms = step_fast2(
        torch.from_numpy(seqs), torch.from_numpy(lens), torch.from_numpy(nsyms), bits
    )
    small, syms = small.numpy(), syms.numpy()
    assert small.shape == want_small.shape == (len(lens), 263)
    assert syms.shape == want_syms.shape == (len(lens), n_max + 2)
    assert want_small[:, 2].any() and not want_small[:, 2].all()  # tied and tie-free rows
    for i in range(len(lens)):
        if want_small[i, 2] == 0:
            assert small[i].tolist() == want_small[i].tolist(), i
            assert syms[i].tolist() == want_syms[i].tolist(), i
        else:
            assert small[i, [0, 2]].tolist() == want_small[i, [0, 2]].tolist(), i


def test_mid_rejects_a_wrong_word_count():
    with pytest.raises(ValueError, match="words"):
        step_ranks_mid(torch.zeros((1, 100), dtype=torch.int32), torch.tensor([5]), 5, 4096)


EXACT_N_MAX = 16_384


def _exact_blocks(rng) -> list[bytes]:
    """Raw blocks of every class at 16,384: a full-length random block of
    200 byte values, real transformed BED (bits 4) and BED6 (class 5), an
    exactly periodic block (no tie in the exact sort) and one byte."""
    from starch3_tpu.api import _parse_transform

    bed3 = _parse_transform(make_bed_text(rng, n=900))[0].text[:9_000]
    bed6 = _tier_text(5, 4096)[:12_000]
    return [
        bytes(rng.integers(0, 200, EXACT_N_MAX, dtype=np.uint8)),
        bed3,
        bed6,
        b"1723\n481\np100\n" * 700,
        b"\x07",
    ]


@pytest.fixture(scope="module")
def exact_batch():
    blocks, lens = raw_batch(_exact_blocks(np.random.default_rng(77)), EXACT_N_MAX, b_pad=6)
    return blocks.numpy(), lens


def test_bwt_remap_matches_jax(exact_batch):
    blocks, lens = exact_batch
    ptrs, used, seqs = bwt_remap(torch.from_numpy(blocks), torch.from_numpy(lens))
    for i in range(blocks.shape[0]):
        j_ptr, j_used, j_seq = jax_pipeline._bwt_remap(blocks[i], np.int32(lens[i]), EXACT_N_MAX)
        assert int(ptrs[i]) == int(j_ptr)
        assert used[i].tolist() == np.asarray(j_used).tolist()
        assert seqs[i].tolist() == np.asarray(j_seq).tolist()


def test_exact_rows_match_jax_step(exact_batch):
    blocks, lens = exact_batch
    want = np.asarray(_jitted_fused_step(EXACT_N_MAX, False)(blocks, lens))
    got = step_exact(torch.from_numpy(blocks), torch.from_numpy(lens)).numpy()
    assert got.shape == want.shape == (6, 257 + EXACT_N_MAX // 4)
    assert got[:, :257].tolist() == want[:, :257].tolist()
    for i, n in enumerate(lens):
        g, w = got[i, 257:].view(np.uint8), want[i, 257:].view(np.uint8)
        assert g[:n].tolist() == w[:n].tolist()
        assert not g[n:].any()  # the kernel branch zeroes past the length


def test_exact_rle2_rows_match_jax_step(exact_batch):
    blocks, lens = exact_batch
    want = np.asarray(_jitted_fused_step_rle2(EXACT_N_MAX, False)(blocks, lens))
    got = step_exact_rle2(torch.from_numpy(blocks), torch.from_numpy(lens)).numpy()
    assert got.shape == want.shape == (6, 518 + (EXACT_N_MAX + 3) // 2)
    assert got.tolist() == want.tolist()


def test_device_encode_blocks_matches_jax(rng):
    datas = _exact_blocks(rng)
    got = device_encode_blocks(datas, EXACT_N_MAX, device="cpu")
    want = jax_pipeline.device_encode_blocks(datas, EXACT_N_MAX)
    assert len(got) == len(want) == len(datas)
    for (g_used, g_ptr, g_ranks), (w_used, w_ptr, w_ranks), data in zip(got, want, datas):
        assert g_used.dtype == bool and g_ranks.dtype == np.uint8
        assert (g_used.tolist(), g_ptr) == (w_used.tolist(), w_ptr)
        assert g_ranks.tolist() == w_ranks.tolist() and g_ranks.size == len(data)
    assert device_encode_blocks([], device="cpu") == []


def test_device_encode_blocks_rejects_a_mesh_and_a_long_block(rng):
    """Under a mesh of 3 ``cpu`` entries (5 blocks pad to 6 rows) the
    results equal the one-device run's and the JAX package's; a block past
    ``n_max`` is refused with a mesh and without one.  The name dates from
    when the port refused a mesh."""
    from starch3_tpu_torch.parallel.mesh import make_block_mesh

    datas = _exact_blocks(rng)
    mesh = make_block_mesh(devices=["cpu"] * 3)
    got = device_encode_blocks(datas, EXACT_N_MAX, mesh=mesh)
    want = jax_pipeline.device_encode_blocks(datas, EXACT_N_MAX)
    one = device_encode_blocks(datas, EXACT_N_MAX, device="cpu")
    def as_lists(res):
        return [(used.tolist(), ptr, ranks.tolist()) for used, ptr, ranks in res]

    assert len(got) == len(datas)
    assert as_lists(got) == as_lists(want) == as_lists(one)
    with pytest.raises(ValueError, match="exceeds n_max"):
        device_encode_blocks([bytes(5_000)], 4096, mesh=mesh)
    with pytest.raises(ValueError, match="exceeds n_max"):
        device_encode_blocks([bytes(5_000)], 4096, device="cpu")
