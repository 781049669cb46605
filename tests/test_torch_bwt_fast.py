"""The port's one-sort BWT (starch3_tpu_torch/ops/bwt_fast.py) against the
JAX function it mirrors (starch3_tpu/ops/bwt_fast.bwt_sort_fast3) and the
NumPy BWT oracle.  Integer codec: the tolerance is zero.

Contract with the JAX function, which sorts unstably: ``orig_ptr`` and
``ties`` equal on every row, ``last`` equal on the valid prefix of every
row with ``ties == 0`` (where it also equals the oracle)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from starch3_tpu.codec.bwt import bwt_encode
from starch3_tpu.ops.bwt_fast import bwt_sort_fast3 as jax_bwt_sort_fast3
from starch3_tpu_torch.ops.bwt_fast import bwt_sort_fast3

from tests.conftest import make_bed_text

torch.set_num_threads(2)


def _check_against_jax(rows: np.ndarray, lens: list[int]):
    """Run the port on the batch and JAX row by row; assert the parity
    contract; return the port's (last, ptr, ties) as numpy."""
    n_max = rows.shape[1]
    last, ptr, ties = (
        x.numpy()
        for x in bwt_sort_fast3(
            torch.from_numpy(rows.astype(np.int32)),
            torch.tensor(lens, dtype=torch.int32),
        )
    )
    for i, n in enumerate(lens):
        jl, jp, jt = jax_bwt_sort_fast3(jnp.asarray(rows[i]), jnp.int32(n), n_max)
        assert int(ptr[i]) == int(jp), (i, n)
        assert int(ties[i]) == int(jt), (i, n)
        if int(jt) == 0:
            assert last[i, :n].tolist() == np.asarray(jl)[:n].tolist(), (i, n)
    return last, ptr, ties


def _check_oracle(seq: np.ndarray, last, ptr, ties):
    if ties == 0:
        l1, p1 = bwt_encode(seq.astype(np.uint8))
        assert last[: seq.size].tolist() == l1.tolist()
        assert int(ptr) == p1


@pytest.mark.parametrize("sigma", [2, 10, 16])
def test_random_matches_jax_and_oracle(rng, sigma):
    seq = rng.integers(0, sigma, 3000).astype(np.int32)
    pad = np.zeros((1, 4096), np.int32)
    pad[0, :3000] = seq
    last, ptr, ties = _check_against_jax(pad, [3000])
    _check_oracle(seq, last[0], ptr[0], ties[0])


def test_real_transform_text_tie_free_and_exact(rng):
    from starch3_tpu.api import _parse_transform
    from starch3_tpu.codec.mtf import symbol_map

    text = _parse_transform(make_bed_text(rng, n=3000))[0].text
    blk = np.frombuffer(text, dtype=np.uint8)
    _, u2s, n_in = symbol_map(blk)
    assert n_in <= 16
    seq = u2s[blk].astype(np.int32)
    n_max = 1 << (seq.size - 1).bit_length()
    pad = np.zeros((1, n_max), np.int32)
    pad[0, : seq.size] = seq
    last, ptr, ties = _check_against_jax(pad, [seq.size])
    assert int(ties[0]) == 0
    l1, p1 = bwt_encode(blk)
    assert last[0, : seq.size].tolist() == u2s[l1].tolist()
    assert int(ptr[0]) == p1


def test_periodic_reports_equal_ties():
    pat = np.frombuffer(b"1723\n481\np100\n" * 40, dtype=np.uint8)
    dense = np.searchsorted(np.unique(pat), pat).astype(np.int32)
    pad = np.zeros((1, 1024), np.int32)
    pad[0, : dense.size] = dense
    _, _, ties = _check_against_jax(pad, [dense.size])
    assert int(ties[0]) > 0


def test_poisoned_pad_is_inert(rng):
    seq = rng.integers(0, 13, 700).astype(np.int32)
    outs = []
    for n_max in (1024, 2048):
        pad = np.full((1, n_max), 15, dtype=np.int32)
        pad[0, :700] = seq
        last, ptr, ties = _check_against_jax(pad, [700])
        outs.append((last[0, :700].tolist(), int(ptr[0]), int(ties[0])))
    assert outs[0] == outs[1]


@pytest.mark.parametrize("n", [1, 2, 23, 24, 25])
def test_short_rows(rng, n):
    """n <= 23 takes the shift ``k % n`` branch of the key ladder."""
    seq = rng.integers(0, 16, n).astype(np.int32)
    pad = np.full((1, 1024), 7, np.int32)
    pad[0, :n] = seq
    last, ptr, ties = _check_against_jax(pad, [n])
    _check_oracle(seq, last[0], ptr[0], ties[0])


def test_mixed_length_batch(rng):
    """Rows of different lengths in one batch: the per-row rotation."""
    lens = [4096, 1, 24, 700, 3001, 17]
    rows = rng.integers(0, 14, (len(lens), 4096)).astype(np.int32)
    last, ptr, ties = _check_against_jax(rows, lens)
    for i, n in enumerate(lens):
        _check_oracle(rows[i, :n], last[i], ptr[i], ties[i])


# --- bwt_sort_fast (bits 4/8) and bwt_sort_fast_mid (bits 5/6) ---------------


def _check_tier(port_fn, jax_fn, rows: np.ndarray, lens: list[int], whole: bool):
    """The port's batch against JAX row by row.  ``orig_ptr`` and ``ties``
    equal on every row.  ``whole``: every output array equals JAX on every
    row and the whole ``n_max`` (all operands are sort keys in JAX);
    otherwise ``last`` equals on the valid prefix where ``ties == 0``
    (the JAX sort's payload order among tied rotations is unstable)."""
    last, ptr, ties = (
        x.numpy()
        for x in port_fn(
            torch.from_numpy(rows.astype(np.int32)), torch.tensor(lens, dtype=torch.int32)
        )
    )
    for i, n in enumerate(lens):
        jl, jp, jt = (np.asarray(x) for x in jax_fn(jnp.asarray(rows[i]), jnp.int32(n)))
        assert (int(ptr[i]), int(ties[i])) == (int(jp), int(jt)), (i, n)
        if whole:
            assert last[i].tolist() == jl.tolist(), (i, n)
        elif int(jt) == 0:
            assert last[i, :n].tolist() == jl[:n].tolist(), (i, n)
    return last, ptr, ties


def _fast(bits, n_max):
    from starch3_tpu.ops.bwt_fast import bwt_sort_fast as jax_fn
    from starch3_tpu_torch.ops.bwt_fast import bwt_sort_fast as port_fn

    return (
        lambda s, n: port_fn(s, n, bits),
        lambda s, n: jax_fn(s, n, n_max, bits),
    )


def _mid(bits, n_max):
    from starch3_tpu.ops.bwt_fast import bwt_sort_fast_mid as jax_fn
    from starch3_tpu_torch.ops.bwt_fast import bwt_sort_fast_mid as port_fn

    return (
        lambda s, n: port_fn(s, n, bits),
        lambda s, n: jax_fn(s, n, n_max, bits),
    )


@pytest.mark.parametrize("bits,sigma", [(4, 16), (8, 90), (8, 256)])
def test_fast_matches_jax_and_oracle(rng, bits, sigma):
    """Random rows of mixed lengths (short ones take the ``k % n`` key
    branch), plus a periodic row whose sort ties."""
    n_max = 4096
    lens = [4096, 1, 7, 17, 700, 3000]
    rows = rng.integers(0, sigma, (len(lens), n_max)).astype(np.int32)
    rows[5, :3000] = np.tile(rng.integers(0, sigma, 9), 334)[:3000]
    last, ptr, ties = _check_tier(*_fast(bits, n_max), rows, lens, whole=False)
    assert ties[5] > 0 and not ties[:5].any()
    for i, n in enumerate(lens[:5]):
        _check_oracle(rows[i, :n], last[i], ptr[i], ties[i])


def test_fast_bits8_real_text_tie_free_and_exact(rng):
    """Transformed BED6 with free-text names, more than 64 distinct bytes:
    the bits==8 tier's 16-symbol context is tie-free there."""
    from starch3_tpu.api import _parse_transform
    from starch3_tpu.codec.mtf import symbol_map
    from starch3_tpu_torch.corpus import wide8_bed

    bed = wide8_bed(seed=3, chroms=("chr1",), n_per=3000)
    # the corpus asserts the bits==8 class of every block
    blk = np.frombuffer(_parse_transform(bed)[0].text[:6000], dtype=np.uint8)
    _, u2s, n_in = symbol_map(blk)
    assert n_in > 64
    seq = u2s[blk].astype(np.int32)
    pad = np.zeros((1, 8192), np.int32)
    pad[0, : seq.size] = seq
    last, ptr, ties = _check_tier(*_fast(8, 8192), pad, [seq.size], whole=False)
    assert int(ties[0]) == 0
    l1, p1 = bwt_encode(blk)
    assert last[0, : seq.size].tolist() == u2s[l1].tolist()
    assert int(ptr[0]) == p1


@pytest.mark.parametrize("bits,sigma", [(5, 17), (5, 32), (6, 33), (6, 64)])
def test_mid_matches_jax_and_oracle(rng, bits, sigma):
    """``TestBwtFastMid``'s random and periodic cases in one batch, with
    mixed lengths and a poisoned pad: equal to JAX on every row."""
    n_max = 4096
    lens = [3000, 4096, 1, 23, 25, 540]
    rows = rng.integers(0, sigma, (len(lens), n_max)).astype(np.int32)
    rows[0, 3000:] = sigma - 1
    rows[5, :540] = np.tile(rng.integers(0, 1 << bits, 9), 60)
    last, ptr, ties = _check_tier(*_mid(bits, n_max), rows, lens, whole=True)
    assert ties[5] > 0 and ties[0] == 0 and ties[1] == 0
    for i, n in enumerate(lens[:5]):
        _check_oracle(rows[i, :n], last[i], ptr[i], ties[i])


def test_mid_config3_style_text_tie_free_and_exact():
    """Config-3 transformed BED (peak ids, scores, strands; about 21
    symbols): the 23-symbol context of bits 5 is tie-free and exact."""
    from starch3_tpu.api import _parse_transform
    from starch3_tpu.codec.mtf import symbol_map
    from starch3_tpu_torch.corpus import config3_bed

    text = _parse_transform(config3_bed(n_per=500))[0].text
    blk = np.frombuffer(text, dtype=np.uint8)
    _, u2s, n_in = symbol_map(blk)
    assert 16 < n_in <= 32
    seq = u2s[blk].astype(np.int32)
    n_max = 1 << (seq.size - 1).bit_length()
    pad = np.zeros((1, n_max), np.int32)
    pad[0, : seq.size] = seq
    last, ptr, ties = _check_tier(*_mid(5, n_max), pad, [seq.size], whole=True)
    assert int(ties[0]) == 0
    l1, p1 = bwt_encode(blk)
    assert last[0, : seq.size].tolist() == u2s[l1].tolist()
    assert int(ptr[0]) == p1


def test_bad_bits_raise():
    from starch3_tpu_torch.ops.bwt_fast import bwt_sort_fast, bwt_sort_fast_mid

    seqs, lens = torch.zeros((1, 64), dtype=torch.int32), torch.tensor([64])
    with pytest.raises(ValueError):
        bwt_sort_fast(seqs, lens, 5)
    with pytest.raises(ValueError):
        bwt_sort_fast_mid(seqs, lens, 4)
