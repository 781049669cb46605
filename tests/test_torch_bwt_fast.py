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
