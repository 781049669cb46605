"""The delta transform's device ops (``starch3_tpu_torch/ops/transform.py``)
on the CPU against the JAX package's ``ops/transform_jax.py``, value for
value and dtype for dtype, on seeded ``int32`` inputs: JAX without x64
keeps ``int32`` all the way through, and so does the port, wraps
included.  ``int64`` inputs, which JAX cannot hold here, are held to the
host transform's ``_dec_len`` and ``_union_length``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from starch3_tpu.ops import transform_jax
from starch3_tpu.transform.delta import _dec_len, _union_length
from starch3_tpu_torch.ops import transform

I32 = np.iinfo(np.int32)


def _intervals(case: str):
    """(starts, stops) int32 of one case, made from a seed."""
    rng = np.random.default_rng(sum(map(ord, case)))
    if case == "wrap":  # the sum of the differences wraps in int32
        return np.zeros(3, np.int32), np.full(3, 2**30, np.int32)
    if case == "one":
        return np.array([17], np.int32), np.array([40], np.int32)
    n = 400
    starts = np.cumsum(rng.integers(1, 1000, n)).astype(np.int32)
    lens = rng.integers(1, 500, n)
    if case == "first_start_zero":
        starts -= starts[0]
    elif case == "tied_diffs":  # runs of equal coordinate differences
        lens = np.repeat(rng.choice([20, 35, 50], n // 8), 8)
    elif case == "overlapping":  # negative deltas
        lens = rng.integers(1, 5000, n)
    return starts, (starts + lens).astype(np.int32)


CASES = ["seeded", "first_start_zero", "tied_diffs", "overlapping", "wrap", "one"]


def _args(op: str, case: str) -> tuple:
    starts, stops = _intervals(case)
    if op in ("transform_core", "union_length_device"):
        return starts, stops
    diffs = stops - starts
    deltas = starts - np.concatenate([[0], stops[:-1]]).astype(np.int32)
    if op == "untransform_core":
        return deltas, diffs
    extremes = np.array([I32.min, I32.min + 1, -10**9, -1, 0, 9, 10, 10**9 - 1, 10**9, I32.max], np.int32)
    return (np.concatenate([deltas, diffs, stops, extremes]),)


def _as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("op", ["transform_core", "untransform_core", "union_length_device", "dec_len_device"])
def test_op_equals_jax(op, case):
    args = _args(op, case)
    want = _as_tuple(getattr(transform_jax, op)(*map(jnp.asarray, args)))
    got = _as_tuple(getattr(transform, op)(*map(torch.from_numpy, args)))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(g.numpy(), w)


def test_int32_wraps_as_in_jax():
    """The reference's two int32 wraps, which the port keeps."""
    nonunique = transform.transform_core(torch.zeros(3, dtype=torch.int32), torch.full((3,), 2**30, dtype=torch.int32))[5]
    assert nonunique.dtype == torch.int32 and int(nonunique) == -(2**30)
    assert transform.dec_len_device(torch.tensor([I32.min], dtype=torch.int32)).tolist() == [2]


@pytest.mark.parametrize("case", CASES)
def test_int64_equals_host_transform(case):
    starts, stops = (x.astype(np.int64) for x in _intervals(case))
    _p_mask, diffs, deltas, _p_lens, d_lens, nonunique = transform.transform_core(
        torch.from_numpy(starts), torch.from_numpy(stops))
    assert d_lens.dtype == torch.int64 and np.array_equal(d_lens.numpy(), _dec_len(deltas.numpy()))
    assert int(nonunique) == int((stops - starts).sum())
    union = transform.union_length_device(torch.from_numpy(starts), torch.from_numpy(stops))
    assert union.dtype == torch.int64 and int(union) == _union_length(starts, stops)
    back = transform.untransform_core(deltas, diffs)
    assert np.array_equal(back[0].numpy(), starts) and np.array_equal(back[1].numpy(), stops)
    big = np.array([10**17, 10**18 - 1, 10**18, 2**62, -(10**18), np.iinfo(np.int64).max], np.int64)
    assert np.array_equal(transform.dec_len_device(torch.from_numpy(big)).numpy(), _dec_len(big))
