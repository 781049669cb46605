"""The port's batched RLE2 (starch3_tpu_torch/ops/rle2.py) against the
JAX op it mirrors (starch3_tpu/ops/rle2_jax.rle2_from_ranks_padded, one
row at a time) and the host oracle (codec/mtf.mtf_rle2_from_ranks): the
cases of ``TestDeviceRle2`` and ``test_device_rle2_power_of_two_runs``
(tests/test_jax_ops.py).  Tolerance: zero."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from starch3_tpu.codec.mtf import mtf_rle2_from_ranks
from starch3_tpu.ops.rle2_jax import rle2_from_ranks_padded as jax_rle2
from starch3_tpu_torch.ops.rle2 import rle2_from_ranks_padded

torch.set_num_threads(2)


def _check(ranks: np.ndarray, lens: np.ndarray, n_in_use: np.ndarray):
    """Whole padded outputs equal JAX's on every row, and the valid part
    equals the host oracle."""
    n_max = ranks.shape[1]
    syms, m, freq = (
        x.numpy()
        for x in rle2_from_ranks_padded(
            torch.from_numpy(ranks), torch.from_numpy(lens), torch.from_numpy(n_in_use)
        )
    )
    assert syms.shape == (len(lens), n_max + 2) and freq.shape == (len(lens), 260)
    for i in range(len(lens)):
        js, jm, jf = jax_rle2(jnp.asarray(ranks[i]), np.int32(lens[i]), np.int32(n_in_use[i]), n_max)
        assert int(m[i]) == int(jm)
        assert syms[i].tolist() == np.asarray(js).tolist()
        assert freq[i].tolist() == np.asarray(jf).tolist()
        in_use = np.zeros(256, bool)
        in_use[: n_in_use[i]] = True
        ref = mtf_rle2_from_ranks(ranks[i, : lens[i]].astype(np.uint8), in_use)
        assert syms[i, : m[i]].tolist() == ref.symbols.tolist()
        assert freq[i, : ref.alpha_size].tolist() == ref.freq.tolist()


def test_matches_jax_and_oracle(rng):
    """Twelve random rows in one batch: 70% zeros, garbage past each
    row's length, the first row all zeros (digits + EOB only)."""
    n_max, b = 2048, 12
    lens = rng.integers(1, n_max, b).astype(np.int32)
    n_in_use = rng.integers(2, 256, b).astype(np.int32)
    ranks = rng.integers(0, 256, (b, n_max)).astype(np.int32)
    for i in range(b):
        n = lens[i]
        ranks[i, :n] = np.where(rng.random(n) < 0.7, 0, rng.integers(1, n_in_use[i], n))
    ranks[0, : lens[0]] = 0
    _check(ranks, lens, n_in_use)


@pytest.mark.parametrize("n", [1, 2, 4096])
def test_full_and_tiny_rows(rng, n):
    ranks = np.zeros((2, 4096), np.int32)
    ranks[0, :n] = rng.integers(0, 3, n)
    ranks[1, :n] = rng.integers(1, 255, n)
    _check(ranks, np.array([n, n], np.int32), np.array([3, 255], np.int32))


def test_power_of_two_runs():
    """Zero runs whose z+1 is a power of two: the bit length must be
    exact there (a float log2 is not)."""
    n_max = 1 << 17
    zs = (1, 3, 32766, 32767, 32768, 65535)
    ranks = np.zeros((len(zs), n_max), np.int32)
    for i, z in enumerate(zs):
        ranks[i, z] = 5
    lens = np.array([z + 1 for z in zs], np.int32)
    _check(ranks, lens, np.full(len(zs), 10, np.int32))
