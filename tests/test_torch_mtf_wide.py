"""The port's wide MTF (starch3_tpu_torch/ops/mtf_wide.py) against the
Pallas kernels it replaces (starch3_tpu/ops/mtf_pallas.py, in interpret
mode on the CPU) and the NumPy MTF oracle.  On a CPU tensor the wrapper
runs the plain PyTorch version; the CUDA kernel itself is tested on the
card (tests/test_torch_cuda.py, chip_smoke.py).  Tolerance: zero."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from starch3_tpu.codec.mtf import mtf_ranks
from starch3_tpu.ops.mtf_pallas import mtf_ranks_pallas, mtf_ranks_pallas_batch
from starch3_tpu_torch.ops import mtf_wide
from starch3_tpu_torch.ops.mtf_wide import (
    mtf_ranks_wide,
    mtf_ranks_wide_batch,
    mtf_ranks_wide_reference,
)

torch.set_num_threads(2)

INTERPRET = jax.default_backend() != "tpu"


def _port(rows: np.ndarray, width: int) -> np.ndarray:
    return mtf_ranks_wide_batch(torch.from_numpy(rows), width).numpy()


@pytest.mark.parametrize("width", [128, 256])
def test_batch_matches_pallas_and_oracle(rng, width):
    """Row 0: random symbols with a pad of out-of-range and negative
    symbols.  Row 1: a rare symbol silent across many chunks.  Whole rows
    compare with the Pallas kernel, pad included: an out-of-range symbol
    ranks ``width`` in both."""
    n_max = 8192
    rows = np.empty((2, n_max), np.int32)
    rows[0] = rng.integers(0, width, n_max)
    rows[0, 6000:] = width + 3
    rows[0, -9:] = -1
    rows[1] = rng.integers(0, 3, n_max)
    rows[1, 5], rows[1, 100], rows[1, n_max - 1] = width - 1, width - 2, width - 1
    got = _port(rows, width)
    want = np.asarray(mtf_ranks_pallas_batch(jnp.asarray(rows), n_max, width, INTERPRET))
    assert got.tolist() == want.tolist()
    assert got[0, :6000].tolist() == mtf_ranks(rows[0, :6000], width).tolist()
    assert (got[0, 6000:] == width).all()
    assert got[1].tolist() == mtf_ranks(rows[1], width).tolist()


def test_single_row_matches_pallas_and_oracle(rng):
    """``mtf_ranks_wide`` is K2 (``mtf_ranks_pallas``): one row, width 256."""
    seq = rng.integers(0, 256, 4096).astype(np.int32)
    seq[:700] = rng.integers(0, 5, 700)  # long runs of few symbols, then all
    got = mtf_ranks_wide(torch.from_numpy(seq)).numpy()
    want = np.asarray(mtf_ranks_pallas(jnp.asarray(seq), 4096, INTERPRET))
    assert got.tolist() == want.tolist()
    assert got.tolist() == mtf_ranks(seq, 256).tolist()


@pytest.mark.parametrize("n,nsym", [(1, 256), (100, 2), (1023, 200), (1025, 256), (5000, 90)])
def test_plain_version_matches_oracle(rng, n, nsym):
    """Lengths on and off the chunk boundary."""
    seq = rng.integers(0, nsym, n).astype(np.int32)
    got = mtf_ranks_wide_reference(torch.from_numpy(seq[None, :]), 256)[0]
    assert got.tolist() == mtf_ranks(seq, 256).tolist()


def test_batch_rows_reinitialize(rng):
    """Row 1's ranks must not depend on row 0."""
    a = rng.integers(0, 256, 4096).astype(np.int32)
    b = rng.integers(0, 256, 4096).astype(np.int32)
    got = _port(np.stack([a, b]), 256)
    assert got[1].tolist() == mtf_ranks(b, 256).tolist()
    assert got[1].tolist() == _port(b[None, :], 256)[0].tolist()


def test_cpu_tensor_runs_plain_version_without_a_launch(rng):
    rows = rng.integers(0, 256, (2, 2048)).astype(np.int32)
    before = mtf_wide.launches
    got = mtf_ranks_wide_batch(torch.from_numpy(rows))
    assert mtf_wide.launches == before
    assert torch.equal(got, mtf_ranks_wide_reference(torch.from_numpy(rows), 256))


def test_wrapper_rejects_bad_input():
    with pytest.raises(ValueError):
        mtf_ranks_wide_batch(torch.zeros((1, 1024), dtype=torch.int32), 64)
    with pytest.raises(TypeError):
        mtf_ranks_wide_batch(torch.zeros((1, 1024), dtype=torch.int64))
    with pytest.raises(TypeError):
        mtf_ranks_wide_batch(torch.zeros(1024, dtype=torch.int32))
    with pytest.raises(TypeError):
        mtf_ranks_wide(torch.zeros((1, 1024), dtype=torch.int32))
