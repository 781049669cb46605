"""The port's narrow MTF (starch3_tpu_torch/ops/mtf_narrow.py) against the
Pallas kernel it replaces (starch3_tpu/ops/mtf_narrow_pallas.py, in
interpret mode on the CPU) and the NumPy MTF oracle.  On a CPU tensor the
wrapper runs the plain PyTorch version; the CUDA kernel itself is tested
on the card (tests/test_torch_cuda.py, chip_smoke.py).  Tolerance: zero.

Interpret mode costs about a second per 4096-position tile here, so the
Pallas comparisons batch their cases into few calls."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from starch3_tpu.codec.mtf import mtf_ranks
from starch3_tpu.ops.mtf_narrow_pallas import mtf_ranks_narrow_batch as pallas_batch
from starch3_tpu_torch.ops import mtf_narrow
from starch3_tpu_torch.ops.mtf_narrow import (
    mtf_ranks_narrow_batch,
    mtf_ranks_narrow_reference,
)

torch.set_num_threads(2)


def _pallas(rows: np.ndarray, width: int) -> np.ndarray:
    interp = jax.default_backend() != "tpu"
    return np.asarray(
        pallas_batch(jnp.asarray(rows), rows.shape[1], interp, width)
    )


def _port(rows: np.ndarray, width: int) -> np.ndarray:
    return mtf_ranks_narrow_batch(torch.from_numpy(rows), width).numpy()


@pytest.mark.parametrize(
    "n,nsym", [(1, 16), (100, 2), (4096, 14), (5000, 16), (12288, 5)]
)
def test_matches_oracle(rng, n, nsym):
    seq = rng.integers(0, nsym, n).astype(np.int32)
    got = _port(seq[None, :], 16)[0]
    assert got.tolist() == mtf_ranks(seq, 16).tolist()


def test_width16_matches_pallas(rng):
    """One batch holds the oracle cases above, each padded to 12,288 with
    symbols outside [0, 16), and a rare symbol silent across tiles.  Whole
    rows compare, pad included: an out-of-range symbol ranks ``width`` in
    both."""
    n_max = 12288
    cases = [(12288, 5), (5000, 16), (4096, 14), (100, 2), (1, 16)]
    rows = np.full((len(cases) + 1, n_max), 99, dtype=np.int32)
    rows[1:, -7:] = -1
    for i, (n, nsym) in enumerate(cases):
        rows[i, :n] = rng.integers(0, nsym, n)
    rare = rng.integers(0, 3, n_max)
    rare[5], rare[100], rare[n_max - 1] = 15, 14, 15
    rows[-1] = rare  # its last rank depends on the order of silent symbols
    got = _port(rows, 16)
    assert got.tolist() == _pallas(rows, 16).tolist()
    for i, (n, _) in enumerate(cases + [(n_max, 16)]):
        assert got[i, :n].tolist() == mtf_ranks(rows[i, :n], 16).tolist()


@pytest.mark.parametrize("width", [32, 64])
def test_wide_matches_pallas_and_oracle(rng, width):
    n_max = 8192
    rows = rng.integers(0, width, (2, n_max)).astype(np.int32)
    rows[0, 7] = width - 1  # rare symbol: recency carry across tiles
    got = _port(rows, width)
    assert got.tolist() == _pallas(rows, width).tolist()
    for i in range(2):
        assert got[i].tolist() == mtf_ranks(rows[i], width).tolist()


def test_batch_rows_reinitialize(rng):
    """Row 1's ranks must not depend on row 0."""
    a = rng.integers(0, 16, 4096).astype(np.int32)
    b = rng.integers(0, 16, 4096).astype(np.int32)
    got = _port(np.stack([a, b]), 16)
    assert got[1].tolist() == mtf_ranks(b, 16).tolist()
    assert got[1].tolist() == _port(b[None, :], 16)[0].tolist()


def test_cpu_tensor_runs_plain_version_without_a_launch(rng):
    rows = rng.integers(0, 16, (2, 4096)).astype(np.int32)
    before = mtf_narrow.launches
    got = mtf_ranks_narrow_batch(torch.from_numpy(rows), 16)
    assert mtf_narrow.launches == before
    want = mtf_ranks_narrow_reference(torch.from_numpy(rows), 16)
    assert torch.equal(got, want)


def test_wrapper_rejects_bad_input():
    with pytest.raises(ValueError):
        mtf_ranks_narrow_batch(torch.zeros((1, 4096), dtype=torch.int32), 8)
    with pytest.raises(TypeError):
        mtf_ranks_narrow_batch(torch.zeros((1, 4096), dtype=torch.int64), 16)
    with pytest.raises(TypeError):
        mtf_ranks_narrow_batch(torch.zeros(4096, dtype=torch.int32), 16)
