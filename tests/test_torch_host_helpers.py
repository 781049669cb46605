"""The ops' host helpers (numpy in, numpy out) on the CPU against the JAX
package's, on the same seeded rows: ``bwt_fast_host``,
``mtf_ranks_narrow_host``, and ``mtf_ranks_wide_host`` against both
``mtf_ranks_pallas_host`` and ``mtf_ranks_jax``.  Exact."""

import numpy as np
import pytest

from starch3_tpu.ops import bwt_fast as jax_bwt_fast
from starch3_tpu.ops import mtf_jax, mtf_narrow_pallas, mtf_pallas
from starch3_tpu_torch.ops import bwt_fast, mtf_narrow, mtf_wide


def _rows(n: int, k: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, k, n).astype(np.uint8)


# (length, alphabet): bits 4 (at most 16 symbols) and bits 8, a row of
# one byte, rows that fill their power of two
@pytest.mark.parametrize("n,k", [(1, 1), (70, 3), (128, 16), (1_000, 12), (5_000, 200), (4_096, 17)])
def test_bwt_fast_host_equals_jax(n, k):
    block = _rows(n, k, n + k)
    last, ptr, ties = bwt_fast.bwt_fast_host(block, device="cpu")
    j_last, j_ptr, j_ties = jax_bwt_fast.bwt_fast_host(block)
    assert (ptr, ties) == (j_ptr, j_ties)
    # on a tied row the JAX sort's order of tied rotations is its own (a
    # documented difference, ROADMAP C); these seeded rows do not tie
    assert ties == 0
    assert last.dtype == np.uint8 and np.array_equal(last, j_last)


@pytest.mark.parametrize("n", [700, 4_096])
def test_mtf_ranks_narrow_host_equals_jax(n):
    seq = _rows(n, 16, n).astype(np.int32)
    got = mtf_narrow.mtf_ranks_narrow_host(seq, device="cpu")
    want = mtf_narrow_pallas.mtf_ranks_narrow_host(seq)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("n,k", [(1, 256), (1_024, 256), (3_000, 256), (2_500, 30)])
def test_mtf_ranks_wide_host_equals_jax(n, k):
    seq = _rows(n, k, n + k).astype(np.int32)
    got = mtf_wide.mtf_ranks_wide_host(seq, device="cpu")
    for want in (mtf_pallas.mtf_ranks_pallas_host(seq), mtf_jax.mtf_ranks_jax(seq, k)):
        assert got.dtype == want.dtype and np.array_equal(got, want)
