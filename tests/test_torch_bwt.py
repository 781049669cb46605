"""The port's exact BWT (starch3_tpu_torch/ops/bwt.py) against the JAX
package's ``bwt_encode_padded`` (ops/bwt_jax.py) and the copied host sort
``codec.bwt.bwt_encode``, on the CPU, with zero tolerance.

Each batched call is held row by row, the whole padded row, to JAX's
one-row call, for ``init_bytes`` 1 and 3: random, 2-symbol, all-equal
and exactly periodic rows, rows of length 1 and of ``n_max``, and a
batch of mixed lengths in which short rows finish long before the last
round.  The bucket stays at 16,384 so that JAX compiles its loop once
per ``init_bytes``; no thread is started."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from starch3_tpu.ops.bwt_jax import bwt_encode_padded as jax_bwt
from starch3_tpu_torch.codec.bwt import bwt_encode as host_bwt
from starch3_tpu_torch.ops.bwt import bwt_encode, bwt_encode_padded, n_rounds

torch.set_num_threads(2)
N_MAX = 16_384


def _row(rng, kind: str) -> np.ndarray:
    if kind == "random":
        return rng.integers(0, 256, 5_000, dtype=np.uint8)
    if kind == "two_symbol":
        return rng.integers(0, 2, 7_001, dtype=np.uint8)
    if kind == "all_equal":
        return np.full(3_333, 65, np.uint8)
    if kind == "periodic":  # period 14, not a divisor-free length
        return np.frombuffer(b"1723\n481\np100\n" * 900, np.uint8)
    if kind == "n1":
        return np.array([200], np.uint8)
    if kind == "n_max":
        return rng.integers(0, 16, N_MAX, dtype=np.uint8)
    raise ValueError(kind)


def _check_rows(rows, init_bytes: int) -> None:
    """One batched call on ``rows``; each row whole against JAX's one-row
    call and its valid prefix against the host sort."""
    blocks = np.zeros((len(rows), N_MAX), np.uint8)
    lens = np.zeros(len(rows), np.int32)
    for i, r in enumerate(rows):
        blocks[i, : r.size] = r
        lens[i] = r.size
    last, ptr = bwt_encode_padded(torch.from_numpy(blocks), torch.from_numpy(lens), init_bytes)
    assert last.dtype == torch.uint8 and ptr.dtype == torch.int32
    for i, r in enumerate(rows):
        j_last, j_ptr = jax_bwt(jnp.asarray(blocks[i]), np.int32(lens[i]), N_MAX, init_bytes)
        assert last[i].tolist() == np.asarray(j_last).tolist()
        assert int(ptr[i]) == int(j_ptr)
        h_last, h_ptr = host_bwt(r)
        assert last[i, : r.size].tolist() == h_last.tolist() and int(ptr[i]) == h_ptr


@pytest.mark.parametrize("kind", ["random", "two_symbol", "all_equal", "periodic", "n1", "n_max"])
@pytest.mark.parametrize("init_bytes", [1, 3])
def test_rows_equal_jax(rng, init_bytes, kind):
    """Each kind of row beside a random row of another length."""
    _check_rows([_row(rng, kind), rng.integers(0, 8, 1_234, dtype=np.uint8)], init_bytes)


@pytest.mark.parametrize("init_bytes", [1, 3])
def test_mixed_batch_equal_jax(rng, init_bytes):
    """Every kind in one batch, in an order that puts short rows between
    long ones: rows that have finished keep their ranks while the others
    go on."""
    kinds = ["n1", "n_max", "periodic", "two_symbol", "all_equal", "random", "n1"]
    _check_rows([_row(rng, k) for k in kinds], init_bytes)


def test_periodic_rotations_by_start_descending():
    """An exactly periodic block: its equal rotations sort by start index,
    descending, so orig_ptr is the last of rotation 0's class (the
    libbz2-observed order, codec/bwt.py)."""
    block = np.frombuffer(b"ab" * 8, np.uint8)
    last, ptr = bwt_encode(block, device="cpu")
    assert (last.tobytes(), ptr) == (b"b" * 8 + b"a" * 8, 7)


@pytest.mark.parametrize("n_max", [None, 4_096])
def test_bwt_encode_matches_host(rng, n_max):
    """The host wrapper, on the CPU, in and out of a larger bucket."""
    for n in (1, 2, 3, 100, 2_000):
        block = rng.integers(0, 4, n, dtype=np.uint8)
        last, ptr = bwt_encode(block, n_max=n_max, device="cpu")
        h_last, h_ptr = host_bwt(block)
        assert last.tolist() == h_last.tolist() and ptr == h_ptr


def test_round_count_is_fixed_by_the_bucket():
    """k = k0, 2 k0, ... while k < 2 n_max: 21 rounds at 901,120 with one
    init byte, 20 with three (k starts at 3)."""
    assert n_rounds(901_120) == 21
    assert n_rounds(901_120, 3) == 20
    assert n_rounds(16_384) == 15
    assert n_rounds(1) == 1


def test_bad_init_bytes_raises():
    with pytest.raises(ValueError, match="init_bytes"):
        bwt_encode_padded(torch.zeros((1, 8), dtype=torch.uint8), torch.ones(1, dtype=torch.int32), 2)
