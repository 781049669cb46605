"""The port's wide MTF (starch3_tpu_torch/ops/mtf_wide.py) against the
Pallas kernels it replaces (starch3_tpu/ops/mtf_pallas.py, in interpret
mode on the CPU) and the NumPy MTF oracle; and a model of the windowed
CUDA kernel, which also runs the narrow wrapper's widths 32/64, against
the plain versions and the Pallas kernels of both wrappers.  On a CPU tensor the wrapper
runs the plain PyTorch version; the CUDA kernel itself is tested on the
card (tests/test_torch_cuda.py, chip_smoke.py).  Tolerance: zero."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from starch3_tpu.codec.mtf import mtf_ranks
from starch3_tpu.ops.mtf_narrow_pallas import mtf_ranks_narrow_batch as narrow_pallas_batch
from starch3_tpu.ops.mtf_pallas import mtf_ranks_pallas, mtf_ranks_pallas_batch
from starch3_tpu_torch.ops import mtf_wide
from starch3_tpu_torch.ops.mtf_narrow import mtf_ranks_narrow_reference
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


# A model of the CUDA kernel's rank pass (csrc/mtf_wide.cu,
# mtf_rank_kernel), step for step, vectorised over the 32 lanes of the warp
# that walks one 1,024-position chunk: it catches an error of the
# algorithm on the CPU, where the kernel cannot run.

_LANES = np.arange(32)


def _warp_sort_desc(vals: np.ndarray) -> np.ndarray:
    """The kernel's bitonic network over 32 lanes, W / 32 values a lane
    (element lane * per + q): descending."""
    per = vals.size // 32
    v = vals.reshape(32, per).copy()
    k = 2
    while k <= vals.size:
        j = k >> 1
        while j:
            if j >= per:  # with the partner lane (__shfl_xor_sync)
                o = v[_LANES ^ (j // per)]
                e = _LANES[:, None] * per + np.arange(per)
                keep_max = ((e & j) == 0) == ((e & k) == 0)
                v = np.where(keep_max, np.maximum(v, o), np.minimum(v, o))
            else:  # within the lane
                for q in range(per):
                    if q & j:
                        continue
                    up = ((_LANES * per + q) & k) == 0
                    a, b = v[:, q].copy(), v[:, q ^ j].copy()
                    v[:, q] = np.where(up, np.maximum(a, b), np.minimum(a, b))
                    v[:, q ^ j] = np.where(up, np.minimum(a, b), np.maximum(a, b))
            j >>= 1
        k <<= 1
    return v.reshape(-1)


def _window(sym: np.ndarray, P: np.ndarray, L: np.ndarray, width: int) -> np.ndarray:
    """One 32-position step: ranks by the counting form, then the list's
    update in place (P: symbol -> position, L: position -> symbol)."""
    valid = (sym >= 0) & (sym < width)
    same = sym[None, :] == sym[:, None]  # __match_any_sync
    below = same & (_LANES[None, :] < _LANES[:, None])
    prev = np.where(below.any(1), 31 - np.argmax(below[:, ::-1], axis=1), -1)
    pi = np.where(valid, P[np.clip(sym, 0, width - 1)], 0)
    first = valid & (prev < 0)
    key = np.where(valid, ((prev + 1) << 16) | pi, 0x7FFFFFFF)
    thr = np.where(prev >= 0, (prev + 2) << 16, pi)
    counted = (key[None, :] < thr[:, None]) & (_LANES[None, :] < _LANES[:, None])
    counted &= np.where(prev[:, None] >= 0, _LANES[None, :] > prev[:, None], True)
    cnt = counted.sum(1)
    n_first = np.cumsum(first) - first
    ranks = np.where(~valid, width, np.where(prev >= 0, cnt, n_first + pi - cnt))
    # the window's symbols to the front by last occurrence, then the rest
    is_last = valid & ~(same & (_LANES[None, :] > _LANES[:, None])).any(1)
    flag = np.zeros(width, bool)
    flag[pi[is_last]] = True
    pos = np.arange(width)
    new_pos = is_last.sum() + pos - (np.cumsum(flag) - flag)
    moved = L[~flag].copy()
    L[new_pos[~flag]] = moved
    P[moved] = new_pos[~flag]
    r = np.cumsum(is_last[::-1])[::-1] - is_last  # last lanes after each
    L[r[is_last]] = sym[is_last]
    P[sym[is_last]] = r[is_last]
    return ranks


# The kernel's pass 3 at widths 32/64 (mtf_rank_reg_kernel) keeps only P,
# in registers: lane l holds P[l] and, at width 64, P[l + 32].


def _shfl_up_or(v: np.ndarray, dd: int) -> np.ndarray:
    """``v |= __shfl_up_sync(FULL, v, dd)``: a lane below ``dd`` gets its
    own value back."""
    return v | v[np.where(_LANES >= dd, _LANES - dd, _LANES)]


def _popc(v) -> np.ndarray:
    return np.bitwise_count(np.asarray(v, np.uint64)).astype(np.int64)


def _window_reg(sym: np.ndarray, P: np.ndarray, width: int) -> np.ndarray:
    """One 32-position step of the register form: ranks from two inclusive
    prefix ORs over the lanes (of the bits 1 << prev and 1 << P[s]), then
    P's update in place: the window's symbols take their rank among the
    window's last occurrences (through shared memory), every other symbol
    moves down by the flagged positions below it."""
    u64 = np.uint64
    valid = (sym >= 0) & (sym < width)
    same = sym[None, :] == sym[:, None]  # __match_any_sync
    below = same & (_LANES[None, :] < _LANES[:, None])
    prev = np.where(below.any(1), 31 - np.argmax(below[:, ::-1], axis=1), -1)
    # P[s] from lane s & 31: one shuffle a slot, a select by bit 5 of s
    slots = P.reshape(width // 32, 32)
    pi = np.where(valid, slots[(sym >> 5) & (width // 32 - 1), sym & 31], 0)
    lanes = _LANES.astype(u64)
    x = np.where(valid & (prev >= 0), u64(1) << np.maximum(prev, 0).astype(u64), u64(0))
    g = np.where(valid, u64(1) << pi.astype(u64), u64(0))
    for dd in (1, 2, 4, 8, 16):
        x, g = _shfl_up_or(x, dd), _shfl_up_or(g, dd)
    vl = np.bitwise_or.reduce(np.where(valid, u64(1) << lanes, u64(0)))  # __ballot_sync
    lt = (u64(1) << lanes) - u64(1)
    # prev >= 0: the lanes in (prev, i) that are the last of their symbol in [0, i)
    seen = _popc(vl & ~x & lt & ~((u64(2) << np.maximum(prev, 0).astype(u64)) - u64(1)))
    # prev < 0: P[s] plus the earlier lanes' symbols behind s in the list
    first = pi + _popc(g & ~((u64(2) << pi.astype(u64)) - u64(1)))
    ranks = np.where(~valid, width, np.where(prev >= 0, seen, first))
    flags = g[31]  # the list positions of the window's symbols
    is_last = valid & ~(same & (_LANES[None, :] > _LANES[:, None])).any(1)
    d = int(is_last.sum())
    R = np.full(width, -1, np.int64)  # the shared array, by symbol
    R[sym[is_last]] = np.cumsum(is_last[::-1])[::-1][is_last] - 1  # last lanes above
    p = P.astype(u64)
    flagged = ((flags >> p) & u64(1)).astype(bool)
    P[:] = np.where(flagged, R, d + P - _popc(flags & ((u64(1) << p) - u64(1))))
    return ranks


def _rank_pass_model(row: np.ndarray, width: int, reg: bool = False) -> np.ndarray:
    """Pass 3 over one row; ``reg``: the register form of widths 32/64."""
    out = np.empty(row.size, np.int64)
    carry = -1 - np.arange(width)  # pass 2's carry into the chunk, seeded with L0
    for c0 in range(0, row.size, 1024):
        packed = ((carry + width + 1) << 8) | np.arange(width)
        order = _warp_sort_desc(packed) & 255
        P = np.empty(width, np.int64)
        P[order] = np.arange(width)
        L = order.copy()
        for w0 in range(c0, c0 + 1024, 32):
            sym = row[w0 : w0 + 32].astype(np.int64)
            out[w0 : w0 + 32] = _window_reg(sym, P, width) if reg else _window(sym, P, L, width)
        chunk = row[c0 : c0 + 1024]
        for k in np.nonzero((chunk >= 0) & (chunk < width))[0]:
            carry[chunk[k]] = c0 + k
    return out


@pytest.mark.parametrize("width", [32, 64, 128, 256])
def test_kernel_model_matches_plain_pallas_and_oracle(rng, width):
    """Row 0: runs of a few symbols, out-of-range and negative pad, a rare
    symbol.  Row 1: uniform over the alphabet.  Widths 32/64 are the
    narrow wrapper's: its plain version and its Pallas kernel."""
    n_max = 4096
    rows = np.empty((2, n_max), np.int32)
    rows[0] = np.repeat(rng.integers(0, 9, n_max // 4), 4)
    rows[0, 1500:1540] = rng.integers(-3, width + 5, 40)
    rows[0, 3000:] = width + 3
    rows[0, -9:] = -1
    rows[0, 77] = width - 1
    rows[1] = rng.integers(0, width, n_max)
    if width <= 64:
        want = mtf_ranks_narrow_reference(torch.from_numpy(rows), width).numpy()
        pallas = np.asarray(narrow_pallas_batch(jnp.asarray(rows), n_max, INTERPRET, width))
    else:
        want = mtf_ranks_wide_reference(torch.from_numpy(rows), width).numpy()
        pallas = np.asarray(mtf_ranks_pallas_batch(jnp.asarray(rows), n_max, width, INTERPRET))
    assert (want == pallas).all()
    for i in range(2):
        assert _rank_pass_model(rows[i], width).tolist() == want[i].tolist()
        if width <= 64:
            assert _rank_pass_model(rows[i], width, reg=True).tolist() == want[i].tolist()
    assert want[1].tolist() == mtf_ranks(rows[1], width).tolist()


@pytest.mark.parametrize("per", [1, 2, 4, 8])
def test_warp_sort_network_sorts(rng, per):
    for _ in range(20):
        vals = rng.permutation(1 << 12)[: 32 * per] - 300
        assert _warp_sort_desc(vals).tolist() == sorted(vals.tolist(), reverse=True)


@pytest.mark.parametrize("width", [32, 64])
def test_register_window_matches_shared_window(rng, width):
    """The register form's window against the shared-memory form's, from
    seeded lists: uniform windows, windows with out-of-range and negative
    symbols, one repeated symbol, every lane distinct, and runs."""
    windows = [rng.integers(0, width, 32) for _ in range(40)]
    windows += [rng.integers(-3, width + 4, 32) for _ in range(40)]
    windows += [np.full(32, rng.integers(0, width)) for _ in range(5)]
    windows += [np.full(32, width + 1), np.full(32, -1), rng.permutation(width)[:32]]
    windows += [np.repeat(rng.integers(0, width, 8), 4) for _ in range(10)]
    for sym in windows:
        P = rng.permutation(width).astype(np.int64)
        L = np.argsort(P)
        P2 = P.copy()
        want = _window(sym.astype(np.int64), P, L, width)
        got = _window_reg(sym.astype(np.int64), P2, width)
        assert got.tolist() == want.tolist()
        assert P2.tolist() == P.tolist()
        assert (L[P] == np.arange(width)).all()
