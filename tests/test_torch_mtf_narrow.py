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
    before = mtf_narrow.launches, dict(mtf_narrow.width_launches)
    got = mtf_ranks_narrow_batch(torch.from_numpy(rows), 16)
    assert (mtf_narrow.launches, mtf_narrow.width_launches) == before
    want = mtf_ranks_narrow_reference(torch.from_numpy(rows), 16)
    assert torch.equal(got, want)


def test_wrapper_rejects_bad_input():
    with pytest.raises(ValueError):
        mtf_ranks_narrow_batch(torch.zeros((1, 4096), dtype=torch.int32), 8)
    with pytest.raises(TypeError):
        mtf_ranks_narrow_batch(torch.zeros((1, 4096), dtype=torch.int64), 16)
    with pytest.raises(TypeError):
        mtf_ranks_narrow_batch(torch.zeros(4096, dtype=torch.int32), 16)


# A model of the width-16 CUDA kernel (csrc/mtf_narrow.cu, mtf16_kernel),
# step for step, in Python integers: it catches an error of the algorithm
# on the CPU, where the kernel cannot run.  The kernel keeps the MTF list
# in one 64-bit word, a nibble per list position (position 0 in the low
# nibble); an aggregate is (list, mask): a run's distinct symbols by last
# occurrence, most recent first.

_CHUNK, _THREADS, _RUN = 4096, 128, 32
_NEG = -(1 << 30)
_FULL = 0xFFFF


def _compose(a, b):
    """a earlier, b later: b's symbols, then a's symbols not in b."""
    (al, am), (bl, bm) = a, b
    if am & ~bm == 0:
        return b
    if bm == 0:
        return a
    in_b = 0
    for p in range(16):
        in_b |= ((bm >> ((al >> (4 * p)) & 15)) & 1) << p
    keep = ~in_b & (0xFFFF >> (16 - bin(am).count("1")))
    cb = bin(bm).count("1")
    out = bl
    for p in range(16):
        if (keep >> p) & 1:
            at = cb + bin(keep & ((1 << p) - 1)).count("1")
            out |= ((al >> (4 * p)) & 15) << (4 * at)
    return out, am | bm


def _run_aggregate(vals):
    """A backward walk keeps each symbol's last occurrence."""
    lst = mask = 0
    slot = 1
    for s in reversed(vals):
        if 0 <= s < 16 and not (mask >> s) & 1:
            lst |= slot * s
            mask |= 1 << s
            slot <<= 4
    return lst, mask


def _rank_and_move(lo, hi, s):
    """One walk step on the list's two 32-bit halves."""
    m32 = 0xFFFFFFFF
    sx = 0x11111111 * s
    xl, xh = lo ^ sx, hi ^ sx
    tl = ((xl - 0x11111111) & m32) & ~xl & 0x88888888
    th = ((xh - 0x11111111) & m32) & ~xh & 0x88888888
    f = tl & (-tl & m32) if tl else th & (-th & m32)
    below, upto = (f >> 3) - 1, ((f << 1) - 1) & m32
    if tl:
        return bin(below).count("1") >> 2, (lo & ~upto) | ((lo & below) << 4) & m32 | s, hi
    hi = (hi & ~upto) | ((hi & below) << 4) & m32 | (lo >> 28)
    return 8 + (bin(below).count("1") >> 2), ((lo << 4) & m32) | s, hi


def _mtf16_kernel_model(row):
    out = np.empty(row.size, np.int64)
    published = []  # each chunk's table: last row position + 2, or 1 if absent
    for t, c0 in enumerate(range(0, row.size, _CHUNK)):
        vals = [int(v) for v in row[c0 : c0 + _CHUNK]]
        last = [-1] * 16
        for k, s in enumerate(vals):
            if 0 <= s < 16:
                last[s] = k
        published.append([c0 + x + 2 if x >= 0 else 1 for x in last])
        # the list entering the chunk: max of L0 and the earlier tables
        key = [max([-1 - s] + [e[s] - 2 if e[s] > 1 else _NEG for e in published[:t]]) for s in range(16)]
        incoming = 0
        for s in range(16):
            incoming |= s << (4 * sum(k > key[s] for k in key))
        aggs = [_run_aggregate(vals[j * _RUN : (j + 1) * _RUN]) for j in range(_THREADS)]
        excl, wp = [], (0, 0)
        for w0 in range(0, _THREADS, 32):  # each warp's scan, then its prefix
            inc = aggs[w0 : w0 + 32]
            d = 1
            while d < 32:
                inc = [_compose(inc[i - d], inc[i]) if i >= d else inc[i] for i in range(32)]
                d *= 2
            excl += [_compose(wp, inc[i - 1] if i else (0, 0)) for i in range(32)]
            wp = _compose(wp, inc[31])
        for j in range(_THREADS):
            lst = _compose((incoming, _FULL), excl[j])[0]
            lo, hi = lst & 0xFFFFFFFF, lst >> 32
            for k in range(_RUN):
                s = vals[j * _RUN + k]
                r = 16
                if 0 <= s < 16:
                    r, lo, hi = _rank_and_move(lo, hi, s)
                out[c0 + j * _RUN + k] = r
    return out


def test_kernel_model_matches_plain_pallas_and_oracle(rng):
    """Row 0: BWT-like runs over 11 symbols with a pad of out-of-range and
    negative symbols (chunks where symbols are absent).  Row 1: uniform
    over 16 symbols with one symbol silent across chunks."""
    n_max = 12288
    rows = np.empty((2, n_max), np.int32)
    rows[0] = np.repeat(rng.integers(0, 11, n_max // 8), 8)
    rows[0, 9000:] = 19
    rows[0, -5:] = -3
    rows[1] = rng.integers(0, 15, n_max)
    rows[1, 7], rows[1, n_max - 2] = 15, 15
    want = mtf_ranks_narrow_reference(torch.from_numpy(rows), 16).numpy()
    assert (want == _pallas(rows, 16)).all()
    for i in range(2):
        assert _mtf16_kernel_model(rows[i]).tolist() == want[i].tolist()
    assert want[0, :9000].tolist() == mtf_ranks(rows[0, :9000], 16).tolist()


def test_compose_is_associative(rng):
    """The block scan and the chunk aggregates group compositions in any
    order; composition with a full list, or with a subset, keeps the list."""

    def aggregate():
        mask = int(rng.integers(0, 1 << 16))
        syms = [s for s in range(16) if (mask >> s) & 1]
        rng.shuffle(syms)
        return sum(s << (4 * i) for i, s in enumerate(syms)), mask

    for _ in range(3000):
        a, b, c = aggregate(), aggregate(), aggregate()
        assert _compose(_compose(a, b), c) == _compose(a, _compose(b, c))
        full = (0xFEDCBA9876543210, _FULL)
        assert _compose(a, full) == full and _compose((0, 0), a) == a == _compose(a, (0, 0))


def test_walk_step_matches_list_mtf(rng):
    """The two-halves walk step against a plain list move-to-front."""
    for _ in range(300):
        order = [int(x) for x in rng.permutation(16)]
        lst = sum(s << (4 * p) for p, s in enumerate(order))
        lo, hi = lst & 0xFFFFFFFF, lst >> 32
        for s in (int(x) for x in rng.integers(0, 16, 40)):
            r, lo, hi = _rank_and_move(lo, hi, s)
            assert r == order.index(s)
            order.insert(0, order.pop(r))
            assert lo | (hi << 32) == sum(x << (4 * p) for p, x in enumerate(order))
