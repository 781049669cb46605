"""The port's device Huffman ops (starch3_tpu_torch/ops/huff.py) against
the JAX package's (starch3_tpu/ops/huff_jax.py) and against
``TestHuffJax``'s NumPy model, on the CPU, at ``n_max`` 4096 and 8192.
Tolerance: zero.

- ``group_histograms`` (the one-hot form) and ``group_hist_padded`` (the
  batched scatter-add form): ``m`` = 0, ``m`` inside the stream and
  ``m`` = ``n_max + 2``; symbols above 257 and below 0 (clipped by the
  padded form, counted nowhere by the one-hot form).
- ``cost_and_select``: random tables, masked tables, all-tie rows (every
  cost equal, empty groups) and the worst case (lengths 17, one symbol
  filling a group)."""

import numpy as np
import pytest
import torch

from starch3_tpu.ops import huff_jax
from starch3_tpu_torch.ops import huff

torch.set_num_threads(2)

N_MAX = [4096, 8192]


def _syms(rng, b, n_max):
    s = rng.integers(0, 40, (b, n_max + 2)).astype(np.int32)
    s[:, ::7] = rng.integers(258, 400, s[:, ::7].shape)  # above the alphabet
    s[:, 3::11] = -rng.integers(1, 5, s[:, 3::11].shape)  # below it
    return s


@pytest.mark.parametrize("n_max", N_MAX)
def test_group_hist_padded_matches_jax(rng, n_max):
    syms = _syms(rng, 4, n_max)
    ms = np.array([0, 1, 1234, n_max + 2], np.int32)
    got = huff.group_hist_padded(torch.from_numpy(syms), torch.from_numpy(ms), n_max).numpy()
    g_max = huff.n_groups_max(n_max)
    assert got.shape == (4, g_max, huff.ALPHA_MAX) and got.dtype == np.int32
    for i in range(4):
        want = np.asarray(huff_jax.group_hist_padded(syms[i], ms[i], n_max))
        assert np.array_equal(got[i], want), i
        assert got[i].sum() == ms[i]
    assert got[3, :, 257].sum() == (syms[3] >= 257).sum()  # clipped, not dropped


def test_group_hist_padded_rejects_a_wrong_width():
    with pytest.raises(ValueError, match="n_max"):
        huff.group_hist_padded(torch.zeros((1, 100), dtype=torch.int32), torch.tensor([5]), 4096)


@pytest.mark.parametrize("n_max", N_MAX)
def test_group_histograms_matches_jax_and_numpy(rng, n_max):
    import jax.numpy as jnp

    g_max = huff.n_groups_max(n_max)
    syms = np.zeros(g_max * huff.GROUP_SIZE, np.int32)
    syms[: n_max + 2] = _syms(rng, 1, n_max)[0]
    for n_mtf in (0, 437, n_max + 2):
        got = huff.group_histograms(torch.from_numpy(syms), n_mtf, g_max).numpy()
        want = np.asarray(huff_jax.group_histograms(jnp.asarray(syms), jnp.int32(n_mtf), g_max))
        assert np.array_equal(got, want), n_mtf
        model = np.zeros_like(want)
        for i in range(n_mtf):
            if 0 <= syms[i] < huff.ALPHA_MAX:
                model[i // huff.GROUP_SIZE, syms[i]] += 1
        assert np.array_equal(got, model), n_mtf


def _numpy_model(hist, lengths, mask):
    """``TestHuffJax``'s model (tests/test_jax_ops.py): int64 costs,
    masked tables at 1 << 30, NumPy's first-minimum argmin."""
    cost = hist.astype(np.int64) @ lengths.T.astype(np.int64)
    cost[:, ~mask] = 1 << 30
    sel = np.argmin(cost, axis=1)
    rfreq = np.zeros((6, huff.ALPHA_MAX), np.int64)
    for g in range(hist.shape[0]):
        rfreq[sel[g]] += hist[g]
    return sel, rfreq


def _cases(rng, g):
    """Four blocks: random with half the tables masked; every table equal
    (all ties) with empty groups; the worst case, lengths 17 and one
    symbol filling each group; two tables only, the second cheaper for
    some groups and tied with the first for others."""
    hist = rng.integers(0, 4, (4, g, huff.ALPHA_MAX)).astype(np.int32)
    lengths = rng.integers(1, 18, (4, 6, huff.ALPHA_MAX)).astype(np.int32)
    masks = np.zeros((4, 6), bool)
    masks[0, :3] = True
    hist[1, : g // 2] = 0
    lengths[1] = 5
    masks[1] = True
    hist[2] = 0
    hist[2, np.arange(g), rng.integers(0, huff.ALPHA_MAX, g)] = huff.GROUP_SIZE
    lengths[2] = 17
    masks[2] = True
    lengths[3, 1] = lengths[3, 0]
    lengths[3, 1, ::2] -= 1
    hist[3, ::3, ::2] = 0  # these groups cost the same under both tables
    masks[3, :2] = True
    return hist, lengths, masks


@pytest.mark.parametrize("n_max", N_MAX)
def test_cost_and_select_matches_jax_and_numpy(rng, n_max):
    import jax.numpy as jnp

    hist, lengths, masks = _cases(rng, huff.n_groups_max(n_max))
    sel, rfreq = huff.cost_and_select(
        torch.from_numpy(hist), torch.from_numpy(lengths), torch.from_numpy(masks)
    )
    assert sel.dtype == rfreq.dtype == torch.int32
    for i in range(4):
        want_sel, want_rfreq = huff_jax.cost_and_select(
            jnp.asarray(hist[i]), jnp.asarray(lengths[i]), jnp.asarray(masks[i])
        )
        assert np.array_equal(sel[i].numpy(), np.asarray(want_sel)), i
        assert np.array_equal(rfreq[i].numpy(), np.asarray(want_rfreq)), i
        model_sel, model_rfreq = _numpy_model(hist[i], lengths[i], masks[i])
        assert np.array_equal(sel[i].numpy(), model_sel), i
        assert np.array_equal(rfreq[i].numpy(), model_rfreq), i
    assert not sel[1].any()  # every table ties: the first wins
    assert set(sel[3].tolist()) == {0, 1}


def test_cost_and_select_first_minimum_and_masks():
    """Ties go to the lowest table, a masked table is never chosen even at
    cost 0, and a block with every table masked selects table 0."""
    a = huff.ALPHA_MAX
    hist = torch.zeros((3, 2, a), dtype=torch.int32)
    hist[:, 0, 7] = 3
    lengths = torch.full((3, 6, a), 4, dtype=torch.int32)
    lengths[0, 4, 7] = 2  # tables 4 and 5 cheapest, tied
    lengths[0, 5, 7] = 2
    lengths[1, 0, 7] = 0  # cheapest, but masked
    masks = torch.ones((3, 6), dtype=torch.bool)
    masks[1, 0] = False
    masks[2] = False
    sel, rfreq = huff.cost_and_select(hist, lengths, masks)
    assert sel.tolist() == [[4, 0], [1, 1], [0, 0]]
    assert rfreq[0, 4, 7] == 3 and rfreq[1, 1, 7] == 3 and rfreq[2, 0, 7] == 3
    assert int(rfreq.sum()) == 9
