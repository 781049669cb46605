"""The port's bits==4 device step (starch3_tpu_torch/parallel/pipeline
.step_ranks4) against the JAX step it mirrors,
``_jitted_fused_step_ranks4(n_max, False)``: the step that
__graft_entry__.entry() compiles.  Rows ``[orig_ptr, ties, packed
ranks]``: columns 0-1 equal on every row, the whole row where ties == 0.
Tolerance: zero."""

import numpy as np
import pytest
import torch

from starch3_tpu.parallel.pipeline import _jitted_fused_step_ranks4
from starch3_tpu_torch.parallel.pipeline import _dense_pack4, step_ranks4

from tests.conftest import make_bed_text

torch.set_num_threads(2)


def _batch(rng, n_max: int):
    """Three rows: random 14 symbols (full length), real transformed BED
    (short row, zero pad), and a periodic text whose sort ties."""
    from starch3_tpu.api import _parse_transform

    packed = np.zeros((3, n_max // 2), np.uint8)
    lens = np.zeros(3, np.int32)
    seqs = rng.integers(0, 14, n_max, dtype=np.uint8)
    packed[0] = seqs[0::2] | (seqs[1::2] << 4)
    lens[0] = n_max
    text = _parse_transform(make_bed_text(rng, n=300))[0].text[: n_max - 100]
    periodic = (b"1723\n481\np100\n" * n_max)[: n_max // 3]
    for i, data in ((1, text), (2, periodic)):
        arr = np.frombuffer(data, np.uint8)
        lens[i] = arr.size
        _dense_pack4(arr, packed[i])
    return packed, lens


@pytest.mark.parametrize("n_max", [4096, 8192])
def test_rows_match_jax_step(rng, n_max):
    packed, lens = _batch(rng, n_max)
    want = np.asarray(_jitted_fused_step_ranks4(n_max, False)(packed, lens))
    got = step_ranks4(torch.from_numpy(packed), torch.from_numpy(lens)).numpy()
    assert got.shape == want.shape == (3, 2 + n_max // 8)
    assert got[:, :2].tolist() == want[:, :2].tolist()
    assert want[2, 1] > 0  # the periodic row ties
    for i in range(3):
        if want[i, 1] == 0:
            assert got[i].tolist() == want[i].tolist()


def test_ranks_past_length_are_zero(rng):
    packed, lens = _batch(rng, 4096)
    rows = step_ranks4(torch.from_numpy(packed), torch.from_numpy(lens)).numpy()
    by = rows[1, 2:].view(np.uint8)
    nibbles = np.stack([by & 0xF, by >> 4], axis=1).reshape(-1)
    assert not nibbles[lens[1]:].any()
