"""Exact BWT rotation sort, batched, in PyTorch ops: prefix doubling.

Counterpart of ``starch3_tpu/ops/bwt_jax.py``, the sort of the legacy
exact modes (``fast_bwt=False``).  Every cyclic rotation of a block is
ordered exactly: each round sorts the pairs (rank_i, rank_{i+k mod n})
and reranks them densely, doubling k until every rank is distinct.
Equal rotations (an exactly periodic block) keep decreasing start-index
order, the libbz2 order (``codec/bwt.py``).  No block ties, so no block
is re-encoded on the host.

What differs from the JAX version, and why:

- The rows are a batch dimension: the reference maps a one-row
  ``lax.while_loop`` over the batch.  Here the rounds are fixed on the
  host from ``n_max`` (k = k0, 2 k0, 4 k0, ... while k < 2 n_max: 21 rounds
  at 901,120 with ``init_bytes=1``), so no round reads a device value on
  the host and a dispatch never waits on the card.  A round updates only
  the rows that the vmapped loop would still run, ``~done & (k < 2 n)``,
  as its select does: a row past that point (a short row in a large
  bucket) keeps its ranks.  No round exits early when every row is done.
- The shift by k is a per-row cyclic gather (``bwt_fast._cyclic_shift``)
  on ``k mod n``, where the reference rolls twice; for a row still in the
  loop (k < 2 n) that is its one conditional subtract.
- The stable two-key sort is one stable sort of the ``int64`` key
  ``rank << 31 | rank2``: both values are at most ``_BIG + 1 < 2**31``.
- ``_unscatter`` is a scatter (``ops/ibwt._unscatter``): the reference
  sorts because a random scatter is slow on a TPU.

These are XLA sorts in the reference, not a Pallas kernel, so they stay
in torch ops and run on whatever device their inputs are on.
"""

from __future__ import annotations

import numpy as np
import torch

from starch3_tpu_torch.ops.bwt_fast import _cyclic_shift
from starch3_tpu_torch.ops.ibwt import _BIG, _unscatter

_PAD = _BIG + 1  # the rank of every position past a row's length


def _dense_rerank(key: torch.Tensor, n: torch.Tensor, valid: torch.Tensor):
    """Stable sort of each row's ``key`` and dense ranks of its distinct
    values, in place order.  Returns (rank int64, done bool[B]): ``done``
    when a row's ``n`` valid ranks are all distinct."""
    ks, order = torch.sort(key, dim=1, stable=True)
    changed = torch.zeros_like(ks)
    changed[:, 1:] = ks[:, 1:] != ks[:, :-1]
    rank = _unscatter(order, torch.cumsum(changed, dim=1))
    rank = torch.where(valid, rank, _PAD)
    done = torch.where(valid, rank, -1).amax(dim=1) == n - 1
    return rank, done


def n_rounds(n_max: int, init_bytes: int = 1) -> int:
    """The doubling rounds run on an ``n_max`` bucket: k = k0, 2 k0, ...
    while k < 2 n_max, with k0 = ``init_bytes``."""
    k, r = init_bytes, 0
    while k < 2 * n_max:
        k, r = 2 * k, r + 1
    return r


def doubling_round(rank, done, k: int, n, idx, valid):
    """One round at shift ``k`` on the rows still in the loop
    (``~done & (k < 2 n)``); the other rows keep their state.  Returns
    (rank, done)."""
    n1 = n.clamp(min=1)
    rank2 = _cyclic_shift(rank, torch.remainder(torch.full_like(n, k), n1), n1, idx)
    rank2 = torch.where(valid, rank2, _PAD)
    new_rank, new_done = _dense_rerank((rank << 31) | rank2, n, valid)
    active = ~done & (k < 2 * n)
    return torch.where(active[:, None], new_rank, rank), torch.where(active, new_done, done)


def initial_state(blocks: torch.Tensor, lens: torch.Tensor, init_bytes: int = 1):
    """The state before the first round: (rank int64[B, n_max], done
    bool[B], n int64[B], idx int64[n_max], valid bool[B, n_max]).  With
    one init byte the ranks are the bytes; with three, the dense ranks of
    each position's cyclic 3-byte big-endian key."""
    if init_bytes not in (1, 3):
        raise ValueError("init_bytes must be 1 or 3")
    b, n_max = blocks.shape
    dev = blocks.device
    n = lens.to(device=dev, dtype=torch.int64)
    idx = torch.arange(n_max, device=dev, dtype=torch.int64)
    valid = idx[None, :] < n[:, None]
    byte = blocks.to(torch.int64)
    if init_bytes == 1:
        rank = torch.where(valid, byte, _PAD)
        return rank, torch.zeros(b, device=dev, dtype=torch.bool), n, idx, valid
    n1 = n.clamp(min=1)

    def cyclic(shift: int) -> torch.Tensor:
        return _cyclic_shift(byte, torch.remainder(torch.full_like(n, shift), n1), n1, idx)

    key = (byte << 16) | (cyclic(1) << 8) | cyclic(2)
    rank, done = _dense_rerank(torch.where(valid, key, _PAD), n, valid)
    return rank, done, n, idx, valid


def bwt_encode_padded(blocks: torch.Tensor, lens: torch.Tensor, init_bytes: int = 1):
    """Rotation-sort a batch of padded blocks.

    Args:
      blocks: uint8[B, n_max] (contents past each row's length ignored)
      lens: int[B] true lengths (1 <= len <= n_max)
      init_bytes: 1 or 3, the bytes packed into the round-0 key; 3 starts
        the doubling at k = 3
    Returns:
      last: uint8[B, n_max] BWT last columns (valid prefix of length n)
      orig_ptr: int32[B] sorted position of rotation 0
    """
    rank, done, n, idx, valid = initial_state(blocks, lens, init_bytes)
    n_max = blocks.shape[1]
    k = init_bytes
    for _ in range(n_rounds(n_max, init_bytes)):
        rank, done = doubling_round(rank, done, k, n, idx, valid)
        k *= 2

    # final order: rank ascending, equal rotations by start index
    # descending (the libbz2-observed order); the keys are distinct
    sa = torch.sort((rank << 31) | (n_max - 1 - idx), dim=1).indices
    prev = torch.where(sa > 0, sa - 1, n[:, None] - 1)
    last = torch.gather(blocks, 1, prev)
    orig_ptr = (sa == 0).to(torch.int32).argmax(dim=1).to(torch.int32)
    return last, orig_ptr


def bwt_encode(block_np: np.ndarray, n_max: int | None = None, device="cuda"):
    """Host wrapper mirroring ``codec.bwt.bwt_encode`` and the JAX
    ``bwt_encode_jax``: (last uint8[n], orig_ptr), sorted on ``device``."""
    n = int(block_np.size)
    if n_max is None:
        n_max = n
    padded = torch.zeros((1, n_max), dtype=torch.uint8)
    padded.numpy()[0, :n] = block_np
    last, ptr = bwt_encode_padded(padded.to(device), torch.tensor([n], dtype=torch.int32).to(device))
    return last[0, :n].cpu().numpy(), int(ptr[0])
