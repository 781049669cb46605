"""One-sort BWT for the bits==4 tier, batched, in PyTorch ops.

Counterpart of ``starch3_tpu/ops/bwt_fast.py`` (``_cyclic_shift`` and
``bwt_sort_fast3``).  Every cyclic rotation of a block is sorted once by
its first 23 symbols, packed 8 symbols per 32-bit key, with the previous
symbol (the BWT last-column payload) riding in key3's low nibble.  A
block is exact when no two adjacent sorted rotations share the 23-symbol
prefix (``ties == 0``); a tied block is re-encoded exactly on the host by
the caller.

What differs from the JAX version, and why:

- Keys are built in ``int64``: torch has little ``uint32`` support, and
  every 32-bit key value fits an ``int64`` with its unsigned order intact.
- The rotation by ``k`` is a per-row gather on ``(i + k_row) % n_row``:
  rows of one batch have different lengths, so ``k`` (which depends on
  ``n`` when ``n <= 23``) is per row and ``torch.roll`` does not fit.
- torch has no lexicographic multi-key sort.  Two *stable* LSD passes
  give the same order: first by key3, then by one ``int64`` holding
  ``((key1 - 2**31) << 32) | key2``, whose signed order is the unsigned
  order of ``(key1, key2)``.  Padded positions hold all-ones keys and so
  still sort to the tail.

The JAX sort is unstable, but it sorts all three operands as keys, so the
sorted key arrays, and with them ``last``, ``orig_ptr`` and ``ties``, are
the same as here on every row.
"""

from __future__ import annotations

import torch

_BIGU = 0xFFFFFFFF
_MASK32 = 0xFFFFFFFF


def _cyclic_shift(seq: torch.Tensor, k: torch.Tensor, n: torch.Tensor, idx: torch.Tensor):
    """``seq[b, (i + k[b]) mod n[b]]`` over each row's valid prefix.

    ``k[b] < n[b]`` for every row.  Positions past a row's length read
    some in-range element (their keys are masked by the caller)."""
    ix = idx[None, :] + k[:, None]
    ix = torch.where(ix >= n[:, None], ix - n[:, None], ix)
    return torch.gather(seq, 1, ix)


def bwt_sort_fast3(seqs: torch.Tensor, lens: torch.Tensor):
    """bits==4 one-sort BWT over a batch.

    Args:
      seqs: int32[B, n_max] dense symbols < 16 (entries past each row's
        length are ignored; they may hold anything)
      lens: int[B] true lengths, 1 <= lens[b] <= n_max
    Returns:
      last: int32[B, n_max] candidate BWT last column (valid prefix of
        each row; exact iff that row's ties == 0)
      orig_ptr: int32[B] sorted position of rotation 0 (iff ties == 0)
      ties: int32[B] adjacent sorted rotations whose 23-symbol prefixes
        collide (0 = the row is exact)
    """
    b, n_max = seqs.shape
    dev = seqs.device
    n = lens.to(device=dev, dtype=torch.int64)
    idx = torch.arange(n_max, device=dev, dtype=torch.int64)
    valid = idx[None, :] < n[:, None]
    seq = torch.where(valid, seqs.to(torch.int64), 0)
    n1 = n.clamp(min=1)

    def shift(arr, k_static: int):
        k = torch.where(k_static >= n, k_static % n1, torch.full_like(n, k_static))
        return _cyclic_shift(arr, k, n, idx)

    # shift-or doubling ladder: 8 symbols per 32-bit key in 3 steps
    acc = seq
    w = 4
    while w * 2 <= 32:
        acc = ((acc << w) & _MASK32) | shift(acc, w // 4)
        w *= 2
    prev = _cyclic_shift(seq, (n - 1).clamp(min=0), n, idx)
    key1 = torch.where(valid, acc, _BIGU)
    key2 = torch.where(valid, shift(acc, 8), _BIGU)
    key3 = torch.where(valid, (shift(acc, 16) & 0xFFFFFFF0) | prev, _BIGU)

    # lexicographic (key1, key2, key3) order by two stable LSD passes
    _, p3 = torch.sort(key3, dim=1, stable=True)
    k3a = torch.gather(key3, 1, p3)
    k12a = torch.gather(((key1 - (1 << 31)) << 32) | key2, 1, p3)
    k12s, p12 = torch.sort(k12a, dim=1, stable=True)
    k3s = torch.gather(k3a, 1, p12)
    last = (k3s & 0xF).to(torch.int32)

    ar = torch.arange(n_max - 1, device=dev, dtype=torch.int64)
    eq = (
        (k12s[:, 1:] == k12s[:, :-1])
        & ((k3s[:, 1:] >> 4) == (k3s[:, :-1] >> 4))
        & (ar[None, :] < (n - 1)[:, None])
    )
    ties = eq.sum(dim=1).to(torch.int32)

    c1, c2, c3 = key1[:, :1], key2[:, :1], key3[:, :1] >> 4
    k3c = key3 >> 4
    lt = (key1 < c1) | ((key1 == c1) & ((key2 < c2) | ((key2 == c2) & (k3c < c3))))
    orig_ptr = (lt & valid).sum(dim=1).to(torch.int32)
    return last, orig_ptr, ties
