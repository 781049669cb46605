"""Inverse BWT, batched, in PyTorch ops: last column -> block, no walk.

Counterpart of ``starch3_tpu/ops/ibwt_jax.py``, whose one-row op the JAX
decode step maps over a batch.  The host decoder inverts the BWT by an
n-step pointer chase over the LF mapping; this form replaces the chase by
parallel steps:

  1. ``lf_mapping``: one stable sort of (last, idx) gives sigma, the row
     of the r-th smallest symbol occurrence, and LF[sigma[r]] = r;
  2. ``jump``: list ranking by pointer jumping with the start row
     (orig_ptr) frozen; each round d[i] += d[nxt[i]], nxt[i] = nxt[nxt[i]]
     gives every row of the start cycle its distance to the start;
  3. ``place``: an exactly periodic block splits LF into several cycles,
     and the sequential walk loops the start cycle (length c) n / c times,
     so its symbols go into a period table P[d] = last[i] and the output
     is out[j] = P[(j - n + 1) mod c]; for a primitive block c == n.

What differs from the JAX op: the rows are a batch dimension; the
``while_loop`` until 2^k >= n becomes ``ceil(log2(n_max))`` rounds fixed
on the host, so no round waits on the device (extra rounds change nothing
on the start cycle, whose rows already point at the frozen start with
d[orig_ptr] = 0, and d elsewhere is never read and stays below 2^20 at
901,120); the pointers are flat int32 indices into the whole batch, so
every jump is one ``index_select``; ``_unscatter`` is a scatter (the
reference sorts because a random scatter is slow on a TPU); the period
table's ``mode="drop"`` is a spare column.  These are XLA ops in the
reference, not Pallas, so they stay in torch ops and run on whatever
device their inputs are on.
"""

from __future__ import annotations

import torch

_BIG = 0x7FFFFFF0


def _unscatter(order: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """``out[..., order[..., i]] = values[..., i]`` along the last axis, for
    a permutation ``order``: the counterpart of ``bwt_jax._unscatter``."""
    return torch.empty_like(values).scatter_(-1, order, values)


def lf_mapping(last: torch.Tensor, n: torch.Tensor, n_max: int) -> torch.Tensor:
    """Step 1: LF of each row, int32[B, n_max]; padding rows (past ``n``)
    sort to the tail and map to themselves."""
    b = last.shape[0]
    idx = torch.arange(n_max, device=last.device, dtype=torch.int32)
    key = torch.where(idx[None, :] < n[:, None], last.to(torch.int32), _BIG)
    sigma = torch.sort(key, dim=1, stable=True).indices
    return _unscatter(sigma, idx.expand(b, n_max).contiguous())


def jump(lf: torch.Tensor, orig_ptr: torch.Tensor, n: torch.Tensor, n_max: int):
    """Step 2: pointer jumping with each row's start frozen.  Returns
    (d int32[B, n_max], nxt int32[B, n_max]), ``nxt`` as flat indices into
    the batch (row * n_max + column)."""
    b = lf.shape[0]
    dev = lf.device
    idx = torch.arange(n_max, device=dev, dtype=torch.int32)
    base = (torch.arange(b, device=dev, dtype=torch.int32) * n_max)[:, None]
    start = idx[None, :] == orig_ptr[:, None]
    nxt = (torch.where(start, idx, lf) + base).reshape(-1)
    d = ((idx[None, :] < n[:, None]) & ~start).to(torch.int32).reshape(-1)
    for _ in range(max(n_max - 1, 0).bit_length()):  # ceil(log2(n_max))
        d = d + torch.index_select(d, 0, nxt)
        nxt = torch.index_select(nxt, 0, nxt)
    return d.reshape(b, n_max), nxt.reshape(b, n_max)


def place(last: torch.Tensor, d: torch.Tensor, nxt: torch.Tensor, orig_ptr: torch.Tensor,
          n: torch.Tensor, n_max: int) -> torch.Tensor:
    """Step 3: the start cycle's symbols tiled with its period c.
    Returns uint8[B, n_max], zero past each row's ``n``."""
    b = last.shape[0]
    dev = last.device
    idx = torch.arange(n_max, device=dev, dtype=torch.int32)
    base = (torch.arange(b, device=dev, dtype=torch.int32) * n_max)[:, None]
    valid = idx[None, :] < n[:, None]
    member = valid & (nxt == (orig_ptr[:, None] + base))
    # c >= 1 for any in-range orig_ptr; the clamp keeps the mod defined on
    # corrupt input (the host validates ptr and the CRCs)
    c = torch.clamp(member.sum(dim=1, dtype=torch.int32), min=1)
    period = torch.zeros((b, n_max + 1), device=dev, dtype=torch.uint8)
    period.scatter_(1, torch.where(member, d, n_max).to(torch.int64), torch.where(member, last, 0).to(torch.uint8))
    at = torch.where(valid, torch.remainder(idx[None, :] - n[:, None] + 1, c[:, None]), 0)
    out = torch.gather(period, 1, at.to(torch.int64))
    return torch.where(valid, out, 0).to(torch.uint8)


def ibwt_padded(last: torch.Tensor, orig_ptr: torch.Tensor, n: torch.Tensor, n_max: int) -> torch.Tensor:
    """Invert BWT last columns.

    Args:
      last: uint8[B, n_max] last columns (entries past each row's ``n``
        ignored)
      orig_ptr: int32[B] sorted position of rotation 0
      n: int32[B] true lengths
      n_max: padded size
    Returns:
      uint8[B, n_max] original blocks (valid prefix of length n)
    """
    lf = lf_mapping(last, n, n_max)
    d, nxt = jump(lf, orig_ptr, n, n_max)
    return place(last, d, nxt, orig_ptr, n, n_max)
