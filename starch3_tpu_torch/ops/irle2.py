"""Inverse RLE2, batched, in PyTorch ops: bzip2 symbols -> MTF ranks.

Counterpart of ``starch3_tpu/ops/irle2_jax.py``, whose one-row op the
JAX decode step maps over a batch.  The run accumulator of the host
decoder vectorises because bijective base-2 digits are additive: a
RUNA/RUNB digit at within-group position k stands for ``(sym + 1) << k``
zeros, so each symbol's output size needs only its position in its group
(a ``cummax`` of the group starts) and the output offsets one exclusive
cumsum.  In rank space a zero run is rank 0 repeated, so the output starts
as zeros and only the non-run symbols scatter their rank ``sym - 1``.

What differs from the JAX op: the rows are a batch dimension, and the
scatter's ``mode="drop"`` is a spare column past the end of each row,
cut off after.  This is an XLA op in the reference, not Pallas, so it
stays in torch ops and runs on whatever device its inputs are on.
"""

from __future__ import annotations

import numpy as np
import torch

_MAX_DIGITS = 21  # runs < 2^21 (block <= 901k); clamp for corrupt input


def irle2_decode_padded(syms: torch.Tensor, m: torch.Tensor, n_max: int):
    """Expand RLE2 symbols (EOB already stripped) into MTF ranks.

    Args:
      syms: int32[B, m_max] symbol streams (entries past each row's ``m``
        ignored)
      m: int32[B] true symbol counts (EOB excluded)
      n_max: padded output size
    Returns:
      ranks: int32[B, n_max] MTF ranks (valid prefix of length n)
      n: int32[B] decoded lengths (> n_max means corrupt input: the
        expansion overflowed the block; callers must check)
    """
    b, m_max = syms.shape
    t_idx = torch.arange(m_max, device=syms.device, dtype=torch.int32)
    valid = t_idx[None, :] < m[:, None]
    is_run = valid & (syms <= 1)
    # within-group digit position: distance from the group's first symbol
    prev_run = torch.nn.functional.pad(is_run[:, :-1], (1, 0), value=False)
    group_start = is_run & ~prev_run
    start_pos = torch.cummax(torch.where(group_start, t_idx, -1), dim=1).values
    k = torch.clamp(t_idx - start_pos, 0, _MAX_DIGITS)
    # output contribution: run digit -> (sym+1) << k zeros; rank -> 1 slot
    contrib = torch.where(is_run, (syms + 1) << k, valid.to(torch.int32)).to(torch.int32)
    total = torch.cumsum(contrib, dim=1, dtype=torch.int32)
    n = total[:, -1].contiguous()
    out_pos = total - contrib  # exclusive cumsum
    is_rank = valid & ~is_run
    keep = is_rank & (out_pos >= 0) & (out_pos < n_max)
    ranks = torch.zeros((b, n_max + 1), device=syms.device, dtype=torch.int32)
    ranks.scatter_(
        1,
        torch.where(keep, out_pos, n_max).to(torch.int64),
        torch.where(keep, syms - 1, 0).to(torch.int32),
    )
    return ranks[:, :n_max], n


def irle2_decode(syms_np: np.ndarray, n_hint: int | None = None) -> np.ndarray:
    """Host wrapper, on the CPU: RLE2 symbols (no EOB) -> MTF ranks array;
    the counterpart of ``irle2_decode_jax``."""
    m = int(syms_np.size)
    if n_hint is None:
        n_hint = 100_000 * 9 + 64
    syms = torch.zeros((1, max(m, 1)), dtype=torch.int32)
    syms[0, :m] = torch.from_numpy(syms_np.astype(np.int32))
    ranks, n = irle2_decode_padded(syms, torch.tensor([m], dtype=torch.int32), n_hint)
    n = int(n[0])
    if n > n_hint:
        raise ValueError("RLE2 expansion exceeds block capacity")
    return ranks[0, :n].numpy()
