"""RLE2 / zero-run coding of MTF ranks, batched, in PyTorch ops.

Counterpart of ``starch3_tpu/ops/rle2_jax.py`` (``rle2_from_ranks_padded``,
which the JAX pipeline maps over a batch).  Zero runs become bijective
base-2 RUNA/RUNB digits (z+1's binary digits, MSB dropped, LSB first),
rank j becomes symbol j+1, and EOB = n_in_use + 1 ends the stream.

The same scatter-minimal formulation as the JAX op: every output symbol
is pinned to a distinct input position (digit r of a zero run rides the
run's r-th zero, a nonzero rank's symbol rides its own position), so two
scans, elementwise math and one compaction scatter give the stream:

    run_start = cummax of nonzero positions        (last nonzero <= i)
    next_nz   = reverse cummin of nonzero positions (first nonzero >= i)
    r         = i - run_start - 1, z_total = next_nz - run_start - 1
    dig       = bitlen(z_total + 1) - 1
    emit      = nonzero | (r < dig)
    value     = nonzero ? rank + 1 : ((z_total + 1) >> r) & 1
    out_idx   = cumsum(emit) - 1

What differs: ``jax.lax.clz`` has no torch op, so the bit length comes
from ``torch.frexp`` on ``float64``, exact for every int32; the scatters'
``mode="drop"`` is a spare slot past the end of each row, cut off after.
This is an XLA op in the reference, not Pallas, so it stays in torch ops.
"""

from __future__ import annotations

import torch


def rle2_from_ranks_padded(ranks: torch.Tensor, lens: torch.Tensor, n_in_use: torch.Tensor):
    """RLE2-encode a batch of MTF ranks.

    Args:
      ranks: int32[B, n_max] MTF ranks (entries past each row's length
        are ignored)
      lens: int[B] true lengths
      n_in_use: int[B] dense alphabet sizes (EOB = n_in_use + 1)
    Returns:
      syms: int32[B, n_max + 2] symbol streams, padded with each row's EOB
      m: int32[B] true symbol counts (EOB included)
      freq: int32[B, 260] symbol histograms over the first m entries
    """
    b, n_max = ranks.shape
    dev = ranks.device
    rk = ranks.to(torch.int64)
    n = lens.to(device=dev, dtype=torch.int64)[:, None]
    idx = torch.arange(n_max, device=dev, dtype=torch.int64)[None, :]
    valid = idx < n
    nz = valid & (rk != 0)

    run_start = torch.cummax(torch.where(nz, idx, -1), dim=1).values
    next_nz = torch.cummin(torch.where(nz, idx, n).flip(1), dim=1).values.flip(1)
    r = idx - run_start - 1  # zero's index within its run
    mval = next_nz - run_start  # z_total + 1
    # bitlen(mval) is frexp's exponent (mval = f * 2**e, 0.5 <= f < 1);
    # 0 maps to -1, as 31 - clz(0) does
    dig = torch.frexp(mval.to(torch.float64)).exponent.to(torch.int64) - 1
    digit = (mval >> r.clamp(0, 62)) & 1
    emit = valid & (nz | (r < dig))
    value = torch.where(nz, rk + 1, digit)

    ecount = torch.cumsum(emit, dim=1)
    m = ecount[:, -1] + 1  # + EOB
    eob = n_in_use.to(device=dev, dtype=torch.int64) + 1
    # the pad IS the EOB symbol, so slot m-1 needs no write; slot n_max+2
    # takes the writes of the positions that emit nothing
    syms = eob[:, None].expand(b, n_max + 3).clone()
    syms.scatter_(1, torch.where(emit, ecount - 1, n_max + 2), torch.where(emit, value, 0))

    zero_emit = emit & ~nz
    freq = torch.zeros((b, 261), dtype=torch.int64, device=dev)
    freq.scatter_add_(1, torch.where(nz, rk + 1, 260), torch.ones_like(rk))
    freq[:, 0] += (zero_emit & (digit == 0)).sum(dim=1)
    freq[:, 1] += (zero_emit & (digit == 1)).sum(dim=1)
    freq.scatter_add_(1, eob[:, None], torch.ones_like(eob[:, None]))
    return (
        syms[:, : n_max + 2].to(torch.int32),
        m.to(torch.int32),
        freq[:, :260].to(torch.int32),
    )
