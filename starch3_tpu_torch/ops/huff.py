"""Huffman refinement on the device: group histograms and table costing.

Counterpart of ``starch3_tpu/ops/huff_jax.py``.  Each round of bzip2's
table refinement (codec/huffman.py) costs every 50-symbol group against
every table, ``cost[g, t] = sum_a hist[g, a] * len[t, a]``, takes the
cheapest table per group (the first minimum, as libbz2) and sums the
histograms of the groups that chose each table.  The code-length heap
between two rounds stays on the host: it is a sequential loop over at
most 258 nodes whose tie-breaks the bytes depend on.

These are XLA ops in the reference, with no Pallas kernel, so they stay
exact PyTorch ops here, batched over the blocks of a batch:

- the cost is a ``float64`` ``bmm``.  CUDA has no integer matmul, and a
  ``float32`` one could run as TF32; every partial sum of these integers
  is far below 2**53, so ``float64`` is exact and needs no global switch;
- the selectors are the first minimum by an explicit ``amin`` over the
  tables whose cost equals the least, not by ``argmin``'s tie order;
- ``rfreq`` is an integer ``index_add_`` of each group's histogram into
  the row of its table;
- the reference's ``mode="drop"`` scatter becomes a spare slot past the
  end of each row, cut off after.

Shapes are padded: ``g_max`` groups, the alphabet fixed at 258 (the most
``nInUse + 2`` can be), 6 tables.
"""

from __future__ import annotations

import torch

ALPHA_MAX = 258
GROUP_SIZE = 50
N_TABLES = 6
MASKED_COST = 1 << 30  # the cost of a table a block does not use


def group_histograms(symbols: torch.Tensor, n_mtf, g_max: int) -> torch.Tensor:
    """``hist[g, s]`` over the 50-symbol groups of one stream, the one-hot
    form: int32[g_max * 50] symbols, entries at or past ``n_mtf`` masked
    -> int32[g_max, 258].  A symbol outside ``[0, 258)`` counts nowhere,
    as ``jax.nn.one_hot`` gives it an all-zero row."""
    dev = symbols.device
    idx = torch.arange(symbols.numel(), device=dev)
    valid = (idx < torch.as_tensor(n_mtf, device=dev)).reshape(g_max, GROUP_SIZE)
    sym_g = symbols.reshape(g_max, GROUP_SIZE).to(torch.int64)
    onehot = sym_g[..., None] == torch.arange(ALPHA_MAX, device=dev)
    return (onehot & valid[..., None]).sum(dim=1, dtype=torch.int32)


def n_groups_max(n_max: int) -> int:
    """Groups of 50 in an RLE2 stream of a block of at most ``n_max``
    bytes (at most ``n_max + 2`` symbols)."""
    return (n_max + 2 + GROUP_SIZE - 1) // GROUP_SIZE


def group_hist_padded(syms: torch.Tensor, m: torch.Tensor, n_max: int) -> torch.Tensor:
    """``hist[b, g, s]`` over the 50-symbol groups of a batch of padded
    RLE2 streams, the scatter-add form (the one-hot form would hold
    ``[B, G, 50, 258]``).

    Args:
      syms: int32[B, n_max + 2] symbol streams; a symbol outside
        ``[0, 258)`` is clipped into it
      m: int[B] symbol counts; entries at or past ``m`` are masked out
    Returns:
      int32[B, g_max, 258], ``g_max = ceil((n_max + 2) / 50)``
    """
    b, n_pad = syms.shape
    if n_pad != n_max + 2:
        raise ValueError(f"syms has {n_pad} columns, expected n_max + 2 = {n_max + 2}")
    dev = syms.device
    g_max = n_groups_max(n_max)
    width = g_max * ALPHA_MAX + 1  # + the spare slot of the masked entries
    idx = torch.arange(n_pad, device=dev, dtype=torch.int64)
    valid = idx[None, :] < m.to(device=dev, dtype=torch.int64)[:, None]
    flat = (idx // GROUP_SIZE) * ALPHA_MAX + syms.to(torch.int64).clamp(0, ALPHA_MAX - 1)
    flat = torch.where(valid, flat, width - 1)
    hist = torch.zeros((b, width), dtype=torch.int32, device=dev)
    hist.scatter_add_(1, flat, torch.ones_like(flat, dtype=torch.int32))
    return hist[:, :-1].reshape(b, g_max, ALPHA_MAX)


def cost_and_select(hist: torch.Tensor, lengths: torch.Tensor, masks: torch.Tensor):
    """One refinement round for a batch of blocks.

    Args:
      hist: int32[B, G, 258] group histograms
      lengths: int32[B, 6, 258] code lengths of each block's tables
      masks: bool[B, 6], True for the tables a block uses
    Returns:
      selectors int32[B, G], the cheapest table of each group, the first
        one on a tie (libbz2's order); a group whose every table is
        masked, or an empty group, selects table 0
      rfreq int32[B, 6, 258], the summed histograms of each table's groups
    """
    b, g, a = hist.shape
    dev = hist.device
    cost = torch.bmm(hist.to(torch.float64), lengths.to(torch.float64).transpose(1, 2))
    cost = torch.where(masks[:, None, :], cost.round().to(torch.int64), MASKED_COST)
    table = torch.arange(N_TABLES, device=dev)
    least = cost.amin(dim=2, keepdim=True)
    selectors = torch.where(cost == least, table, N_TABLES).amin(dim=2).to(torch.int32)
    rows = (torch.arange(b, device=dev)[:, None] * N_TABLES + selectors).reshape(-1)
    rfreq = torch.zeros((b * N_TABLES, a), dtype=torch.int32, device=dev)
    rfreq.index_add_(0, rows, hist.reshape(b * g, a).to(torch.int32))
    return selectors, rfreq.reshape(b, N_TABLES, a)
