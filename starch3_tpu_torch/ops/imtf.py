"""Inverse MTF, batched, in PyTorch ops: a tile-blocked permutation scan.

Counterpart of ``starch3_tpu/ops/imtf_jax.py``, whose one-row op the JAX
decode step maps over a batch.  The step "emit list[r], move it to the
front" changes the list by a position-space permutation p_r that depends
on the rank r only, never on the list's contents:

    p_r(0) = r,  p_r(i) = i-1 for 1 <= i <= r,  p_r(i) = i for i > r

so a tile of T steps has a net permutation Q_t that needs no incoming
list, and tiles compose associatively:

  - pass 1 (``tile_permutations``): the T-step loop, over every tile of
    every row at once; each step is a one-element gather, a shift and a
    select over a (B, n_tiles, 256) carry.  The emitted symbol's position
    in the tile's starting list, front_k = Q^(k)[r_k], is the gathered
    element;
  - pass 2 (``compose_exclusive``): the exclusive composition of the tile
    permutations into each tile's starting list C_t;
  - ``gather_symbols``: sym[t, k] = alphabet[C_t[front_{t,k}]].

What differs from the JAX op: pass 2 is a ``lax.scan`` over the tiles
there, and here a log-depth (Hillis-Steele) scan of compositions, 11
rounds at 1,760 tiles, which gives the same integers in 11 launches
instead of 1,760.  Every list position is below 256, so the carry and the
fronts are ``uint8``.  These are XLA ops in the reference, not Pallas, so
they stay in torch ops and run on whatever device their inputs are on.
"""

from __future__ import annotations

import numpy as np
import torch

_TILE = 512


def tile_permutations(ranks: torch.Tensor, n: torch.Tensor, n_max: int):
    """Pass 1: each tile's net permutation and the fronts of its steps.

    Ranks past each row's ``n`` become 0 (rank 0 is the identity step) and
    every rank is clamped to [0, 255], as in the reference.  Returns
    (q uint8[B, n_tiles, 256], fronts uint8[B, n_tiles, _TILE])."""
    if n_max % _TILE:
        raise ValueError(f"n_max={n_max} is not a multiple of {_TILE}")
    b = ranks.shape[0]
    n_tiles = n_max // _TILE
    dev = ranks.device
    pos_g = torch.arange(n_max, device=dev, dtype=torch.int32)
    r_all = torch.clamp(torch.where(pos_g[None, :] < n[:, None], ranks, 0), 0, 255)
    r_tiles = r_all.reshape(b, n_tiles, _TILE).to(torch.int64)
    pos = torch.arange(256, device=dev, dtype=torch.int64)
    q = pos.to(torch.uint8).expand(b, n_tiles, 256).contiguous()
    fronts = torch.empty((_TILE, b, n_tiles), device=dev, dtype=torch.uint8)
    for k in range(_TILE):
        r_k = r_tiles[:, :, k : k + 1]
        front = torch.gather(q, 2, r_k)  # Q[r]
        moved = torch.cat([front, q[:, :, :255]], dim=2)  # front, then Q[x-1]
        q = torch.where(pos <= r_k, moved, q)
        fronts[k] = front[:, :, 0]
    return q, fronts.permute(1, 2, 0)


def compose_exclusive(q: torch.Tensor) -> torch.Tensor:
    """Pass 2: C_0 = identity, C_{t+1} = C_t[Q_t] along dim 1, by a
    log-depth inclusive scan of P_t = P_{t-s}[P_t] shifted by one tile.
    ``q`` uint8[B, n_tiles, 256]; returns the same shape."""
    p = q
    s = 1
    while s < p.shape[1]:
        nxt = p.clone()
        nxt[:, s:] = torch.gather(p[:, :-s], 2, p[:, s:].to(torch.int64))
        p = nxt
        s *= 2
    ident = torch.arange(256, device=q.device, dtype=torch.uint8).expand(q.shape[0], 1, 256)
    return torch.cat([ident, p], dim=1)[:, :-1]


def gather_symbols(c_pre: torch.Tensor, fronts: torch.Tensor, alphabet: torch.Tensor) -> torch.Tensor:
    """sym[t, k] = alphabet[C_t[front_{t,k}]]: int32[B, n_tiles * _TILE]."""
    b = c_pre.shape[0]
    listpos = torch.gather(c_pre, 2, fronts.to(torch.int64))
    return torch.gather(alphabet, 1, listpos.reshape(b, -1).to(torch.int64)).to(torch.int32)


def imtf_decode_padded(ranks: torch.Tensor, n: torch.Tensor, alphabet: torch.Tensor, n_max: int) -> torch.Tensor:
    """Invert MTF ranks to byte values.

    Args:
      ranks: int32[B, n_max] MTF ranks (entries past each row's ``n``
        ignored)
      n: int32[B] true lengths
      alphabet: int32[B, 256] each row's initial list (position -> byte
        value; entries past the alphabet size are never read by a valid
        stream)
      n_max: padded size, a multiple of 512
    Returns:
      int32[B, n_max] decoded byte values (valid prefix of length n)
    """
    q, fronts = tile_permutations(ranks, n, n_max)
    return gather_symbols(compose_exclusive(q), fronts, alphabet)


def imtf_decode(ranks_np: np.ndarray, in_use: np.ndarray) -> np.ndarray:
    """Host wrapper, on the CPU: MTF ranks + used-byte map -> byte values;
    the counterpart of ``imtf_decode_jax``."""
    seq_syms = np.flatnonzero(in_use).astype(np.int32)
    alphabet = np.zeros((1, 256), dtype=np.int32)
    alphabet[0, : seq_syms.size] = seq_syms
    n = ranks_np.size
    n_max = ((n + _TILE - 1) // _TILE) * _TILE
    padded = np.zeros((1, n_max), dtype=np.int32)
    padded[0, :n] = ranks_np
    out = imtf_decode_padded(
        torch.from_numpy(padded), torch.tensor([n], dtype=torch.int32), torch.from_numpy(alphabet), n_max
    )
    return out[0, :n].numpy().astype(np.uint8)
