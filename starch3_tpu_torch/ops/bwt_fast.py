"""One-sort BWT, batched, in PyTorch ops: every alphabet tier.

Counterpart of ``starch3_tpu/ops/bwt_fast.py``: ``bwt_sort_fast3`` (the
bits==4 production sort), ``bwt_sort_fast_mid`` (bits 5/6) and
``bwt_sort_fast`` (bits 4/8, the sort of the bits==8 tier).  Every cyclic
rotation of a block is sorted once by its first symbols, packed into
32-bit keys.  A block is exact when no two adjacent sorted rotations share
the packed prefix (``ties == 0``); a tied block is re-encoded exactly on
the host by the caller.

What differs from the JAX version, and why:

- Keys are built in ``int64``: torch has little ``uint32`` support, and
  every 32-bit key value fits an ``int64`` with its unsigned order intact.
- The rotation by ``k`` is a per-row gather on ``(i + k_row) % n_row``:
  rows of one batch have different lengths, so ``k`` (which depends on
  ``n`` when ``n`` is below the context length) is per row and
  ``torch.roll`` does not fit.
- torch has no lexicographic multi-key sort.  Stable LSD passes give the
  same order, one pass per pair of keys: ``((k_a - 2**31) << 32) | k_b``
  is an ``int64`` whose signed order is the unsigned order of
  ``(k_a, k_b)``, and an odd last key sorts alone.  Padded positions hold
  all-ones keys and so still sort to the tail.

Where the JAX sort takes every operand as a key (``bwt_sort_fast3``,
``bwt_sort_fast_mid``: the payload rides in the last key's low bits), the
sorted arrays, and with them ``last``, ``orig_ptr`` and ``ties``, equal
the JAX output on every row.  ``bwt_sort_fast`` carries the payload
beside the keys, and the JAX sort there is unstable: on a row with
``ties > 0`` the order of tied rotations, so ``last``, may differ;
``orig_ptr`` and ``ties`` equal on every row.

``bwt_fast_host`` is the JAX module's host wrapper (numpy in, numpy out)
over ``bwt_sort_fast``, on an explicit device.
"""

from __future__ import annotations

import numpy as np
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


def key_params(bits: int) -> tuple[int, int]:
    """(n_keys, symbols_per_key) for ``bwt_sort_fast`` at ``bits``."""
    if bits == 4:
        return 3, 8  # 24 symbols of context
    if bits == 8:
        return 4, 4  # 16 symbols of context
    raise ValueError("bits must be 4 or 8")


class _Rows:
    """A batch of dense-symbol rows and their cyclic shifts.

    ``seq`` is ``seqs`` in ``int64`` with the pad zeroed, ``valid`` marks
    each row's prefix, ``prev`` is the previous symbol (the BWT payload)
    and ``shift(arr, k)`` rotates each row by ``k`` (mod its length when
    ``k`` reaches it)."""

    def __init__(self, seqs: torch.Tensor, lens: torch.Tensor):
        self.n_max = seqs.shape[1]
        dev = seqs.device
        self.n = lens.to(device=dev, dtype=torch.int64)
        self.idx = torch.arange(self.n_max, device=dev, dtype=torch.int64)
        self.valid = self.idx[None, :] < self.n[:, None]
        self.seq = torch.where(self.valid, seqs.to(torch.int64), 0)
        self._n1 = self.n.clamp(min=1)
        self.prev = _cyclic_shift(self.seq, (self.n - 1).clamp(min=0), self.n, self.idx)

    def shift(self, arr: torch.Tensor, k_static: int) -> torch.Tensor:
        n = self.n
        k = torch.where(k_static >= n, k_static % self._n1, torch.full_like(n, k_static))
        return _cyclic_shift(arr, k, n, self.idx)

    def key(self, arr: torch.Tensor) -> torch.Tensor:
        """``arr`` on each row's prefix, all-ones on the pad."""
        return torch.where(self.valid, arr, _BIGU)


def _sort_rotations(rows: _Rows, keys, payload_bits: int = 0, payload=None):
    """Sort each row's rotations by ``keys`` (32-bit values in ``int64``,
    most significant first) in stable LSD passes.

    With ``payload_bits`` the last key's low bits hold the payload, which
    is then no context: ``last`` is those bits of the sorted last key.
    Otherwise ``last`` is ``payload`` carried into the sorted order.
    Returns (last int32, orig_ptr int32, ties int32)."""
    groups = [((keys[i] - (1 << 31)) << 32) | keys[i + 1] for i in range(0, len(keys) - 1, 2)]
    if len(keys) % 2:
        groups.append(keys[-1])

    perm = first = None
    for g in reversed(groups):  # least significant pass first
        if perm is not None:
            g = torch.gather(g, 1, perm)
        first, p = torch.sort(g, dim=1, stable=True)
        perm = p if perm is None else torch.gather(perm, 1, p)
    sorted_groups = [first] + [torch.gather(g, 1, perm) for g in groups[1:]]

    if payload is None:
        last = sorted_groups[-1] & ((1 << payload_bits) - 1)
    else:
        last = torch.gather(payload, 1, perm)

    # adjacent prefix collisions among the valid prefix (payload masked)
    ctx_sorted = sorted_groups[:-1] + [sorted_groups[-1] >> payload_bits]
    ar = torch.arange(rows.n_max - 1, device=rows.idx.device, dtype=torch.int64)
    eq = ar[None, :] < (rows.n - 1)[:, None]
    for g in ctx_sorted:
        eq = eq & (g[:, 1:] == g[:, :-1])
    ties = eq.sum(dim=1).to(torch.int32)

    # orig_ptr: rotations strictly below rotation 0 in the prefix order
    lt = torch.zeros_like(rows.valid)
    ge = torch.ones_like(rows.valid)  # "equal so far"
    for g in groups[:-1] + [groups[-1] >> payload_bits]:
        g0 = g[:, :1]
        lt = lt | (ge & (g < g0))
        ge = ge & (g == g0)
    orig_ptr = (lt & rows.valid).sum(dim=1).to(torch.int32)
    return last.to(torch.int32), orig_ptr, ties


def bwt_sort_fast3(seqs: torch.Tensor, lens: torch.Tensor):
    """bits==4 one-sort BWT over a batch: three keys holding 23 symbols
    of context (8 + 8 + 7), the previous symbol in key3's low nibble.

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
    rows = _Rows(seqs, lens)
    # shift-or doubling ladder: 8 symbols per 32-bit key in 3 steps
    acc = rows.seq
    w = 4
    while w * 2 <= 32:
        acc = ((acc << w) & _MASK32) | rows.shift(acc, w // 4)
        w *= 2
    keys = [
        rows.key(acc),
        rows.key(rows.shift(acc, 8)),
        rows.key((rows.shift(acc, 16) & 0xFFFFFFF0) | rows.prev),
    ]
    return _sort_rotations(rows, keys, payload_bits=4)


def bwt_sort_fast(seqs: torch.Tensor, lens: torch.Tensor, bits: int):
    """One-sort BWT at ``bits`` 4 or 8 (``key_params``): 3 keys of 8
    symbols, or 4 keys of 4 symbols (the bits==8 tier, any byte
    alphabet), with the previous symbol carried beside the keys.

    Args and returns as ``bwt_sort_fast3`` (symbols < 2**bits); the
    context is 24 symbols at bits 4 and 16 at bits 8."""
    n_keys, spk = key_params(bits)
    rows = _Rows(seqs, lens)
    # shift-or doubling ladder: spk symbols per 32-bit key
    acc = rows.seq
    w = bits
    while w * 2 <= spk * bits:
        acc = ((acc << w) & _MASK32) | rows.shift(acc, w // bits)
        w *= 2
    keys = [rows.key(acc)] + [rows.key(rows.shift(acc, j * spk)) for j in range(1, n_keys)]
    return _sort_rotations(rows, keys, payload=rows.prev)


def bwt_sort_fast_mid(seqs: torch.Tensor, lens: torch.Tensor, bits: int):
    """One-sort BWT for mid-width dense alphabets (17..64 symbols).

    bits==5: 6 symbols per 30-bit key, 4 keys, 23 symbols of context
    (6 + 6 + 6 + 5) and the 5-bit payload in the last key's low bits.
    bits==6: 5 symbols per key, 5 keys, 24 symbols of context
    (5 + 5 + 5 + 5 + 4) and a 6-bit payload.

    Args and returns as ``bwt_sort_fast3`` (symbols < 2**bits)."""
    if bits == 5:
        spk, n_ctx_keys = 6, 3
    elif bits == 6:
        spk, n_ctx_keys = 5, 4
    else:
        raise ValueError("bits must be 5 or 6")
    rows = _Rows(seqs, lens)

    # doubling accumulators: acc[c][i] packs c consecutive symbols MSB-first
    a1 = rows.seq
    a2 = (a1 << bits) | rows.shift(a1, 1)
    a4 = (a2 << (2 * bits)) | rows.shift(a2, 2)
    acc = {1: a1, 2: a2, 4: a4}

    def word(p: int, k: int) -> torch.Tensor:
        """Pack symbols seq[(i+p) .. (i+p+k)) (cyclic) MSB-first."""
        out = None
        for c in (4, 2, 1):
            while k >= c:
                part = acc[c] if p == 0 else rows.shift(acc[c], p)
                out = part if out is None else (out << (c * bits)) | part
                p += c
                k -= c
        return out

    # valid keys stay < 2**30, so padded rows sort to the tail
    keys = [rows.key(word(j * spk, spk)) for j in range(n_ctx_keys)]
    keys.append(rows.key((word(n_ctx_keys * spk, spk - 1) << bits) | rows.prev))
    return _sort_rotations(rows, keys, payload_bits=bits)


def bwt_fast_host(block_np: np.ndarray, device="cuda"):
    """Host wrapper over raw bytes, as the JAX package's: dense-remaps
    the bytes, sorts at bits 4 (at most 16 symbols) or 8 with
    ``bwt_sort_fast`` on ``device`` (one row padded to a power of two, at
    least 128), and returns (last bytes uint8[n], orig_ptr, ties)."""
    n = int(block_np.size)
    used = np.zeros(256, dtype=bool)
    used[np.unique(block_np)] = True
    seq = (np.cumsum(used) - 1)[block_np].astype(np.int32)
    bits = 4 if int(used.sum()) <= 16 else 8
    n_max = max(128, 1 << (n - 1).bit_length())
    padded = np.zeros((1, n_max), dtype=np.int32)
    padded[0, :n] = seq
    dev = torch.device(device)
    last, ptr, ties = bwt_sort_fast(torch.from_numpy(padded).to(dev), torch.tensor([n], device=dev), bits)
    s2u = np.flatnonzero(used).astype(np.uint8)
    return s2u[last[0, :n].cpu().numpy()], int(ptr[0]), int(ties[0])
