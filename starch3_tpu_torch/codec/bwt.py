"""Burrows-Wheeler transform: cyclic rotation sort (NumPy oracle).

bzip2's block sort orders all N cyclic rotations of the block
lexicographically; the output is the last column plus ``origPtr`` — the
sorted position of the untouched rotation (rotation 0).  Any correct
rotation sort yields the same bytes; bzip2 1.0.x never randomizes blocks
(its sorting fallback is still a true sort), so bit-exactness only requires
a correct order with rotation-equal ties handled consistently (ties can
only arise for periodic blocks, where every consistent order yields the
same last column; ``origPtr`` follows libbz2's convention of the *first*
sorted index pointing at rotation 0).

Oracle algorithm: prefix doubling over cyclic shifts with dense reranking —
the same formulation the TPU path uses (starch3_tpu/ops/bwt_jax.py), where
each doubling round is an XLA sort over (rank, rank-at-offset-k) keys.
"""

from __future__ import annotations

import numpy as np


def bwt_best(block: np.ndarray) -> tuple[np.ndarray, int]:
    """Production host-path BWT: native SA-IS (runtime/runtime.cpp) when
    built, NumPy prefix doubling otherwise.  Both produce identical
    output including the equal-rotation tie order (tests/test_runtime.py).
    """
    from starch3_tpu_torch.runtime import bwt_native

    native = bwt_native(block)
    if native is not None:
        return native
    return bwt_encode(block)


def bwt_encode(block: np.ndarray) -> tuple[np.ndarray, int]:
    """Sort all cyclic rotations of ``block`` (uint8).

    Returns (last_column uint8 array, orig_ptr).
    """
    n = int(block.size)
    if n == 0:
        raise ValueError("empty block")
    if n == 1:
        return block.copy(), 0
    idx = np.arange(n, dtype=np.int64)
    # initial ranks: dense rank of first byte
    rank = block.astype(np.int64)
    k = 1
    while True:
        rank2 = rank[(idx + k) % n]
        # lexsort: primary rank, secondary rank2; stable => index tie-break
        order = np.lexsort((rank2, rank))
        key_r = rank[order]
        key_r2 = rank2[order]
        changed = np.empty(n, dtype=bool)
        changed[0] = False
        changed[1:] = (key_r[1:] != key_r[:-1]) | (key_r2[1:] != key_r2[:-1])
        new_rank = np.empty(n, dtype=np.int64)
        new_rank[order] = np.cumsum(changed)
        rank = new_rank
        if rank[order[-1]] == n - 1 or k >= n:
            # all distinct, or period reached (remaining ties are equal
            # rotations -> resolved by stable index order)
            break
        k <<= 1
    # Equal rotations (periodic blocks): libbz2's sorter leaves them in
    # *decreasing* start-index order (empirically verified against stdlib
    # bz2 on periodic inputs, e.g. b"abcdef"*100: rotation 0 sorts last
    # among its ties, origPtr = n_ties-1).  Match that so origPtr is
    # bit-identical; the last column itself is tie-invariant.
    sa = np.lexsort((-idx, rank))
    last = block[(sa - 1) % n]
    orig_ptr = int(np.flatnonzero(sa == 0)[0])
    return last, orig_ptr


def bwt_decode(last: np.ndarray, orig_ptr: int) -> np.ndarray:
    """Invert the BWT (vectorized counting construction).

    Builds the standard successor vector: stable-sort the last column and
    walk from ``orig_ptr``.
    """
    n = int(last.size)
    counts = np.bincount(last, minlength=256)
    first_col_starts = np.concatenate(([0], np.cumsum(counts)[:-1]))
    # occ[i]: index of last[i] among equal bytes before i
    occ = _occurrence_index(last)
    # LF mapping: row i of the sorted-rotation matrix ends with last[i];
    # LF(i) is the row of the rotation shifted one char earlier.  Walking
    # LF from orig_ptr yields the original bytes back-to-front.
    lf = first_col_starts[last] + occ
    out = np.empty(n, dtype=np.uint8)
    lf_list = lf.tolist()
    last_list = last.tolist()
    row = orig_ptr
    for i in range(n - 1, -1, -1):
        out[i] = last_list[row]
        row = lf_list[row]
    return out


def _occurrence_index(vals: np.ndarray) -> np.ndarray:
    """occ[i] = number of j < i with vals[j] == vals[i] (vectorized)."""
    n = vals.size
    order = np.argsort(vals, kind="stable")
    sorted_vals = vals[order]
    starts = np.empty(n, dtype=np.int64)
    starts[0] = 0
    new_group = sorted_vals[1:] != sorted_vals[:-1]
    group_id = np.concatenate(([0], np.cumsum(new_group)))
    # index within group = position - first position of group
    first_pos = np.empty(n, dtype=np.int64)
    group_starts = np.concatenate(([0], np.flatnonzero(new_group) + 1))
    first_pos = group_starts[group_id]
    within = np.arange(n) - first_pos
    occ = np.empty(n, dtype=np.int64)
    occ[order] = within
    return occ
