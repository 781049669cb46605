"""Huffman coding stage: bzip2's multi-table scheme, bit-exact.

The format requires, per block:
  - 2..6 coding tables depending on symbol count
    (<200: 2, <600: 3, <1200: 4, <2400: 5, else 6);
  - symbols processed in groups of 50, each group coded with one table,
    recorded in a selector stream that is itself MTF-coded;
  - table code lengths found by 4 refinement iterations: cost each group
    under every table (initial tables: 0/15 "icost" split of the frequency
    mass), pick the cheapest (lowest index wins ties), re-derive each
    table's lengths from the frequencies of the groups it won;
  - length construction uses a weight-packed heap where a node's packed
    word is (weight << 8) | depth, combined parents add weights and take
    1 + max(depth), and the whole derivation reruns with halved weights
    (w -> 1 + w/2) until no code exceeds 17 bits;
  - canonical codes assigned in (length, symbol) order.

Every tie-break above is observable in the output bits, so this module
replicates the exact discipline (validated bit-for-bit against libbz2 in
tests/test_bitexact.py).  The group-costing inner product is expressed as a
(groups x alphabet) histogram times (alphabet x tables) length matrix —
which is how the TPU path runs it on the MXU (starch3_tpu/ops/huff_jax.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

GROUP_SIZE = 50
N_ITERS = 4
MAX_CODE_LEN = 17  # encoder limit (format allows up to 23 on decode)
LESSER_ICOST = 0
GREATER_ICOST = 15


def n_groups_for(n_mtf: int) -> int:
    if n_mtf < 200:
        return 2
    if n_mtf < 600:
        return 3
    if n_mtf < 1200:
        return 4
    if n_mtf < 2400:
        return 5
    return 6


def make_code_lengths(freq: np.ndarray, alpha_size: int, max_len: int = MAX_CODE_LEN) -> np.ndarray:
    """Code lengths via the weight-packed-heap construction.

    ``freq`` is int64[alpha_size].  Deterministic including all tie-breaks:
    node ids 1..alpha_size are the leaves (symbol i -> node i+1), internal
    nodes get increasing ids, and the binary heap orders by the full packed
    (weight<<8)|depth word with strict-less comparisons.

    Dispatches to the native runtime (runtime/runtime.cpp) when built;
    the Python implementation below is the behavioral reference and the
    fallback.
    """
    from starch3_tpu_torch.runtime import make_code_lengths_native

    native = make_code_lengths_native(freq, alpha_size, max_len)
    if native is not None:
        return native
    weight = np.zeros(alpha_size * 2 + 2, dtype=np.int64)
    parent = np.zeros(alpha_size * 2 + 2, dtype=np.int64)
    heap = np.zeros(alpha_size + 2, dtype=np.int64)
    lengths = np.zeros(alpha_size, dtype=np.int64)

    w = np.where(freq == 0, 1, freq) << 8
    while True:
        weight[1 : alpha_size + 1] = w
        n_nodes = alpha_size
        n_heap = 0
        heap[0] = 0
        weight[0] = 0
        parent[0] = -2
        # push leaves
        for i in range(1, alpha_size + 1):
            parent[i] = -1
            n_heap += 1
            heap[n_heap] = i
            # upheap
            z = n_heap
            tmp = heap[z]
            while weight[tmp] < weight[heap[z >> 1]]:
                heap[z] = heap[z >> 1]
                z >>= 1
            heap[z] = tmp
        # merge
        while n_heap > 1:
            n1 = heap[1]
            heap[1] = heap[n_heap]
            n_heap -= 1
            _downheap(heap, weight, n_heap)
            n2 = heap[1]
            heap[1] = heap[n_heap]
            n_heap -= 1
            _downheap(heap, weight, n_heap)
            n_nodes += 1
            parent[n1] = parent[n2] = n_nodes
            w1, w2 = int(weight[n1]), int(weight[n2])
            weight[n_nodes] = ((w1 & ~0xFF) + (w2 & ~0xFF)) | (
                1 + max(w1 & 0xFF, w2 & 0xFF)
            )
            parent[n_nodes] = -2
            n_heap += 1
            heap[n_heap] = n_nodes
            z = n_heap
            tmp = heap[z]
            while weight[tmp] < weight[heap[z >> 1]]:
                heap[z] = heap[z >> 1]
                z >>= 1
            heap[z] = tmp
        # read depths
        too_long = False
        for i in range(1, alpha_size + 1):
            j = 0
            k = i
            while parent[k] >= 0:
                k = parent[k]
                j += 1
            lengths[i - 1] = j
            if j > max_len:
                too_long = True
        if not too_long:
            return lengths.copy()
        # rescale weights and retry
        w = ((1 + (w >> 8) // 2) << 8).astype(np.int64)


def _downheap(heap: np.ndarray, weight: np.ndarray, n_heap: int) -> None:
    z = 1
    tmp = heap[z]
    while True:
        yy = z << 1
        if yy > n_heap:
            break
        if yy < n_heap and weight[heap[yy + 1]] < weight[heap[yy]]:
            yy += 1
        if weight[tmp] < weight[heap[yy]]:
            break
        heap[z] = heap[yy]
        z = yy
    heap[z] = tmp


def assign_codes(lengths: np.ndarray) -> np.ndarray:
    """Canonical codes in (length, symbol-index) order."""
    codes = np.zeros(lengths.size, dtype=np.int64)
    vec = 0
    for n in range(int(lengths.min()), int(lengths.max()) + 1):
        for i in range(lengths.size):
            if lengths[i] == n:
                codes[i] = vec
                vec += 1
        vec <<= 1
    return codes


@dataclass(frozen=True)
class HuffmanPlan:
    """Everything the bit-packer needs for one block's coded data."""

    n_groups: int
    lengths: np.ndarray  # int64[n_groups, alpha_size]
    codes: np.ndarray  # int64[n_groups, alpha_size]
    selectors: np.ndarray  # int64[n_selectors] (un-MTF'd table ids)
    selectors_mtf: np.ndarray  # int64[n_selectors] (MTF-coded for output)
    group_ids: np.ndarray  # int64[n_symbols] table id per symbol


def initial_lengths(freq: np.ndarray, alpha_size: int, n_mtf: int) -> np.ndarray:
    """Initial tables: bzip2's contiguous frequency-mass split (with its
    quirky odd-part adjustment), as 0/15 icost rows."""
    n_groups = n_groups_for(n_mtf)
    lengths = np.empty((n_groups, alpha_size), dtype=np.int64)
    rem_f = n_mtf
    gs = 0
    for n_part in range(n_groups, 0, -1):
        t_freq = rem_f // n_part
        ge = gs - 1
        a_freq = 0
        while a_freq < t_freq and ge < alpha_size - 1:
            ge += 1
            a_freq += int(freq[ge])
        if (
            ge > gs
            and n_part != n_groups
            and n_part != 1
            and (n_groups - n_part) % 2 == 1
        ):
            a_freq -= int(freq[ge])
            ge -= 1
        row = np.full(alpha_size, GREATER_ICOST, dtype=np.int64)
        row[gs : ge + 1] = LESSER_ICOST
        lengths[n_part - 1] = row
        gs = ge + 1
        rem_f -= a_freq
    return lengths


def build_plan(symbols: np.ndarray, freq: np.ndarray, alpha_size: int) -> HuffmanPlan:
    """Run the refinement iterations and produce the final coding plan."""
    n_mtf = int(symbols.size)
    n_groups = n_groups_for(n_mtf)
    n_sel = (n_mtf + GROUP_SIZE - 1) // GROUP_SIZE

    lengths = initial_lengths(freq, alpha_size, n_mtf)

    # --- per-group histograms (vectorized; reused across iterations) -----
    group_id_per_symbol = np.arange(n_mtf, dtype=np.int64) // GROUP_SIZE
    hist = np.bincount(
        group_id_per_symbol * alpha_size + symbols.astype(np.int64),
        minlength=n_sel * alpha_size,
    ).reshape(n_sel, alpha_size)

    selectors = np.empty(n_sel, dtype=np.int64)
    for _ in range(N_ITERS):
        # cost[g, t] = sum_s hist[g, s] * lengths[t, s]   (MXU-shaped)
        cost = hist @ lengths.T
        selectors = np.argmin(cost, axis=1)  # first minimum wins, as libbz2
        # accumulate each table's winning-group frequencies
        rfreq = np.zeros((n_groups, alpha_size), dtype=np.int64)
        np.add.at(rfreq, (selectors,), hist)
        for t in range(n_groups):
            lengths[t] = make_code_lengths(rfreq[t], alpha_size)

    # --- selector MTF ----------------------------------------------------
    pos = list(range(n_groups))
    sel_mtf = np.empty(n_sel, dtype=np.int64)
    for i, s in enumerate(selectors.tolist()):
        j = pos.index(s)
        sel_mtf[i] = j
        pos.pop(j)
        pos.insert(0, s)

    codes = np.empty_like(lengths)
    for t in range(n_groups):
        codes[t] = assign_codes(lengths[t])
    return HuffmanPlan(
        n_groups=n_groups,
        lengths=lengths,
        codes=codes,
        selectors=selectors,
        selectors_mtf=sel_mtf,
        group_ids=selectors[group_id_per_symbol],
    )
