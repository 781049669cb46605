"""Symbol mapping, move-to-front, and zero-run (RLE2) coding.

bzip2 maps the block's used byte values onto a dense alphabet, MTF-encodes
the BWT output, replaces zero-runs with bijective-base-2 RUNA/RUNB digits,
and appends an end-of-block symbol:

    alphabet:  RUNA=0, RUNB=1, symbol j (MTF rank j>=1) -> j+1,
               EOB = nInUse+1; alphaSize = nInUse+2
    zero run z: digits of (z+1) in binary, MSB dropped, emitted LSB-first,
                0-digit -> RUNA, 1-digit -> RUNB

MTF is reformulated for vectorization (same formulation the TPU kernel in
starch3_tpu/ops/mtf_jax.py uses): the MTF rank of symbol s at position i
equals the number of symbols whose most recent occurrence is later than
s's, with never-seen symbols ordered by initial alphabet position:

    L0(t) = -1 - t                  (initial list order)
    L(t, i) = last j < i with x[j] == t, else L0(t)
    rank(i) = #{ t : L(t, i) > L(x[i], i) }

The last-occurrence table is computed chunk-by-chunk: a cumulative max over
a (chunk, alphabet) position matrix inside each chunk, with a (alphabet,)
carry across chunks — a scan-of-cummax, which maps directly onto the VPU.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

RUNA = 0
RUNB = 1

_CHUNK = 4096
_NEG = np.int64(-(1 << 40))


@dataclass(frozen=True)
class MtfResult:
    symbols: np.ndarray  # int32 MTF/RLE2 symbol stream, EOB included
    freq: np.ndarray  # int64 histogram over alphaSize symbols
    in_use: np.ndarray  # bool[256] byte-used map
    alpha_size: int  # nInUse + 2


def symbol_map(block: np.ndarray) -> tuple[np.ndarray, np.ndarray, int]:
    """Dense alphabet mapping: (in_use[256], unseq_to_seq[256], n_in_use)."""
    in_use = np.zeros(256, dtype=bool)
    in_use[block] = True
    n_in_use = int(in_use.sum())
    unseq_to_seq = np.cumsum(in_use) - 1  # valid only where in_use
    return in_use, unseq_to_seq.astype(np.int64), n_in_use


def mtf_ranks(seq: np.ndarray, n_sym: int) -> np.ndarray:
    """Vectorized MTF ranks of ``seq`` (values in [0, n_sym))."""
    n = seq.size
    ranks = np.empty(n, dtype=np.int32)
    carry = -1 - np.arange(n_sym, dtype=np.int64)  # L0
    sym_ids = np.arange(n_sym, dtype=np.int64)
    for start in range(0, n, _CHUNK):
        chunk = seq[start : start + _CHUNK]
        m = chunk.size
        pos = np.arange(start, start + m, dtype=np.int64)
        occ = np.where(chunk[:, None] == sym_ids[None, :], pos[:, None], _NEG)
        # exclusive cumulative max -> last occurrence strictly before i
        cm = np.maximum.accumulate(occ, axis=0)
        excl = np.empty_like(cm)
        excl[0] = _NEG
        excl[1:] = cm[:-1]
        last = np.maximum(excl, carry[None, :])
        own = last[np.arange(m), chunk]
        ranks[start : start + m] = (last > own[:, None]).sum(axis=1)
        carry = np.maximum(carry, cm[-1])
    return ranks


def encode_zero_run(z: int) -> list[int]:
    """RUNA/RUNB digits for a zero-run of length z (bijective base 2)."""
    digits = []
    m = z + 1
    while m > 1:
        digits.append(m & 1)  # 0 -> RUNA, 1 -> RUNB
        m >>= 1
    return digits


def mtf_rle2(block: np.ndarray, ranks: np.ndarray | None = None) -> MtfResult:
    """Full MTF + RLE2 stage for one post-BWT block.

    ``ranks`` may be precomputed (e.g. by the device kernel
    ops/mtf_jax.py); otherwise the NumPy formulation runs.
    """
    in_use, unseq_to_seq, n_in_use = symbol_map(block)
    if ranks is None:
        from starch3_tpu_torch.runtime import mtf_ranks_native

        seq = unseq_to_seq[block]
        ranks = mtf_ranks_native(seq, n_in_use)
        if ranks is None:
            ranks = mtf_ranks(seq, n_in_use)
    return mtf_rle2_from_ranks(ranks, in_use)


def mtf_rle2_from_ranks(ranks: np.ndarray, in_use: np.ndarray) -> MtfResult:
    """RLE2 assembly from precomputed MTF ranks + used-byte map — the
    host residue when the device pipeline computed the ranks (the BWT
    last column itself never has to leave the device)."""
    n_in_use = int(in_use.sum())
    from starch3_tpu_torch.runtime import rle2_from_ranks_native

    native = rle2_from_ranks_native(ranks, n_in_use)
    if native is not None:
        symbols, freq = native
        return MtfResult(
            symbols=symbols, freq=freq, in_use=in_use, alpha_size=n_in_use + 2
        )
    eob = n_in_use + 1
    alpha_size = n_in_use + 2

    nz_pos = np.flatnonzero(ranks != 0)
    nz_vals = ranks[nz_pos].astype(np.int64) + 1  # rank j -> symbol j+1
    # zero-run lengths: before each nonzero, and one tail run before EOB
    prev = np.concatenate(([-1], nz_pos))
    run_before = nz_pos - prev[:-1] - 1  # zeros before each nonzero
    tail_run = ranks.size - (int(nz_pos[-1]) + 1 if nz_pos.size else 0)

    # digit counts: d(z) = bit_length(z+1) - 1
    def dcount(z: np.ndarray) -> np.ndarray:
        return np.where(z > 0, np.int64(np.log2(z + 1)), 0)

    # log2 is float-unsafe for large z; compute bit lengths exactly
    def bit_len(z: np.ndarray) -> np.ndarray:
        z = z.astype(np.int64)
        out = np.zeros_like(z)
        v = z + 1
        while (v > 1).any():
            mask = v > 1
            out[mask] += 1
            v = np.where(mask, v >> 1, v)
        return out

    runs = np.concatenate((run_before, [tail_run])).astype(np.int64)
    digit_counts = bit_len(runs)
    # output layout: [digits(run_0), sym_0, digits(run_1), sym_1, ...,
    #                 digits(tail), EOB]
    n_nz = nz_vals.size
    chunk_lens = np.empty(n_nz + 1, dtype=np.int64)
    chunk_lens[:n_nz] = digit_counts[:n_nz] + 1
    chunk_lens[n_nz] = digit_counts[n_nz] + 1  # + EOB
    offsets = np.concatenate(([0], np.cumsum(chunk_lens)))
    total = int(offsets[-1])
    out = np.empty(total, dtype=np.int32)
    # place digits column-by-column over the shrinking set of runs that
    # still have digits (geometric decay: most zero-runs are 1-2 long, so
    # this is ~2n ops instead of an n x max_digits dense expansion)
    m = runs + 1
    starts_ = offsets[:-1]
    active = np.flatnonzero(m >= 2)  # has digit 0
    k = 0
    while active.size:
        out[starts_[active] + k] = (m[active] >> k) & 1
        k += 1
        active = active[(m[active] >> k) >= 2]
    # place nonzero symbols and EOB
    if n_nz:
        out[offsets[:n_nz] + digit_counts[:n_nz]] = nz_vals
    out[offsets[n_nz] + digit_counts[n_nz]] = eob
    freq = np.bincount(out, minlength=alpha_size).astype(np.int64)
    return MtfResult(symbols=out, freq=freq, in_use=in_use, alpha_size=alpha_size)


def mtf_rle2_decode(
    symbols: np.ndarray, in_use: np.ndarray
) -> np.ndarray:
    """Invert MTF+RLE2: symbol stream (without EOB) -> byte block."""
    seq_syms = np.flatnonzero(in_use).astype(np.uint8)
    mtf_list = list(seq_syms)
    out = bytearray()
    run = 0
    run_weight = 1
    for s in symbols.tolist():
        if s <= RUNB:
            run += run_weight << s  # RUNA adds w, RUNB adds 2w
            run_weight <<= 1
            continue
        if run:
            out += bytes([mtf_list[0]]) * run
            run = 0
        run_weight = 1
        j = s - 1
        sym = mtf_list.pop(j)
        mtf_list.insert(0, sym)
        out.append(sym)
    if run:
        out += bytes([mtf_list[0]]) * run
    return np.frombuffer(bytes(out), dtype=np.uint8)
