"""NumPy implementation of the Starch delta transform and inverse.

Spec: see package docstring (reference include/starch3api.hpp:428-504).
This module also computes the per-chromosome statistics the reference
declares but never fills (base_count_unique / base_count_nonunique,
starch3api.hpp:61-62 — allocated and reset, never updated; SURVEY.md §3.5):
nonunique = sum of interval lengths, unique = length of the union.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from starch3_tpu_torch.bed.parser import ChromBlock
from starch3_tpu_torch.errors import FormatError


@dataclass
class TransformedChrom:
    chrom: str
    text: bytes  # the transformed per-chromosome stream (pre-compression)
    line_count: int
    base_count_nonunique: int
    base_count_unique: int


def _dec_len(vals: np.ndarray) -> np.ndarray:
    """Decimal text length of each int64 (sign included), vectorized."""
    neg = vals < 0
    mag = np.abs(vals)
    ndig = np.ones(vals.shape, dtype=np.int64)
    p = np.int64(10)
    # int64 magnitudes have at most 19 digits
    for _ in range(18):
        ndig += mag >= p
        if p > np.int64(10**17):
            break
        p *= 10
    return ndig + neg


def _emit_decimals(
    out: np.ndarray, offsets: np.ndarray, vals: np.ndarray, lens: np.ndarray
) -> None:
    """Write decimal text of vals at out[offsets], vectorized by digit column.

    Dispatches to the native runtime (runtime.cpp s3_emit_decimals) when
    built; the column formulation below is the fallback and mirrors the
    device emission kernel.
    """
    from starch3_tpu_torch.runtime import emit_decimals_native

    if vals.size and emit_decimals_native(out, offsets, vals, lens):
        return
    neg = vals < 0
    mag = np.abs(vals)
    out[offsets[neg]] = ord("-")
    digit_lens = lens - neg
    digit_off = offsets + neg
    max_len = int(digit_lens.max()) if lens.size else 0
    j = np.arange(max_len, dtype=np.int64)
    # digit k (from most significant) = mag // 10^(L-1-k) % 10
    exp = digit_lens[:, None] - 1 - j[None, :]
    valid = exp >= 0
    pow10 = np.where(valid, 10 ** np.maximum(exp, 0), 1)
    digits = (mag[:, None] // pow10) % 10
    tgt = digit_off[:, None] + j[None, :]
    out[tgt[valid]] = (digits[valid] + ord("0")).astype(np.uint8)


def _scatter_blob(
    out: np.ndarray, offsets: np.ndarray, blob: np.ndarray, src_offsets: np.ndarray
) -> None:
    """Copy blob[src_offsets[i]:src_offsets[i+1]] to out[offsets[i]...]."""
    lens = np.diff(src_offsets)
    total = int(lens.sum())
    if total == 0:
        return
    flat_out = np.repeat(offsets - np.cumsum(np.concatenate(([0], lens[:-1]))), lens) + np.arange(
        total, dtype=np.int64
    )
    out[flat_out] = blob


def transform_chrom(block: ChromBlock) -> TransformedChrom:
    """Columnar encode of one chromosome's records to transformed text."""
    starts, stops = block.starts, block.stops
    n = starts.size
    coord_diff = stops - starts
    prev_diff = np.empty(n, dtype=np.int64)
    prev_diff[0] = 0  # last_coord_diff initialized to 0 (starch3api.hpp:510)
    prev_diff[1:] = coord_diff[:-1]
    p_mask = coord_diff != prev_diff

    last_stop = np.empty(n, dtype=np.int64)
    last_stop[0] = 0  # last_stop initialized to 0 (starch3api.hpp:509)
    last_stop[1:] = stops[:-1]
    # value-test semantics of the reference (starch3api.hpp:456): absolute
    # start is emitted whenever last_stop == 0, positionally the first record
    # for any valid BED
    absolute = last_stop == 0
    deltas = np.where(absolute, starts, starts - last_stop)

    rem_lens = np.diff(block.rem_offsets)
    p_lens = np.where(p_mask, 2 + _dec_len(coord_diff), 0)  # 'p' + digits + '\n'
    d_lens = _dec_len(deltas) + np.where(rem_lens > 0, 1 + rem_lens, 0) + 1
    rec_lens = p_lens + d_lens
    rec_offsets = np.concatenate(([0], np.cumsum(rec_lens)))
    total = int(rec_offsets[-1])
    out = np.empty(total, dtype=np.uint8)

    # p-lines
    p_idx = np.flatnonzero(p_mask)
    if p_idx.size:
        p_off = rec_offsets[p_idx]
        out[p_off] = ord("p")
        pv = coord_diff[p_idx]
        pl = _dec_len(pv)
        _emit_decimals(out, p_off + 1, pv, pl)
        out[p_off + 1 + pl] = ord("\n")
    # delta lines
    d_off = rec_offsets[:-1] + p_lens
    dl = _dec_len(deltas)
    _emit_decimals(out, d_off, deltas, dl)
    with_rem = rem_lens > 0
    tab_pos = d_off + dl
    out[tab_pos[with_rem]] = ord("\t")
    if with_rem.any():
        rem_tgt = (tab_pos + 1)[with_rem]
        ro = block.rem_offsets
        keep_off = np.concatenate(
            (ro[:-1][with_rem][:, None], ro[1:][with_rem][:, None]), axis=1
        )
        # compact blob slices for kept records
        blob = np.frombuffer(block.rem_blob, dtype=np.uint8)
        lens = keep_off[:, 1] - keep_off[:, 0]
        src_offsets = np.concatenate(([0], np.cumsum(lens)))
        compact = blob[
            np.repeat(keep_off[:, 0] - src_offsets[:-1], lens)
            + np.arange(int(lens.sum()), dtype=np.int64)
        ]
        _scatter_blob(out, rem_tgt, compact, src_offsets)
    out[rec_offsets[1:] - 1] = ord("\n")

    nonuniq = int(coord_diff.sum())
    uniq = _union_length(starts, stops)
    return TransformedChrom(
        chrom=block.chrom,
        text=out.tobytes(),
        line_count=n,
        base_count_nonunique=nonuniq,
        base_count_unique=uniq,
    )


def _union_length(starts: np.ndarray, stops: np.ndarray) -> int:
    """Total covered bases (union of half-open intervals), vectorized.

    For sorted starts: clip each interval's start to the running max of
    previous stops, sum positive residuals.
    """
    if starts.size == 0:
        return 0
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], stops[order]
    running = np.concatenate(([s[0]], np.maximum.accumulate(e)[:-1]))
    return int(np.maximum(e - np.maximum(s, running), 0).sum())


def untransform_chrom(chrom: str, text: bytes) -> ChromBlock:
    """Inverse transform: per-chromosome transformed text -> records.

    Parsing is vectorized like the BED tokenizer; the coordinate
    reconstruction is the prefix-scan formulation:
        stop_i = scan(+)(delta_i + diff_i)  over non-p lines,
    with diff_i the forward-filled p-values.
    """
    if not text:
        return ChromBlock(
            chrom=chrom,
            starts=np.empty(0, dtype=np.int64),
            stops=np.empty(0, dtype=np.int64),
            rem_blob=b"",
            rem_offsets=np.zeros(1, dtype=np.int64),
        )
    arr = np.frombuffer(text, dtype=np.uint8)
    if arr[-1] != ord("\n"):
        raise FormatError("transformed stream must end with newline")
    nl = np.flatnonzero(arr == ord("\n"))
    line_starts = np.concatenate(([0], nl[:-1] + 1))
    line_ends = nl
    is_p = arr[line_starts] == ord("p")

    # p-values, forward-filled onto data lines
    from starch3_tpu_torch.bed.parser import _parse_int_fields

    n_lines = line_starts.size
    diff_vals = np.zeros(n_lines, dtype=np.int64)
    p_idx = np.flatnonzero(is_p)
    if p_idx.size:
        diff_vals[p_idx] = _parse_int_fields(
            arr, line_starts[p_idx] + 1, line_ends[p_idx], "p-line"
        )
    # forward fill: index of most recent p-line at or before each line
    p_seen = np.maximum.accumulate(np.where(is_p, np.arange(n_lines), -1))
    if (p_seen < 0).any() and (~is_p[np.flatnonzero(p_seen < 0)]).any():
        # data lines before any p-line: diff stays 0 (matches reference
        # init last_coord_diff=0 — only possible for zero-length intervals)
        pass
    diff_filled = np.where(p_seen >= 0, diff_vals[np.maximum(p_seen, 0)], 0)

    data_idx = np.flatnonzero(~is_p)
    ds, de = line_starts[data_idx], line_ends[data_idx]
    # delta field ends at first tab or line end
    tabs = np.flatnonzero(arr == ord("\t"))
    tab_line_all = np.searchsorted(line_ends, tabs, side="right")
    first_tab = np.full(n_lines, -1, dtype=np.int64)
    # keep the first tab of each line
    rev = tab_line_all[::-1]
    first_tab[rev] = tabs[::-1]
    ft = first_tab[data_idx]
    has_rem = ft >= 0
    delta_end = np.where(has_rem, ft, de)
    deltas = _parse_int_fields(arr, ds, delta_end, "delta")
    diffs = diff_filled[data_idx]

    # reconstruct: stop_i = stop_{i-1} + delta_i + diff_i (stop_{-1}=0),
    # except the reference emits absolute start when last_stop == 0 — the
    # cumsum formulation already handles that (stop_{-1} = 0)
    stops = np.cumsum(deltas + diffs)
    starts = stops - diffs
    rem_starts = np.where(has_rem, ft + 1, de)
    rem_lens = de - rem_starts
    rem_offsets = np.concatenate(([0], np.cumsum(rem_lens)))
    total = int(rem_offsets[-1])
    blob = (
        arr[
            np.repeat(rem_starts - rem_offsets[:-1], rem_lens)
            + np.arange(total, dtype=np.int64)
        ].tobytes()
        if total
        else b""
    )
    return ChromBlock(
        chrom=chrom,
        starts=starts.astype(np.int64),
        stops=stops.astype(np.int64),
        rem_blob=blob,
        rem_offsets=rem_offsets.astype(np.int64),
    )
