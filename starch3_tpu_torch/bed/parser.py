"""Vectorized BED tokenizer: text -> columnar arrays.

Replaces the reference's char-at-a-time 4-state token machine
(reference include/starch3api.hpp:220-297: chr -> start -> stop ->
remainder on tab delimiters, newline-terminated) and its per-field sscanf
(starch3api.hpp:306-307) with NumPy whole-buffer operations: one pass to
find delimiters, gather-based field extraction, and positional-notation
integer parsing — no Python-level per-line loop.

Output is the columnar form the TPU transform consumes: per-chromosome
groups of (start:int64, stop:int64) plus a remainder byte-blob with
per-record offsets (variable-length text stays host-side; devices only
see fixed-width integer arrays, SURVEY.md §7 step 1).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from starch3_tpu_torch.errors import BedParseError

_TAB = 9
_NL = 10


@dataclass
class ChromBlock:
    """All records of one chromosome (contiguous in sorted BED)."""

    chrom: str
    starts: np.ndarray  # int64[n]
    stops: np.ndarray  # int64[n]
    # remainder text (fields 4+) per record: rem_blob[rem_offsets[i]:rem_offsets[i+1]]
    rem_blob: bytes
    rem_offsets: np.ndarray  # int64[n+1]

    @property
    def n_records(self) -> int:
        return int(self.starts.size)

    def remainder(self, i: int) -> bytes:
        return self.rem_blob[self.rem_offsets[i] : self.rem_offsets[i + 1]]


def _gather_slices(arr: np.ndarray, starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Concatenate arr[starts[i]:starts[i]+lens[i]] for all i (vectorized)."""
    total = int(lens.sum())
    if total == 0:
        return np.empty(0, dtype=arr.dtype)
    offsets = np.concatenate(([0], np.cumsum(lens)))
    idx = np.repeat(starts - offsets[:-1], lens) + np.arange(total, dtype=np.int64)
    return arr[idx]


def _parse_int_fields(arr: np.ndarray, starts: np.ndarray, ends: np.ndarray, what: str) -> np.ndarray:
    """Parse decimal integer fields at arr[starts:ends), vectorized.

    Fixed-width positional parse: gather up to max_len digit columns,
    validate, and combine with powers of ten — the same fixed-shape
    formulation the device tokenizer kernel uses.  Dispatches to the
    native runtime (runtime.cpp s3_parse_ints) when built.
    """
    from starch3_tpu_torch.runtime import parse_ints_native

    try:
        native = parse_ints_native(arr, starts, ends)
    except ValueError as e:
        raise BedParseError(f"{what}: {e}") from e
    if native is not None:
        return native
    lens = ends - starts
    if (lens <= 0).any():
        raise BedParseError(f"empty {what} field")
    neg = arr[starts] == ord("-")
    digit_starts = starts + neg
    digit_lens = lens - neg
    max_len = int(digit_lens.max())
    if max_len > 19:
        raise BedParseError(f"{what} field exceeds int64 range")
    j = np.arange(max_len, dtype=np.int64)
    idx = np.minimum(digit_starts[:, None] + j[None, :], arr.size - 1)
    chars = arr[idx].astype(np.int64)
    valid = j[None, :] < digit_lens[:, None]
    digits = chars - ord("0")
    if ((digits < 0) | (digits > 9))[valid].any():
        raise BedParseError(f"non-numeric {what} field")
    digits = np.where(valid, digits, 0)
    # positional weights: digit k of an L-digit number scales by 10^(L-1-k)
    pow10 = 10 ** np.maximum(digit_lens[:, None] - 1 - j[None, :], 0)
    vals = (digits * pow10 * valid).sum(axis=1)
    return np.where(neg, -vals, vals)


def parse_bed(data: bytes) -> list[ChromBlock]:
    """Parse BED text into per-chromosome columnar blocks.

    Accepts 3+ column BED (chrom, start, stop, remainder...), newline
    terminated (final newline optional, matching getc-until-EOF behavior
    of the reference producer, starch3api.hpp:163-199).  Chromosomes must
    be contiguous (sorted BED), as the reference's single-pass chromosome
    switching requires (starch3api.hpp:331-334).
    """
    if not data:
        return []
    arr = np.frombuffer(data, dtype=np.uint8)
    nl = np.flatnonzero(arr == _NL)
    if nl.size and nl[-1] == arr.size - 1:
        line_ends = nl
    else:
        line_ends = np.concatenate((nl, [arr.size]))
    line_starts = np.concatenate(([0], nl[: line_ends.size - 1] + 1))
    # drop empty lines
    keep = line_ends > line_starts
    line_starts, line_ends = line_starts[keep], line_ends[keep]
    n = line_starts.size
    if n == 0:
        return []

    tabs = np.flatnonzero(arr == _TAB)
    tab_line = np.searchsorted(line_ends, tabs, side="right")
    tab_counts = np.bincount(tab_line, minlength=n)
    if (tab_counts < 2).any():
        bad = int(np.flatnonzero(tab_counts < 2)[0])
        raise BedParseError(f"line {bad + 1}: fewer than 3 BED fields")
    tab_offsets = np.concatenate(([0], np.cumsum(tab_counts)))
    tab1 = tabs[tab_offsets[:-1]]
    tab2 = tabs[tab_offsets[:-1] + 1]
    has_rem = tab_counts >= 3
    tab3 = np.where(
        has_rem, tabs[np.minimum(tab_offsets[:-1] + 2, tabs.size - 1)], line_ends
    )

    starts = _parse_int_fields(arr, tab1 + 1, tab2, "start")
    stops = _parse_int_fields(arr, tab2 + 1, tab3, "stop")

    # chromosome boundaries: adjacent-line name comparison via fixed-width
    # gather (chunked if enormous)
    chrom_lens = tab1 - line_starts
    if (chrom_lens <= 0).any():
        raise BedParseError("empty chromosome field")
    boundaries = _chrom_boundaries(arr, line_starts, chrom_lens)
    group_starts = np.flatnonzero(boundaries)
    group_ends = np.concatenate((group_starts[1:], [n]))

    blocks: list[ChromBlock] = []
    seen: set[str] = set()
    for gs, ge in zip(group_starts.tolist(), group_ends.tolist()):
        chrom = bytes(arr[line_starts[gs] : tab1[gs]]).decode("ascii")
        if chrom in seen:
            raise BedParseError(
                f"chromosome {chrom!r} is not contiguous; input must be sorted"
            )
        seen.add(chrom)
        rem_starts = np.where(has_rem[gs:ge], tab3[gs:ge] + 1, line_ends[gs:ge])
        rem_lens = line_ends[gs:ge] - rem_starts
        rem_blob = _gather_slices(arr, rem_starts, rem_lens).tobytes()
        rem_offsets = np.concatenate(([0], np.cumsum(rem_lens)))
        blocks.append(
            ChromBlock(
                chrom=chrom,
                starts=starts[gs:ge].astype(np.int64),
                stops=stops[gs:ge].astype(np.int64),
                rem_blob=rem_blob,
                rem_offsets=rem_offsets.astype(np.int64),
            )
        )
    return blocks


def _chrom_boundaries(
    arr: np.ndarray, name_starts: np.ndarray, name_lens: np.ndarray, chunk: int = 1 << 20
) -> np.ndarray:
    """bool[n]: True where line i's chromosome differs from line i-1's."""
    n = name_starts.size
    out = np.zeros(n, dtype=bool)
    out[0] = True
    max_len = int(name_lens.max())
    j = np.arange(max_len, dtype=np.int64)
    for lo in range(0, n, chunk):
        hi = min(n, lo + chunk)
        # include one overlap row for the cross-chunk comparison
        lo0 = max(lo - 1, 0)
        idx = np.minimum(name_starts[lo0:hi, None] + j[None, :], arr.size - 1)
        mat = arr[idx].astype(np.int16)
        mat[j[None, :] >= name_lens[lo0:hi, None]] = -1
        diff = (mat[1:] != mat[:-1]).any(axis=1)
        out[lo0 + 1 : hi] = diff
    return out
