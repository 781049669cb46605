"""The delta transform's scan formulation, in torch ops.

Counterpart of ``starch3_tpu/ops/transform_jax.py``.  The encode
direction is element-wise (the previous record's stop and coordinate
difference are shift-by-one reads), the decode direction a prefix sum
(stop_i = cumsum(delta_i + diff_i)), and decimal lengths are threshold
sums, so the host would only scatter bytes.  The production transform is
the native ``s3_bed_transform`` on the host; these ops are the columnar
form that the reference keeps for coordinates already on a device.

Every op runs on its inputs' device and keeps their dtype all the way
through, as JAX does without x64: an ``int32`` sum or prefix sum wraps,
and ``dec_len_device`` of the ``int32`` minimum is 2, because its
magnitude wraps to itself (faults of the reference that the port keeps).
"""

from __future__ import annotations

import torch


def dec_len_device(vals: torch.Tensor) -> torch.Tensor:
    """Decimal text length (sign included), element-wise, in ``vals``'
    dtype; thresholds up to 10**18 for ``int64`` and 10**9 otherwise."""
    neg = (vals < 0).to(vals.dtype)
    mag = torch.abs(vals)
    max_digits = 19 if vals.dtype == torch.int64 else 10
    ndig = torch.ones_like(vals)
    for k in range(1, max_digits):
        ndig += (mag >= 10**k).to(vals.dtype)
    return ndig + neg


def _shift_in_zero(x: torch.Tensor) -> torch.Tensor:
    """``[0, x[0], ..., x[n-2]]``: the previous record's value."""
    return torch.cat([x.new_zeros(1), x[:-1]])


def transform_core(starts: torch.Tensor, stops: torch.Tensor):
    """Columnar encode core: (starts, stops) int[n] ->
    (p_mask bool[n], coord_diff, deltas, p_lens, d_digit_lens: int[n],
    nonunique: a 0-d int), in the inputs' dtype."""
    coord_diff = stops - starts
    p_mask = coord_diff != _shift_in_zero(coord_diff)
    last_stop = _shift_in_zero(stops)
    deltas = torch.where(last_stop == 0, starts, starts - last_stop)
    p_lens = torch.where(p_mask, 2 + dec_len_device(coord_diff), 0)
    d_digit_lens = dec_len_device(deltas)
    return p_mask, coord_diff, deltas, p_lens, d_digit_lens, coord_diff.sum(dtype=coord_diff.dtype)


def untransform_core(deltas: torch.Tensor, diffs: torch.Tensor):
    """Decode core: per-record (delta, filled diff) -> (starts, stops),
    stop_i = cumsum(delta_i + diff_i) and start_i = stop_i - diff_i."""
    stops = torch.cumsum(deltas + diffs, 0, dtype=deltas.dtype)
    return stops - diffs, stops


def union_length_device(starts: torch.Tensor, stops: torch.Tensor) -> torch.Tensor:
    """Bases covered by start-sorted half-open intervals (0-d, the
    inputs' dtype): each interval clipped to the running max of the stops
    before it."""
    running = torch.cat([starts[:1], torch.cummax(stops, 0).values[:-1]])
    covered = torch.clamp_min(stops - torch.maximum(starts, running), 0)
    return covered.sum(dtype=stops.dtype)
