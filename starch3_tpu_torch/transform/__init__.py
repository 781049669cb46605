"""Starch coordinate transform: columnar delta encoding and its inverse.

The reference implements this as a sequential per-record state machine
(``update_transformation_state``, reference include/starch3api.hpp:428-504):

  - maintain last_coord_diff (init 0 per chromosome); when the record's
    (stop - start) differs, emit a line ``p<coord_diff>\\n``
    (starch3api.hpp:438-455);
  - if last_stop != 0 emit ``<start - last_stop>[\\t<remainder>]\\n``
    (starch3api.hpp:456-478), else the absolute ``<start>[\\t<remainder>]\\n``
    (starch3api.hpp:479-500);
  - state (last_stop, last_coord_diff, line_count) resets per chromosome
    (starch3api.hpp:523-536).

Here the same mapping is computed columnar-and-vectorized: element-wise
diffs for the encode direction (last_stop is just stop shifted by one) and
an associative prefix-scan for the decode direction (stop_i = cumsum of
(delta_i + diff_i)); the text emission is a fixed-width positional
int->decimal kernel.  See ops/transform_jax.py for the device version.
"""

from starch3_tpu_torch.transform.delta import (
    TransformedChrom,
    transform_chrom,
    untransform_chrom,
)

__all__ = ["TransformedChrom", "transform_chrom", "untransform_chrom"]
