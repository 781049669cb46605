"""Columnar records -> BED text (decode side), vectorized.

The inverse of bed/parser.py: emits ``chrom\\tstart\\tstop[\\trem]\\n`` per
record with the same fixed-width positional decimal emission used by the
transform layer.
"""

from __future__ import annotations

import numpy as np

from starch3_tpu_torch.bed.parser import ChromBlock
from starch3_tpu_torch.transform.delta import _dec_len, _emit_decimals, _scatter_blob


def write_bed(blocks: list[ChromBlock]) -> bytes:
    return b"".join(write_bed_chrom(b) for b in blocks)


def write_bed_chrom(block: ChromBlock) -> bytes:
    n = block.n_records
    if n == 0:
        return b""
    chrom = block.chrom.encode("ascii")
    cl = len(chrom)
    sl = _dec_len(block.starts)
    el = _dec_len(block.stops)
    rem_lens = np.diff(block.rem_offsets)
    rec_lens = cl + 1 + sl + 1 + el + np.where(rem_lens > 0, 1 + rem_lens, 0) + 1
    offsets = np.concatenate(([0], np.cumsum(rec_lens)))
    out = np.empty(int(offsets[-1]), dtype=np.uint8)
    # chrom column: same bytes in every record
    chrom_arr = np.frombuffer(chrom, dtype=np.uint8)
    tgt = offsets[:-1][:, None] + np.arange(cl, dtype=np.int64)[None, :]
    out[tgt] = chrom_arr[None, :]
    out[offsets[:-1] + cl] = ord("\t")
    s_off = offsets[:-1] + cl + 1
    _emit_decimals(out, s_off, block.starts, sl)
    out[s_off + sl] = ord("\t")
    e_off = s_off + sl + 1
    _emit_decimals(out, e_off, block.stops, el)
    with_rem = rem_lens > 0
    tab_pos = e_off + el
    out[tab_pos[with_rem]] = ord("\t")
    if with_rem.any():
        blob = np.frombuffer(block.rem_blob, dtype=np.uint8)
        ro = block.rem_offsets
        lens = rem_lens[with_rem]
        src_offsets = np.concatenate(([0], np.cumsum(lens)))
        compact = blob[
            np.repeat(ro[:-1][with_rem] - src_offsets[:-1], lens)
            + np.arange(int(lens.sum()), dtype=np.int64)
        ]
        _scatter_blob(out, (tab_pos + 1)[with_rem], compact, src_offsets)
    out[offsets[1:] - 1] = ord("\n")
    return out.tobytes()
