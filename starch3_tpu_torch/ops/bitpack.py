"""Bit packing on the device: MSB-first ``(value, nbits)`` fields -> words.

Counterpart of ``starch3_tpu/ops/bitpack_jax.py``: the device form of
``codec/bitio.pack_bits``, the bzip2 container's bit writer.

  1. split: a field wider than 16 bits becomes ``ceil(w / 16)`` pieces of
     at most 16 bits, so that every piece spans at most two 32-bit words
     (``emit_coded_padded``'s codes are at most 17 bits and need no split:
     any field of at most 32 bits spans at most two words);
  2. place: an exclusive cumsum of the widths gives each piece's bit
     offset; it adds its high part to word ``off >> 5`` and its low part
     to the next word, by two scatter-adds (fields never overlap, so add
     is or).

These are XLA ops in the reference, with no Pallas kernel, so they stay
PyTorch ops here.  torch has almost no ``uint32`` arithmetic, so every
shift and sum runs in ``int64`` and is masked to 32 bits, which is the
reference's ``uint32`` wrap.  A write past the last word goes to a spare
column that is cut off after, as ``mode="drop"`` drops it; nothing is
clamped into the last word.  The words come back as ``torch.uint32``, so
``.numpy()`` gives the reference's ``uint32`` array, and the stream's
bytes are their big-endian view.
"""

from __future__ import annotations

import numpy as np
import torch

from starch3_tpu_torch.ops.huff import ALPHA_MAX, GROUP_SIZE

_MAX_PIECES = 4  # ceil(48 / 16): the widest bzip2 field (the magics)
_MASK32 = 0xFFFFFFFF


def _as_uint32(words: torch.Tensor) -> torch.Tensor:
    """int64 values in ``[0, 2**32)`` -> the same bits as ``torch.uint32``
    (through an int32 view: a cast of int64 to uint32 is not on every
    device)."""
    signed = words - ((words >> 31) << 32)  # [-2**31, 2**31): exact in int32
    return signed.to(torch.int32).view(torch.uint32)


def _place(vals: torch.Tensor, widths: torch.Tensor, keep: torch.Tensor, n_words: int):
    """Place fields of at most 32 bits MSB-first in ``n_words`` words, on
    the last axis: ``vals`` and ``widths`` int64[..., n], ``keep`` bool
    (a field that is not kept adds nothing).  Returns (int64 words in
    ``[0, 2**32)`` [..., n_words], int64 total bits [...])."""
    ends = torch.cumsum(widths, dim=-1)
    starts = ends - widths
    total = ends[..., -1] if widths.shape[-1] else ends.new_zeros(widths.shape[:-1])
    word = starts >> 5
    rs = 32 - (starts & 31) - widths  # < 0: the field spills into the next word
    fits = rs >= 0
    hi = torch.where(fits, vals << rs.clamp(min=0), vals >> (-rs).clamp(min=0)) & _MASK32
    lo = torch.where(fits, 0, (vals << (32 + rs).clamp(0, 31)) & _MASK32)
    out = torch.zeros(widths.shape[:-1] + (n_words + 1,), dtype=torch.int64, device=vals.device)
    for at, part in ((word, hi), (word + 1, lo)):
        out.scatter_add_(-1, torch.where(keep & (at < n_words), at, n_words), part)
    return out[..., :n_words] & _MASK32, total


def pack_bits_device(values: torch.Tensor, nbits: torch.Tensor, n_words: int):
    """Pack fields into a big-endian bit stream on the tensors' device.

    Args:
      values: int[n] field values of at most 32 bits (read as uint32),
        each masked to its width
      nbits: int[n] widths in [0, 32] (0: skip)
      n_words: output capacity in 32-bit words
    Returns:
      words: uint32[n_words] (MSB-first bit content)
      total_bits: int32 scalar
    """
    dev = values.device
    v = values.to(torch.int64) & _MASK32
    w = nbits.to(device=dev, dtype=torch.int64)
    k = torch.arange(_MAX_PIECES, device=dev)
    p_count = (w + 15) // 16  # pieces per field
    w_msb = w - 16 * (p_count - 1)  # the first (most significant) piece
    widths = torch.where(k < p_count[:, None], torch.where(k == 0, w_msb[:, None], 16), 0)
    right = w[:, None] - torch.cumsum(widths, dim=1)  # bits to a piece's right
    pieces = (v[:, None] >> right.clamp(min=0)) & ((1 << widths) - 1)
    flat_w = widths.reshape(-1)
    words, total = _place(pieces.reshape(-1), flat_w, torch.ones_like(flat_w, dtype=torch.bool), n_words)
    return _as_uint32(words), total.to(torch.int32)


def emit_coded_padded(
    syms: torch.Tensor,
    m: torch.Tensor,
    selectors: torch.Tensor,
    lut: torch.Tensor,
    n_max: int,
    w_cap: int,
):
    """Huffman-code a batch of RLE2 symbol streams into packed words: the
    device half of libbz2's sendMTFValues emit loop.  Each symbol looks up
    ``(code, len)`` in its group's table and is appended MSB-first.

    Args:
      syms: int32[B, n_max + 2] RLE2 symbols (entries at or past ``m``
        ignored; a symbol outside ``[0, 258)`` is clipped into it)
      m: int[B] symbol counts
      selectors: int[B, g_max] the table of each 50-symbol group
      lut: int32[B, 6 * 258] ``(code << 5) | len`` per table and symbol
      n_max: block geometry
      w_cap: output capacity in words; bits past ``32 * w_cap`` are
        dropped, and ``total_bits`` tells the caller
    Returns:
      words: uint32[B, w_cap] MSB-first bit content
      total_bits: int32[B], the whole stream's length even past the cap
    """
    b, n_pad = syms.shape
    if n_pad != n_max + 2:
        raise ValueError(f"syms has {n_pad} columns, expected n_max + 2 = {n_max + 2}")
    dev = syms.device
    idx = torch.arange(n_pad, device=dev)
    valid = idx[None, :] < m.to(device=dev, dtype=torch.int64)[:, None]
    g_max = selectors.shape[1]
    gid = selectors.to(torch.int64)[:, :, None].expand(b, g_max, GROUP_SIZE).reshape(b, -1)[:, :n_pad]
    at = gid * ALPHA_MAX + syms.to(torch.int64).clamp(0, ALPHA_MAX - 1)
    entry = torch.gather(lut.to(torch.int64), 1, at)
    entry = torch.where(valid, entry, 0)
    # the int32 entry's (entry & 31, entry >> 5 as uint32), in int64
    widths = entry & 31
    vals = (entry >> 5) & _MASK32
    words, total = _place(vals, widths, valid, w_cap)
    return _as_uint32(words), total.to(torch.int32)


def pack_bits_via_device(values, nbits, device="cuda") -> bytes:
    """Host wrapper: fields of any width up to 64 -> the zero-padded byte
    stream (``bitio.pack_bits``'s bytes plus the padded last byte).
    Fields wider than 32 bits are split on the host; the packing runs on
    ``device``."""
    values = np.asarray(values, dtype=np.uint64)
    nbits = np.asarray(nbits, dtype=np.int64)
    if (nbits > 32).any():
        out_v, out_w = [], []
        for v, w in zip(values.tolist(), nbits.tolist()):
            if w > 32:
                out_v += [v >> 32, v & _MASK32]
                out_w += [w - 32, 32]
            else:
                out_v.append(v)
                out_w.append(w)
        values = np.array(out_v, dtype=np.uint64)
        nbits = np.array(out_w, dtype=np.int64)
    total = int(nbits.sum())
    words, total_bits = pack_bits_device(
        torch.from_numpy(values.astype(np.int64)).to(device),
        torch.from_numpy(nbits).to(device),
        total // 32 + 2,
    )
    if int(total_bits) != total:
        raise RuntimeError(f"packed {int(total_bits)} bits, expected {total}")
    raw = words.cpu().numpy().astype(">u4").tobytes()
    return raw[: (total + 7) // 8]
