"""Block-encode pipeline on a torch device: host segmentation -> device
step -> host bit assembly, with spare CPU cores stealing blocks.

Counterpart of ``starch3_tpu/parallel/pipeline.py`` for the production
("fast") mode, every alphabet tier.  Each block is classed by its
distinct bytes at feed time (``_bits_class``) and batched with its class:

  bits 4 (<= 16 symbols, three-column BED): ``step_ranks4``: nibble
           unpack -> one-sort BWT (ops/bwt_fast.py) -> narrow MTF at
           width 16 (ops/mtf_narrow.py) -> rows
           ``[orig_ptr, ties, nibble-packed ranks]``
  bits 5/6 (17..64 symbols, BED with remainder columns):
           ``step_ranks_mid``: word unpack -> ``bwt_sort_fast_mid`` ->
           narrow MTF at width 32/64 -> rows
           ``[orig_ptr, ties, 30//bits ranks per word]``
  bits 8 (more than 64 symbols): ``step_fast``: ``bwt_sort_fast`` ->
           wide MTF at width 256 (ops/mtf_wide.py) -> RLE2 (ops/rle2.py)
           -> rows ``[ptr, m, ties, freq[260], two symbols per word]``
  host:    native RLE2 (bits 4-6) + Huffman + bit emission per block on
           the tail pool, and stream assembly in block order

``device_huffman`` (``mode="fast_huff"``) keeps the Huffman stage on the
device too: every class runs ``step_fast2`` (the one-sort BWT and the
wide MTF at width 128 for bits 4, at width 256 with the byte remap for
every other class, then RLE2), whose symbols and group histograms
(ops/huff.py) stay on the device while only ``[ptr, m, ties, freq]``
comes home.  A finisher thread per batch (``_drain_fast_huff``) refines
the tables in 4 device cost/select rounds with the native length heap
between them, emits the coded bits on the device (ops/bitpack.py) and
downloads only the occupied prefix of the selectors and the words.

The legacy exact modes (``fast_bwt=False``) upload raw bytes and run
the prefix-doubling BWT (ops/bwt.py) on every class, so no block ties and
none is re-encoded on the host: ``mode="ranks"`` (``step_exact``: BWT ->
byte remap -> wide MTF at width 256 -> rows ``[orig_ptr, used[256], four
ranks per word]``, RLE2 and Huffman on the host) and, with
``device_rle2``, ``mode="rle2"`` (``step_exact_rle2``: RLE2 on the device
too, rows ``[ptr, m, used[256], freq[260], two symbols per word]``).
Their tuples go straight to the stream assembler.  ``device_rle2`` with
``fast_bwt`` is fast mode, as in the reference (``encode_mode``).

The MTF stages are hand-written CUDA kernels on a CUDA device.  The host
tier (the block queue and its stealers, classing, the row decoders, the
tail pool and the stream assembler) is the port's own copy of the JAX
package's, in ``host.py``.  Only the device steps, dispatch and drain,
and the driver loop are this module's.

Blocks whose packed-prefix sort ties re-encode exactly on the host, as in
the JAX package; ``device_stats["tie_reencodes"]`` counts them, and
``huff_host_reencodes`` the ``fast_huff`` blocks whose coded bits overflow
the emit's capacity, which the reference re-encodes on the host too.  The
driver's fault handling is the JAX package's too: a device slower than
half the stealers' aggregate is benched and probed for recovery, and a
batch that is not ready after ``_ABANDON_S`` is abandoned to the host
(``scheduler_stats`` counts demotions, repromotions and abandoned
batches), so a stalled stream cannot hang an encode.

Decode (``decode_streams``, reached by ``decompress_starch_bytes(use_jax=
True)``) is the reference's mirror path: the host walks each block to its
RLE2 symbols, ``step_decode`` runs inverse RLE2 (ops/irle2.py), inverse
MTF (ops/imtf.py) and inverse BWT (ops/ibwt.py) on batches of 8 blocks of
one bucket, and the host inverts RLE1 and checks the CRCs.

Every entry takes a ``mesh`` (``parallel/mesh.py``) beside ``device``, as
the reference takes a ``jax.sharding.Mesh``: a batch is padded to a
multiple of the mesh's size and split into equal row ranges, each entry
runs the same step on its slice on its own stream (``_dispatch_meshed``),
and the drain takes the entries' rows in mesh order (``_per_entry``).
Blocks never exchange state, so nothing crosses entries.  The driver
treats a meshed batch as one unit.
"""

from __future__ import annotations

import collections
import functools
import os
import threading
import time

import numpy as np
import torch

from starch3_tpu_torch.codec.bitio import BitReader, BitWriter
from starch3_tpu_torch.codec.crc32 import combine_block_crc, crc32_bytes
from starch3_tpu_torch.codec.decoder import read_block_symbols
from starch3_tpu_torch.codec.encoder import BLOCK_MAGIC, STREAM_END_MAGIC
from starch3_tpu_torch.codec.randtable import derandomize
from starch3_tpu_torch.codec.rle1 import rle1_decode
from starch3_tpu_torch.errors import FormatError
from starch3_tpu_torch.observability import Stats, span, span_keys
from starch3_tpu_torch.ops.bitpack import emit_coded_padded
from starch3_tpu_torch.ops.huff import ALPHA_MAX, GROUP_SIZE, N_TABLES, cost_and_select, group_hist_padded
from starch3_tpu_torch.parallel import host
from starch3_tpu_torch.parallel.mesh import BlockMesh, block_sharding, on_entry, pad_batch
from starch3_tpu_torch.parallel.host import (
    _PIPELINE_DEPTH,
    _TAIL_RESERVE_PER_STEALER,
    _assemble_stream,
    _BlockQueue,
    _fragment_from_ranks_row,
    _fragment_from_row,
    _split_classify,
    _start_host_stealers,
    _submit_tail,
    scheduler_stats,
)
from starch3_tpu_torch.ops.bwt import bwt_encode_padded
from starch3_tpu_torch.ops.bwt_fast import bwt_sort_fast, bwt_sort_fast3, bwt_sort_fast_mid
from starch3_tpu_torch.ops.ibwt import ibwt_padded
from starch3_tpu_torch.ops.imtf import imtf_decode_padded
from starch3_tpu_torch.ops.irle2 import irle2_decode_padded
from starch3_tpu_torch.ops.mtf_narrow import mtf_ranks_narrow_batch
from starch3_tpu_torch.ops import mtf_wide
from starch3_tpu_torch.ops.mtf_wide import mtf_ranks_wide_batch
from starch3_tpu_torch.ops.rle2 import rle2_from_ranks_padded
from starch3_tpu_torch.runtime import read_block_symbols_native

CLASSES = (4, 5, 6, 8)  # the alphabet classes of _bits_class

# cumulative device-path events for this process, in total and per
# alphabet class (chip_smoke.py and the tests read these; results never
# depend on them): batches and blocks dispatched, blocks re-encoded on the
# host for ties and (fast_huff) for an emit overflow, and the bytes the
# host reads back from the device; the decode batches and blocks; and the
# fast step's CUDA graphs captured and replayed (``_StepGraph``); and, per
# class, the driver's skips of a class-gated bucket (their total is
# ``scheduler_stats["class_skips"]``).  The device lane's spans
# (``observability.span``): the feed's waits on its source
# (``feed_source``), ``pack_batch`` (``pack``), the launcher's work on a
# batch (``launch``) and its queue before it (``launch_wait_s``), and the
# driver's tie re-encodes (``tie_reencode``, in fast mode); ``encodes``
# counts the streaming encodes and ``first_block_s`` sums each one's
# seconds from its start to its first block in the queue
device_stats = Stats(
    {
        f"{k}{c}": 0
        for k in ("batches", "blocks", "tie_reencodes", "huff_host_reencodes", "d2h_bytes", "graph_captures",
                  "graph_replays")
        for c in ("",) + tuple(f"_bits{c}" for c in CLASSES)
    }
    | {"decode_batches": 0, "decode_blocks": 0}
    | {f"class_skips_bits{c}": 0 for c in CLASSES}
    | span_keys("feed_source") | span_keys("pack") | span_keys("launch") | span_keys("tie_reencode")
    | {"launch_wait_s": 0.0, "encodes": 0, "first_block_s": 0.0}
)


def resolve_device(device) -> torch.device:
    """The explicit device for the device path: ``cuda`` (the entry
    points' default) needs a card (there is no silent CPU fallback),
    ``cpu`` runs the plain versions.  Without a card the error names both
    ways of asking for the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is "
                "false; ask for the CPU: use_jax=False (EncodeConfig(use_jax=False), "
                "decompress_starch_bytes(..., use_jax=False), --platform=host) for the "
                "native host codec, or device='cpu' (--platform=cpu) for the device "
                "path's plain PyTorch versions"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev} (use 'cuda' or 'cpu')")
    return dev


def encode_mode(fast_bwt: bool = True, device_rle2: bool = False, device_huffman: bool = False) -> str:
    """The reference's mode for an encode's flags: with ``fast_bwt``,
    ``"fast_huff"`` if ``device_huffman`` else ``"fast"`` (``device_rle2``
    is then moot); without it, the exact modes, ``"rle2"`` if
    ``device_rle2`` else ``"ranks"``."""
    if fast_bwt:
        return "fast_huff" if device_huffman else "fast"
    return "rle2" if device_rle2 else "ranks"


def _unpack_nibbles(packed: torch.Tensor) -> torch.Tensor:
    """uint8[B, n_max // 2], two symbols per byte (low nibble first) ->
    int32[B, n_max]."""
    p = packed.to(torch.int32)
    return torch.stack([p & 0xF, p >> 4], dim=-1).reshape(packed.shape[0], -1)


def _mask_past_length(ranks: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """Zero the garbage ranks past each row's length, so they never leak
    into a neighbour's bits of a packed word."""
    idx = torch.arange(ranks.shape[1], device=ranks.device, dtype=torch.int32)
    return torch.where(idx[None, :] < lens[:, None], ranks, 0)


def _pack_words(vals: torch.Tensor, per_word: int, bits: int) -> torch.Tensor:
    """Pack ``per_word`` values of ``bits`` bits into each int32 word,
    lowest bits first, zero-padding the last word.  The words must stay
    below 2**31 (the callers' values do)."""
    b, n = vals.shape
    n_words = -(-n // per_word)
    v = torch.nn.functional.pad(vals, (0, n_words * per_word - n)).reshape(b, n_words, per_word)
    word = v[..., 0]
    for k in range(1, per_word):
        word = word | (v[..., k] << (bits * k))
    return word


def bwt_of_batch(seqs: torch.Tensor, lens: torch.Tensor, bits: int, n_max: int, wide: bool = False):
    """The BWT half of a device step on a ``pack_batch`` batch: (last,
    ptrs, ties), ``last`` int32[B, n_max] being the MTF kernel's input.
    ``bwt_sort_fast3`` at bits 4, ``bwt_sort_fast_mid`` at bits 5/6,
    ``bwt_sort_fast`` at bits 8, and at bits 4 too with ``wide`` (the
    ``step_bwt_mtf_fast`` form)."""
    if bits in (5, 6):
        spw = 30 // bits
        b, n_words = seqs.shape
        if n_words != -(-n_max // spw):
            raise ValueError(f"{n_words} words do not hold n_max={n_max} symbols at bits={bits}")
        mask = (1 << bits) - 1
        syms = torch.stack([(seqs >> (bits * k)) & mask for k in range(spw)], dim=-1)
        syms = syms.reshape(b, n_words * spw)[:, :n_max].contiguous()
        return bwt_sort_fast_mid(syms, lens, bits)
    if bits == 4:
        seqs = _unpack_nibbles(seqs)
        if not wide:
            return bwt_sort_fast3(seqs, lens)
    return bwt_sort_fast(seqs.to(torch.int32), lens, bits)


def step_ranks4(seqs_packed: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """The bits==4 device step, counterpart of
    ``_jitted_fused_step_ranks4``.

    Args:
      seqs_packed: uint8[B, n_max // 2], two dense symbols per byte (low
        nibble first); n_max a multiple of 4096
      lens: int32[B] true lengths (1 <= len <= n_max)
    Returns:
      int32[B, 2 + n_max // 8] rows ``[orig_ptr, ties, packed ranks]``,
      eight 4-bit ranks per word, ranks past each row's length zero.
    """
    b, half = seqs_packed.shape
    last, ptrs, ties = bwt_of_batch(seqs_packed, lens, 4, 2 * half)
    ranks = _mask_past_length(mtf_ranks_narrow_batch(last, 16), lens)
    # nibble pairs as bytes, read as little-endian words: the same words
    # as the JAX step's shift-or, without int32 shift overflow
    nib = ranks.to(torch.uint8).reshape(b, half, 2)
    packed = (nib[..., 0] | (nib[..., 1] << 4)).view(torch.int32)
    return torch.cat([ptrs[:, None], ties[:, None], packed], dim=1)


def step_ranks_mid(words: torch.Tensor, lens: torch.Tensor, bits: int, n_max: int) -> torch.Tensor:
    """The bits 5/6 device step, counterpart of
    ``_jitted_fused_step_ranks_mid(n_max, bits)``.

    Args:
      words: int32[B, ceil(n_max / spw)], ``spw = 30 // bits`` dense
        symbols per word, lowest bits first; n_max a multiple of 4096
      lens: int32[B] true lengths (1 <= len <= n_max)
    Returns:
      int32[B, 2 + words.shape[1]] rows ``[orig_ptr, ties, packed
      ranks]``, ``spw`` ranks of ``bits`` bits per word, ranks past each
      row's length zero.
    """
    spw = 30 // bits
    last, ptrs, ties = bwt_of_batch(words, lens, bits, n_max)
    ranks = mtf_ranks_narrow_batch(last, 32 if bits == 5 else 64)
    packed = _pack_words(_mask_past_length(ranks, lens), spw, bits)
    return torch.cat([ptrs[:, None], ties[:, None], packed], dim=1)


def step_bwt_mtf_fast(seqs: torch.Tensor, lens: torch.Tensor, bits: int):
    """One-sort BWT -> wide MTF, counterpart of
    ``_jitted_bwt_mtf_fast(n_max, bits)``.

    ``seqs`` is uint8[B, n_max] dense symbols at bits 8, or two symbols
    per byte (uint8[B, n_max // 2]) at bits 4; n_max a multiple of 1024.
    Returns (ptrs int32[B], ties int32[B], ranks int32[B, n_max]), the
    ranks zero past each row's length."""
    n_max = seqs.shape[1] * (2 if bits == 4 else 1)
    last, ptrs, ties = bwt_of_batch(seqs, lens, bits, n_max, wide=True)
    # bits==4 implies a dense alphabet <= 16, so width 128 always covers it
    ranks = mtf_ranks_wide_batch(last, 128 if bits == 4 else 256)
    return ptrs, ties, _mask_past_length(ranks, lens)


def step_rle2_pack(ptrs, ties, ranks, lens, nsyms, bits: int) -> torch.Tensor:
    """RLE2 + download packing, counterpart of
    ``_jitted_rle2_pack(n_max, bits)``: rows ``[ptr, m, ties, freq[260],
    packed symbols]``, six 5-bit symbols per word at bits 4 (every symbol
    is <= 17 there), two 16-bit symbols per word otherwise."""
    syms, m, freq = rle2_from_ranks_padded(ranks, lens, nsyms)
    spw, sb = (6, 5) if bits == 4 else (2, 16)
    packed = _pack_words(syms, spw, sb)
    return torch.cat([ptrs[:, None], m[:, None], ties[:, None], freq, packed], dim=1)


def step_fast(seqs: torch.Tensor, lens: torch.Tensor, nsyms: torch.Tensor, bits: int) -> torch.Tensor:
    """The bits==8 device step (bits 4 too), counterpart of
    ``_jitted_fused_step_fast(n_max, bits)``: ``step_bwt_mtf_fast`` then
    ``step_rle2_pack``.  ``nsyms`` is int32[B], each row's dense
    alphabet size."""
    ptrs, ties, ranks = step_bwt_mtf_fast(seqs, lens, bits)
    return step_rle2_pack(ptrs, ties, ranks, lens, nsyms, bits)


def step_rle2_raw(ptrs, ties, ranks, lens, nsyms):
    """RLE2 for the device Huffman stage, counterpart of
    ``_jitted_rle2_raw(n_max)``: (small int32[B, 263] rows ``[ptr, m,
    ties, freq[260]]``, the only part that goes home, and the symbol
    streams int32[B, n_max + 2], which stay on the device)."""
    syms, m, freq = rle2_from_ranks_padded(ranks, lens, nsyms)
    small = torch.cat([ptrs[:, None], m[:, None], ties[:, None], freq], dim=1)
    return small, syms


def step_fast2(seqs: torch.Tensor, lens: torch.Tensor, nsyms: torch.Tensor, bits: int):
    """``fast_huff``'s device step, counterpart of
    ``_jitted_fused_step_fast2(n_max, bits)``: ``step_bwt_mtf_fast`` (the
    wide MTF at width 128 for bits 4, 256 for bits 8) then
    ``step_rle2_raw``."""
    ptrs, ties, ranks = step_bwt_mtf_fast(seqs, lens, bits)
    return step_rle2_raw(ptrs, ties, ranks, lens, nsyms)


def bwt_remap(blocks: torch.Tensor, lens: torch.Tensor):
    """The exact modes' prologue, counterpart of ``_bwt_remap`` mapped over
    a batch: the prefix-doubling BWT (ops/bwt.py), each row's used-byte
    map and the dense remap of its last column.  Returns (ptrs int32[B],
    used int32[B, 256], seqs int32[B, n_max] zero past each length)."""
    last, ptrs = bwt_encode_padded(blocks, lens)
    b, n_max = blocks.shape
    idx = torch.arange(n_max, device=blocks.device, dtype=torch.int32)
    valid = idx[None, :] < lens[:, None]
    ix = last.to(torch.int64)
    # the used map by scatter, its padding writes into a spare column
    used = torch.zeros((b, 257), device=blocks.device, dtype=torch.int32)
    used.scatter_(1, torch.where(valid, ix, 256), 1)
    used = used[:, :256].contiguous()
    u2s = torch.cumsum(used, dim=1, dtype=torch.int32) - 1  # codec/mtf.py symbol_map
    seqs = torch.where(valid, torch.gather(u2s, 1, ix), 0)
    return ptrs, used, seqs


def _exact_ranks(blocks: torch.Tensor, lens: torch.Tensor):
    """``bwt_remap``, then the wide MTF at width 256 zeroed past each
    length (the kernel branch of the reference's ``_batch_ranks``)."""
    ptrs, used, seqs = bwt_remap(blocks, lens)
    return ptrs, used, _mask_past_length(mtf_ranks_wide_batch(seqs, 256), lens)


def step_exact(blocks: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """The ``ranks`` mode's device step, counterpart of
    ``_jitted_fused_step(n_max)``.

    Args:
      blocks: uint8[B, n_max] raw post-RLE1 bytes, n_max a multiple of 1024
      lens: int32[B] true lengths (1 <= len <= n_max)
    Returns:
      int32[B, 257 + n_max // 4] rows ``[orig_ptr, used[256], ranks]``,
      four ranks per word, little-endian (the reference's
      ``bitcast_convert_type``), ranks past each row's length zero.
    """
    ptrs, used, ranks = _exact_ranks(blocks, lens)
    packed = ranks.to(torch.uint8).view(torch.int32)
    return torch.cat([ptrs[:, None], used, packed], dim=1)


def step_exact_rle2(blocks: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """The ``rle2`` mode's device step, counterpart of
    ``_jitted_fused_step_rle2(n_max)``: ``step_exact``'s ranks, then RLE2
    with each row's used bytes as its alphabet.  Returns int32[B, 518 +
    (n_max + 3) // 2] rows ``[ptr, m, used[256], freq[260], symbols]``,
    two 16-bit symbols per word."""
    ptrs, used, ranks = _exact_ranks(blocks, lens)
    syms, m, freq = rle2_from_ranks_padded(ranks, lens, used.sum(dim=1))
    packed = _pack_words(syms, 2, 16)
    return torch.cat([ptrs[:, None], m[:, None], used, freq, packed], dim=1)


def _unpack_results(out: np.ndarray, lens, b: int, n_max: int) -> list:
    """``step_exact`` rows on the host -> per block ``(used bool[256],
    orig_ptr, ranks uint8[n])``, the ranks a view of ``out``."""
    used = out[:, 1:257].astype(bool)
    ranks = out[:, 257:].view(np.uint8).reshape(out.shape[0], n_max)
    return [(used[i], int(out[i, 0]), ranks[i, : lens[i]]) for i in range(b)]


def _unpack_results_rle2(out: np.ndarray, b: int) -> list:
    """``step_exact_rle2`` rows on the host -> per block ``(used
    bool[256], orig_ptr, symbols int32[m], freq int32[260])``."""
    res = []
    for row in out[:b]:
        m = int(row[1])
        packed = row[518:]
        syms = np.empty(packed.size * 2, dtype=np.int32)
        syms[0::2] = packed & 0xFFFF
        syms[1::2] = (packed >> 16) & 0xFFFF
        res.append((row[2:258].astype(bool), int(row[0]), syms[:m], row[258:518]))
    return res


def raw_batch(block_datas, n_max: int, b_pad: int | None = None):
    """The exact modes' upload: raw bytes, uint8[b_pad, n_max], padding
    rows of length 1 and zero bytes, in pageable memory.  Returns
    (tensor, lens int32[b_pad])."""
    b_pad = max(len(block_datas), b_pad or 0)
    buf = torch.zeros((b_pad, n_max), dtype=torch.uint8)
    rows_np = buf.numpy()
    lens = np.ones(b_pad, dtype=np.int32)
    for i, data in enumerate(block_datas):
        arr = np.frombuffer(data, dtype=np.uint8)
        if arr.size > n_max:
            raise ValueError(f"block {i} exceeds n_max ({arr.size} > {n_max})")
        rows_np[i, : arr.size] = arr
        lens[i] = arr.size
    return buf, lens


def device_encode_blocks(block_datas: list[bytes], n_max: int = host.N_MAX_BLOCK, mesh=None,
                         device="cuda") -> list:
    """Run the ``ranks`` mode's device step on a batch of post-RLE1 blocks
    and wait for it; the counterpart of the JAX ``device_encode_blocks``.
    The step runs on ``device``, or, given a ``mesh`` (``parallel/mesh.py``),
    on each of its entries for its slice of the batch, padded to a multiple
    of the mesh's size; ``device`` is then ignored.

    Returns per block: (in_use bool[256], orig_ptr, mtf ranks uint8[n])."""
    b = len(block_datas)
    if b == 0:
        return []
    if mesh is None:
        dev = resolve_device(device)
        batch, lens = raw_batch(block_datas, n_max)
        out = step_exact(batch.to(dev), torch.from_numpy(lens).to(dev)).cpu().numpy()
        return _unpack_results(out, lens, b, n_max)
    batch, lens = raw_batch(block_datas, n_max, pad_batch(b, mesh.size))
    lens_t = torch.from_numpy(lens)
    meshed = _dispatch_meshed(mesh, b, lambda rows, dev: step_exact(batch[rows].to(dev), lens_t[rows].to(dev)))
    rows = []
    for dev, stream, part in zip(mesh.devices, mesh.streams, meshed.parts):
        with on_entry(dev, stream):  # the download waits for the entry's stream
            rows.append(part.cpu())
    return _unpack_results(torch.cat(rows).numpy(), lens, b, n_max)


def _emit_w_cap(n_max: int) -> int:
    """The emit's capacity in words: about 5.3 coded bits per input
    symbol.  A block that needs more is re-encoded on the host, which
    its ``total_bits`` tells (the reference's rule)."""
    return (n_max + 2) // 6 + 64


def _dense_pack4(arr: np.ndarray, out_row: np.ndarray):
    """Dense-remap one block and pack two symbols per byte into
    ``out_row``: the native pass (which keeps the GIL), or the same in
    NumPy without the native lib.  Returns (distinct bytes, used
    bool[256])."""
    from starch3_tpu_torch.runtime import dense_pack4_native

    res = dense_pack4_native(arr, out_row)
    if res is not None:
        return res
    used = np.bincount(arr, minlength=256) > 0
    syms = (np.cumsum(used) - 1).astype(np.uint8)[arr]
    if syms.size % 2:
        syms = np.append(syms, np.uint8(0))
    out_row[: syms.size // 2] = syms[0::2] | (syms[1::2] << 4)
    return int(used.sum()), used


def _dense_pack_words(arr: np.ndarray, out_words: np.ndarray, bits: int):
    """Dense-remap one block and pack ``30 // bits`` symbols per uint32
    word into ``out_words``: the native pass (which keeps the GIL), or
    the same in NumPy without the native lib.  Returns (distinct bytes,
    used bool[256])."""
    from starch3_tpu_torch.runtime import dense_pack_words_native

    res = dense_pack_words_native(arr, bits, out_words)
    if res is not None:
        return res
    spw = 30 // bits
    used = np.bincount(arr, minlength=256) > 0
    syms = (np.cumsum(used) - 1).astype(np.uint32)[arr]
    syms.resize(-(-syms.size // spw) * spw)
    sp = syms.reshape(-1, spw)
    w = sp[:, 0].copy()
    for k in range(1, spw):
        w |= sp[:, k] << (bits * k)
    out_words[: w.size] = w
    return int(used.sum()), used


def _dense_remap(arr: np.ndarray, out_row: np.ndarray):
    """Dense-remap one block into ``out_row`` (uint8, one symbol per
    byte).  Returns (distinct bytes, used bool[256])."""
    used = np.bincount(arr, minlength=256) > 0
    out_row[: arr.size] = (np.cumsum(used) - 1).astype(np.uint8)[arr]
    return int(used.sum()), used


def pack_batch(block_datas, n_max: int, bits: int, b_pad: int | None = None):
    """Dense-remap and pack blocks into the upload format of the ``bits``
    tier's step, padded to ``b_pad`` rows (length 1, one symbol):
    nibble pairs (uint8[B, n_max // 2]) at bits 4, ``30 // bits`` symbols
    per word (int32[B, ceil(n_max / spw)]) at bits 5/6, one symbol per byte
    (uint8[B, n_max]) at bits 8, in pageable memory.  Returns (tensor,
    lens int32[B], nsyms int32[B], the blocks' ``used`` bool[256]
    tables).  The rows are NumPy's zeros (a torch call would let the GIL
    go and wait to win it back), and the native packs keep the GIL.
    ``device_stats`` times it as the span ``pack``."""
    with span(device_stats, "pack"):
        if bits not in CLASSES:
            raise ValueError(f"unknown alphabet class bits=={bits}")
        b_pad = max(len(block_datas), b_pad or 0)
        lens = np.ones(b_pad, dtype=np.int32)
        nsyms = np.ones(b_pad, dtype=np.int32)
        if bits == 4:
            rows_np = np.zeros((b_pad, n_max // 2), dtype=np.uint8)
            buf = torch.from_numpy(rows_np)
            pack = _dense_pack4
        elif bits in (5, 6):
            rows_np = np.zeros((b_pad, -(-n_max // (30 // bits))), dtype=np.uint32)
            buf = torch.from_numpy(rows_np.view(np.int32))
            pack = functools.partial(_dense_pack_words, bits=bits)
        else:
            rows_np = np.zeros((b_pad, n_max), dtype=np.uint8)
            buf = torch.from_numpy(rows_np)
            pack = _dense_remap
        useds = []
        for i, data in enumerate(block_datas):
            arr = np.frombuffer(data, dtype=np.uint8)
            if arr.size > n_max:
                raise ValueError(f"block {i} exceeds n_max ({arr.size} > {n_max})")
            lens[i] = arr.size
            nsyms[i], used = pack(arr, rows_np[i])
            if bits != 8 and nsyms[i] > 1 << bits:  # the queue classed this block
                raise RuntimeError(f"block {i} has {nsyms[i]} distinct bytes in the bits=={bits} tier")
            useds.append(used)
        return buf, lens, nsyms, useds


def step_for_class(seqs, lens, nsyms, bits: int, n_max: int) -> torch.Tensor:
    """The device step of alphabet class ``bits`` on a ``pack_batch``
    batch (already on the device): ``step_ranks4``, ``step_ranks_mid`` or
    ``step_fast``."""
    if bits == 4:
        return step_ranks4(seqs, lens)
    if bits in (5, 6):
        return step_ranks_mid(seqs, lens, bits, n_max)
    return step_fast(seqs, lens, nsyms, 8)


class _Meshed:
    """A batch split over a mesh: each entry's part (what the one-device
    dispatch returns for its slice) in mesh order, each of ``per`` rows of
    the padded batch."""

    def __init__(self, parts: tuple, per: int):
        self.parts, self.per = parts, per


def _dispatch_meshed(mesh: BlockMesh, n_rows: int, dispatch) -> _Meshed:
    """Pad a batch of ``n_rows`` to a multiple of the mesh's size, split it
    into the entries' row ranges (``block_sharding``) and call
    ``dispatch(rows, device)`` for each entry in mesh order, with its
    device and stream current: every upload, kernel, copy and event of the
    part enqueues on the entry's own stream."""
    b_pad = pad_batch(n_rows, mesh.size)
    parts = []
    for dev, stream, rows in zip(mesh.devices, mesh.streams, block_sharding(mesh, b_pad)):
        with on_entry(dev, stream):
            parts.append(dispatch(rows, dev))
    return _Meshed(tuple(parts), b_pad // mesh.size)


def _per_entry(chunk, handle, single) -> list:
    """What to drain of a dispatched batch of ``chunk``: ``[(chunk,
    single)]``, or, when ``handle`` is ``_Meshed``, each entry's slice of
    ``chunk`` with its part, in mesh order.  An entry that holds only
    padding has nothing to drain; its part stays referenced by the batch."""
    if not isinstance(handle, _Meshed):
        return [(chunk, single)]
    per = handle.per
    return [(chunk[i * per : (i + 1) * per], part) for i, part in enumerate(handle.parts) if i * per < len(chunk)]


def _dispatch_chunk(block_datas, nm, device, pad_to=None, mode: str = "fast"):
    """Pack, upload and launch one batch without waiting for it.

    ``nm`` is the queue's ``(n_max, bits class)`` bucket key; the batch is
    padded to ``pad_to`` rows.  ``device`` is the encode's torch device or
    its ``BlockMesh``.  Returns ``(handle, aux)``; under a mesh the handle
    is ``_Meshed``, whose parts are each entry's ``(handle, aux)``, padded
    together to a multiple of the mesh's size, and aux is None.  The
    one-device form is ``_dispatch_one``'s.  Counts one batch in
    ``device_stats``."""
    if isinstance(device, BlockMesh):
        handle = _dispatch_meshed(
            device, max(len(block_datas), pad_to or 0),
            lambda rows, dev: _dispatch_one(block_datas[rows], nm, dev, rows.stop - rows.start, mode),
        )
        out = (handle, None)
        d2h = sum(aux["d2h"] for _h, aux in handle.parts)
    else:
        out = _dispatch_one(block_datas, nm, device, pad_to, mode)
        d2h = out[1]["d2h"]
    _count_batch(len(block_datas), nm[1], d2h)
    return out


def _rows_width(mode: str, bits: int, n_max: int) -> int:
    """The int32 columns of a batch's rows, which its drain reads back:
    ``step_exact``'s, ``step_exact_rle2``'s, ``step_ranks4``'s,
    ``step_ranks_mid``'s or ``step_fast``'s (``step_fast2``'s small rows
    are the finisher's to count)."""
    if mode == "ranks":
        return 257 + n_max // 4
    if mode == "rle2":
        return 518 + (n_max + 3) // 2
    if bits == 4:
        return 2 + n_max // 8
    if bits in (5, 6):
        return 2 + -(-n_max // (30 // bits))
    return 263 + (n_max + 3) // 2


def _dispatch_one(block_datas, nm, device: torch.device, pad_to, mode: str):
    """``_dispatch_chunk`` on one device, on its current stream.

    The driver's thread packs the batch in pageable memory.  On the CPU
    the step runs here and the handle is ``(rows, None)``, the rows ready.
    On a CUDA device the handle is ``(None, _Launched)``: the launcher
    thread pins and uploads the batch, enqueues the step (in ``fast``
    mode a replay of its CUDA graph, ``_StepGraph``) and a non-blocking
    copy of its rows into pinned memory, and records an event;
    ``_landed`` gives the handle in the CPU's form.  In
    ``fast_huff`` the rows are ``step_fast2``'s small rows and the handle
    goes on with the device tensors the finisher reads, ``(syms, m,
    hist)``.  The exact modes (``ranks``, ``rle2``) upload the raw bytes,
    whatever the class, to ``step_exact`` or ``step_exact_rle2``.  Each
    batch gets its own pinned buffer: the drain hands row views to the
    tail pool or the assembler, which read them later.  ``aux["d2h"]`` is
    the bytes its rows bring back (0 in ``fast_huff``, whose finisher
    counts its own); on the CPU ``aux["step_s"]`` is the step's wall time,
    the batch's own time on the device (``_device_seconds``)."""
    n_max, bits = nm
    aux = {"bits": bits, "mode": mode, "n_max": n_max}
    if mode in ("ranks", "rle2"):
        raw, lens = raw_batch(block_datas, n_max, pad_to)
        inputs = (raw, torch.from_numpy(lens))
        exact = step_exact if mode == "ranks" else step_exact_rle2

        def step(*args):
            return exact(*args), ()
    else:
        # fast_huff packs bits 4 as nibbles and every other class as bytes
        # (the reference's dispatch: no word pack at bits 5/6 there)
        step_bits = bits if mode == "fast" else (4 if bits == 4 else 8)
        packed, lens, nsyms, aux["useds"] = pack_batch(block_datas, n_max, step_bits, pad_to)
        inputs = (packed, torch.from_numpy(lens), torch.from_numpy(nsyms))

        def step(*args):
            if mode != "fast_huff":
                return step_for_class(*args, bits, n_max), ()
            rows, syms = step_fast2(*args, step_bits)
            m = rows[:, 1].contiguous()
            # the histograms launch at once; they stay on the device with syms
            return rows, (syms, m, group_hist_padded(syms, m, n_max))
    aux["lens"] = lens
    aux["d2h"] = 0 if mode == "fast_huff" else lens.size * _rows_width(mode, bits, n_max) * 4
    if device.type != "cuda":
        t0 = time.monotonic()
        rows, on_device = step(*inputs)
        aux["step_s"] = time.monotonic() - t0
        return (rows, None) + on_device, aux
    return (None, _launch(device, inputs, step, (bits, n_max) if mode == "fast" else None)), aux


def _count_batch(b: int, bits: int, d2h_bytes: int) -> None:
    """Count one dispatched batch of ``b`` blocks of class ``bits`` and the
    bytes its rows will bring back (a fast_huff finisher counts its own
    downloads)."""
    counts = {"batches": 1, "blocks": b, f"batches_bits{bits}": 1, f"blocks_bits{bits}": b}
    if d2h_bytes:
        counts.update({"d2h_bytes": d2h_bytes, f"d2h_bytes_bits{bits}": d2h_bytes})
    device_stats.add(**counts)


class _Launched:
    """A batch whose work the launcher thread enqueues: ``query`` and
    ``synchronize`` as the CUDA event's that the launcher records after
    it; ``future`` gives ``(rows, event, *on_device)``.  A launch error
    raises from each.  ``start`` is the timing event the launcher records
    before the batch's uploads, set before ``future`` completes;
    ``first_of_key`` is True when the batch warmed up its key or captured
    its graph for the first time (``_step_graph``), a cost paid once per
    key."""

    def __init__(self, future=None):
        self.future = future
        self.start = None
        self.first_of_key = False

    def query(self) -> bool:
        return self.future.done() and self.future.result()[1].query()

    def synchronize(self) -> None:
        self.future.result()[1].synchronize()

    def elapsed_s(self) -> float:
        """Seconds on the card from before the uploads to after the rows'
        copy, once the batch is ready."""
        return self.start.elapsed_time(self.future.result()[1]) / 1e3


def _landed(handle) -> tuple:
    """A one-device handle as ``(rows, event, *on_device)``, waiting for
    its launcher when it has one (not for its event)."""
    return handle[1].future.result() if handle[0] is None else handle


_LAUNCHER = None
_launcher_lock = threading.Lock()


def _launcher():
    """The process's launcher: one thread, so batches enqueue in dispatch
    order.  The driver's thread makes no CUDA call for a batch, because a
    CUDA call can wait on a stalled card, and a dispatch that waits hides
    the stall from the driver, which then cannot abandon the batch.  On
    an NVIDIA H100 80GB HBM3, 700 W (``chip_smoke.py`` phases 8 b and
    10 e): an exact step enqueues about 1,400 kernels and copies a batch
    at (3, 901,120), more than a stream queues ahead of a stalled card, so
    a launch blocks until the card drains; a page-locked allocation that
    misses the caching host allocator (``cudaHostAlloc``) then waits as
    long on any thread; and in a fresh process the first launches of a
    fast-mode step waited out a whole 3 s stall."""
    global _LAUNCHER
    with _launcher_lock:
        if _LAUNCHER is None:
            from concurrent.futures import ThreadPoolExecutor

            _LAUNCHER = ThreadPoolExecutor(1, thread_name_prefix="s3tlaunch")
        return _LAUNCHER


_STEP_GRAPHS_MAX = 8  # per card, stream and class, as the reference's lru_cache(maxsize=8) per class
# the fast step's graphs: (device index, stream, bits) -> (n_max, input
# shapes) -> _StepGraph, least recently used first.  A key's first batch
# ever runs eagerly (the warm-up, ``_warmed``); its graph is captured at
# its second.  Only the launcher thread reads or writes these.
_STEP_GRAPHS: dict = {}
_warmed: set = set()  # (device index, stream, bits, n_max, shapes) whose warm-up ran
_captured: set = set()  # the same keys, once captured (a capture after an eviction is not the first)
_capture_streams: dict = {}  # device index -> the side stream captures run on


class _StepGraph:
    """The fast-mode step of one key captured as a CUDA graph: the port's
    counterpart of the reference's cached ``jax.jit``.  A replay launches
    the step's hundred-odd kernels and copies in one call, where the
    eager step issues each from Python, letting the GIL go and taking it
    back each time; the kernels are the same.

    The capture runs on the launcher thread, on a side stream, in
    ``thread_local`` mode, so that the other threads' CUDA calls (a mesh
    entry's, the ``fast_huff`` finisher's, decode's) go on meanwhile; it
    does not synchronize the device, so a stalled stream does not hold it
    up.  Its memory comes from the pool of a live graph of the same
    stream, where there is one (a pool whose graphs were all dropped is
    gone): a stream's graphs replay one at a time in its order, and each
    batch's rows are copied out on the stream before the next replay
    overwrites them.  The inputs are views of one static buffer outside
    the pool, which each batch fills with one upload from one pinned
    buffer (``stage``).  The MTF wrappers count no launch while a capture
    records their kernels (``mtf_wide.captured_launches``); each replay
    counts what the capture recorded.  A failed capture raises: there is
    no fallback to the eager step."""

    def __init__(self, stream, step, inputs, bits: int):
        dev = stream.device
        self.bits = bits
        self.spans, end = [], 0  # each input's bytes in the static buffer, 16-byte aligned
        for t in inputs:
            self.spans.append((end, end + t.numel() * t.element_size()))
            end = -(-self.spans[-1][1] // 16) * 16
        self.flat = torch.empty(end, dtype=torch.uint8, device=dev)
        self.static = [self.flat[a:b].view(t.dtype).view(t.shape) for (a, b), t in zip(self.spans, inputs)]
        self.graph = torch.cuda.CUDAGraph()
        pool = next((g.graph.pool() for where, graphs in _STEP_GRAPHS.items()
                     if where[:2] == (dev.index, stream.cuda_stream) for g in graphs.values()), None)
        side = _capture_streams.get(dev.index)
        if side is None:
            side = _capture_streams[dev.index] = torch.cuda.Stream(dev)
        with torch.cuda.stream(side), mtf_wide.captured_launches() as tally:
            self.graph.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                self.rows = step(*self.static)[0]
            except BaseException:
                try:
                    self.graph.capture_end()
                except Exception:
                    pass  # the capture is invalid anyway; the step's error is the one to raise
                raise
            self.graph.capture_end()
        self.launches = tuple(tally)
        self.done = None  # the event after the latest replay's rows were copied out
        device_stats.add(**{"graph_captures": 1, f"graph_captures_bits{bits}": 1})

    def stage(self, inputs) -> torch.Tensor:
        """A batch's inputs copied into one pinned buffer laid out as the
        static one (NumPy copies, which let the GIL go)."""
        pinned = torch.empty(self.flat.shape, dtype=torch.uint8, pin_memory=True)
        host_view = pinned.numpy()
        for (a, b), t in zip(self.spans, inputs):
            host_view[a:b] = t.numpy().reshape(-1).view(np.uint8)
        return pinned

    def replay(self, pinned) -> torch.Tensor:
        """Upload a staged batch into the static inputs and replay the
        step on the current stream; returns the static rows, which the
        next replay overwrites.  The caller counts the replay
        (``counted``) once its work is enqueued."""
        self.flat.copy_(pinned, non_blocking=True)
        self.graph.replay()
        return self.rows

    def counted(self) -> None:
        """Count one replay and the kernel launches its capture recorded."""
        mtf_wide.count_replayed(self.launches)
        device_stats.add(**{"graph_replays": 1, f"graph_replays_bits{self.bits}": 1})


def _step_graph(stream, graph_key, inputs, step):
    """``(graph, first)``: the graph of this batch's key on ``stream``,
    captured now if it is not cached; None at the key's first batch ever,
    which runs eagerly, the capture's warm-up (every kernel loaded, every
    lazy initialization done).  ``first`` is True for the warm-up and for
    the key's first capture, not for a capture after an eviction.  Past
    ``_STEP_GRAPHS_MAX`` keys of one card, stream and class, the least
    recently used graph is dropped once its last replay is done."""
    bits, n_max = graph_key
    where = (stream.device.index, stream.cuda_stream, bits)
    key = (n_max, *(tuple(t.shape) for t in inputs))
    if where + key not in _warmed:
        _warmed.add(where + key)
        return None, True
    graphs = _STEP_GRAPHS.setdefault(where, collections.OrderedDict())
    if key in graphs:
        graphs.move_to_end(key)
        return graphs[key], False
    while len(graphs) >= _STEP_GRAPHS_MAX:
        old = graphs.pop(next(iter(graphs)))
        if old.done is not None:
            old.done.synchronize()  # its pool's memory is reused once it is dropped
    graphs[key] = _StepGraph(stream, step, inputs, bits)
    first = where + key not in _captured
    _captured.add(where + key)
    return graphs[key], first


def _launch(device: torch.device, inputs, step, graph_key=None) -> _Launched:
    """Submit one batch to the launcher: pin ``inputs``, record a timing
    event, upload them, run ``step(*uploads)`` -> ``(rows, on_device)``, copy
    the rows into pinned memory and record an event, on the stream that is
    current here (the device's or a mesh entry's).  With a ``graph_key``
    (``(bits, n_max)``, the fast step's) the step runs as a replay of its
    ``_StepGraph``, captured at the key's second batch (``_step_graph``).
    ``device_stats`` times the launcher's work on the batch as the span
    ``launch``, and adds its wait from the submit to that work's start
    (the launcher's queue and the hand-over of the GIL) to
    ``launch_wait_s``."""
    if device.index is None:
        # resolving "cuda" to its index asks torch.cuda.is_available(),
        # which may query NVML: once here, not on every call below
        device = torch.device("cuda", torch.cuda.current_device())
    stream = torch.cuda.current_stream(device)
    launched = _Launched()

    def launch():
        device_stats.add(launch_wait_s=time.perf_counter() - submitted)
        with span(device_stats, "launch"), torch.cuda.device(device), torch.cuda.stream(stream):
            graph, launched.first_of_key = (None, False) if graph_key is None else _step_graph(
                stream, graph_key, inputs, step)
            # pinned, so that the uploads never wait on a stalled stream;
            # the host copies come before the timing event
            if graph is None:
                pinned, out = [t.pin_memory() for t in inputs], None
            else:
                pinned = graph.stage(inputs)
                out = torch.empty(graph.rows.shape, dtype=graph.rows.dtype, pin_memory=True)
            start = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            if graph is not None:
                rows, on_device = graph.replay(pinned), ()
            else:
                rows, on_device = step(*(t.to(device, non_blocking=True) for t in pinned))
                out = torch.empty(rows.shape, dtype=rows.dtype, pin_memory=True)
            out.copy_(rows, non_blocking=True)
            event = torch.cuda.Event(enable_timing=True)
            event.record(stream)
            if graph is not None:
                graph.done = event
                graph.counted()
        launched.start = start
        return (out, event) + on_device

    submitted = time.perf_counter()
    launched.future = _launcher().submit(launch)
    return launched


def _device_seconds(handle, aux) -> float:
    """A ready batch's own time on its device: on a card, the CUDA events'
    elapsed time from before its uploads to after its rows' copy; on the
    CPU, the step's wall time (``aux["step_s"]``, 0 when a caller's
    dispatch gives none).  Under a mesh, the slowest entry's."""
    if isinstance(handle, _Meshed):
        return max(_device_seconds(h, a) for h, a in handle.parts)
    if handle[0] is None:
        return handle[1].elapsed_s()
    return aux.get("step_s", 0.0)


def _first_of_key(handle) -> bool:
    """True when a ready batch warmed up its key or captured its key's
    graph for the first time (under a mesh, on any entry)."""
    if isinstance(handle, _Meshed):
        return any(_first_of_key(h) for h, _aux in handle.parts)
    return handle[0] is None and handle[1].first_of_key


def _await_rows(handle) -> None:
    """Wait until a one-device batch's rows are on the host."""
    event = _landed(handle)[1]
    if event is not None:
        event.synchronize()


def _batch_ready(handle) -> bool:
    """True when a dispatched batch's work is done and its rows are on
    the host (under a mesh, every entry's)."""
    if isinstance(handle, _Meshed):
        return all(_batch_ready(h) for h, _aux in handle.parts)
    event = handle[1]
    return event is None or event.query()


def _drain_into(results, per_stream_blocks, item, on_done=None, huff=None):
    """Hand one dispatched batch's rows to the host tail.  A row whose
    sort tied re-encodes exactly on the host, here.  An exact-mode batch
    (``ranks``, ``rle2``) puts its blocks' tuples straight into
    ``results``: its sort never ties.

    A ``fast_huff`` batch drains asynchronously, as in the reference: each
    of its blocks gets a ``Future`` in ``results`` at once, and the
    finisher (``_drain_fast_huff``) runs on ``huff``, the encode's
    ``_huff_pool()``, so its device round trips and host heaps overlap the
    driver's next dispatch.  ``on_done`` (the driver's drain-rate hook)
    then fires from the finisher thread, when the blocks exist; a failed
    finisher sets its exception on every future of the batch.

    ``on_done(work_s, device_s)`` gets the lane's host work on the batch
    once its rows had landed (the drain here, or the finisher's run; not
    the wait for the rows, nor the hand-off to a finisher) and the batch's
    own device time (``_device_seconds``)."""
    chunk, (handle, aux) = item
    if aux.get("mode") == "fast_huff":
        from concurrent.futures import Future

        pool, slots = huff
        slots.acquire()  # bounds the batches whose device tensors are alive
        futs = {key: Future() for key in chunk}
        results.update(futs)

        def finish():
            nonlocal handle
            try:
                _await_rows(handle)
                t_work = time.monotonic()
                local: dict = {}
                _drain_fast_huff(local, per_stream_blocks, chunk, handle, aux)
                timing = (time.monotonic() - t_work, _device_seconds(handle, aux))
            except BaseException as e:
                for f in futs.values():
                    f.set_exception(e)
            else:
                for key, f in futs.items():
                    f.set_result(local[key])
                if on_done is not None:
                    on_done(*timing)
            finally:
                handle = None  # free the batch's device tensors now
                slots.release()

        pool.submit(finish)
        return
    _await_rows(handle)
    t_work = time.monotonic()
    out = _landed(handle)[0].numpy()
    mode = aux.get("mode")
    if mode in ("ranks", "rle2"):
        # the exact modes: no tie column, no host re-encode; the tuples go
        # to _assemble_stream, which writes their blocks
        b = len(chunk)
        unpacked = (
            _unpack_results_rle2(out, b)
            if mode == "rle2"
            else _unpack_results(out, aux["lens"], b, aux["n_max"])
        )
        results.update(zip(chunk, unpacked))
        if on_done is not None:
            on_done(time.monotonic() - t_work, _device_seconds(handle, aux))
        return
    bits = aux["bits"]
    tie_col = 2 if bits == 8 else 1  # rows [ptr, m, ties, ...] at bits 8
    ties = 0
    for i, ((si, bi), used) in enumerate(zip(chunk, aux["useds"])):
        blk = per_stream_blocks[si][bi]
        if int(out[i, tie_col]) != 0:
            from starch3_tpu_torch.codec.encoder import encode_block_fragment

            with span(device_stats, "tie_reencode"):
                results[(si, bi)] = encode_block_fragment(blk)
            ties += 1
        elif bits == 8:
            results[(si, bi)] = _submit_tail(_fragment_from_row, out[i], 8, used, blk.crc)
        else:
            results[(si, bi)] = _submit_tail(
                _fragment_from_ranks_row, out[i], used, blk.crc, int(aux["lens"][i]), bits
            )
    device_stats.add(**{"tie_reencodes": ties, f"tie_reencodes_bits{bits}": ties})
    if on_done is not None:
        on_done(time.monotonic() - t_work, _device_seconds(handle, aux))


def _after_all(n: int, fn):
    """A callable ``(work_s, device_s)`` that calls ``fn`` on its ``n``-th
    call, from whichever thread makes it, with the calls' summed host work
    and their longest device time: the drain-rate hook of a batch whose
    mesh entries drain separately (a ``fast_huff`` entry's finisher calls
    it when its blocks exist)."""
    if n == 1:
        return fn
    acc = [n, 0.0, 0.0]  # calls left, work, device
    lock = threading.Lock()

    def call(work_s: float, device_s: float) -> None:
        with lock:
            acc[0] -= 1
            acc[1] += work_s
            acc[2] = max(acc[2], device_s)
            last = acc[0] == 0
        if last:
            fn(acc[1], acc[2])

    return call


def _download(t: torch.Tensor) -> np.ndarray:
    """A device tensor's values on the host: a blocking copy on the
    calling thread's current stream, which waits for that stream only."""
    return t.cpu().numpy()


# device index -> the finishers' idle CUDA streams.  A finisher takes one
# and gives it back, so the finishers of a process reuse as many streams as
# run at once: the caching allocator keeps the blocks freed on a stream for
# that stream, and a fresh stream a batch (torch's pool has 32 a device)
# held up to 32 batches' blocks
_finisher_streams: dict = {}
_finisher_lock = threading.Lock()


def _take_finisher_stream(dev: torch.device):
    with _finisher_lock:
        idle = _finisher_streams.setdefault(dev.index, [])
        return idle.pop() if idle else torch.cuda.Stream(dev)


def _give_finisher_stream(dev: torch.device, stream) -> None:
    with _finisher_lock:
        _finisher_streams[dev.index].append(stream)


def _drain_fast_huff(results, per_stream_blocks, chunk, handle, aux) -> None:
    """Finish a ``fast_huff`` batch, the counterpart of the reference's
    ``_drain_fast_huff``: 4 device cost/select rounds, each followed by
    the native code-length heaps on the host, then one device emit of the
    coded bits; the host writes the block headers and splices in the
    words.  A block whose sort tied, or whose coded bits overflow the
    emit's capacity, is re-encoded on the host (the reference's rule).

    On a CUDA device the finisher waits for its batch's event only, and
    runs its device work on a stream of its own while it runs
    (``_take_finisher_stream``), so its round trips do not queue behind
    the driver's next dispatch; every read-back is a blocking copy on that
    stream, never a device-wide synchronize."""
    from starch3_tpu_torch.codec import huffman
    from starch3_tpu_torch.codec.encoder import encode_block_fragment, write_block_header
    from starch3_tpu_torch.runtime import (
        refine_lengths_batch_native,
        selector_mtf_native,
        write_block_header_native,
    )

    small_h, event, syms, m_d, hist = _landed(handle)
    n_max, bits = aux["n_max"], aux["bits"]
    dev = syms.device
    if event is not None:
        event.synchronize()
    small = small_h.numpy()
    d2h = small.nbytes
    b = len(chunk)
    ptrs, ms, ties, freqs = small[:, 0], small[:, 1], small[:, 2], small[:, 3:263]
    b_pad = small.shape[0]

    # host: initial tables + refinement bookkeeping (padded to 6 tables)
    lens = np.zeros((b_pad, N_TABLES, ALPHA_MAX), dtype=np.int32)
    masks = np.zeros((b_pad, N_TABLES), dtype=bool)
    n_groups = np.zeros(b_pad, dtype=np.int64)
    alphas = np.zeros(b_pad, dtype=np.int64)
    for i in range(b):
        alpha = int(aux["useds"][i].sum()) + 2
        m = int(ms[i])
        ng = huffman.n_groups_for(m)
        init = huffman.initial_lengths(freqs[i][:alpha].astype(np.int64), alpha, m)
        lens[i, :ng, :alpha] = init
        lens[i, :ng, alpha:] = huffman.GREATER_ICOST
        masks[i, :ng] = True
        n_groups[i] = ng
        alphas[i] = alpha
    masks[b:, 0] = True  # padding rows: keep the selection well-defined

    stream = None if event is None else _take_finisher_stream(dev)
    try:
        if stream is not None:
            stream.wait_event(event)
        with torch.cuda.stream(stream):
            masks_d = torch.from_numpy(masks).to(dev)
            sel_d = None
            for _ in range(huffman.N_ITERS):
                sel_d, rfreq_d = cost_and_select(hist, torch.from_numpy(lens).to(dev), masks_d)
                rfreq = _download(rfreq_d)
                d2h += rfreq.nbytes
                # one native call per round covers every (block, table) heap
                rfreq64 = np.ascontiguousarray(rfreq[:b], dtype=np.int64)
                if not refine_lengths_batch_native(rfreq64, n_groups[:b], alphas[:b], lens):
                    for i in range(b):
                        alpha = int(alphas[i])
                        for t in range(int(n_groups[i])):
                            lens[i, t, :alpha] = huffman.make_code_lengths(
                                rfreq[i, t, :alpha].astype(np.int64), alpha
                            )

            # canonical codes -> packed (code << 5) | len LUT per block
            luts = np.zeros((b_pad, N_TABLES * ALPHA_MAX), dtype=np.int32)
            for i in range(b):
                alpha = int(alphas[i])
                for t in range(int(n_groups[i])):
                    codes = huffman.assign_codes(lens[i, t, :alpha].astype(np.int64))
                    luts[i, t * ALPHA_MAX : t * ALPHA_MAX + alpha] = (
                        codes.astype(np.int64) << 5
                    ) | lens[i, t, :alpha]

            w_cap = _emit_w_cap(n_max)
            words_d, totals_d = emit_coded_padded(syms, m_d, sel_d, torch.from_numpy(luts).to(dev), n_max, w_cap)
            totals = _download(totals_d)
            # only the occupied prefix of the selectors (~m / 50) and of
            # the words (~the coded size) crosses the link
            n_sel_need = max((int(ms[i]) + GROUP_SIZE - 1) // GROUP_SIZE for i in range(b))
            sel = _download(sel_d[:, :n_sel_need])
            w_need = max((min(int(totals[i]), 32 * w_cap) + 31) // 32 for i in range(b))
            words = _download(words_d.view(torch.int32)[:, :w_need]).view(np.uint32)
            d2h += totals.nbytes + sel.nbytes + words.nbytes
    finally:
        if stream is not None:
            stream.synchronize()  # nothing of this batch may be freed in flight
            _give_finisher_stream(dev, stream)

    overflows = ties_n = 0
    for i, (si, bi) in enumerate(chunk):
        m = int(ms[i])
        total = int(totals[i])
        blk = per_stream_blocks[si][bi]
        if int(ties[i]) != 0 or total > 32 * w_cap:
            results[(si, bi)] = encode_block_fragment(blk)
            if int(ties[i]) != 0:
                ties_n += 1
            else:
                overflows += 1
            continue
        n_sel = (m + GROUP_SIZE - 1) // GROUP_SIZE
        selectors = sel[i, :n_sel].astype(np.int64)
        alpha = int(alphas[i])
        ng = int(n_groups[i])
        hdr = write_block_header_native(
            blk.crc, int(ptrs[i]), aux["useds"][i], lens[i, :ng, :alpha], selectors
        )
        frag = BitWriter()
        if hdr is not None:
            frag._out += hdr[0]
            frag._acc, frag._nbits = hdr[1], hdr[2]
        else:  # no native lib: the Python header writer
            sel_mtf = selector_mtf_native(selectors)
            if sel_mtf is None:
                pos = list(range(ng))
                sel_mtf = np.empty(n_sel, dtype=np.int64)
                for k, s in enumerate(selectors.tolist()):
                    j = pos.index(s)
                    sel_mtf[k] = j
                    pos.pop(j)
                    pos.insert(0, s)
            write_block_header(
                frag, blk.crc, int(ptrs[i]), aux["useds"][i], ng,
                lens[i, :ng, :alpha].astype(np.int64), sel_mtf,
            )
        # splice the device-packed words: whole bytes + a <8-bit tail
        raw = words[i, : (total + 31) // 32].astype(">u4").tobytes()
        full_bytes, tail_bits = divmod(total, 8)
        coded = BitWriter()
        coded._out += raw[:full_bytes]
        if tail_bits:
            coded._acc = raw[full_bytes] >> (8 - tail_bits)
            coded._nbits = tail_bits
        frag.append_writer(coded)
        results[(si, bi)] = frag
    device_stats.add(**{
        "tie_reencodes": ties_n, f"tie_reencodes_bits{bits}": ties_n,
        "huff_host_reencodes": overflows, f"huff_host_reencodes_bits{bits}": overflows,
        "d2h_bytes": d2h, f"d2h_bytes_bits{bits}": d2h,
    })


def _huff_pool():
    """A ``fast_huff`` encode's finisher executor and its in-flight bound,
    as the reference's: 2 threads, so that consecutive batches' rounds
    overlap (each finisher's 4 rounds are sequential), and 3 slots,
    bounding the batches whose symbols and histograms are alive on the
    device (two running, one queued).  Each encode makes its own and shuts
    it down at its end, so no finisher outlives the encode."""
    from concurrent.futures import ThreadPoolExecutor

    return ThreadPoolExecutor(2, thread_name_prefix="s3huff"), threading.Semaphore(3)


def _host_encode(q: _BlockQueue, results, key) -> None:
    """Encode one claimed block on the host, in the calling thread, and
    wake the assembler."""
    from starch3_tpu_torch.codec.encoder import encode_block_fragment

    si, bi = key
    results[key] = encode_block_fragment(q.per_stream_blocks[si][bi])
    with q.cond:
        q.cond.notify_all()


def _pop_for_host(q: _BlockQueue):
    """Claim one block from the back of the biggest bucket, as a stealer
    does, or None when every bucket is empty.  Caller holds ``q.cond``."""
    for nm in sorted(q.buckets, reverse=True):
        if q.buckets[nm]:
            return q.buckets[nm].pop()
    return None


def _abandon_batch(q: _BlockQueue, results, entry) -> None:
    """Take a stuck batch away from the device and bench it, the
    counterpart of the JAX ``_abandon_batch``.  Blocks go back to the
    queue front for the stealers; if no stealer thread is still alive
    (they exit when the queue momentarily drains after feeding), they are
    host-encoded right here, so the encode terminates either way.  A
    later duplicate encode of a re-enqueued block is benign (per-block
    byte determinism).  The caller keeps the batch's handles."""
    nm, (chunk, _handles) = entry[:2]
    with q.cond:
        q.device_demoted = True
        q.device_probe_at = time.monotonic() + host._DEMOTE_PROBE_S
        scheduler_stats.add(demotions=1, abandoned_batches=1)
        inline = q.live_stealers == 0
        if not inline:
            dq = q.buckets.setdefault(nm, q._deque())
            for key in reversed(chunk):
                dq.appendleft(key)
        q.cond.notify_all()
    if inline:
        for key in chunk:
            _host_encode(q, results, key)


def _device_driver(q: _BlockQueue, results, errors, device, batch_size, reserve, mode="fast",
                   huff=None):
    """The device side of the queue: claim batches from the front of a
    bucket, keep ``_PIPELINE_DEPTH`` in flight, drain the oldest, and
    leave the post-feeding tail to the stealer cores (``reserve``).
    Batches run in ``mode``; a ``fast_huff`` batch drains to a finisher
    on ``huff`` (``_drain_into``), and a finisher once started is not
    abandoned, as in the reference.

    ``device`` is a torch device or a ``BlockMesh``: a meshed batch is one
    unit for the claim loop, the rates, the probes and abandonment, and
    drains entry by entry in mesh order.

    The claim loop and its fault handling are those of the JAX
    ``_device_driver``.  ``claim_priority`` orders the buckets and
    ``class_gated`` routes a class to the stealers when its measured
    device rate loses to theirs.  The lane's drain rate (``note_drain``)
    benches ("demotes") the whole device when it falls below
    ``_DEMOTE_FRACTION`` of the stealers' aggregate; a benched device is
    probed with one batch every ``_DEMOTE_PROBE_S`` and resumes when the
    probe, rated by the same rule, runs fast enough.
    A batch not ready ``_ABANDON_S`` after its dispatch is abandoned
    (``_abandon_batch``) and the device benched, so a stalled stream
    cannot hang the encode.  With no stealer the driver itself host-encodes
    while benched, unless ``STARCH3_TPU_NO_HOST_FALLBACK=1``, which keeps a
    device-only encode pure: nothing is abandoned and the drain blocks.

    Only ``event.query()`` touches a batch that is not ready: a stalled
    stream blocks every synchronizing CUDA call behind it.  The handles of
    abandoned batches and of unfinished probes stay referenced until their
    rows land or the driver returns, so no pinned buffer that a pending copy
    still targets is dropped here.  The constants are read from ``host`` at
    call time.  Scheduling only: bytes are claim-order invariant."""
    pending: collections.deque = collections.deque()  # (nm, (chunk, handle), nbytes, t0, pack_s)
    orphans: list = []  # handles of batches given up on before their rows landed
    drain_clock = [None]
    fallback_ok = not host._no_host_fallback()

    def note_drain(nbytes: int, bits: int, t_dispatch: float, pack_s: float, handle, work_s: float,
                   device_s: float) -> None:
        # the lane's rate, in all and per alphabet class (read by
        # class_gated, kept for the next encode in _class_rate_cache).  A
        # batch queued behind another is rated drain to drain: the lane
        # was busy all that interval.  A batch dispatched after the last
        # drain found the pipeline dry, so its wait for blocks and its
        # latency (the launcher's queue, the copies' turnaround) are not
        # what the lane sustains at _PIPELINE_DEPTH: it is rated by its
        # own time, the driver's pack and drain (serial with each other)
        # against its device time (which overlaps them).  The first drain,
        # the first after an abandonment or a probe, and a batch that
        # warmed up or captured its key's graph (once per key, as the
        # reference's first call of a jitted step compiles it) only start
        # the clock.  The reference counts the wait for blocks and benches
        # a starved device (it resets the clock when its claim finds
        # nothing, which its claim loop never lets happen)
        now = time.monotonic()
        with q.cond:
            prev = drain_clock[0]
            drain_clock[0] = now
            if prev is None or now <= prev or _first_of_key(handle):
                return
            span = now - prev if t_dispatch < prev else max(pack_s + work_s, device_s)
            if span <= 0:
                return
            r = nbytes / span
            q.device_rate = r if q.device_rate is None else 0.6 * q.device_rate + 0.4 * r
            q.device_rate_samples += 1
            cr = q.class_rate.get(bits)
            q.class_rate[bits] = r if cr is None else 0.6 * cr + 0.4 * r
            q.class_samples[bits] = q.class_samples.get(bits, 0) + 1
            host._class_rate_cache[bits] = q.class_rate[bits]
            if (
                not q.device_demoted
                and q.n_stealers > 0
                and q.stealer_rate
                and q.device_rate_samples >= host._DEMOTE_MIN_SAMPLES
                and q.device_rate < host._DEMOTE_FRACTION * q.stealer_rate * q.n_stealers
            ):
                q.device_demoted = True
                q.device_probe_at = now + host._DEMOTE_PROBE_S
                scheduler_stats.add(demotions=1)
                q.cond.notify_all()

    def keep_orphan(handle) -> None:
        orphans[:] = [h for h in orphans if not _batch_ready(h)]
        orphans.append(handle)

    def head_ready() -> bool:
        return _batch_ready(pending[0][1][1][0])

    def drain_oldest() -> None:
        nm0, (chunk, (handle, aux)), nbytes, t0, pack_s = pending.popleft()
        items = _per_entry(chunk, handle, (handle, aux))
        on_done = _after_all(len(items), functools.partial(note_drain, nbytes, nm0[1], t0, pack_s, handle))
        for item in items:  # a mesh's entries in order, each as one batch
            _drain_into(results, q.per_stream_blocks, item, on_done=on_done, huff=huff)
        with q.cond:  # wake the incremental assembler
            q.cond.notify_all()

    def abandon_oldest() -> None:
        entry = pending.popleft()
        keep_orphan(entry[1][1][0])
        _abandon_batch(q, results, entry)
        # an interval spanning the wait would fake a low device rate
        drain_clock[0] = None

    def probe(chunk, nm) -> None:
        """The recovery probe, which holds no block hostage: dispatch the
        batch, host-encode the same blocks at once, then wait up to
        ``_ABANDON_S`` for the rows (host-encoding queued blocks meanwhile
        when no stealer is left) and repromote the device if they came
        fast enough, or re-arm the probe.  The rows are only a rate
        signal, so the rate is note_drain's for a dry pipeline with no
        drain: the pack against the device time.  The duplicate encode is
        byte-identical."""
        datas = [q.per_stream_blocks[si][bi].data for si, bi in chunk]
        nbytes = sum(map(len, datas))
        t0 = time.monotonic()
        handle, aux = _dispatch_chunk(datas, nm, device, pad_to=batch_size, mode=mode)
        pack_s = time.monotonic() - t0
        for key in chunk:
            _host_encode(q, results, key)
        while (
            not _batch_ready(handle)
            and time.monotonic() - t0 < host._ABANDON_S
            and not errors
            and not q.cancelled
        ):
            fill = None
            if fallback_ok:
                with q.cond:
                    if q.live_stealers == 0:
                        fill = _pop_for_host(q)
            if fill is not None:
                _host_encode(q, results, fill)
            else:
                time.sleep(0.01)
        ready = _batch_ready(handle)
        rate = nbytes / max(pack_s, _device_seconds(handle, aux), 1e-9) if ready else 0.0
        with q.cond:
            if ready and (
                not q.stealer_rate
                or rate >= host._DEMOTE_FRACTION * q.stealer_rate * q.n_stealers
            ):
                q.device_demoted = False
                q.device_rate = rate
                q.device_rate_samples = 1
                scheduler_stats.add(repromotions=1)
            else:
                q.device_probe_at = time.monotonic() + host._DEMOTE_PROBE_S
            q.cond.notify_all()
        if not ready:
            keep_orphan(handle)
        drain_clock[0] = None

    try:
        while True:
            chunk = inline_claim = None
            with q.cond:
                while True:
                    if errors or q.cancelled:
                        return
                    probe_due = q.device_demoted and time.monotonic() >= q.device_probe_at
                    if q.device_demoted and not probe_due:
                        # benched: the stealers own the queue.  Drain what
                        # is in flight first; with no stealer left the
                        # driver itself works the queue between probes
                        if pending or (not q.feeding and not any(q.buckets.values())):
                            break
                        if q.live_stealers == 0 and fallback_ok:
                            inline_claim = _pop_for_host(q)
                            if inline_claim is not None:
                                break
                        q.cond.wait(0.1)
                        continue
                    for nm in sorted(q.buckets, key=q.claim_priority):
                        dq = q.buckets[nm]
                        remaining = len(dq)
                        if remaining <= 0:
                            continue
                        if q.class_gated(nm[1], time.monotonic()):
                            scheduler_stats.add(class_skips=1)
                            device_stats.add(**{f"class_skips_bits{nm[1]}": 1})
                            continue
                        if q.active_feeding() and remaining < batch_size:
                            continue  # wait for a full batch while blocks arrive
                        take = min(batch_size, remaining)
                        if not q.feeding and reserve and remaining - take < reserve:
                            continue  # leave the tail to the host cores
                        chunk = [dq.popleft() for _ in range(take)]
                        q.device_claimed += take
                        this_nm = nm
                        break
                    if chunk is not None or pending or not q.feeding:
                        break
                    q.cond.wait(0.005)
                if chunk is None and inline_claim is None and not pending and not q.feeding:
                    break  # queue fully claimed; stealers own the rest
                # a claim made while benched is the recovery probe
                probing = chunk is not None and q.device_demoted
                # a single-block corpus gets a one-row batch: padding to
                # batch_size would triple the only dispatch of the run
                pad = batch_size
                if chunk is not None and len(chunk) == 1 and not q.feeding:
                    live = [bs for bs in q.per_stream_blocks if bs is not None]
                    if sum(map(len, live)) == 1:
                        pad = 1
            if inline_claim is not None:
                _host_encode(q, results, inline_claim)
                continue
            if probing:
                probe(chunk, this_nm)
                continue
            if chunk is not None:
                datas = [q.per_stream_blocks[si][bi].data for si, bi in chunk]
                t_dispatch = time.monotonic()
                handle = _dispatch_chunk(datas, this_nm, device, pad_to=pad, mode=mode)
                # the pack and dispatch are the lane's own time
                pending.append((this_nm, (chunk, handle), sum(map(len, datas)), t_dispatch,
                                time.monotonic() - t_dispatch))
                if len(pending) < _PIPELINE_DEPTH:
                    continue
            if not pending:
                continue
            # Pipeline full, or nothing claimable: drain the oldest batch
            # once its rows have landed, and block on it only while over
            # full.  A batch still not ready _ABANDON_S after its dispatch
            # is abandoned at any depth, unless nothing could take its
            # blocks (no stealer, no host fallback): then the drain blocks.
            abandon_ok = q.n_stealers > 0 or fallback_ok
            while pending:
                if errors or q.cancelled:
                    return
                if head_ready():
                    break
                if abandon_ok and time.monotonic() - pending[0][3] > host._ABANDON_S:
                    abandon_oldest()
                    continue
                if len(pending) < _PIPELINE_DEPTH or not abandon_ok:
                    break
                time.sleep(0.005)
            if pending and (len(pending) >= _PIPELINE_DEPTH or head_ready()):
                drain_oldest()
            elif chunk is None:
                time.sleep(0.002)  # nothing claimable, batch not ready
        abandon_ok = q.n_stealers > 0 or fallback_ok
        while pending:
            if errors or q.cancelled:
                return
            if abandon_ok and not head_ready():
                if time.monotonic() - pending[0][3] > host._ABANDON_S:
                    abandon_oldest()
                else:
                    time.sleep(0.005)
                continue
            drain_oldest()
    except BaseException as e:  # surfaced by the caller
        errors.append(e)


def encode_streams(
    texts: list[bytes],
    level: int = 9,
    device="cuda",
    batch_size: int = 3,
    device_rle2: bool = False,
    fast_bwt: bool = True,
    host_assist: bool | None = None,
    device_huffman: bool = False,
    mesh=None,
) -> list:  # list[codec.encoder.EncodedStream]
    """Compress many independent streams through one device queue; the
    counterpart of the JAX ``encode_streams``.  The device steps run on
    ``device``, or, given a ``mesh`` (``parallel/mesh.py``), on its entries,
    each on its slice of every batch; ``device`` is then ignored.  Output
    bytes equal the host encoder's."""
    return encode_streams_feed(
        iter(texts),
        level=level,
        device=device,
        mesh=mesh,
        batch_size=batch_size,
        device_rle2=device_rle2,
        fast_bwt=fast_bwt,
        host_assist=host_assist,
        device_huffman=device_huffman,
    )


def encode_streams_feed(
    text_iter,
    level: int = 9,
    device="cuda",
    batch_size: int = 3,
    device_rle2: bool = False,
    fast_bwt: bool = True,
    host_assist: bool | None = None,
    device_huffman: bool = False,
    mesh=None,
) -> list:  # list[codec.encoder.EncodedStream]
    """``encode_streams`` over a stream of texts: encoding begins while
    later texts are still being produced."""
    return list(
        encode_streams_iter(
            text_iter,
            level=level,
            device=device,
            mesh=mesh,
            batch_size=batch_size,
            device_rle2=device_rle2,
            fast_bwt=fast_bwt,
            host_assist=host_assist,
            device_huffman=device_huffman,
        )
    )


# cores kept beside a card for the threads of the feed and the device lane:
# the feed (``s3tfeed``), the driver (``s3tdevice``), the launcher
# (``s3tlaunch``) and the tail pool (``s3tail``)
_LANE_CORES = 4


def _host_threads(on_card: bool) -> tuple[int, int]:
    """(host stealers, split workers) of an encode.  On the CPU every
    core steals, as in the reference.  Beside a card the stealers and the
    split pool take the cores left after ``_LANE_CORES`` (at least 1 and
    2).  On an 8-core host (NVIDIA H100 80GB HBM3, 700 W, ``profile_lane``
    at 1.1e9 bytes of BED), 8 or 6 stealers left the lane's dry batches
    20-58 ms of host time each and benched a healthy card once (ROADMAP
    C4); 4 stealers and 4 split workers left them a few ms."""
    cores = os.cpu_count() or 2
    if not on_card:
        return cores, max(2, min(8, cores))
    free = max(1, cores - _LANE_CORES)
    return free, max(2, min(8, free))


def encode_streams_iter(
    text_iter,
    level: int = 9,
    device="cuda",
    batch_size: int = 3,
    device_rle2: bool = False,
    fast_bwt: bool = True,
    host_assist: bool | None = None,
    device_huffman: bool = False,
    window_bytes: int = 256 << 20,
    mesh=None,
):
    """Generator yielding each stream's EncodedStream in feed order as
    soon as all its blocks are done, while later texts are still being
    fed (at most ``window_bytes`` of block data in flight).

    ``host_assist`` (default: on when the native runtime is built and no
    ``mesh`` is given, as in the reference) runs every CPU core as a work
    stealer beside the device; off, every block goes through the device
    (or the mesh, which then replaces ``device``).  ``device_huffman`` runs
    ``mode="fast_huff"``, the Huffman stage on the device too;
    ``fast_bwt=False`` the exact modes, ``"ranks"``, or ``"rle2"`` with
    ``device_rle2`` (``encode_mode``).  Bytes are the same either way.

    ``device_stats`` counts the encode (``encodes``), its seconds from its
    start to its first block in the queue (``first_block_s``; an encode
    that feeds no block adds none) and the feed's waits on ``text_iter``
    (the span ``feed_source``: in ``api.compress_bed_stream`` the read,
    the native transform and the carry)."""
    started = time.perf_counter()
    device_stats.add(encodes=1)
    mode = encode_mode(fast_bwt, device_rle2, device_huffman)
    dev = mesh if mesh is not None else resolve_device(device)
    if host_assist is None:
        from starch3_tpu_torch.runtime import get_lib

        host_assist = mesh is None and get_lib() is not None

    q = _BlockQueue()
    q.steal_holdback = batch_size
    q.device_low_water = batch_size * _PIPELINE_DEPTH
    q.window_bytes = window_bytes
    # per-class tier rates from this process's earlier encodes (capped
    # sample credit: one fresh drain still re-rates quickly)
    q.class_rate.update(host._class_rate_cache)
    q.class_samples.update({b: host._CLASS_MIN_SAMPLES for b in host._class_rate_cache})
    results: dict = {}
    errors: list[BaseException] = []
    on_card = dev.type == "cuda" if isinstance(dev, torch.device) else any(d.type == "cuda" for d in dev.devices)
    n_stealers, split_width = _host_threads(on_card)
    if host_assist:
        q.n_stealers = n_stealers
    stealers = _start_host_stealers(q, results, errors, host_assist)
    reserve = _TAIL_RESERVE_PER_STEALER * len(stealers)
    huff = _huff_pool() if mode == "fast_huff" else None
    driver = threading.Thread(
        target=_device_driver,
        args=(q, results, errors, dev, batch_size, reserve, mode, huff),
        name="s3tdevice",
        daemon=True,
    )
    driver.start()

    def run_feed():
        """Feeder: the caller's iterator runs here; segmentation and
        classing run in order on a small prefetch pool (the natives
        release the GIL).  What is split is fed before the next text is
        asked for: a slow source (the streaming parser of
        ``api.compress_bed_stream``) would otherwise hold back every
        block until the prefetch is full, ``width + 2`` texts (the
        reference's feeder waits so)."""
        from concurrent.futures import ThreadPoolExecutor

        width = split_width
        first = True  # no block fed yet

        def feed(split) -> None:
            nonlocal first
            q.feed_blocks(*split)
            if first and split[0]:
                first = False
                device_stats.add(first_block_s=time.perf_counter() - started)

        try:
            with ThreadPoolExecutor(width, thread_name_prefix="s3tsplit") as ex:
                futs: collections.deque = collections.deque()
                it = iter(text_iter)
                exhausted = False
                while True:
                    while not exhausted and len(futs) < width + 2 and not (errors or q.cancelled):
                        while futs and futs[0].done():
                            feed(futs.popleft().result())
                        try:
                            with span(device_stats, "feed_source"):
                                text = next(it)
                        except StopIteration:
                            exhausted = True
                            break
                        futs.append(ex.submit(_split_classify, text, level))
                    if not futs or errors or q.cancelled:
                        break
                    feed(futs.popleft().result())
        except BaseException as e:  # surfaced by the generator below
            errors.append(e)
        finally:
            q.finish_feeding()

    feeder = threading.Thread(target=run_feed, name="s3tfeed", daemon=True)
    feeder.start()

    next_si = 0
    try:
        while True:
            blocks = None
            with q.cond:
                while True:
                    if errors:
                        raise errors[0]
                    if next_si < len(q.per_stream_blocks):
                        cand = q.per_stream_blocks[next_si]
                        if all((next_si, bi) in results for bi in range(len(cand))):
                            blocks = cand
                            break
                    elif not q.feeding:
                        break
                    q.cond.wait(0.05)
            if blocks is None:
                break
            enc = _assemble_stream(blocks, results, next_si, level)
            with q.cond:
                # release the yielded stream and open the feeder's window
                q.per_stream_blocks[next_si] = None
                q.inflight_bytes -= sum(len(b.data) for b in blocks)
                for bi in range(len(blocks)):
                    results.pop((next_si, bi), None)
                q.cond.notify_all()
            next_si += 1
            yield enc
        driver.join()
        for t in stealers:
            t.join()
        feeder.join()
        if errors:
            raise errors[0]
    finally:
        # early close or error: stop the feeder, then let the workers
        # finish what they claimed before control returns
        with q.cond:
            q.cancelled = True
            q.cond.notify_all()
        q.finish_feeding()
        feeder.join()
        driver.join()
        for t in stealers:
            t.join()
        if huff is not None:  # the finishers of batches drained before the end
            huff[0].shutdown(wait=True)


def torch_bz2_compress(data: bytes, config=None, device="cuda", mesh=None) -> bytes:
    """bzip2-compatible compression of one stream with the heavy stages
    on ``device``, or on the entries of ``mesh``; the counterpart of
    ``jax_bz2_compress``."""
    level = config.block_size_100k if config is not None else 9
    batch_size = config.blocks_per_batch if config is not None else 3
    return encode_streams(
        [data],
        level=level,
        device=device,
        mesh=mesh,
        batch_size=batch_size,
        device_rle2=getattr(config, "device_rle2", False),
        fast_bwt=getattr(config, "fast_bwt", True),
        device_huffman=getattr(config, "device_huffman", False),
    )[0].data


# ---------------------------------------------------------------------------
# Device decode, the counterpart of the JAX package's decode half.  The
# host walks each block's bits down to Huffman-decoded RLE2 symbols (bit
# positions are inherently sequential), the device runs inverse RLE2 ->
# MTF -> BWT batched over every stream's blocks, and the host finishes with
# the RLE1 inversion and the CRCs.
# ---------------------------------------------------------------------------


def step_decode(syms: torch.Tensor, m: torch.Tensor, alphabet: torch.Tensor, ptr: torch.Tensor, n_max: int):
    """The decode step, counterpart of ``_jitted_device_decode_step(n_max)``.

    Args:
      syms: int32[B, n_max] RLE2 symbols, EOB stripped
      m: int32[B] symbol counts
      alphabet: int32[B, 256] each block's used bytes in order
      ptr: int32[B] orig_ptr of each block
      n_max: the bucket, a multiple of 512
    Returns:
      (blocks uint8[B, n_max], n int32[B]): each block's bytes as the BWT
      took them, RLE1-coded (the valid prefix of length n), and n as the
      symbols expand, which the host holds to its own count.
    """
    ranks, n = irle2_decode_padded(syms, m, n_max)
    n_c = torch.clamp(n, max=n_max)  # corrupt streams: the host re-validates n
    byts = imtf_decode_padded(ranks, n_c, alphabet, n_max)
    return ibwt_padded(byts.to(torch.uint8), ptr, n_c, n_max), n


def _rle2_decoded_len(syms: np.ndarray) -> int:
    """Decoded byte count of an RLE2 symbol stream (EOB stripped) — the
    host-side twin of the contribution sum in ops/irle2_jax.py; used to
    pick the geometry bucket and validate before dispatch."""
    if syms.size == 0:
        return 0
    is_run = syms <= 1
    t = np.arange(syms.size, dtype=np.int64)
    starts = is_run & np.concatenate([[True], ~is_run[:-1]])
    start_pos = np.maximum.accumulate(np.where(starts, t, -1))
    k = np.minimum(t - start_pos, 21)
    contrib = np.where(is_run, (syms.astype(np.int64) + 1) << k, 1)
    return int(contrib.sum())


def read_stream_blocks(stream: bytes):
    """The host half before the device: walk one bzip2 stream's blocks down
    to their RLE2 symbols (native, or the Python walk without the native
    runtime) and check each block's geometry.  Returns (blocks, stored
    stream CRC), each block ``(crc, ptr, in_use, symbols, n_exp,
    randomised)``.  Raises ``FormatError`` on a corrupt stream."""
    if len(stream) < 4 or stream[:3] != b"BZh":
        raise FormatError("bzip2: bad stream header")
    level = stream[3] - 0x30
    if not 1 <= level <= 9:
        raise FormatError("bzip2: bad block-size digit")
    max_block = 100_000 * level + 64
    br = BitReader(stream)
    br.read(32)
    blocks = []
    while True:
        magic_pos = br.bit_pos
        magic = br.read(48)
        if magic == STREAM_END_MAGIC:
            return blocks, br.read(32)
        if magic != BLOCK_MAGIC:
            raise FormatError("bzip2: bad block magic")
        try:
            native = read_block_symbols_native(stream, magic_pos, level)
        except ValueError as e:
            raise FormatError(str(e)) from None
        if native is not None:
            crc, ptr, in_use, symbols, next_pos, randomised = native
            br._pos = next_pos
        else:
            crc, ptr, in_use, symbols, randomised = read_block_symbols(br)
        n_exp = _rle2_decoded_len(np.asarray(symbols))
        if not 0 < n_exp <= max_block or ptr >= n_exp:
            raise FormatError("bzip2: bad block geometry")
        blocks.append((crc, ptr, in_use, np.asarray(symbols), n_exp, randomised))


def pack_decode_batch(block_metas, n_max: int, pin: bool = False, b_pad: int | None = None):
    """The step's inputs for ``read_stream_blocks`` blocks: (syms int32[B,
    n_max], m int32[B], alphabet int32[B, 256], ptr int32[B]) on the CPU,
    pinned with ``pin``, padded to ``b_pad`` rows of no symbols (which
    decode to nothing)."""
    b = max(len(block_metas), b_pad or 0)
    syms = torch.zeros((b, n_max), dtype=torch.int32, pin_memory=pin)
    ms = torch.zeros(b, dtype=torch.int32, pin_memory=pin)
    alphas = torch.zeros((b, 256), dtype=torch.int32, pin_memory=pin)
    ptrs = torch.zeros(b, dtype=torch.int32, pin_memory=pin)
    syms_np, ms_np, alphas_np, ptrs_np = (t.numpy() for t in (syms, ms, alphas, ptrs))
    for i, (_crc, ptr, in_use, symbols, _n_exp, _rand) in enumerate(block_metas):
        syms_np[i, : symbols.size] = symbols
        ms_np[i] = symbols.size
        seq = np.flatnonzero(in_use)
        alphas_np[i, : seq.size] = seq
        ptrs_np[i] = ptr
    return syms, ms, alphas, ptrs


def decode_streams(stream_datas: list[bytes], device="cuda", batch_size: int = 8, mesh=None) -> list[bytes]:
    """Decompress many bzip2 streams through one device queue; the
    counterpart of the JAX ``decode_streams``.  The step runs on
    ``device``, or, given a ``mesh``, on each entry for its slice of every
    batch, padded to a multiple of the mesh's size; ``device`` is then
    ignored.

    Every stream's blocks share geometry-bucketed batches of
    ``batch_size``, pipelined two deep: batch k+1 is dispatched before
    batch k is drained.  The bytes equal the host decoder's, and any
    corruption, a CRC mismatch included, is a ``FormatError``.
    ``device_stats`` counts ``decode_batches`` and ``decode_blocks``."""
    device = mesh if mesh is not None else resolve_device(device)
    per_stream = [read_stream_blocks(stream) for stream in stream_datas]

    by_bucket: dict[int, list[tuple[int, int]]] = {}
    for si, (blocks, _stored) in enumerate(per_stream):
        for bi, blk in enumerate(blocks):
            by_bucket.setdefault(host._bucket_for(blk[4]), []).append((si, bi))

    decoded: dict[tuple[int, int], bytes] = {}
    for n_max, items in by_bucket.items():
        pending = []
        for lo in range(0, len(items), batch_size):
            chunk = items[lo : lo + batch_size]
            metas = [per_stream[si][0][bi] for si, bi in chunk]
            pending.append((chunk, _dispatch_decode_chunk(metas, n_max, device)))
            if len(pending) > 1:
                _drain_decode(decoded, per_stream, pending.pop(0))
        while pending:
            _drain_decode(decoded, per_stream, pending.pop(0))

    out = []
    for si, (blocks, stored) in enumerate(per_stream):
        combined = 0
        parts = []
        for bi, (crc, *_rest) in enumerate(blocks):
            data = rle1_decode(decoded[(si, bi)])
            if crc32_bytes(data) != crc:
                raise FormatError("bzip2: block CRC mismatch")
            combined = combine_block_crc(combined, crc)
            parts.append(data)
        if combined != stored:
            raise FormatError("bzip2: stream CRC mismatch")
        out.append(b"".join(parts))
    return out


def _dispatch_decode_chunk(block_metas, n_max: int, device):
    """Upload and launch one decode batch without waiting for it, on
    ``device`` or, when it is a ``BlockMesh``, split over its entries
    (``_Meshed`` parts).  Counts one batch in ``device_stats``."""
    device_stats.add(decode_batches=1, decode_blocks=len(block_metas))
    if isinstance(device, BlockMesh):
        return _dispatch_meshed(
            device, len(block_metas),
            lambda rows, dev: _dispatch_decode_one(block_metas[rows], n_max, dev, rows.stop - rows.start),
        )
    return _dispatch_decode_one(block_metas, n_max, device)


def _dispatch_decode_one(block_metas, n_max: int, device: torch.device, b_pad: int | None = None):
    """``_dispatch_decode_chunk`` on one device, on its current stream,
    padded to ``b_pad`` rows.  Returns (blocks, n, event): on a CUDA device
    pinned host tensors that non-blocking copies are filling and the event
    that marks the end of the batch's work; on the CPU the results and
    None."""
    cuda = device.type == "cuda"
    args = tuple(
        t.to(device, non_blocking=True) for t in pack_decode_batch(block_metas, n_max, pin=cuda, b_pad=b_pad)
    )
    blocks, n = step_decode(*args, n_max)
    if not cuda:
        return blocks, n, None
    out = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in (blocks, n))
    for dst, src in zip(out, (blocks, n)):
        dst.copy_(src, non_blocking=True)
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    return out + (event,)


def _drain_decode(decoded, per_stream, item) -> None:
    """Wait for one dispatched decode batch (under a mesh, each entry's
    part in order) and keep each block's bytes, de-randomising legacy
    randomised blocks.  A block that did not expand to the host's count is
    a ``FormatError``."""
    chunk, handle = item
    for part in _per_entry(chunk, handle, handle):
        _drain_decode_one(decoded, per_stream, part)


def _drain_decode_one(decoded, per_stream, item) -> None:
    """``_drain_decode`` of one device's part."""
    chunk, (blocks_t, n_t, event) = item
    if event is not None:
        event.synchronize()
    blocks = blocks_t.numpy()
    ns = n_t.numpy()
    for i, (si, bi) in enumerate(chunk):
        n_exp = per_stream[si][0][bi][4]
        if int(ns[i]) != n_exp:
            raise FormatError("bzip2: inconsistent block expansion")
        out_block = blocks[i, :n_exp]
        if per_stream[si][0][bi][5]:  # legacy randomised block
            out_block = derandomize(out_block)
        decoded[(si, bi)] = out_block.tobytes()
