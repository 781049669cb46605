"""Native host runtime loader (ctypes over runtime.cpp).

The port's own copy of ``starch3_tpu/runtime``: the same ``runtime.cpp``
and the same entry points, so the host path's bytes are the JAX
package's.  Only the build differs: the library is built with g++ at
first use into the repository's ``build/`` (``_build.build_host``),
named by a hash of the source and the flags, never next to the source.
Every entry point has a NumPy fallback so the package works without a
toolchain; ``get_lib()`` says which one runs.  The dense packs of the
device lane (``dense_pack4_native``, ``dense_pack_words_native``) call the
same library through a second, ``ctypes.PyDLL`` handle, which keeps the
GIL for the call.

The environment knobs keep their names: STARCH3_TPU_NO_NATIVE skips the
library, STARCH3_TPU_NO_SIMD drops ``-march=native`` (the scalar paths),
STARCH3_TPU_CFLAGS appends compiler flags, e.g. for a sanitizer run:

    STARCH3_TPU_CFLAGS="-O1 -g -fsanitize=address,undefined -fno-sanitize-recover=undefined" \
        LD_PRELOAD=$(g++ -print-file-name=libasan.so) ASAN_OPTIONS=detect_leaks=0 \
        python -m pytest tests/test_torch_*.py -q
"""

from __future__ import annotations

import ctypes
import os
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "runtime.cpp"
_lock = threading.Lock()
_lib = None
_gil_lib = None  # the same library through ctypes.PyDLL: its calls keep the GIL
_tried = False
lib_path: Path | None = None  # the loaded library, once get_lib() found one


def _flags() -> tuple[str, ...]:
    arch = () if os.environ.get("STARCH3_TPU_NO_SIMD") else ("-march=native",)
    extra = tuple(os.environ.get("STARCH3_TPU_CFLAGS", "").split())
    return ("-O3", *arch, "-shared", "-fPIC", "-std=c++17", *extra)


def get_lib():
    """The loaded native library, or None (fallback mode).  Safe to call
    from several threads at once: ``_tried`` is set only after ``_lib``,
    so a thread that finds the load under way waits for it on the lock
    rather than taking None."""
    global _lib, _gil_lib, _tried, lib_path
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        try:
            loaded = _load()
            if loaded is not None:
                _lib, _gil_lib, lib_path = loaded
        finally:
            _tried = True
        return _lib


def _load():
    """Build (into ``build/``) and load the library: ``(CDLL, PyDLL,
    path)``, or None."""
    if os.environ.get("STARCH3_TPU_NO_NATIVE"):
        return None
    from starch3_tpu_torch._build import build_host

    try:
        path = build_host("runtime", _SRC, _flags())
        lib = ctypes.CDLL(str(path))
    except (OSError, RuntimeError):
        return None
    lib.s3_make_code_lengths.restype = ctypes.c_int
    lib.s3_make_code_lengths.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p,
    ]
    lib.s3_pack_bits.restype = ctypes.c_int64
    lib.s3_pack_bits.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_uint64, ctypes.c_int32, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.s3_mtf_ranks.restype = None
    lib.s3_mtf_ranks.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_void_p,
    ]
    lib.s3_rle1_encode.restype = ctypes.c_int64
    lib.s3_rle1_encode.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
    ]
    lib.s3_rle1_decode.restype = ctypes.c_int64
    lib.s3_rle1_decode.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
    ]
    lib.s3_rle1_split.restype = ctypes.c_int64
    lib.s3_rle1_split.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,
    ]
    lib.s3_bz2_decompress.restype = ctypes.c_int64
    lib.s3_bz2_decompress.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
    ]
    lib.s3_bz2_decode_block.restype = ctypes.c_int64
    lib.s3_bz2_decode_block.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
    ]
    lib.s3_refine_lengths_batch.restype = ctypes.c_int32
    lib.s3_refine_lengths_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p,
    ]
    lib.s3_selector_mtf.restype = None
    lib.s3_selector_mtf.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
    ]
    lib.s3_read_block_symbols.restype = ctypes.c_int64
    lib.s3_read_block_symbols.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p,
    ]
    lib.s3_bwt.restype = ctypes.c_int64
    lib.s3_bwt.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
    lib.s3_rle2_from_ranks.restype = ctypes.c_int64
    lib.s3_rle2_from_ranks.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.s3_bed_transform.restype = ctypes.c_int64
    lib.s3_bed_transform.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.s3_untransform_bed.restype = ctypes.c_int64
    lib.s3_untransform_bed.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
    ]
    lib.s3_encode_block.restype = ctypes.c_int64
    lib.s3_encode_block.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint32,
        ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.s3_encode_tail.restype = ctypes.c_int64
    lib.s3_encode_tail.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_int32, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_uint32, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.s3_write_block_header.restype = ctypes.c_int64
    lib.s3_write_block_header.argtypes = [
        ctypes.c_uint32, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.s3_crc32.restype = ctypes.c_uint32
    lib.s3_crc32.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.s3_append_shifted.restype = ctypes.c_int64
    lib.s3_append_shifted.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_uint64, ctypes.c_void_p,
    ]
    lib.s3_count_distinct.restype = ctypes.c_int32
    lib.s3_count_distinct.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.s3_parse_ints.restype = ctypes.c_int64
    lib.s3_parse_ints.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_void_p,
    ]
    lib.s3_emit_decimals.restype = None
    lib.s3_emit_decimals.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int64,
    ]
    # the device lane's packs take about a millisecond a block: letting
    # the GIL go around each and winning it back beside a busy feed and
    # the host stealers cost the lane tens of ms a batch (ROADMAP C4)
    gil = ctypes.PyDLL(str(path))
    gil.s3_dense_pack4.restype = ctypes.c_int32
    gil.s3_dense_pack4.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
    ]
    gil.s3_dense_pack_words.restype = ctypes.c_int32
    gil.s3_dense_pack_words.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    return lib, gil, path


def crc32_native(data: bytes) -> int | None:
    """bzip2 MSB-first CRC-32 (runtime.cpp s3_crc32), or None."""
    lib = get_lib()
    if lib is None or not data:
        return None
    arr = np.frombuffer(data, dtype=np.uint8)
    return int(lib.s3_crc32(arr.ctypes.data, arr.size))


def make_code_lengths_native(freq: np.ndarray, alpha_size: int, max_len: int):
    """Native Huffman lengths, or None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    freq = np.ascontiguousarray(freq, dtype=np.int64)
    out = np.empty(alpha_size, dtype=np.int32)
    rc = lib.s3_make_code_lengths(
        freq.ctypes.data, alpha_size, max_len, out.ctypes.data
    )
    if rc != 0:
        return None
    return out.astype(np.int64)


def pack_bits_native(values: np.ndarray, nbits: np.ndarray, acc: int, acc_nbits: int):
    lib = get_lib()
    if lib is None:
        return None
    values = np.ascontiguousarray(values, dtype=np.uint64)
    nbits32 = np.ascontiguousarray(nbits, dtype=np.int32)
    total_bits = acc_nbits + int(nbits32.sum())
    out = np.empty(total_bits // 8 + 16, dtype=np.uint8)
    tail = ctypes.c_uint64()
    tail_nbits = ctypes.c_int32()
    n = lib.s3_pack_bits(
        values.ctypes.data, nbits32.ctypes.data, values.size,
        acc, acc_nbits, out.ctypes.data,
        ctypes.byref(tail), ctypes.byref(tail_nbits),
    )
    return out[:n].tobytes(), int(tail.value), int(tail_nbits.value)


def write_block_header_native(
    crc: int, orig_ptr: int, in_use: np.ndarray, lens: np.ndarray,
    sels: np.ndarray,
):
    """Serialize one block's pre-coded-data header (magics, CRC,
    origPtr, used map, selector MTF+unary, delta-coded tables) in one
    native call (runtime.cpp s3_write_block_header).  ``lens`` is
    int-castable [n_groups, alpha]; ``sels`` are RAW table ids (MTF
    happens natively).  Returns (bytes, tail_acc, tail_nbits) or None
    (no lib / invalid inputs -> caller uses the Python writer)."""
    lib = get_lib()
    if lib is None:
        return None
    lens32 = np.ascontiguousarray(lens, dtype=np.int32)
    n_groups, alpha = lens32.shape
    sels32 = np.ascontiguousarray(sels, dtype=np.int32)
    used8 = np.ascontiguousarray(in_use, dtype=np.uint8)
    if used8.size != 256:
        # the native serializer reads exactly 256 entries unconditionally;
        # a shorter map would be an out-of-bounds read
        return None
    cap = 4096 + sels32.size  # map+tables < 1 kB; selectors <= 6 bits each
    out = np.empty(cap, dtype=np.uint8)
    tail = ctypes.c_uint64()
    tail_nbits = ctypes.c_int32()
    n = lib.s3_write_block_header(
        crc & 0xFFFFFFFF, orig_ptr, used8.ctypes.data,
        n_groups, alpha, lens32.ctypes.data,
        sels32.ctypes.data, sels32.size,
        out.ctypes.data, cap,
        ctypes.byref(tail), ctypes.byref(tail_nbits),
    )
    if n < 0:
        return None
    return out[:n].tobytes(), int(tail.value), int(tail_nbits.value)


def append_shifted_into(dst: bytearray, src, nbits: int, acc: int):
    """Bit-shifted splice for the stream assembler (runtime.cpp
    s3_append_shifted): grows ``dst`` by len(src) and writes the merged
    bytes straight into the tail (no intermediate buffer).  Returns the
    new accumulator, or None (no lib / nbits out of 1..7) — caller
    falls back to the NumPy formulation."""
    lib = get_lib()
    if lib is None or not (0 < nbits < 8):
        return None
    a = np.frombuffer(src, dtype=np.uint8)
    if a.size == 0:
        return acc & ((1 << nbits) - 1)
    start = len(dst)
    dst += bytes(a.size)
    out = np.frombuffer(memoryview(dst)[start:], dtype=np.uint8)
    new_acc = lib.s3_append_shifted(
        a.ctypes.data, a.size, nbits, acc, out.ctypes.data
    )
    if new_acc < 0:
        del dst[start:]
        return None
    return int(new_acc)


def count_distinct_native(buf) -> int | None:
    """Distinct-byte count of a buffer (runtime.cpp s3_count_distinct),
    or None without the lib."""
    lib = get_lib()
    if lib is None:
        return None
    a = np.frombuffer(buf, dtype=np.uint8)
    if a.size == 0:
        return 0
    return int(lib.s3_count_distinct(a.ctypes.data, a.size))


def append_shifted_at(dst, pos: int, src, nbits: int, acc: int):
    """Like append_shifted_into, but writes into the PREALLOCATED
    region dst[pos : pos+len(src)] (the one-allocation stream
    assembler, pipeline._assemble_stream).  Returns the new acc or
    None."""
    lib = get_lib()
    if lib is None or not (0 < nbits < 8):
        return None
    a = np.frombuffer(src, dtype=np.uint8)
    if a.size == 0:
        return acc & ((1 << nbits) - 1)
    out = np.frombuffer(memoryview(dst)[pos : pos + a.size], dtype=np.uint8)
    new_acc = lib.s3_append_shifted(
        a.ctypes.data, a.size, nbits, acc, out.ctypes.data
    )
    if new_acc < 0:
        return None
    return int(new_acc)


def mtf_ranks_native(seq: np.ndarray, n_sym: int):
    lib = get_lib()
    if lib is None:
        return None
    seq = np.ascontiguousarray(seq, dtype=np.int32)
    out = np.empty(seq.size, dtype=np.int32)
    lib.s3_mtf_ranks(seq.ctypes.data, seq.size, n_sym, out.ctypes.data)
    return out


def rle1_split_native(data: bytes, level: int):
    """Native block segmentation; returns (out_buf bytes, block_offsets,
    src_bounds) or None."""
    lib = get_lib()
    if lib is None:
        return None
    arr = np.frombuffer(data, dtype=np.uint8)
    out_cap = arr.size + arr.size // 4 + 64
    out = np.empty(out_cap, dtype=np.uint8)
    max_blocks = arr.size // (100_000 * level - 19) + 4
    offsets = np.zeros(max_blocks + 1, dtype=np.int64)
    bounds = np.zeros(max_blocks + 1, dtype=np.int64)
    nb = lib.s3_rle1_split(
        arr.ctypes.data, arr.size, level, out.ctypes.data, out_cap,
        offsets.ctypes.data, bounds.ctypes.data, max_blocks,
    )
    if nb < 0:
        return None
    return out, offsets[: nb + 1], bounds[:nb]


def rle2_from_ranks_native(ranks: np.ndarray, n_in_use: int):
    """(symbols int32[m], freq int64[alpha]) or None."""
    lib = get_lib()
    if lib is None:
        return None
    ranks = np.ascontiguousarray(ranks, dtype=np.uint8)
    out = np.empty(ranks.size + 2, dtype=np.uint16)
    freq = np.zeros(n_in_use + 2, dtype=np.int64)
    m = lib.s3_rle2_from_ranks(
        ranks.ctypes.data, ranks.size, n_in_use, out.ctypes.data, freq.ctypes.data
    )
    # keep the native uint16 layout: the downstream consumer
    # (s3_encode_tail) takes uint16, so an int32 round trip here cost
    # two full-array copies per block on the hot tail path
    return out[:m], freq


def parse_ints_native(arr: np.ndarray, starts: np.ndarray, ends: np.ndarray):
    """int64 field values, or None; raises ValueError on a bad field."""
    lib = get_lib()
    if lib is None:
        return None
    arr = np.ascontiguousarray(arr, dtype=np.uint8)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    ends = np.ascontiguousarray(ends, dtype=np.int64)
    out = np.empty(starts.size, dtype=np.int64)
    rc = lib.s3_parse_ints(
        arr.ctypes.data, starts.ctypes.data, ends.ctypes.data, starts.size,
        out.ctypes.data,
    )
    if rc < 0:
        raise ValueError(f"bad integer field at record {-(rc + 1)}")
    return out


def emit_decimals_native(
    out: np.ndarray, offsets: np.ndarray, vals: np.ndarray, lens: np.ndarray
) -> bool:
    lib = get_lib()
    if lib is None:
        return False
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    vals = np.ascontiguousarray(vals, dtype=np.int64)
    lens = np.ascontiguousarray(lens, dtype=np.int64)
    assert out.dtype == np.uint8 and out.flags.c_contiguous
    lib.s3_emit_decimals(
        out.ctypes.data, offsets.ctypes.data, vals.ctypes.data,
        lens.ctypes.data, vals.size,
    )
    return True


def bed_transform_native(data):
    """Fused BED parse + delta transform (runtime.cpp s3_bed_transform).

    ``data`` is any contiguous byte buffer (``bytes``, ``bytearray``,
    ``memoryview``, a uint8 NumPy array).  Returns a list of 6-tuples
    (chrom_name: str, text, line_count, base_count_nonunique,
    base_count_unique, raw_input_offset) in input order — raw_input_offset
    is the byte offset of the group's first line in ``data`` — or None to
    fall back to the NumPy path (unavailable runtime, or any parse error —
    the fallback re-raises with exact diagnostics).

    Each ``text`` is a read-only ``memoryview`` of one buffer the native
    pass wrote, not a copy: copying a chunk's text to ``bytes`` holds the
    GIL, which starves the threads beside the feed.  It equals the JAX
    package's ``bytes`` under ``==``, and every consumer of a text (the
    block split, the host encoders, ``len``) takes a buffer.
    """
    lib = get_lib()
    if lib is None or not len(data):
        return None
    arr = np.frombuffer(data, dtype=np.uint8)
    # optimistic capacities first (counting newlines to size exactly costs
    # a full extra pass over corpus-scale inputs); -2 = capacity -> retry
    # once with the worst-case bound before giving up
    for attempt in range(2):
        if attempt == 0:
            out_cap = arr.size + arr.size // 4 + 4096
            max_chroms = 65536
        else:
            n_lines = int(np.count_nonzero(arr == 10)) + 1
            out_cap = arr.size + 48 * n_lines + 64
            max_chroms = n_lines + 1
        out = np.empty(out_cap, dtype=np.uint8)
        # the C side writes text_offsets[0]; np.empty everywhere (entries
        # past nc are never read)
        text_offsets = np.empty(max_chroms + 1, dtype=np.int64)
        name_offsets = np.empty(max_chroms, dtype=np.int64)
        name_lens = np.empty(max_chroms, dtype=np.int64)
        line_counts = np.empty(max_chroms, dtype=np.int64)
        nonuniq = np.empty(max_chroms, dtype=np.int64)
        uniq = np.empty(max_chroms, dtype=np.int64)
        nc = lib.s3_bed_transform(
            arr.ctypes.data, arr.size, out.ctypes.data, out_cap, max_chroms,
            text_offsets.ctypes.data, name_offsets.ctypes.data,
            name_lens.ctypes.data, line_counts.ctypes.data,
            nonuniq.ctypes.data, uniq.ctypes.data,
        )
        if nc != -2:
            break
    if nc < 0:
        return None
    buf = memoryview(out).toreadonly()
    result = []
    for k in range(nc):
        name = arr[name_offsets[k] : name_offsets[k] + name_lens[k]].tobytes()
        result.append(
            (
                name.decode("ascii"),
                buf[text_offsets[k] : text_offsets[k + 1]],
                int(line_counts[k]),
                int(nonuniq[k]),
                int(uniq[k]),
                # raw-input offset of the group's first line (the start of
                # its span in ``data``; consumers slice group k's raw text
                # as data[off_k : off_{k+1}])
                int(name_offsets[k]),
            )
        )
    return result


def encode_block_native(data: bytes, crc: int):
    """Full post-RLE1 block encode (runtime.cpp s3_encode_block):
    (fragment_bytes, tail_acc, tail_nbits) or None."""
    lib = get_lib()
    if lib is None:
        return None
    arr = np.frombuffer(data, dtype=np.uint8)
    cap = arr.size * 3 + 8192
    out = np.empty(cap, dtype=np.uint8)
    tail = ctypes.c_uint64()
    tail_nbits = ctypes.c_int32()
    n = lib.s3_encode_block(
        arr.ctypes.data, arr.size, crc, out.ctypes.data, cap,
        ctypes.byref(tail), ctypes.byref(tail_nbits),
    )
    if n < 0:
        return None
    return out[:n].tobytes(), int(tail.value), int(tail_nbits.value)


def encode_tail_native(
    syms: np.ndarray,
    freq: np.ndarray,
    in_use: np.ndarray,
    orig_ptr: int,
    crc: int,
):
    """Block tail from device results (runtime.cpp s3_encode_tail):
    Huffman refinement + serialization over a precomputed RLE2 symbol
    stream.  Returns (fragment_bytes, tail_acc, tail_nbits) or None."""
    lib = get_lib()
    if lib is None:
        return None
    syms16 = np.ascontiguousarray(syms, dtype=np.uint16)
    freq64 = np.zeros(258, dtype=np.int64)
    freq64[: min(freq.size, 258)] = freq[:258]
    used = np.ascontiguousarray(in_use, dtype=np.uint8)
    n_in_use = int(used.sum())
    cap = syms16.size * 3 + 8192
    out = np.empty(cap, dtype=np.uint8)
    tail = ctypes.c_uint64()
    tail_nbits = ctypes.c_int32()
    n = lib.s3_encode_tail(
        syms16.ctypes.data, syms16.size, freq64.ctypes.data,
        n_in_use, used.ctypes.data, orig_ptr, crc,
        out.ctypes.data, cap, ctypes.byref(tail), ctypes.byref(tail_nbits),
    )
    if n < 0:
        return None
    return out[:n].tobytes(), int(tail.value), int(tail_nbits.value)


def bwt_native(block: np.ndarray):
    """SA-IS rotation sort (runtime.cpp s3_bwt): (last, orig_ptr) or None."""
    lib = get_lib()
    if lib is None:
        return None
    block = np.ascontiguousarray(block, dtype=np.uint8)
    last = np.empty(block.size, dtype=np.uint8)
    ptr = lib.s3_bwt(block.ctypes.data, block.size, last.ctypes.data)
    if ptr < 0:
        return None
    return last, int(ptr)


def bz2_decompress_native(stream: bytes, size_hint: int | None = None):
    """Full-stream bzip2 decode in the native runtime, or None.

    Raises FormatError-compatible ValueError on corrupt streams.
    """
    lib = get_lib()
    if lib is None:
        return None
    arr = np.frombuffer(stream, dtype=np.uint8)
    cap = max(size_hint or 0, len(stream) * 4, 1 << 16)
    for _ in range(8):
        out = np.empty(cap, dtype=np.uint8)
        n = lib.s3_bz2_decompress(arr.ctypes.data, arr.size, out.ctypes.data, cap)
        if n >= 0:
            return out[:n].tobytes()
        if n == -2:
            cap *= 4
            continue
        raise ValueError(
            "bzip2: corrupt stream" if n == -1 else "bzip2: CRC mismatch"
        )
    raise ValueError("bzip2: output capacity loop exceeded")


def untransform_bed_native(chrom: str, text: bytes):
    """Fused inverse transform + BED emission (runtime.cpp
    s3_untransform_bed): (bed_bytes, n_records) or None to fall back."""
    lib = get_lib()
    if lib is None or not text:
        return None
    arr = np.frombuffer(text, dtype=np.uint8)
    name = chrom.encode("ascii")
    # optimistic capacity first (exact newline counting costs an extra
    # pass); -2 = capacity -> retry once with the worst-case bound
    for attempt in range(2):
        if attempt == 0:
            # BED output is typically ~3x the transformed text; np.empty
            # is lazy, so a generous virtual cap costs nothing
            cap = 8 * arr.size + 64 * (len(name) + 46) + 4096
        else:
            n_lines = text.count(b"\n") + 1
            cap = arr.size + n_lines * (len(name) + 46) + 64
        out = np.empty(cap, dtype=np.uint8)
        nrec = np.zeros(1, dtype=np.int64)
        n = lib.s3_untransform_bed(
            arr.ctypes.data, arr.size, name, len(name),
            out.ctypes.data, cap, nrec.ctypes.data,
        )
        if n != -2:
            break
    if n < 0:
        return None
    return out[:n].tobytes(), int(nrec[0])


def bz2_decode_block_native(stream: bytes, bit_offset: int, level: int):
    """Decode one block at a known bit offset (runtime.cpp
    s3_bz2_decode_block): (bytes, block_crc) or None.  Raises ValueError
    on corruption."""
    lib = get_lib()
    if lib is None:
        return None
    arr = np.frombuffer(stream, dtype=np.uint8)
    # RLE1 expansion can reach ~52x the post-RLE1 block bytes; start at a
    # typical size and grow on -2 (capacity) up to the true worst case
    cap = 2 * 100_000 * level
    max_cap = (100_000 * level + 64) // 5 * 259 + 1024
    crc = ctypes.c_uint32()
    while True:
        out = np.empty(cap, dtype=np.uint8)
        n = lib.s3_bz2_decode_block(
            arr.ctypes.data, arr.size, bit_offset, out.ctypes.data, cap,
            ctypes.byref(crc),
        )
        if n >= 0:
            return out[:n].tobytes(), int(crc.value)
        if n == -2 and cap < max_cap:
            cap = min(cap * 4, max_cap)
            continue
        raise ValueError(
            "bzip2: corrupt stream" if n != -3 else "bzip2: CRC mismatch"
        )


def refine_lengths_batch_native(
    rfreq64: np.ndarray, n_groups: np.ndarray, alphas: np.ndarray,
    lens_out: np.ndarray, max_len: int = 17,
) -> bool:
    """One call builds Huffman lengths for every active (block, table)
    pair (runtime.cpp s3_refine_lengths_batch).  ``rfreq64`` int64
    [b,6,258] C-contiguous; ``lens_out`` int32[b,6,258] updated in
    place at [:alpha] of active rows.  False without the lib."""
    lib = get_lib()
    if lib is None:
        return False
    assert rfreq64.dtype == np.int64 and rfreq64.flags.c_contiguous
    assert lens_out.dtype == np.int32 and lens_out.flags.c_contiguous
    ng = np.ascontiguousarray(n_groups, dtype=np.int64)
    al = np.ascontiguousarray(alphas, dtype=np.int64)
    rc = lib.s3_refine_lengths_batch(
        rfreq64.ctypes.data, ng.ctypes.data, al.ctypes.data,
        rfreq64.shape[0], max_len, lens_out.ctypes.data,
    )
    return rc == 0


def selector_mtf_native(selectors: np.ndarray):
    """MTF-code a selector run (runtime.cpp s3_selector_mtf), or None."""
    lib = get_lib()
    if lib is None:
        return None
    sels = np.ascontiguousarray(selectors, dtype=np.int32)
    out = np.empty(sels.size, dtype=np.uint8)
    lib.s3_selector_mtf(sels.ctypes.data, sels.size, out.ctypes.data)
    return out


def dense_pack4_native(arr: np.ndarray, out_row: np.ndarray):
    """Dense-remap + nibble-pack one block into ``out_row`` (runtime.cpp
    s3_dense_pack4).  Returns (n_in_use, used bool[256]) — the packed
    row is only valid when n_in_use <= 16 — or None without the lib.
    The call keeps the GIL."""
    if get_lib() is None:
        return None
    assert arr.dtype == np.uint8 and out_row.dtype == np.uint8
    assert out_row.flags.c_contiguous and out_row.size >= (arr.size + 1) // 2
    used = np.zeros(256, dtype=np.uint8)
    n_in_use = _gil_lib.s3_dense_pack4(
        arr.ctypes.data, arr.size, out_row.ctypes.data, used.ctypes.data
    )
    return int(n_in_use), used.astype(bool)


def dense_pack_words_native(arr: np.ndarray, bits: int, out_words: np.ndarray):
    """Dense-remap + word-pack one block for the mid-width upload format
    (runtime.cpp s3_dense_pack_words): 30//bits symbols per uint32, low
    bits first.  Returns (n_in_use, used bool[256]) — the packed row is
    only valid when n_in_use <= 1 << bits — or None without the lib.
    The call keeps the GIL."""
    if get_lib() is None:
        return None
    spw = 30 // bits
    assert arr.dtype == np.uint8 and out_words.dtype == np.uint32
    assert out_words.flags.c_contiguous
    assert out_words.size >= (arr.size + spw - 1) // spw
    used = np.zeros(256, dtype=np.uint8)
    n_in_use = _gil_lib.s3_dense_pack_words(
        arr.ctypes.data, arr.size, bits, out_words.ctypes.data, used.ctypes.data
    )
    return int(n_in_use), used.astype(bool)


def read_block_symbols_native(stream: bytes, bit_offset: int, level: int):
    """Huffman-decode one block's RLE2 symbol stream at a known bit
    offset (runtime.cpp s3_read_block_symbols): returns
    (crc, orig_ptr, in_use bool[256], symbols int32[m], next_bit_pos,
    randomised) or None when the native runtime is unavailable.  Raises
    ValueError on corrupt streams."""
    lib = get_lib()
    if lib is None:
        return None
    arr = np.frombuffer(stream, dtype=np.uint8)
    # RLE2 output is at most the post-RLE1 block size + 1 digit slack
    cap = 100_000 * level + 128
    syms = np.empty(cap, dtype=np.uint16)
    in_use = np.zeros(256, dtype=np.uint8)
    crc = ctypes.c_uint32()
    ptr = ctypes.c_int32()
    bitpos = ctypes.c_int64()
    rand = ctypes.c_uint8()
    m = lib.s3_read_block_symbols(
        arr.ctypes.data, arr.size, bit_offset, syms.ctypes.data, cap,
        in_use.ctypes.data, ctypes.byref(crc), ctypes.byref(ptr),
        ctypes.byref(bitpos), ctypes.byref(rand),
    )
    if m < 0:
        raise ValueError("bzip2: corrupt stream")
    return (
        int(crc.value),
        int(ptr.value),
        in_use.astype(bool),
        syms[:m].astype(np.int32),
        int(bitpos.value),
        bool(rand.value),
    )


def rle1_decode_native(data: bytes):
    lib = get_lib()
    if lib is None:
        return None
    arr = np.frombuffer(data, dtype=np.uint8)
    cap = arr.size // 5 * 259 + 1024
    out = np.empty(cap, dtype=np.uint8)
    n = lib.s3_rle1_decode(arr.ctypes.data, arr.size, out.ctypes.data, cap)
    if n < 0:
        raise ValueError("truncated RLE1 run" if n == -1 else "RLE1 overflow")
    return out[:n].tobytes()
