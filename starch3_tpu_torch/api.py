"""High-level encode and decode: BED -> .starch archive bytes and back.

The port's counterpart of ``starch3_tpu/api.py``.  The host parts
(parsing and the delta transform, the host bzip2 and gzip encoders, the
archive format, decode, listing and random access) are the port's own
copies of the JAX package's functions, with the same bytes.  The device
branches differ: ``use_jax=True`` selects the port's device path, which
runs on the explicit ``device`` (``"cuda"`` by default, ``"cpu"`` for the
plain PyTorch versions), in encode and in decode
(``decompress_starch_bytes(use_jax=True)``).

The device path is the default: ``EncodeConfig().use_jax`` is True and
``decompress_starch_bytes`` decodes on the device unless told otherwise,
on ``"cuda"``.  The caller asks for the CPU in one of two ways:
``use_jax=False`` (``EncodeConfig(use_jax=False)``,
``decompress_starch_bytes(..., use_jax=False)``) for the native host
codec, or ``device="cpu"`` for the device path's plain PyTorch versions.
Without a card a default call raises (``parallel.pipeline.resolve_device``);
there is no fallback.  A gzip archive has no device path and is encoded
and decoded on the host whatever the flags; so are
``decompress_starch_file``, ``extract_chromosome`` and
``list_chromosomes``.
"""

from __future__ import annotations

import dataclasses
import zlib

import numpy as np

from starch3_tpu_torch.bed.parser import parse_bed
from starch3_tpu_torch.bed.writer import write_bed_chrom
from starch3_tpu_torch.config import CompressionMethod, EncodeConfig
from starch3_tpu_torch.errors import BedParseError, FormatError, UnsupportedCodecError
from starch3_tpu_torch.format.archive import StarchReader, StarchWriter
from starch3_tpu_torch.transform.delta import transform_chrom, untransform_chrom
from starch3_tpu_torch.observability import StageTimer, logger
from starch3_tpu_torch.parallel import pipeline as _pipe

__all__ = [
    "EncodeConfig",
    "compress_bed_bytes",
    "compress_bed_file",
    "compress_bed_stream",
    "decompress_starch_bytes",
    "decompress_starch_file",
    "extract_chromosome",
    "list_chromosomes",
]


@dataclasses.dataclass(frozen=True)
class _MemberStream:
    """A compressed stream made of self-contained members (gzip tier);
    duck-compatible with codec.encoder.EncodedStream for assembly."""

    data: bytes
    block_bit_offsets: tuple[int, ...]


def _gzip_members(
    text: bytes, config: EncodeConfig, workers: int | None = None
) -> tuple[bytes, list[int]]:
    """Gzip a transformed stream as concatenated independent members.

    The reference advertises gzip but exits ENOSYS (starch3api.hpp:777-779);
    here the tier is implemented for real, with the same design as the
    bzip2 tier: streams larger than ``gzip_segment_bytes`` split into
    independent members (RFC 1952 multi-member — any standard gzip
    decodes the concatenation), member boundaries land in the metadata
    block index as bit offsets (always byte-aligned, multiples of 8),
    members compress in parallel (zlib releases the GIL) and decode
    member-parallel.  Streams at or under one segment stay a single
    member with an empty index — byte-identical to the pre-index format
    (the golden_gzip fixture freezes this).
    """
    seg = config.gzip_segment_bytes

    def one(part: bytes) -> bytes:
        co = zlib.compressobj(config.gzip_level, zlib.DEFLATED, 31)
        return co.compress(part) + co.flush()

    if seg <= 0 or len(text) <= seg:
        return one(text), []
    parts = [text[i : i + seg] for i in range(0, len(text), seg)]
    if workers and workers > 1 and len(parts) > 1:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(min(workers, len(parts))) as ex:
            members = list(ex.map(one, parts))
    else:
        members = [one(p) for p in parts]
    offsets, pos = [], 0
    for m in members:
        offsets.append(pos * 8)
        pos += len(m)
    return b"".join(members), offsets




def _on_device(config: EncodeConfig) -> bool:
    """True when ``config`` selects the device path: a bzip2 encode with
    ``use_jax`` (the default).  gzip has no device path in either
    package, so a gzip encode stays on the host and needs no card."""
    return config.use_jax and config.method is CompressionMethod.BZIP2


def _encode_kwargs(config: EncodeConfig, device) -> dict:
    return {
        "level": config.block_size_100k,
        "device": device,
        "batch_size": config.blocks_per_batch,
        "device_rle2": config.device_rle2,
        "fast_bwt": config.fast_bwt,
        "device_huffman": config.device_huffman,
    }


def _compress_stream(text: bytes, config: EncodeConfig, device="cuda") -> bytes:
    if _on_device(config):
        return _pipe.torch_bz2_compress(text, config, device=device)
    if config.method is CompressionMethod.BZIP2:
        from starch3_tpu_torch.codec.encoder import bz2_compress

        return bz2_compress(text, config.block_size_100k)
    if config.method is CompressionMethod.GZIP:
        return _gzip_members(text, config)[0]
    raise UnsupportedCodecError(f"unknown codec {config.method}")


def _compress_stream_ex(
    text: bytes, config: EncodeConfig, workers: int | None = None, device="cuda"
) -> tuple[bytes, list[int]]:
    """Like _compress_stream but also returns the per-block bit offsets
    (the archive block index) for bzip2 streams."""
    if config.method is CompressionMethod.BZIP2:
        if _on_device(config):
            enc = _pipe.encode_streams([text], **_encode_kwargs(config, device))[0]
        else:
            from starch3_tpu_torch.codec.encoder import bz2_compress_ex

            enc = bz2_compress_ex(text, config.block_size_100k, workers=workers)
        return enc.data, list(enc.block_bit_offsets)
    if config.method is CompressionMethod.GZIP:
        return _gzip_members(text, config, workers)
    return _compress_stream(text, config, device=device), []


def _decompress_stream(data: bytes, compression_format: str) -> bytes:
    if compression_format == "bzip2":
        # hot decode path: our native C++ decoder (runtime/runtime.cpp),
        # equivalence-tested against libbz2; stdlib bz2 as fallback when
        # the native runtime isn't built
        from starch3_tpu_torch.runtime import bz2_decompress_native

        try:
            out = bz2_decompress_native(data)
        except ValueError as e:
            raise FormatError(str(e)) from e
        if out is not None:
            return out
        import bz2

        try:
            return bz2.decompress(data)
        except (OSError, EOFError, ValueError) as e:
            raise FormatError(f"bzip2: {e}") from e
    if compression_format == "gzip":
        # streams may be a concatenation of independent members
        # (_gzip_members); walk them all, like gzip(1) does.  An empty
        # stream is corruption, not empty text: the encoder emits a
        # ~20-byte member even for empty input, so the truncated-member
        # error below is the right answer for b"".
        out = []
        mv = memoryview(data)
        pos, n = 0, len(data)
        # feed bounded slices; a finished member's unused_data becomes
        # the next feed source directly (never re-concatenated), so each
        # boundary copies <= chunk_sz and a many-member stream decodes
        # in O(stream), not O(members x chunk)
        chunk_sz = 256 << 10
        do = zlib.decompressobj(31)
        carry = b""  # start-of-next-member bytes from a finished member
        try:
            while True:
                if carry:
                    chunk, carry = carry, b""
                elif pos < n:
                    chunk = mv[pos : pos + chunk_sz]
                    pos += len(chunk)
                else:
                    if not do.eof:
                        raise FormatError("gzip: truncated member")
                    break
                out.append(do.decompress(chunk))
                if do.eof:
                    # unused_data <= len(chunk) <= chunk_sz: carry sizes
                    # only shrink until the next fresh input chunk
                    carry = do.unused_data
                    if not carry and pos >= n:
                        break
                    do = zlib.decompressobj(31)
        except zlib.error as e:
            raise FormatError(f"gzip: {e}") from e
        return b"".join(out)
    raise UnsupportedCodecError(f"unknown codec {compression_format!r}")


def _gzip_member_decode(member: bytes) -> bytes:
    """Decode exactly one gzip member (a metadata-index slice)."""
    do = zlib.decompressobj(31)
    try:
        out = do.decompress(member) + do.flush()
    except zlib.error as e:
        raise FormatError(f"gzip member: {e}") from e
    if not do.eof or do.unused_data:
        raise FormatError("gzip member: boundary does not match index")
    return out


def _parse_transform_chunked(data: bytes, workers: int):
    """Chunk-parallel native parse+transform.

    Chromosome transforms are self-contained, so chunks split at line
    boundaries parse independently; only a chromosome whose lines span a
    chunk boundary (same leading name on both sides) is re-transformed
    from its merged raw span.  Returns the same 6-tuple list as
    bed_transform_native, or None to fall back.
    """
    from concurrent.futures import ThreadPoolExecutor

    from starch3_tpu_torch.runtime import bed_transform_native

    # line-aligned chunk bounds
    bounds = [0]
    for w in range(1, workers):
        cut = data.find(b"\n", len(data) * w // workers)
        if cut < 0:
            break
        if cut + 1 > bounds[-1]:
            bounds.append(cut + 1)
    bounds.append(len(data))
    chunks = [
        (bounds[i], data[bounds[i] : bounds[i + 1]])
        for i in range(len(bounds) - 1)
        if bounds[i + 1] > bounds[i]
    ]
    if len(chunks) < 2:
        return bed_transform_native(data)
    with ThreadPoolExecutor(len(chunks)) as ex:
        parsed = list(ex.map(lambda c: bed_transform_native(c[1]), chunks))
    if any(p is None for p in parsed):
        return None
    # flatten to (name, tuple, abs_start, abs_end, first_in_chunk)
    pieces = []
    for (base, chunk), groups in zip(chunks, parsed):
        for k, g in enumerate(groups):
            start = base + g[5]
            end = base + (groups[k + 1][5] if k + 1 < len(groups) else len(chunk))
            pieces.append((g[0], g, start, end, k == 0))
    # merge maximal runs of boundary-adjacent same-name pieces
    out = []
    i = 0
    while i < len(pieces):
        j = i
        while (
            j + 1 < len(pieces)
            and pieces[j + 1][4]  # first group of its chunk
            and pieces[j + 1][0] == pieces[i][0]
            # contiguous up to dropped empty lines
            and data[pieces[j][3] : pieces[j + 1][2]].strip(b"\n") == b""
        ):
            j += 1
        if j == i:
            out.append(pieces[i][1])
        else:
            merged = bed_transform_native(data[pieces[i][2] : pieces[j][3]])
            if merged is None or len(merged) != 1:
                return None
            out.append(merged[0])
        i = j + 1
    return out


def _parse_transform(data: bytes):
    """Parse + transform, preferring the fused native single pass
    (runtime.cpp s3_bed_transform); the NumPy path is the behavioral
    reference, the fallback, and the source of exact parse diagnostics."""
    import os

    from starch3_tpu_torch.runtime import bed_transform_native
    from starch3_tpu_torch.transform.delta import TransformedChrom

    workers = os.cpu_count() or 1
    # chunked parse pays off when parse time dominates thread overhead:
    # measured on a 2-core host it is noise-negative for ~25 MB inputs,
    # so it engages only at real corpus scale on multi-core machines
    if len(data) > (64 << 20) and workers >= 4:
        native = _parse_transform_chunked(data, min(workers, 8))
        if native is None:
            native = bed_transform_native(data)
    else:
        native = bed_transform_native(data)
    if native is not None:
        chroms = [t[0] for t in native]
        if len(set(chroms)) == len(chroms):
            return [
                TransformedChrom(
                    chrom=c,
                    text=text,
                    line_count=lc,
                    base_count_nonunique=nu,
                    base_count_unique=u,
                )
                for c, text, lc, nu, u, _off in native
            ]
        # duplicate (non-contiguous) chromosomes: let the NumPy parser
        # raise its exact error
    return [transform_chrom(b) for b in parse_bed(data)]


class _FeedFallback(Exception):
    """Streaming parse hit something the incremental path can't express
    (native runtime unavailable, parse error, duplicate chromosome):
    redo through the one-shot path, which produces exact diagnostics."""


def _iter_parse_transform(data: bytes, chunk_bytes: int = 4 << 20):
    """Sequential chunked native parse+transform: yields each chromosome's
    TransformedChrom as soon as its raw span is complete, so the encode
    pipeline (parallel/pipeline.encode_streams_feed) is already
    compressing early chromosomes while later ones are still being
    tokenized — the streaming rebuild of the reference's producer thread
    (starch3api.hpp:158-199), with a whole chunk per handoff instead of
    one line under one mutex.

    A chromosome whose lines span a chunk boundary is re-transformed
    once from its merged raw span when its end is found (same merge
    contract as _parse_transform_chunked).  Raises _FeedFallback when
    the one-shot path must take over.
    """
    from starch3_tpu_torch.runtime import bed_transform_native
    from starch3_tpu_torch.transform.delta import TransformedChrom

    from starch3_tpu_torch.runtime import get_lib

    if get_lib() is None or not data:
        raise _FeedFallback()

    seen: set = set()

    def mk(g) -> TransformedChrom:
        c, text, lc, nu, u, _off = g
        if c in seen:
            raise _FeedFallback()  # duplicate chromosome: exact error path
        seen.add(c)
        return TransformedChrom(
            chrom=c,
            text=text,
            line_count=lc,
            base_count_nonunique=nu,
            base_count_unique=u,
        )

    n = len(data)
    pos = 0
    # pending chromosome possibly continuing into the next chunk:
    # (name, abs_start, abs_end, group_or_None). group is the native
    # result when the span never crossed a boundary (emit as-is);
    # None after a merge (re-transform the raw span on finalize).
    pending = None

    def finalize(p) -> TransformedChrom:
        name, lo, hi, group = p
        if group is not None:
            return mk(group)
        merged = bed_transform_native(data[lo:hi])
        if merged is None or len(merged) != 1:
            raise _FeedFallback()
        return mk(merged[0])

    while pos < n:
        if n - pos <= chunk_bytes:
            end = n
        else:
            cut = data.find(b"\n", pos + chunk_bytes)
            end = n if cut < 0 else cut + 1
        groups = bed_transform_native(data[pos:end])
        if groups is None:
            raise _FeedFallback()
        if groups:
            offs = [pos + g[5] for g in groups]
            if (
                pending is not None
                and groups[0][0] == pending[0]
                and data[pending[2] : offs[0]].strip(b"\n") == b""
            ):
                # first group continues the pending chromosome
                g_end = offs[1] if len(groups) > 1 else end
                pending = (pending[0], pending[1], g_end, None)
                groups = groups[1:]
                offs = offs[1:]
            if groups:
                if pending is not None:
                    yield finalize(pending)
                for k, g in enumerate(groups[:-1]):
                    yield mk(g)
                g_last = groups[-1]
                pending = (g_last[0], offs[-1], end, g_last)
        pos = end
    if pending is not None:
        yield finalize(pending)


def compress_bed_bytes(
    data: bytes, config: EncodeConfig | None = None, timer=None, device="cuda"
) -> bytes:
    """BED text -> .starch archive bytes; the device path runs on
    ``device``.

    ``timer``: optional observability.StageTimer; per-stage wall time and
    throughput accumulate into it."""
    timer = timer if timer is not None else StageTimer()
    config = config or EncodeConfig()
    on_device = _on_device(config)
    if on_device:
        _pipe.resolve_device(device)  # no card: raise before any work, also on empty input
    writer = StarchWriter(
        note=config.note,
        compression=config.method.value,
        final_newline=(not data) or data.endswith(b"\n"),
    )
    transformed = None
    streams = None
    if on_device:
        # the chunked native parser feeds each chromosome into the device
        # queue as soon as its raw span completes
        with timer.stage("parse+compress (pipelined)", len(data)):
            transformed = []

            def _gen():
                for tc in _iter_parse_transform(data):
                    transformed.append(tc)
                    yield tc.text

            try:
                streams = _pipe.encode_streams_feed(_gen(), **_encode_kwargs(config, device))
            except _FeedFallback:
                transformed = None
                streams = None
    if streams is None:
        with timer.stage("parse+transform", len(data)):
            transformed = _parse_transform(data)
        total_text = sum(len(tf.text) for tf in transformed)
        with timer.stage("compress", total_text):
            if on_device and transformed:
                # one device queue across all chromosomes: blocks from
                # every stream share batches
                streams = _pipe.encode_streams(
                    [tf.text for tf in transformed], **_encode_kwargs(config, device)
                )
            elif config.method is CompressionMethod.BZIP2 and transformed:
                # host path: shared thread pool over every stream's blocks
                # (the native stages release the GIL)
                import os

                from starch3_tpu_torch.codec.encoder import encode_streams_host

                streams = encode_streams_host(
                    [tf.text for tf in transformed],
                    level=config.block_size_100k,
                    workers=os.cpu_count(),
                )
            else:
                # gzip tier (or empty input): members carry their own
                # boundaries into the metadata block index and compress
                # on all cores (zlib releases the GIL)
                import os

                streams = [
                    _MemberStream(*_gzip_members(tf.text, config, os.cpu_count()))
                    if config.method is CompressionMethod.GZIP
                    else _compress_stream(tf.text, config)
                    for tf in transformed
                ]
    with timer.stage("assemble"):
        for tf, enc in zip(transformed, streams):
            compressed = enc if isinstance(enc, bytes) else enc.data
            offsets = [] if isinstance(enc, bytes) else list(enc.block_bit_offsets)
            writer.add_stream(
                tf.chrom,
                compressed,
                uncompressed_size=len(tf.text),
                line_count=tf.line_count,
                base_count_nonunique=tf.base_count_nonunique,
                base_count_unique=tf.base_count_unique,
                block_bit_offsets=offsets,
            )
        archive = writer.finish()
    logger.debug("encode stages: %s", timer.report())
    return archive


def _decode_stream_to_bed(meta, stream: bytes, fmt: str, text: bytes | None = None) -> bytes:
    """One stream -> BED text, with the full validation set (size,
    line count); shared by whole-archive decode and random access."""
    if text is None:
        text = _decompress_stream(stream, fmt)
    if len(text) != meta.uncompressed_size:
        raise FormatError(
            f"{meta.chromosome}: uncompressed size mismatch "
            f"({len(text)} != {meta.uncompressed_size})"
        )
    from starch3_tpu_torch.runtime import untransform_bed_native

    native = untransform_bed_native(meta.chromosome, text)
    if native is not None:
        bed_text, n_records = native
    else:
        block = untransform_chrom(meta.chromosome, text)
        bed_text, n_records = write_bed_chrom(block), block.n_records
    if n_records != meta.line_count:
        raise FormatError(
            f"{meta.chromosome}: line count mismatch "
            f"({n_records} != {meta.line_count})"
        )
    return bed_text


def _verify_stream_tail(chrom: str, stream: bytes, block_crcs: list[int]) -> None:
    """Verify a bzip2 stream's end magic + combined CRC against the
    per-block CRCs (the check the serial decoder performs inline).

    The tail is zero-padded to a byte, so the [EOS(48) crc(32)] fields
    end 0..7 bits before the end; the unique EOS magic locates them.
    """
    from starch3_tpu_torch.codec.crc32 import combine_block_crc
    from starch3_tpu_torch.codec.encoder import STREAM_END_MAGIC

    combined = 0
    for c in block_crcs:
        combined = combine_block_crc(combined, c)
    tail = int.from_bytes(stream[-11:], "big")
    for pad in range(8):
        candidate = tail >> pad
        if (candidate >> 32) & 0xFFFFFFFFFFFF == STREAM_END_MAGIC:
            if candidate & 0xFFFFFFFF != combined:
                raise FormatError(f"{chrom}: combined CRC mismatch")
            return
    raise FormatError(f"{chrom}: missing stream-end magic")


def _append_bytes(buf: np.ndarray, length: int, part: np.ndarray) -> tuple[np.ndarray, int]:
    """Append ``part`` to the first ``length`` bytes of ``buf``, growing it
    (at least twofold) when it lacks room.  NumPy copies without the GIL.
    Returns the buffer and the new length."""
    end = length + part.size
    if end > buf.size:
        grown = np.empty(max(end, 2 * buf.size), dtype=np.uint8)
        grown[:length] = buf[:length]
        buf = grown
    buf[length:end] = part
    return buf, end


def compress_bed_file(
    in_path: str,
    out_fh,
    config: EncodeConfig | None = None,
    chunk_bytes: int = 64 << 20,
    device="cuda",
) -> None:
    """Streaming file encode: ``compress_bed_stream`` over a named file."""
    with open(in_path, "rb") as f:
        compress_bed_stream(f, out_fh, config, chunk_bytes, device=device)


def compress_bed_stream(
    in_fh,
    out_fh,
    config: EncodeConfig | None = None,
    chunk_bytes: int = 64 << 20,
    device="cuda",
) -> None:
    """Streaming encode from any binary file object: constant memory in
    the corpus size.  Works on pipes/stdin — the reference's producer
    streams stdin line-at-a-time with O(1) memory
    (reference include/starch3api.hpp:158-199); this is the chunked
    equivalent (a BASELINE config-5 pipe must not slurp the corpus).

    Chromosomes are contiguous in sorted BED and every chromosome's
    transform state starts fresh, so a chunk's interior chromosome groups
    transform identically in isolation; only a group continuing across a
    chunk boundary is carried as raw text and re-transformed when its
    chromosome completes.  Peak memory ~ the largest single chromosome,
    not the corpus (BASELINE.json config 5 scale).  Output bytes are
    identical to ``compress_bed_bytes`` on the whole input.

    Peak memory ~ a small window of chromosomes (the pool's in-flight
    texts), not the corpus.  With ``use_jax``, completed chromosomes
    feed the device queue on ``device`` (parallel/pipeline.
    encode_streams_iter), so chunked streaming and cross-chromosome block
    batching compose.  Falls back to the in-memory path only when the
    native runtime (the streaming parser) is absent.
    """
    import os

    from starch3_tpu_torch.format.archive import StarchFileWriter
    from starch3_tpu_torch.runtime import bed_transform_native, get_lib

    config = config or EncodeConfig()
    if _on_device(config):
        _pipe.resolve_device(device)
    if get_lib() is None:
        out_fh.write(compress_bed_bytes(in_fh.read(), config, device=device))
        return

    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    writer = StarchFileWriter(out_fh, note=config.note, compression=config.method.value)
    seen: set[str] = set()
    workers = os.cpu_count() or 1
    # one block spans at most ~1.01 MB of transformed text (900 kB
    # post-RLE1 at worst-case 4/5 shrink); streams bigger than a couple
    # of blocks compress exclusively with the block pool instead of
    # nesting a per-stream pool inside the stream pool
    big_stream = 4 * 100_000 * config.block_size_100k
    # cap on queued uncompressed text: a couple of in-flight chromosomes
    # per worker keeps the pool saturated; anything larger only inflates
    # peak RSS (the constant-memory bound is window + largest chromosome)
    window_bytes = 256 << 20
    pool = ThreadPoolExecutor(workers)
    pending: deque = deque()  # (chrom, text_len, lc, nu, u, future)
    inflight = 0  # queued uncompressed bytes

    def drain(limit: int) -> None:
        nonlocal inflight
        while len(pending) > limit or (pending and inflight > window_bytes):
            chrom, tlen, lc, nu, u, fut = pending.popleft()
            inflight -= tlen
            stream, offsets = fut.result()
            writer.add_stream(
                chrom,
                stream,
                uncompressed_size=tlen,
                line_count=lc,
                base_count_nonunique=nu,
                base_count_unique=u,
                block_bit_offsets=offsets,
            )

    use_jax_queue = _on_device(config)

    def emit(chrom: str, text: bytes, lc: int, nu: int, u: int) -> None:
        # chromosome streams compress on the pool; archive writes stay in
        # input order via the bounded window
        if chrom in seen:
            raise BedParseError(
                f"chromosome {chrom!r} is not contiguous; input must be sorted"
            )
        seen.add(chrom)
        if len(text) > big_stream:
            # multi-block chromosome: drain the window, then let this
            # stream's own blocks use the whole machine (no pool nesting)
            drain(0)
            stream, offsets = _compress_stream_ex(text, config, workers)
            writer.add_stream(
                chrom,
                stream,
                uncompressed_size=len(text),
                line_count=lc,
                base_count_nonunique=nu,
                base_count_unique=u,
                block_bit_offsets=offsets,
            )
            return
        nonlocal inflight
        inflight += len(text)
        pending.append(
            (chrom, len(text), lc, nu, u, pool.submit(_compress_stream_ex, text, config))
        )
        drain(workers + 1)

    def transform_or_raise(raw):
        groups = bed_transform_native(raw)
        if groups is None:
            # parse error: rerun the NumPy parser for the exact diagnostic
            _parse_transform(bytes(raw))
            raise BedParseError("unparseable BED chunk")
        return groups

    def iter_groups():
        """Yield each completed chromosome's native transform tuple as
        the chunked read progresses (the carry logic merges a chromosome
        whose lines span chunk boundaries).

        No bulk copy holds the GIL, which the device lane's threads
        need: chunks are read into one reused buffer (``readinto``, or
        ``read`` and a NumPy copy for a file object without it), lines
        are cut by views of it, and a chromosome carried across chunks
        is gathered into a reused NumPy buffer (NumPy lets the GIL go
        while it copies)."""
        readinto = getattr(in_fh, "readinto", None)
        buf = bytearray(chunk_bytes + (1 << 16))
        carry = np.empty(0, dtype=np.uint8)
        carry_len = 0
        carry_name: str | None = None
        filled = 0  # the partial line at the front of buf
        while True:
            if len(buf) - filled < chunk_bytes:  # a line longer than the slack
                grown = bytearray(filled + chunk_bytes + (1 << 16))
                np.frombuffer(grown, np.uint8)[:filled] = np.frombuffer(buf, np.uint8)[:filled]
                buf = grown
            view = memoryview(buf)
            if readinto is not None:
                n = readinto(view[filled : filled + chunk_bytes])
            else:
                chunk = in_fh.read(chunk_bytes)
                n = len(chunk) if chunk else 0
                np.frombuffer(buf, np.uint8)[filled : filled + n] = np.frombuffer(chunk, np.uint8)
                del chunk
            if not n:
                break
            total = filled + n
            cut = buf.rfind(b"\n", 0, total)
            if cut < 0:
                filled = total
                continue
            arr = np.frombuffer(buf, np.uint8)
            body = arr[: cut + 1]
            groups = transform_or_raise(body)
            # raw span boundaries come straight from the parse: group
            # k's raw text spans [off_k, off_{k+1}) in body
            names = [g[0] for g in groups]
            if not groups:
                parts = []  # blank lines only
            elif carry_name is not None and names[0] == carry_name and len(groups) == 1:
                parts = [body]  # chromosome still continuing
            else:
                offs = [g[5] for g in groups] + [body.size]
                if carry_name is not None:
                    if names[0] == carry_name:
                        carry, carry_len = _append_bytes(carry, carry_len, body[: offs[1]])
                        groups, names, offs = groups[1:], names[1:], offs[1:]
                    yield from transform_or_raise(carry[:carry_len])
                    carry_len = 0
                # all groups except the last are fully bounded: final
                yield from groups[:-1]
                carry_name = names[-1]
                parts = [body[offs[-2] :]]
            for part in parts:
                carry, carry_len = _append_bytes(carry, carry_len, part)
            # the partial line moves to the front for the next read
            filled = total - (cut + 1)
            arr[:filled] = arr[cut + 1 : total].copy()
        writer.final_newline = not filled
        if filled:  # final line without newline
            carry, carry_len = _append_bytes(carry, carry_len, np.frombuffer(buf, np.uint8)[:filled])
        if carry_len:
            yield from transform_or_raise(carry[:carry_len])

    if use_jax_queue:
        # the device queue runs across the whole corpus: the feeder
        # (parse) thread and the incremental assembler meet through
        # encode_streams_iter's bounded window
        meta_q: deque = deque()  # feed-order (chrom, len, lc, nu, u)

        def gen_texts():
            for g in iter_groups():
                chrom = g[0]
                if chrom in seen:
                    raise BedParseError(
                        f"chromosome {chrom!r} is not contiguous; "
                        "input must be sorted"
                    )
                seen.add(chrom)
                meta_q.append((chrom, len(g[1]), g[2], g[3], g[4]))
                yield g[1]

        for enc in _pipe.encode_streams_iter(gen_texts(), **_encode_kwargs(config, device)):
            chrom, tlen, lc, nu, u = meta_q.popleft()
            writer.add_stream(
                chrom,
                enc.data,
                uncompressed_size=tlen,
                line_count=lc,
                base_count_nonunique=nu,
                base_count_unique=u,
                block_bit_offsets=list(enc.block_bit_offsets),
            )
        writer.finish()
        return

    try:
        for g in iter_groups():
            emit(g[0], g[1], g[2], g[3], g[4])
        drain(0)
    finally:
        pool.shutdown(wait=False, cancel_futures=True)
    writer.finish()


def _submit_stream_blocks(ex, meta, stream: bytes, fmt: str, use_blocks: bool):
    """Fan one stream's blocks/members out on executor ``ex`` via the
    metadata block index.  Returns ("bz2"|"gz", [futures]) or None when
    the stream has no usable index (callers decode it whole)."""
    offs = list(getattr(meta, "block_bit_offsets", []) or [])
    if use_blocks and len(offs) > 1 and len(stream) >= 4:
        from starch3_tpu_torch.runtime import bz2_decode_block_native

        level = stream[3] - 0x30
        if 1 <= level <= 9:
            return (
                "bz2",
                [
                    ex.submit(bz2_decode_block_native, stream, off, level)
                    for off in offs
                ],
            )
    elif (
        fmt == "gzip"
        and len(offs) > 1
        and all(o % 8 == 0 for o in offs)
        and offs[0] == 0
    ):
        # member-parallel gzip: the index records byte-aligned member
        # boundaries (_gzip_members); each slice is a self-contained
        # member with its own CRC32
        bounds = [o // 8 for o in offs] + [len(stream)]
        return (
            "gz",
            [
                ex.submit(
                    _gzip_member_decode, stream[bounds[k] : bounds[k + 1]]
                )
                for k in range(len(offs))
            ],
        )
    return None


def _join_stream_blocks(meta, stream: bytes, sf) -> bytes | None:
    """Join a _submit_stream_blocks fan-out into the stream's transformed
    text (verifying the bzip2 combined CRC); None when sf is None."""
    if sf is None:
        return None
    if sf[0] == "bz2":
        try:
            results = [f.result() for f in sf[1]]
        except ValueError as e:
            raise FormatError(f"{meta.chromosome}: {e}") from e
        _verify_stream_tail(meta.chromosome, stream, [r[1] for r in results])
        return b"".join(r[0] for r in results)
    try:
        return b"".join(f.result() for f in sf[1])
    except FormatError as e:
        raise FormatError(f"{meta.chromosome}: {e}") from e


def decompress_starch_bytes(
    data: bytes, workers: int | None = None, use_jax: bool = True, mesh=None, device="cuda"
) -> bytes:
    """.starch archive bytes -> BED text (byte-exact round trip).

    Streams are independent, so decode runs them through a thread pool
    (the native decoder releases the GIL); results concatenate in
    metadata order regardless of completion order.  Multi-block streams
    additionally decode block-parallel via the metadata block index.

    ``use_jax`` (the default) routes the vectorizable decode stages of a
    bzip2 archive (inverse RLE2 -> MTF -> BWT) through the device path on
    ``device`` (``"cuda"`` needs a card; ``"cpu"`` runs the same torch ops
    there), batched over all streams' blocks
    (parallel/pipeline.decode_streams), or over the entries of ``mesh``
    (parallel/mesh.py), which then replaces ``device``.
    ``use_jax=False`` is the native block-parallel host decode.  A gzip
    archive decodes on the host either way.
    """
    reader = StarchReader.from_bytes(data)
    fmt = reader.metadata.compression_format
    if use_jax and fmt == "bzip2" and mesh is None:
        _pipe.resolve_device(device)  # no card: raise, also for an archive of no stream

    items = list(reader.iter_streams())
    if workers is None:
        import os

        workers = os.cpu_count() or 1
    if use_jax and fmt == "bzip2" and items:
        texts = _pipe.decode_streams([stream for _meta, stream in items], device=device, mesh=mesh)
        parts = [
            _decode_stream_to_bed(meta, stream, fmt, text)
            for (meta, stream), text in zip(items, texts)
        ]
    elif workers > 1 and items:
        from concurrent.futures import ThreadPoolExecutor

        from starch3_tpu_torch.runtime import get_lib

        # per-stream flow on one pool: multi-block streams fan their
        # blocks out (block_bit_offsets index); each stream's inverse
        # transform is submitted as soon as its own blocks are joined, so
        # later streams' blocks overlap earlier streams' untransform
        use_blocks = fmt == "bzip2" and get_lib() is not None
        with ThreadPoolExecutor(workers) as ex:
            block_futs = [
                _submit_stream_blocks(ex, meta, stream, fmt, use_blocks)
                for meta, stream in items
            ]
            finish_futs = []
            for si, (meta, stream) in enumerate(items):
                text = _join_stream_blocks(meta, stream, block_futs[si])
                finish_futs.append(
                    ex.submit(_decode_stream_to_bed, meta, stream, fmt, text)
                )
            parts = [f.result() for f in finish_futs]
    else:
        parts = [_decode_stream_to_bed(meta, stream, fmt) for meta, stream in items]
    out = b"".join(parts)
    if not reader.metadata.final_newline and out.endswith(b"\n"):
        out = out[:-1]  # the input's last line had no newline
    return out


def decompress_starch_file(in_path: str, out_fh, workers: int | None = None) -> None:
    """Streaming archive decode: holds the (compressed) archive plus a
    bounded window of decoded streams — memory is bounded by a few
    chromosomes, not the decoded corpus.  Streams decode on a thread
    pool and are written in archive order."""
    import os
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    with open(in_path, "rb") as f:
        data = f.read()
    reader = StarchReader.from_bytes(data)
    fmt = reader.metadata.compression_format
    if workers is None:
        workers = os.cpu_count() or 1
    if len(reader.metadata.streams) <= 2 * workers:
        # few streams: the in-memory path's block-level fan-out beats
        # stream-level parallelism (e.g. one multi-block chromosome),
        # and its memory ceiling is the same at this scale
        out_fh.write(decompress_starch_bytes(data, workers=workers, use_jax=False))
        return
    del data
    strip_last = not reader.metadata.final_newline
    n_streams = len(reader.metadata.streams)
    with ThreadPoolExecutor(workers) as ex:
        pending = deque()
        done = 0

        def write_one(text: bytes) -> None:
            nonlocal done
            done += 1
            if strip_last and done == n_streams and text.endswith(b"\n"):
                text = text[:-1]
            out_fh.write(text)

        for meta, stream in reader.iter_streams():
            pending.append(ex.submit(_decode_stream_to_bed, meta, stream, fmt))
            while len(pending) > 2 * workers:
                write_one(pending.popleft().result())
        while pending:
            write_one(pending.popleft().result())


def extract_chromosome(data: bytes, chrom: str, workers: int | None = None) -> bytes:
    """Random-access decode of one chromosome's BED records.

    The metadata byte-offset index makes this O(stream) instead of
    O(archive) — the capability the reference's per-chromosome framing
    and block-close offset plumbing (SURVEY.md C5/C13) was building
    toward.  Multi-block (bzip2) / multi-member (gzip) streams decode
    block-parallel via the per-stream block index.
    """
    reader = StarchReader.from_bytes(data)
    fmt = reader.metadata.compression_format
    for meta in reader.metadata.streams:
        if meta.chromosome != chrom:
            continue
        stream = reader.stream_bytes(chrom)
        text = None
        offs = meta.block_bit_offsets
        if workers is None:
            import os

            workers = os.cpu_count() or 1
        if workers > 1 and len(offs) > 1:
            from concurrent.futures import ThreadPoolExecutor

            from starch3_tpu_torch.runtime import get_lib

            use_blocks = fmt == "bzip2" and get_lib() is not None
            with ThreadPoolExecutor(min(workers, len(offs))) as ex:
                sf = _submit_stream_blocks(ex, meta, stream, fmt, use_blocks)
                text = _join_stream_blocks(meta, stream, sf)
        return _decode_stream_to_bed(meta, stream, fmt, text)
    raise FormatError(f"chromosome {chrom!r} not present in archive")


def list_chromosomes(data: bytes) -> list[dict]:
    """Metadata table for an archive (the unstarch --list analogue)."""
    reader = StarchReader.from_bytes(data)
    return [
        {
            "chromosome": s.chromosome,
            "lineCount": s.line_count,
            "size": s.size,
            "uncompressedSize": s.uncompressed_size,
            "nonUniqueBaseCount": s.base_count_nonunique,
            "uniqueBaseCount": s.base_count_unique,
        }
        for s in reader.metadata.streams
    ]
