"""High-level encode on a torch device: BED -> .starch archive bytes.

Counterpart of ``starch3_tpu/api.py`` for its device branches.  The
entry points take the same ``EncodeConfig``; ``use_jax=True`` selects the
device path, which runs on the explicit ``device`` (``"cuda"`` by
default, ``"cpu"`` for the plain PyTorch versions).  Everything else (the
host encoder, gzip, parsing and the delta transform, the archive format,
decode, listing and random access) is the JAX package's host code,
imported here and never copied.
"""

from __future__ import annotations

from starch3_tpu import api as _host
from starch3_tpu.api import (  # noqa: F401  (host functions, re-exported)
    _FeedFallback,
    _iter_parse_transform,
    _parse_transform,
    decompress_starch_file,
    extract_chromosome,
    list_chromosomes,
)
from starch3_tpu.config import CompressionMethod, EncodeConfig
from starch3_tpu.errors import BedParseError
from starch3_tpu.format.archive import StarchWriter
from starch3_tpu_torch.observability import StageTimer
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


def _on_device(config: EncodeConfig) -> bool:
    """True when ``config`` selects the device path; raises for the
    device modes not ported yet."""
    if not (config.use_jax and config.method is CompressionMethod.BZIP2):
        return False
    _pipe.check_modes(config.fast_bwt, config.device_rle2, config.device_huffman)
    return True


def _encode_kwargs(config: EncodeConfig, device) -> dict:
    return {
        "level": config.block_size_100k,
        "device": device,
        "batch_size": config.blocks_per_batch,
    }


def _compress_stream(text: bytes, config: EncodeConfig, device="cuda") -> bytes:
    if _on_device(config):
        return _pipe.torch_bz2_compress(text, config, device=device)
    return _host._compress_stream(text, config)


def _compress_stream_ex(
    text: bytes, config: EncodeConfig, workers: int | None = None, device="cuda"
) -> tuple[bytes, list[int]]:
    """Like ``_compress_stream`` but also returns the per-block bit
    offsets (the archive block index) for bzip2 streams."""
    if _on_device(config):
        enc = _pipe.encode_streams([text], **_encode_kwargs(config, device))[0]
        return enc.data, list(enc.block_bit_offsets)
    return _host._compress_stream_ex(text, config, workers)


def compress_bed_bytes(
    data: bytes, config: EncodeConfig | None = None, timer=None, device="cuda"
) -> bytes:
    """BED text -> .starch archive bytes; the device path runs on
    ``device``.  Each chromosome enters the device queue as soon as the
    chunked parser completes it."""
    config = config or EncodeConfig()
    timer = timer if timer is not None else StageTimer()
    if not _on_device(config):
        return _host.compress_bed_bytes(data, config, timer)
    writer = StarchWriter(
        note=config.note,
        compression=config.method.value,
        final_newline=(not data) or data.endswith(b"\n"),
    )
    with timer.stage("parse+compress (pipelined)", len(data)):
        transformed = []

        def _gen():
            for tc in _iter_parse_transform(data):
                transformed.append(tc)
                yield tc.text

        try:
            streams = _pipe.encode_streams_feed(_gen(), **_encode_kwargs(config, device))
        except _FeedFallback:
            # duplicate chromosome or unparseable chunk: the one-shot
            # parser raises the exact error, or encodes what it accepts
            transformed = _parse_transform(data)
            streams = _pipe.encode_streams(
                [tf.text for tf in transformed], **_encode_kwargs(config, device)
            ) if transformed else []
    with timer.stage("assemble"):
        for tf, enc in zip(transformed, streams):
            writer.add_stream(
                tf.chrom,
                enc.data,
                uncompressed_size=len(tf.text),
                line_count=tf.line_count,
                base_count_nonunique=tf.base_count_nonunique,
                base_count_unique=tf.base_count_unique,
                block_bit_offsets=list(enc.block_bit_offsets),
            )
        return writer.finish()


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


def _iter_groups(in_fh, chunk_bytes: int, writer):
    """Each completed chromosome's native transform tuple
    ``(chrom, text, lines, nonunique, unique, offset)``, read chunk by
    chunk; a chromosome whose lines span chunks is carried as raw text
    and transformed when it completes.  Sets ``writer.final_newline``
    at the end.  The same carry logic as the JAX package's streaming
    encode."""
    from starch3_tpu.runtime import bed_transform_native

    def transform_or_raise(raw: bytes):
        groups = bed_transform_native(raw)
        if groups is None:
            _parse_transform(raw)  # the exact diagnostic
            raise BedParseError("unparseable BED chunk")
        return groups

    carry_name: str | None = None
    carry_parts: list[bytes] = []
    partial = b""
    while True:
        chunk = in_fh.read(chunk_bytes)
        if not chunk:
            break
        buf = partial + chunk
        cut = buf.rfind(b"\n")
        if cut < 0:
            partial = buf
            continue
        partial = buf[cut + 1 :]
        buf = buf[: cut + 1]
        groups = transform_or_raise(buf)
        if not groups:
            continue
        names = [g[0] for g in groups]
        if carry_name is not None and names[0] == carry_name and len(groups) == 1:
            carry_parts.append(buf)  # chromosome still continuing
            continue
        offs = [g[5] for g in groups] + [len(buf)]
        spans = [(offs[k], offs[k + 1]) for k in range(len(groups))]
        if carry_name is not None:
            if names[0] == carry_name:
                carry_parts.append(buf[: spans[1][0]])
                groups, names, spans = groups[1:], names[1:], spans[1:]
            yield from transform_or_raise(b"".join(carry_parts))
            carry_name, carry_parts = None, []
        yield from groups[:-1]  # all but the last are complete
        carry_name = names[-1]
        carry_parts = [buf[spans[-1][0] :]]
    writer.final_newline = not partial
    if partial:
        carry_parts.append(partial)  # final line without newline
    if carry_parts:
        yield from transform_or_raise(b"".join(carry_parts))


def compress_bed_stream(
    in_fh,
    out_fh,
    config: EncodeConfig | None = None,
    chunk_bytes: int = 64 << 20,
    device="cuda",
) -> None:
    """Streaming encode from a binary file object, in memory bounded by
    a window of chromosomes: the device queue runs across the whole
    corpus while the parser feeds it.  Output bytes equal
    ``compress_bed_bytes`` on the whole input."""
    from starch3_tpu.runtime import get_lib

    config = config or EncodeConfig()
    if get_lib() is None:  # the streaming parser is native
        out_fh.write(compress_bed_bytes(in_fh.read(), config, device=device))
        return
    if not _on_device(config):
        _host.compress_bed_stream(in_fh, out_fh, config, chunk_bytes)
        return
    from collections import deque

    from starch3_tpu.format.archive import StarchFileWriter

    writer = StarchFileWriter(out_fh, note=config.note, compression=config.method.value)
    seen: set[str] = set()
    meta_q: deque = deque()  # feed-order (chrom, len, lines, nonunique, unique)

    def gen_texts():
        for g in _iter_groups(in_fh, chunk_bytes, writer):
            chrom = g[0]
            if chrom in seen:
                raise BedParseError(
                    f"chromosome {chrom!r} is not contiguous; input must be sorted"
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


def decompress_starch_bytes(data: bytes, workers: int | None = None) -> bytes:
    """.starch archive bytes -> BED text, on the host (native
    block-parallel decode; device decode is ROADMAP A12)."""
    return _host.decompress_starch_bytes(data, workers=workers)
