"""Starch archive container: magic, per-chromosome streams, metadata, footer.

Layout (format/SPEC.md has the normative description):

    [0:4]   magic bytes 0xca 0x5c 0xad 0x1a
            (identical to the reference's header, include/starch3api.hpp:
            907-910, written immediately on out-stream init, :765-769)
    [4:..]  per-chromosome compressed streams, concatenated in input
            order; each is an independent, complete bzip2 (or gzip) stream
    [..]    metadata: UTF-8 JSON document (schema in metadata.py — the
            index jansson was bundled for but never fed,
            include/starch3api.hpp:17)
    [-128:] footer, fixed 128 bytes:
              [0:20]    decimal byte offset of the metadata, zero-padded
              [20:64]   base64(SHA-256(metadata bytes)), 44 chars
              [64:80]   format tag, 'starch3-tpu/1.1' zero-padded
              [80:124]  reserved (zeros)
              [124:128] magic bytes again (archive self-identification
                        from either end)

Everything is deterministic: identical input + config => identical archive
bytes, regardless of host/chip topology (BASELINE.json determinism
requirement; block partitioning is input-derived only).
"""

from __future__ import annotations

import base64
import hashlib
import json
from dataclasses import dataclass

from starch3_tpu_torch.errors import FormatError
from starch3_tpu_torch.format.metadata import ArchiveMetadata, StreamMetadata

ARCHIVE_MAGIC = bytes([0xCA, 0x5C, 0xAD, 0x1A])
FOOTER_LEN = 128
FORMAT_TAG = b"starch3-tpu/1.1"


def build_footer(metadata_offset: int, metadata_bytes: bytes) -> bytes:
    off = str(metadata_offset).rjust(20, "0").encode()
    digest = base64.b64encode(hashlib.sha256(metadata_bytes).digest())
    assert len(digest) == 44
    tag = FORMAT_TAG.ljust(16, b"\x00")
    footer = off + digest + tag + b"\x00" * 44 + ARCHIVE_MAGIC
    assert len(footer) == FOOTER_LEN
    return footer


@dataclass
class StarchWriter:
    """Streaming archive writer: magic, then streams, then metadata+footer."""

    note: str = ""
    compression: str = "bzip2"
    final_newline: bool = True  # see metadata.ArchiveMetadata

    def __post_init__(self) -> None:
        self._chunks: list[bytes] = [ARCHIVE_MAGIC]
        self._offset = len(ARCHIVE_MAGIC)
        self._streams: list[StreamMetadata] = []

    def add_stream(
        self,
        chrom: str,
        compressed: bytes,
        *,
        uncompressed_size: int,
        line_count: int,
        base_count_nonunique: int,
        base_count_unique: int,
        block_bit_offsets: list[int] | None = None,
    ) -> None:
        self._chunks.append(compressed)
        self._streams.append(
            StreamMetadata(
                chromosome=chrom,
                filename=f"{chrom}.{self.compression_ext}",
                byte_offset=self._offset,
                size=len(compressed),
                uncompressed_size=uncompressed_size,
                line_count=line_count,
                base_count_nonunique=base_count_nonunique,
                base_count_unique=base_count_unique,
                signature=hashlib.sha256(compressed).hexdigest(),
                block_bit_offsets=list(block_bit_offsets or []),
            )
        )
        self._offset += len(compressed)

    @property
    def compression_ext(self) -> str:
        return "bz2" if self.compression == "bzip2" else "gz"

    def finish(self) -> bytes:
        meta = ArchiveMetadata(
            note=self.note,
            compression_format=self.compression,
            streams=self._streams,
            final_newline=self.final_newline,
        )
        meta_bytes = meta.to_json_bytes()
        footer = build_footer(self._offset, meta_bytes)
        return b"".join(self._chunks) + meta_bytes + footer


class StarchFileWriter(StarchWriter):
    """StarchWriter that spills each stream to a file object as it
    arrives instead of accumulating in memory — the constant-memory sink
    of the streaming encoder (api.compress_bed_file).  Bytes written are
    identical to StarchWriter's for the same inputs."""

    def __init__(self, fh, note: str = "", compression: str = "bzip2") -> None:
        super().__init__(note=note, compression=compression)
        # final_newline may be assigned any time before finish()
        self._fh = fh
        fh.write(ARCHIVE_MAGIC)
        self._chunks.clear()  # magic already on disk; nothing buffers

    def add_stream(self, chrom: str, compressed: bytes, **kw) -> None:
        super().add_stream(chrom, compressed, **kw)
        self._fh.write(self._chunks.pop())

    def finish(self) -> None:
        # _chunks is empty, so the parent returns exactly metadata+footer
        self._fh.write(super().finish())


@dataclass
class StarchReader:
    metadata: ArchiveMetadata
    _data: bytes

    @classmethod
    def from_bytes(cls, data: bytes) -> "StarchReader":
        if len(data) < len(ARCHIVE_MAGIC) + FOOTER_LEN:
            raise FormatError("archive too short")
        if data[:4] != ARCHIVE_MAGIC:
            raise FormatError("bad archive magic")
        footer = data[-FOOTER_LEN:]
        if footer[124:128] != ARCHIVE_MAGIC:
            raise FormatError("bad archive footer magic")
        try:
            meta_offset = int(footer[:20])
        except ValueError as e:
            raise FormatError("bad metadata offset in footer") from e
        meta_bytes = data[meta_offset : len(data) - FOOTER_LEN]
        digest = base64.b64encode(hashlib.sha256(meta_bytes).digest())
        if digest != footer[20:64]:
            raise FormatError("metadata digest mismatch")
        meta = ArchiveMetadata.from_json_bytes(meta_bytes)
        return cls(metadata=meta, _data=data)

    def stream_bytes(self, chrom: str) -> bytes:
        for s in self.metadata.streams:
            if s.chromosome == chrom:
                return self._data[s.byte_offset : s.byte_offset + s.size]
        raise KeyError(chrom)

    def iter_streams(self):
        for s in self.metadata.streams:
            yield s, self._data[s.byte_offset : s.byte_offset + s.size]


def write_archive(streams, note: str = "", compression: str = "bzip2") -> bytes:
    """Convenience: streams = iterable of (chrom, compressed, stats dict)."""
    w = StarchWriter(note=note, compression=compression)
    for chrom, compressed, stats in streams:
        w.add_stream(chrom, compressed, **stats)
    return w.finish()


def read_archive(data: bytes) -> StarchReader:
    return StarchReader.from_bytes(data)
