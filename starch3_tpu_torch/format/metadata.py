"""Archive metadata schema (the index jansson 2.9 was bundled for).

The reference links jansson and includes its header (reference
include/starch3api.hpp:17, makefile:32) but contains zero json_* call
sites; the evident intent — a per-chromosome index carrying the
statistics held in transform_state_t (line_count maintained at
starch3api.hpp:503; base_count_unique / base_count_nonunique declared at
:61-62 but never computed) — is implemented here for real.

Serialization is canonical (sorted keys, fixed separators) so archives
are byte-deterministic.
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field

from starch3_tpu_torch._version import FORMAT_VERSION
from starch3_tpu_torch.errors import FormatError


@dataclass
class StreamMetadata:
    chromosome: str
    filename: str
    byte_offset: int  # absolute offset of the stream in the archive
    size: int  # compressed bytes
    uncompressed_size: int  # transformed-text bytes
    line_count: int  # BED records in this chromosome
    base_count_nonunique: int  # sum of interval lengths
    base_count_unique: int  # length of interval union
    signature: str  # sha256 hex of the compressed stream
    # absolute bit offset of each bzip2 block's 48-bit magic within the
    # stream — the information the reference's patched bz_stream
    # block-close callback existed to recover (bundled bzlib.h:66-67,
    # fired at bzlib.c:470); recorded here as data, it enables
    # block-parallel decode and block-granular resume
    block_bit_offsets: list[int] = field(default_factory=list)


@dataclass
class ArchiveMetadata:
    note: str = ""
    compression_format: str = "bzip2"
    streams: list[StreamMetadata] = field(default_factory=list)
    creation_timestamp: str | None = None  # optional: omitted by default so
    # identical inputs yield identical archives
    # transformed records are canonically newline-terminated; when the
    # original input's final line lacked its newline this records it so
    # decode strips the synthesized one (byte-exact round trip).  Omitted
    # from the JSON when True (the overwhelmingly common case)
    final_newline: bool = True

    def to_json_bytes(self) -> bytes:
        doc = {
            "type": "starch3-tpu",
            "version": {
                "major": FORMAT_VERSION[0],
                "minor": FORMAT_VERSION[1],
                "revision": FORMAT_VERSION[2],
            },
            "note": self.note,
            "compressionFormat": self.compression_format,
            "streams": [asdict(s) for s in self.streams],
        }
        if self.creation_timestamp is not None:
            doc["creationTimestamp"] = self.creation_timestamp
        if not self.final_newline:
            doc["finalNewline"] = False
        return json.dumps(doc, sort_keys=True, separators=(",", ":")).encode()

    @classmethod
    def from_json_bytes(cls, data: bytes) -> "ArchiveMetadata":
        try:
            doc = json.loads(data)
        except json.JSONDecodeError as e:
            raise FormatError(f"bad metadata JSON: {e}") from e
        if doc.get("type") != "starch3-tpu":
            raise FormatError("not a starch3-tpu archive")
        streams = [StreamMetadata(**s) for s in doc.get("streams", [])]
        return cls(
            note=doc.get("note", ""),
            compression_format=doc.get("compressionFormat", "bzip2"),
            streams=streams,
            creation_timestamp=doc.get("creationTimestamp"),
            final_newline=doc.get("finalNewline", True),
        )
