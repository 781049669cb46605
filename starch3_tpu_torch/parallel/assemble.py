"""Deterministic archive assembly + block manifest (checkpoint/resume).

The reference writes the archive strictly sequentially to stdout
(starch3api.hpp:765-769) and has no recovery story (SURVEY.md §5).  The
rebuild's assembly is a deterministic ordered gather:

  - per-chromosome streams are produced in input order regardless of
    which host/chip encoded them (partitioning is input-derived);
  - a manifest records every stream's (chromosome, content hash, offset,
    size, stats); any interrupted run resumes by re-encoding only the
    chromosomes whose entries are missing or whose hashes mismatch —
    per-stream encode is idempotent, so retry granularity is one stream.
"""

from __future__ import annotations

import hashlib
import json
import os
from dataclasses import dataclass, field

from starch3_tpu_torch.format.archive import StarchWriter


@dataclass
class Manifest:
    """Persistent record of per-chromosome encode results."""

    path: str | None = None
    entries: dict = field(default_factory=dict)  # chrom -> entry dict

    @classmethod
    def load(cls, path: str) -> "Manifest":
        m = cls(path=path)
        if os.path.exists(path):
            with open(path) as f:
                for line in f:
                    if line.strip():
                        e = json.loads(line)
                        m.entries[e["chromosome"]] = e
        return m

    def has(self, chrom: str, input_digest: str) -> bool:
        e = self.entries.get(chrom)
        return bool(e) and e["inputDigest"] == input_digest

    def record(self, chrom: str, input_digest: str, stream_path: str, stats: dict) -> None:
        e = {
            "chromosome": chrom,
            "inputDigest": input_digest,
            "streamPath": stream_path,
            **stats,
        }
        self.entries[chrom] = e
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(e, sort_keys=True) + "\n")


def input_digest(transformed_text: bytes) -> str:
    return hashlib.sha256(transformed_text).hexdigest()


def assemble_ordered(
    chrom_order: list[str],
    results: dict[str, tuple[bytes, dict]],
    note: str = "",
    compression: str = "bzip2",
) -> bytes:
    """Gather per-chromosome (stream, stats) into an archive in input
    order — byte-identical regardless of encode topology."""
    w = StarchWriter(note=note, compression=compression)
    for chrom in chrom_order:
        stream, stats = results[chrom]
        w.add_stream(chrom, stream, **stats)
    return w.finish()
