"""Configuration for starch3-tpu.

The reference's configuration surface is a handful of compile-time constants
(reference include/starch3api.hpp:151-156) plus hardwired bzip2 tuning
(blockSize100k=9, workFactor=30; starch3api.hpp:833-837).  The rebuild keeps
those values as defaults of a real config object and adds the TPU-execution
knobs (mesh shape, block batching) that the reference has no analogue for.
"""

from __future__ import annotations

import dataclasses
import enum


class CompressionMethod(enum.Enum):
    """Mirrors compression_method_t {k_bzip2, k_gzip, undefined}
    (reference include/starch3api.hpp:30-34)."""

    BZIP2 = "bzip2"
    GZIP = "gzip"

    @classmethod
    def default(cls) -> "CompressionMethod":
        # The reference defaults to bzip2 when no flag is given
        # (src/starch3.cpp:164-166).
        return cls.BZIP2


# bzip2 tuning, identical to the reference's BZ2_bzCompressInit(ptr, 9, v, 30)
# call (include/starch3api.hpp:835-837).  blockSize100k=9 means 900_000-byte
# post-RLE1 blocks; work_factor only affects the reference sorter's fallback
# heuristics, never the output bytes, but is kept for parity.
DEFAULT_BLOCK_SIZE_100K = 9
DEFAULT_WORK_FACTOR = 30

# Field delimiters, identical to the reference constants
# (include/starch3api.hpp:155-156).
FIELD_DELIMITER = b"\t"
LINE_DELIMITER = b"\n"


@dataclasses.dataclass(frozen=True)
class EncodeConfig:
    """Everything that shapes an encode run."""

    #: archive-level free-text note (reference --note, src/starch3.cpp:120-123)
    note: str = ""
    #: compression backend (reference --bzip2/--gzip, src/starch3.cpp:124-127)
    method: CompressionMethod = CompressionMethod.BZIP2
    #: bzip2 block size in units of 100 kB (1..9)
    block_size_100k: int = DEFAULT_BLOCK_SIZE_100K
    #: gzip level used when method == GZIP (the reference aborts on gzip;
    #: we implement it, level 6 mirrors common zlib defaults)
    gzip_level: int = 6
    #: transformed-text bytes per gzip member.  A stream larger than this
    #: is emitted as concatenated independent gzip members (valid
    #: multi-member gzip per RFC 1952 — any standard tool decodes it),
    #: with each member's byte boundary recorded in the metadata block
    #: index, giving the gzip tier the same member-parallel encode,
    #: block-parallel decode, and block-granular resume properties as the
    #: bzip2 tier.  <= 0 disables segmentation (one member per stream)
    gzip_segment_bytes: int = 4 << 20
    #: run the heavy per-block codec stages of a bzip2 encode on the device
    #: path when True (the default: on the entry point's ``device``,
    #: ``"cuda"`` unless the caller names ``"cpu"``, and no fallback
    #: without a card); False asks for the native host codec.  The
    #: reference's default is the host codec: this default is the one
    #: difference between the two packages' configurations
    use_jax: bool = True
    #: number of 900 kB blocks batched per device dispatch on the JAX
    #: path.  3 balances dispatch amortization against the hybrid
    #: scheduler's claim granularity (swept on the bench corpus with
    #: the streaming feeder; the post-feeding tail is protected by the
    #: scheduler's stealer reserve, so bigger batches no longer risk a
    #: device straggler)
    blocks_per_batch: int = 3
    #: extend the fused device step through RLE2 (ops/rle2_jax.py), so
    #: the download is the coded symbol stream rather than MTF ranks.
    #: Default off: it lengthens the device program's one-time compile,
    #: which dominates short runs on tunneled backends
    device_rle2: bool = False
    #: sort every rotation once by a packed multi-symbol prefix key
    #: (ops/bwt_fast.py) instead of prefix-doubling, falling back to the
    #: exact host encoder for the rare blocks whose prefixes tie (the
    #: fallback is detected on device, so output bytes never depend on
    #: this flag).  This is the production device path; False forces the
    #: exact prefix-doubling kernel everywhere (tests, worst-case inputs)
    fast_bwt: bool = True
    #: run Huffman group costing (MXU matmuls) and coded-data bit packing
    #: on device too, leaving the host only the 258-node length heaps,
    #: headers, and splicing.  Worth it when chips outnumber host cores
    #: (pods); on a 1-chip host the native C++ tail is faster, so default
    #: off.  Output bytes are identical either way.
    device_huffman: bool = False

    def __post_init__(self) -> None:
        if not 1 <= self.block_size_100k <= 9:
            raise ValueError("block_size_100k must be in 1..9")


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout for sharded encode (parallel/mesh.py).

    The reference's only concurrency is 4 pthreads around one mutex
    (src/starch3.cpp:36-54); here parallelism is data-parallel over
    independent 900 kB blocks across TPU chips.
    """

    #: mesh axis name for the data-parallel block axis
    data_axis: str = "blocks"
    #: number of devices; None = all visible devices
    num_devices: int | None = None
