"""bzip2-compatible block codec, written from scratch.

The reference bundles a patched bzip2 1.0.6 (reference third-party/
bzip2-1.0.6.tar.gz; patch adds a block-close callback to bz_stream,
bzlib.h:66-67) and initializes it with blockSize100k=9, workFactor=30
(reference include/starch3api.hpp:835-837).  This package reimplements the
*format* — not the reference implementation — in three tiers:

  1. ``encoder`` / ``decoder``: a NumPy implementation of the full bzip2
     stream format, validated bit-exactly against libbz2 (Python stdlib
     ``bz2``) in tests/test_bitexact.py.  This is the correctness oracle.
  2. ``starch3_tpu.ops``: JAX/Pallas kernels for the hot stages — BWT
     rotation sort (prefix doubling over XLA sort), MTF (chunked scan),
     Huffman group costing (MXU matmuls) — all checked stage-by-stage
     against tier 1.
  3. ``starch3_tpu.runtime``: C++ host runtime for the serial residue
     (bitstream packing, stream assembly), mirroring the reference's
     choice of native code for its codec layer.

Stage layout of one bzip2 block (what the format requires, established from
the public format and verified against libbz2 output — no reference code was
copied):

    original bytes --CRC32--> blockCRC
    original bytes --RLE1--> block (<= 100k*level - 19 bytes)
    block --BWT rotation sort--> last column + origPtr
    bwt bytes --symbol map + MTF + zero-run RLE2--> mtf symbol stream + EOB
    mtf symbols --2..6 Huffman tables, 50-symbol groups, 4 refinement
                  iterations--> selectors + canonical code lengths
    everything --bit packer--> block bitstream
"""

from starch3_tpu_torch.codec.encoder import bz2_compress
from starch3_tpu_torch.codec.decoder import bz2_decompress

__all__ = ["bz2_compress", "bz2_decompress"]
