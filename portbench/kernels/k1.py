"""K1, the narrow MTF at width 16 (``starch3_tpu_torch/ops/mtf_narrow.py``,
``csrc/mtf_narrow.cu``'s ``mtf16_kernel``): the ranks of the bits-4
tier's blocks, 3-column BED's.  Its bytes are the data's own: one byte
read per symbol of a block's real (unpadded) length and one byte written
per rank, whatever types and padding an implementation uses."""

NAMES = (r"\bmtf16_kernel\b",)
BITS = 4  # the alphabet class whose blocks K1 at width 16 ranks


def bytes_moved(packs) -> int | None:
    n = sum(sum(lens) for bits, lens in packs if bits == BITS)
    return 2 * n or None
