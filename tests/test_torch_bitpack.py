"""The port's device bit packing (starch3_tpu_torch/ops/bitpack.py) against
the JAX package's (starch3_tpu/ops/bitpack_jax.py) and the host packer
(``codec.bitio.pack_bits``), on the CPU.  Tolerance: zero.

- ``emit_coded_padded`` at ``n_max`` 4096 and 8192, filled below and
  above its capacity ``w_cap``: ``total_bits`` (the whole stream's length
  even past the cap) and every word equal, the words ``uint32``.
- ``pack_bits_device`` with fields of 0-32 bits, into a capacity that
  drops the tail.
- ``pack_bits_via_device`` against ``pack_bits``, mirroring
  ``TestDeviceBitPack`` (tests/test_jax_ops.py)."""

import numpy as np
import pytest
import torch

from starch3_tpu.ops import bitpack_jax
from starch3_tpu_torch.codec.bitio import pack_bits
from starch3_tpu_torch.ops import bitpack, huff
from starch3_tpu_torch.parallel.pipeline import _emit_w_cap

torch.set_num_threads(2)


def _luts(rng, b):
    """Random canonical-looking tables: lengths 1..17, codes below
    2**len, packed ``(code << 5) | len``."""
    lens = rng.integers(1, 18, (b, 6 * huff.ALPHA_MAX))
    codes = rng.integers(0, 1 << 17, lens.shape) & ((1 << lens) - 1)
    return ((codes << 5) | lens).astype(np.int32)


@pytest.mark.parametrize("n_max", [4096, 8192])
def test_emit_matches_jax_below_and_above_cap(rng, n_max):
    w_cap = _emit_w_cap(n_max)
    g_max = huff.n_groups_max(n_max)
    syms = rng.integers(0, 30, (3, n_max + 2)).astype(np.int32)
    syms[0, ::5] = 300  # clipped into the alphabet
    ms = np.array([n_max // 10, n_max + 2, 0], np.int32)
    sel = rng.integers(0, 6, (3, g_max)).astype(np.int32)
    lut = _luts(rng, 3)
    lut[1] |= 16  # lengths 16..31 bits: row 1 overflows the capacity
    words, totals = bitpack.emit_coded_padded(
        torch.from_numpy(syms), torch.from_numpy(ms), torch.from_numpy(sel),
        torch.from_numpy(lut), n_max, w_cap,
    )
    assert words.dtype == torch.uint32 and words.shape == (3, w_cap)
    assert totals.dtype == torch.int32
    for i in range(3):
        want_words, want_total = bitpack_jax.emit_coded_padded(
            syms[i], ms[i], sel[i], lut[i], n_max, w_cap
        )
        assert int(totals[i]) == int(want_total), i
        assert np.array_equal(words[i].numpy(), np.asarray(want_words)), i
    assert int(totals[0]) < 32 * w_cap < int(totals[1])
    assert int(totals[2]) == 0 and not words[2].numpy().any()


def test_pack_bits_device_matches_jax(rng):
    import jax.numpy as jnp

    n = 3000
    nbits = rng.integers(0, 33, n).astype(np.int32)
    vals = (rng.integers(0, 1 << 32, n, dtype=np.uint64) & ((np.uint64(1) << nbits.astype(np.uint64)) - np.uint64(1)))
    n_words = int(nbits.sum()) // 32 - 5  # the last fields are dropped
    words, total = bitpack.pack_bits_device(
        torch.from_numpy(vals.astype(np.int64)), torch.from_numpy(nbits), n_words
    )
    want_words, want_total = bitpack_jax.pack_bits_device(
        jnp.asarray(vals.astype(np.uint32)), jnp.asarray(nbits), n_words
    )
    assert int(total) == int(want_total) == int(nbits.sum())
    assert words.dtype == torch.uint32
    assert np.array_equal(words.numpy(), np.asarray(want_words))


def test_pack_bits_via_device_matches_host(rng):
    for _ in range(8):
        n = int(rng.integers(1, 2000))
        bits = rng.integers(1, 49, n)
        vals = rng.integers(0, 1 << 48, n, dtype=np.uint64) & (
            (np.uint64(1) << bits.astype(np.uint64)) - np.uint64(1)
        )
        whole, tail, tail_n = pack_bits(vals, bits)
        ref = whole + (bytes([(tail << (8 - tail_n)) & 0xFF]) if tail_n else b"")
        assert bitpack.pack_bits_via_device(vals, bits, device="cpu") == ref
        assert bitpack_jax.pack_bits_via_device(vals, bits) == ref
