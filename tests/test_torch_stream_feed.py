"""The port's streaming feed (``api.compress_bed_stream``) and its native
transform (``runtime.bed_transform_native``), which read into one reused
buffer, cut lines by views and carry a chromosome across chunks in a
NumPy buffer: the archive bytes equal the JAX package's
``compress_bed_stream`` and ``compress_bed_bytes`` on the same BED, on
the host path and on the port's device path on the CPU, and the
transform equals the JAX package's whatever buffer it is given."""

import io
import re

import numpy as np
import pytest

from starch3_tpu import api as jax_api
from starch3_tpu import runtime as jax_runtime
from starch3_tpu.config import EncodeConfig as JaxEncodeConfig
from starch3_tpu_torch import api, corpus, runtime
from starch3_tpu_torch.config import EncodeConfig

from tests.test_torch_isolation import _jax_runtime_lib


class _ReadOnly:
    """A binary file object with ``read`` and no ``readinto``."""

    def __init__(self, data: bytes):
        self._f = io.BytesIO(data)

    def read(self, n: int = -1) -> bytes:
        return self._f.read(n)


def _bed(case: str) -> bytes:
    if case == "blank_lines":
        # a run of blank lines longer than a chunk inside a chromosome
        bed = corpus.make_bed(("chr1", "chr2"), 600, 4)
        mid = bed.index(b"\n", len(bed) // 4) + 1
        return bed[:mid] + b"\n" * 3000 + bed[mid:]
    if case == "long_chromosome":
        # chr2 holds about 190 kB: at 4 kB a chunk it spans some 47 chunks
        return corpus.make_bed(("chr1", "chr2", "chr3"), 300, 5) + corpus.make_bed(("chr4",), 8_000, 6)
    bed = corpus.make_bed(("chr1", "chr2", "chrM"), 1_200, 3)
    return bed[:-1] if case == "no_final_newline" else bed


# (case, chunk_bytes, reader): an odd chunk size cuts inside lines
CASES = [
    ("cut_inside_a_line", 997, io.BytesIO),
    ("long_chromosome", 4096, io.BytesIO),
    ("no_final_newline", 777, io.BytesIO),
    ("no_readinto", 1_501, _ReadOnly),
    ("blank_lines", 1_024, io.BytesIO),
]


@pytest.mark.parametrize("use_jax", [False, True], ids=["host", "device_cpu"])
@pytest.mark.parametrize("case,chunk_bytes,reader", CASES, ids=[c[0] for c in CASES])
def test_stream_equals_jax_package(case, chunk_bytes, reader, use_jax):
    bed = _bed(case)
    assert hasattr(reader(bed), "readinto") == (case != "no_readinto")
    out = io.BytesIO()
    api.compress_bed_stream(reader(bed), out, EncodeConfig(use_jax=use_jax, block_size_100k=1),
                            chunk_bytes=chunk_bytes, device="cpu")
    want = io.BytesIO()
    jax_api.compress_bed_stream(io.BytesIO(bed), want, JaxEncodeConfig(block_size_100k=1),
                                chunk_bytes=chunk_bytes)
    assert out.getvalue() == want.getvalue()
    assert out.getvalue() == jax_api.compress_bed_bytes(bed, JaxEncodeConfig(block_size_100k=1))
    # an archive keeps no blank line
    assert api.decompress_starch_bytes(out.getvalue(), use_jax=False) == re.sub(rb"\n+", b"\n", bed)


def _transform_bed() -> bytes:
    bed = corpus.make_bed(("chr1", "chr2"), 2_000, 9) + corpus.config3_bed(n_per=300)[:20_000]
    return bed[: bed.rfind(b"\n") + 1]


@pytest.mark.parametrize("kind", ["bytes", "bytearray", "memoryview", "numpy_view"])
def test_transform_takes_any_buffer(kind):
    _jax_runtime_lib()
    bed = _transform_bed()
    data = {
        "bytes": lambda: bed,
        "bytearray": lambda: bytearray(bed),
        "memoryview": lambda: memoryview(bed),
        # a slice of a larger buffer, as the feed hands it over
        "numpy_view": lambda: np.frombuffer(b"#" * 7 + bed, np.uint8)[7:],
    }[kind]()
    got = runtime.bed_transform_native(data)
    want = jax_runtime.bed_transform_native(bed)
    assert got == want and len(got) == 5  # chr1, chr2, then BED6 lines of chr1-chr3
    for g, w in zip(got, want):
        assert bytes(g[1]) == w[1] and g[1].readonly


def test_lost_jax_runtime_load_is_retried():
    """A worker whose first load of the JAX package's runtime lost the
    build race keeps None for good (``_lib`` None, ``_tried`` True);
    ``_jax_runtime_lib`` loads it again, the reference's transform then
    equals the port's, and the loaded library is back afterwards."""
    lib = _jax_runtime_lib()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_runtime, "_lib", None)
        mp.setattr(jax_runtime, "_tried", True)
        assert jax_runtime.get_lib() is None
        assert _jax_runtime_lib() is not None and jax_runtime.get_lib() is jax_runtime._lib
        bed = _transform_bed()
        want = jax_runtime.bed_transform_native(bed)
        assert want is not None and runtime.bed_transform_native(bed) == want
    assert jax_runtime._lib is lib and jax_runtime.get_lib() is lib
