"""The port stands alone: ``starch3_tpu_torch`` and ``chip_smoke.py``
import nothing of the JAX package ``starch3_tpu`` (not even its host
modules, which load no JAX) and nothing of JAX.  The port's host tier is
a copy of the JAX package's, and it must write the same bytes: the
copies are held to their originals, and the two host paths to each
other on seeded BED of each alphabet tier and on the golden archives,
with zero tolerance."""

import ast
import fcntl
import io
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from starch3_tpu import api as jax_api
from starch3_tpu import runtime as jax_runtime
from starch3_tpu import config as jax_config
from starch3_tpu_torch import _build, api, config, corpus, runtime

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "starch3_tpu_torch"
JAX_PKG = ROOT / "starch3_tpu"

# the JAX package's modules the port keeps copies of, with the package
# prefix of their imports rewritten and nothing else changed
COPIED = sorted(
    str(p.relative_to(JAX_PKG))
    for d in ("codec", "bed", "format", "transform")
    for p in (JAX_PKG / d).iterdir()
    if p.suffix in (".py", ".md")
) + ["config.py", "errors.py", "_version.py", "runtime/runtime.cpp", "parallel/assemble.py"]


def _is_jax_package(name: str) -> bool:
    return name == "starch3_tpu" or name.startswith("starch3_tpu.")


def test_no_module_of_the_jax_package_or_jax_loads():
    """A fresh process where importing ``starch3_tpu`` raises imports every
    module of the port and ``chip_smoke``; neither JAX nor the JAX package
    is then loaded."""
    code = f"""
import importlib.abc, pkgutil, sys
class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name == "starch3_tpu" or name.startswith("starch3_tpu."):
            raise ImportError("the port imported " + name)
sys.meta_path.insert(0, Refuse())
sys.path.insert(0, {str(ROOT)!r})
import starch3_tpu_torch
names = [m.name for m in pkgutil.walk_packages(starch3_tpu_torch.__path__, "starch3_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "starch3_tpu" or m.startswith("starch3_tpu."))
assert not bad, bad
assert len(names) > 20, names
print(len(names))
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize(
    "path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"], ids=lambda p: str(p.relative_to(ROOT))
)
def test_source_imports_nothing_of_jax(path):
    bad = [n for n in _imports(path) if _is_jax_package(n) or n == "jax" or n.startswith("jax.")]
    assert not bad, bad


@pytest.mark.parametrize("rel", COPIED)
def test_copy_equals_its_original(rel):
    """A fix to one copy that misses the other shows here."""
    want = (JAX_PKG / rel).read_text()
    want = want.replace("from starch3_tpu.", "from starch3_tpu_torch.").replace(
        "from starch3_tpu import", "from starch3_tpu_torch import"
    )
    assert (PORT / rel).read_text() == want


def test_runtime_builds_into_build_dir():
    """The port's native runtime loads, from its own build, never the JAX
    package's library."""
    assert runtime.get_lib() is not None
    assert runtime.lib_path.parent == _build.BUILD_DIR
    assert runtime.lib_path.name.startswith("runtime-")
    assert runtime.lib_path != Path(jax_runtime.__file__).parent / "_runtime.so"


def _beds():
    return {
        "config2": corpus.make_bed(corpus.GENOME_CHROMS[:3], 900, seed=2),
        "config3": corpus.config3_bed(seed=3, n_per=300),
        "wide8": corpus.wide8_bed(seed=4, chroms=("chr1", "chr2"), n_per=300),
    }


@pytest.mark.parametrize("name", ["config2", "config3", "wide8"])
@pytest.mark.parametrize("method", ["bzip2", "gzip"])
def test_host_path_equals_jax_package(name, method):
    bed = _beds()[name]
    cfg = config.EncodeConfig(method=config.CompressionMethod(method))
    got = api.compress_bed_bytes(bed, cfg)
    want = jax_api.compress_bed_bytes(
        bed, jax_config.EncodeConfig(method=jax_config.CompressionMethod(method))
    )
    assert got == want
    assert api.decompress_starch_bytes(got) == jax_api.decompress_starch_bytes(want) == bed
    assert api.list_chromosomes(got) == jax_api.list_chromosomes(want)
    chrom = api.list_chromosomes(got)[-1]["chromosome"]
    assert api.extract_chromosome(got, chrom) == jax_api.extract_chromosome(want, chrom)
    out = io.BytesIO()
    api.compress_bed_stream(io.BytesIO(bed), out, cfg, chunk_bytes=4096)
    assert out.getvalue() == got


@pytest.mark.parametrize("path", sorted((ROOT / "tests").glob("golden*.starch")), ids=lambda p: p.name)
def test_golden_archives_decode_alike(path):
    data = path.read_bytes()
    assert api.decompress_starch_bytes(data) == jax_api.decompress_starch_bytes(data)
    rows = api.list_chromosomes(data)
    assert rows == jax_api.list_chromosomes(data)
    for row in rows:
        chrom = row["chromosome"]
        assert api.extract_chromosome(data, chrom) == jax_api.extract_chromosome(data, chrom)


def _jax_runtime_lib(deadline_s: float = 60.0):
    """The JAX package's native library, once it is whole.

    Its loader builds ``_runtime.so`` in place with no lock and caches a
    failed load for good, so a test worker that loads while another
    process rebuilds the library gets None (the reference's build race,
    ROADMAP C).  Here one waiter at a time, under a lock in ``build/``,
    polls until the stamp is current and the library loads, then asks the
    loader again; past the deadline the test fails with that message and
    never compares against None."""
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    end = time.monotonic() + deadline_s
    with open(_build.BUILD_DIR / "jax-runtime-wait.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        while jax_runtime._lib is None:
            if jax_runtime._is_stale() or _loads(jax_runtime._SO):
                jax_runtime._tried = False  # ask again: it loads the whole file, or builds a stale one
                if jax_runtime.get_lib() is not None:
                    break
            if time.monotonic() > end:
                pytest.fail(
                    f"the JAX package's native runtime ({jax_runtime._SO}) did not build and load "
                    f"within {deadline_s:.0f} s; its loader returned None"
                )
            time.sleep(0.2)
    return jax_runtime._lib


def _loads(path: str) -> bool:
    """True when the library at ``path`` loads (it is whole), tried in a
    child process: a half-written library can crash the process that maps
    it rather than raise."""
    probe = "import ctypes, sys; ctypes.CDLL(sys.argv[1])"
    return subprocess.run([sys.executable, "-c", probe, path], capture_output=True, timeout=60).returncode == 0


def test_native_entry_points_equal_jax_package():
    """The two runtimes from one source: the dense pack of the bits-4 tier
    and the BED transform give equal outputs."""
    _jax_runtime_lib()
    bed = _beds()["config3"]
    assert runtime.bed_transform_native(bed) == jax_runtime.bed_transform_native(bed)
    text = api._parse_transform(_beds()["config2"])[0].text
    arr = np.frombuffer(text, np.uint8)
    got_row = np.zeros(-(-arr.size // 2), np.uint8)
    want_row = np.zeros_like(got_row)
    got = runtime.dense_pack4_native(arr, got_row)
    want = jax_runtime.dense_pack4_native(arr, want_row)
    assert got is not None and got[0] == want[0] and (got[1] == want[1]).all()
    assert (got_row == want_row).all()
