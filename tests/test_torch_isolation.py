"""The port stands alone: ``starch3_tpu_torch`` and ``chip_smoke.py``
import nothing of the JAX package ``starch3_tpu`` (not even its host
modules, which load no JAX) and nothing of JAX.  The port's host tier is
a copy of the JAX package's, and it must write the same bytes: the
copies are held to their originals, and the two host paths to each
other on seeded BED of each alphabet tier and on the golden archives,
with zero tolerance.  The port's ``config.py`` is held to the original's
in every name, field, type and default but one: ``use_jax`` defaults to
the device path."""

import ast
import dataclasses
import enum
import fcntl
import io
import re
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
# prefix of their imports rewritten and nothing else changed (config.py
# differs in use_jax's default: test_config_*)
COPIED = sorted(
    str(p.relative_to(JAX_PKG))
    for d in ("codec", "bed", "format", "transform")
    for p in (JAX_PKG / d).iterdir()
    if p.suffix in (".py", ".md")
) + ["errors.py", "_version.py", "runtime/runtime.cpp", "parallel/assemble.py"]


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


def _config_names(mod) -> list[str]:
    """The module's own public names: its enums, constants and dataclasses."""
    return sorted(
        n for n, v in vars(mod).items()
        if not n.startswith("_") and n != "annotations" and not isinstance(v, type(ast))
    )


def _plain(value):
    """An enum member as its class's name and its value (each package has
    its own enum class); anything else as it is."""
    return (type(value).__name__, value.value) if isinstance(value, enum.Enum) else value


def test_config_has_the_originals_names():
    assert _config_names(config) == _config_names(jax_config)
    assert len(_config_names(config)) == 7


@pytest.mark.parametrize("name", _config_names(jax_config))
def test_config_name_equals_the_original(name):
    """Each enum by its members and default, each constant by type and
    value, each dataclass by its parameters and its fields' names, types
    and defaults; the one difference is ``EncodeConfig.use_jax``'s default,
    the device path in the port and the host codec in the reference."""
    ours, theirs = getattr(config, name), getattr(jax_config, name)
    if isinstance(theirs, type) and issubclass(theirs, enum.Enum):
        assert [(m.name, m.value) for m in ours] == [(m.name, m.value) for m in theirs]
        assert ours.default().value == theirs.default().value
    elif dataclasses.is_dataclass(theirs):
        assert repr(ours.__dataclass_params__) == repr(theirs.__dataclass_params__)
        fields, want = ([(f.name, f.type, _plain(f.default), f.default_factory, f.init) for f in dataclasses.fields(c)]
                        for c in (ours, theirs))
        if name == "EncodeConfig":
            i = [f[0] for f in want].index("use_jax")
            assert (want[i][2], fields[i][2]) == (False, True)
            fields[i] = want[i]
        assert fields == want
        assert set(vars(ours)) - {"__module__", "__doc__"} == set(vars(theirs)) - {"__module__", "__doc__"}
    else:
        assert (type(ours), ours) == (type(theirs), theirs)


def test_config_rejects_what_the_original_rejects():
    for bad in (0, 10):
        with pytest.raises(ValueError, match="block_size_100k"):
            config.EncodeConfig(block_size_100k=bad)
        with pytest.raises(ValueError, match="block_size_100k"):
            jax_config.EncodeConfig(block_size_100k=bad)
    assert config.EncodeConfig().use_jax is True and jax_config.EncodeConfig().use_jax is False


def test_config_source_differs_only_in_use_jax():
    """The port's source is the original's, but for ``use_jax``'s comment
    and default."""
    use_jax = re.compile(r"(?:    #:[^\n]*\n)*    use_jax: bool = (?:True|False)\n")
    ours, theirs = (PORT / "config.py").read_text(), (JAX_PKG / "config.py").read_text()
    assert len(use_jax.findall(ours)) == len(use_jax.findall(theirs)) == 1
    assert use_jax.sub("", ours) == use_jax.sub("", theirs)
    assert "use_jax: bool = True" in ours


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
        "bits6": corpus.bits6_bed(seed=5, n_per=300),
        "wide8": corpus.wide8_bed(seed=4, chroms=("chr1", "chr2"), n_per=300),
    }


@pytest.mark.parametrize("name", ["config2", "config3", "bits6", "wide8"])
@pytest.mark.parametrize("method", ["bzip2", "gzip"])
def test_host_path_equals_jax_package(name, method):
    """The port's host path, asked for with ``use_jax=False``, against the
    JAX package's default (its host path)."""
    bed = _beds()[name]
    cfg = config.EncodeConfig(method=config.CompressionMethod(method), use_jax=False)
    got = api.compress_bed_bytes(bed, cfg)
    want = jax_api.compress_bed_bytes(
        bed, jax_config.EncodeConfig(method=jax_config.CompressionMethod(method))
    )
    assert got == want
    assert api.decompress_starch_bytes(got, use_jax=False) == jax_api.decompress_starch_bytes(want) == bed
    assert api.list_chromosomes(got) == jax_api.list_chromosomes(want)
    chrom = api.list_chromosomes(got)[-1]["chromosome"]
    assert api.extract_chromosome(got, chrom) == jax_api.extract_chromosome(want, chrom)
    out = io.BytesIO()
    api.compress_bed_stream(io.BytesIO(bed), out, cfg, chunk_bytes=4096)
    assert out.getvalue() == got


@pytest.mark.parametrize("path", sorted((ROOT / "tests").glob("golden*.starch")), ids=lambda p: p.name)
def test_golden_archives_decode_alike(path):
    data = path.read_bytes()
    assert api.decompress_starch_bytes(data, use_jax=False) == jax_api.decompress_starch_bytes(data)
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
    never compares against None.  Every port test that reads the JAX
    package's native entry points calls it first
    (``test_port_tests_reach_jax_runtime_only_through_helper``)."""
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


# A port test reaches the JAX package's native loader and entry points
# only after _jax_runtime_lib: called first, they return None in a worker
# that lost the reference's build race.
JAX_RUNTIME = "starch3_tpu.runtime"


def _import_aliases(nodes) -> dict:
    """Each name the imports among ``nodes`` bind, mapped to the dotted
    name it stands for."""
    aliases = {}
    for node in nodes:
        if isinstance(node, ast.Import):
            for a in node.names:
                name = a.name if a.asname else a.name.split(".")[0]
                aliases[a.asname or name] = name
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            for a in node.names:
                aliases[a.asname or a.name] = f"{node.module}.{a.name}"
    return aliases


def _dotted(node, aliases: dict):
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name) or node.id not in aliases:
        return None
    return ".".join([aliases[node.id], *reversed(parts)])


def _jax_runtime_uses(source: str) -> list:
    """(line, name, guarded) for each use in ``source`` of the JAX
    package's ``get_lib`` or of an entry point of its runtime that ends in
    ``_native``; guarded when the function (or the module's top level)
    that makes it has called ``_jax_runtime_lib`` before it."""
    tree = ast.parse(source)
    defs = (ast.FunctionDef, ast.AsyncFunctionDef)
    units = [s for s in tree.body if isinstance(s, defs)]
    units += [f for c in tree.body if isinstance(c, ast.ClassDef) for f in c.body if isinstance(f, defs)]
    top = [s for s in tree.body if not isinstance(s, (*defs, ast.ClassDef))]
    module_aliases = _import_aliases(n for s in top for n in ast.walk(s))
    uses = []
    for unit in [*units, ast.Module(body=top, type_ignores=[])]:
        if getattr(unit, "name", None) == "_jax_runtime_lib":
            continue
        nodes = list(ast.walk(unit))
        aliases = {**module_aliases, **_import_aliases(nodes)}
        guards = [
            (n.lineno, n.col_offset)
            for n in nodes
            if isinstance(n, ast.Call)
            and "_jax_runtime_lib" in (getattr(n.func, "id", None), getattr(n.func, "attr", None))
        ]
        for n in nodes:
            name = _dotted(n, aliases) if isinstance(n, (ast.Name, ast.Attribute)) else None
            module, _, attr = (name or "").rpartition(".")
            if module == JAX_RUNTIME and (attr.endswith("_native") or attr == "get_lib"):
                uses.append((n.lineno, name, any(g < (n.lineno, n.col_offset) for g in guards)))
    return sorted(uses)


IMPORT_R = "from starch3_tpu import runtime as r\n"
GUARD_CASES = {  # source, the lines of its unguarded uses
    "unguarded": (IMPORT_R + "def test_a():\n    r.bed_transform_native(b'')\n", [3]),
    "guarded": (IMPORT_R + "def test_a():\n    _jax_runtime_lib()\n    r.bed_transform_native(b'')\n", []),
    "guard_after": (IMPORT_R + "def test_a():\n    r.dense_pack4_native(a, b)\n    _jax_runtime_lib()\n", [3]),
    "get_lib": ("import starch3_tpu.runtime as rt\ndef test_a():\n    assert rt.get_lib()\n", [3]),
    "full_path": ("import starch3_tpu.runtime\ndef test_a():\n    starch3_tpu.runtime.get_lib()\n", [3]),
    "from_import": (
        "from starch3_tpu.runtime import dense_pack_words_native as p\ndef test_a():\n    p(a, 5, b)\n", [3]),
    "local_import": (
        "from starch3_tpu_torch import runtime\ndef test_a():\n    from starch3_tpu import runtime\n"
        "    runtime.bed_transform_native(b'')\n", [4]),
    "method": (IMPORT_R + "class T:\n    def test_a(self):\n        f = r.bed_transform_native\n", [4]),
    "module_level": (IMPORT_R + "LIB = r.get_lib()\n", [2]),
    "other_guarded_test": (
        IMPORT_R + "def test_a():\n    _jax_runtime_lib()\ndef test_b():\n    r.bed_transform_native(b'')\n", [5]),
    "port_runtime": (
        "from starch3_tpu_torch import runtime\ndef test_a():\n"
        "    runtime.get_lib(); runtime.bed_transform_native(b'')\n", []),
    "not_an_entry_point": (IMPORT_R + "def test_a():\n    r._is_stale(); r.lib_path\n", []),
}


@pytest.mark.parametrize("case", sorted(GUARD_CASES))
def test_jax_runtime_guard_finds_unguarded_uses(case):
    source, lines = GUARD_CASES[case]
    assert [line for line, _, guarded in _jax_runtime_uses(source) if not guarded] == lines


def test_port_tests_reach_jax_runtime_only_through_helper():
    """No port test calls the JAX package's native loader or entry points
    before ``_jax_runtime_lib``, and the guard sees the tests that do."""
    unguarded, users = [], set()
    for path in sorted((ROOT / "tests").glob("test_torch_*.py")):
        for line, name, guarded in _jax_runtime_uses(path.read_text()):
            users.add(path.name)
            if not guarded:
                unguarded.append(f"{path.relative_to(ROOT)}:{line}: {name} before _jax_runtime_lib()")
    assert not unguarded, "\n".join(unguarded)
    assert {"test_torch_isolation.py", "test_torch_step.py", "test_torch_stream_feed.py"} <= users
