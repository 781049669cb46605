"""No run loads JAX or the JAX package, and the harness reads nothing of
the JAX package's benchmark.  Module names are compared by their
top-level name, whole: ``starch3_tpu_torch`` is the port, and passes."""

import ast
import json
import subprocess
import sys
import types
from pathlib import Path

import pytest

from portbench import run as harness
from portbench.tests.conftest import PORTBENCH, REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "starch3_tpu"}

# a run at the tests' size in a fresh process, with every reader,
# kernel and writer of the layout loaded, then the top-level names of
# what it loaded
SCRIPT = """
import json, sys, time
from pathlib import Path
from portbench import check, control, peaks, run, trace, traffic, window
from portbench.layout import Layout
from portbench.reference import starch
layout = Layout(Path(sys.argv[1]))
for kind in ("metrics", "kernels", "corpora"):
    for path in sorted((layout.root / kind).glob("*.py")):
        if path.stem != "__init__":
            layout.module(kind, path.stem)
for cell in ("bed3.bulk", "reads.bulk"):
    for traced in (False, True):
        line, _ = run.run_cell(layout, cell, 5, 0.1, traced, device="cpu", t0=time.perf_counter())
        assert line["correct"], line
print(json.dumps(sorted({m.partition(".")[0] for m in list(sys.modules)})))
"""


def test_a_run_loads_no_jax(tiny):
    out = subprocess.run([sys.executable, "-c", SCRIPT, str(tiny.root)], cwd=REPO, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "starch3_tpu_torch" in loaded and "torch" in loaded
    assert not loaded & FORBIDDEN


@pytest.mark.parametrize("name, found", [("starch3_tpu_torch.api", []), ("starch3_tpu.codec", ["starch3_tpu"]),
                                         ("jaxlib.xla_client", ["jaxlib"]), ("flax", ["flax"]),
                                         ("jax_fake_helper", [])])
def test_forbidden_names_compare_whole(monkeypatch, name, found):
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert (name.partition(".")[0] in harness.forbidden_modules()) == bool(found)


def _sources():
    return sorted(p for p in PORTBENCH.rglob("*.py") if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(PORTBENCH)))
def test_imports_and_reads(path):
    """No file imports JAX, the JAX package or the JAX package's bench
    (the root ``bench.py``, ``benchmarks/``), nor names their files; the
    reference imports nothing of the program or of the harness."""
    tree = ast.parse(path.read_text())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.partition(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            tops.add(node.module.partition(".")[0])
    assert not tops & (FORBIDDEN | {"bench", "benchmarks"})
    if "reference" in path.relative_to(PORTBENCH).parts:
        assert not tops & {"starch3_tpu_torch", "portbench", "torch"}
    if path != Path(__file__).resolve():
        words = {"bench" + ".py", "benchmarks" + "/"}
        strings = [n.value for n in ast.walk(tree) if isinstance(n, ast.Constant) and isinstance(n.value, str)]
        assert not [s for s in strings if any(w in s for w in words)]
