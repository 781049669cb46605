"""Fixtures of the benchmark's tests: a copy of ``portbench/`` with its
configurations cut to a few hundred kB (``tiny``), and ``card``, which
skips a test without a CUDA card (decided when the test runs)."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
PORTBENCH = HERE.parent
REPO = PORTBENCH.parent
# each configuration's writer arguments and target at the tests' size
TINY = {"wgs_bed3": ({"n_total": 20_000, "lengths": [150, 350]}, None), "chipseq_reads": ({"n_total": 300_000}, 2_000_000)}


def copy_portbench(dest: Path) -> Path:
    """``portbench/`` and ``BENCHMARK.json`` under ``dest``; returns the
    copy's ``portbench``."""
    root = dest / "portbench"
    shutil.copytree(PORTBENCH, root, ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", dest / "BENCHMARK.json")
    return root


@pytest.fixture
def tiny(tmp_path):
    """A ``Layout`` of a copy whose configurations are cut to the tests'
    size."""
    from portbench.layout import Layout

    root = copy_portbench(tmp_path)
    for name, (args, target) in TINY.items():
        path = root / "configs" / f"{name}.json"
        cfg = json.loads(path.read_text())
        cfg["writer_args"], cfg["target_bytes"] = args, target
        path.write_text(json.dumps(cfg))
    return Layout(root)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.cuda.get_device_name(0)
