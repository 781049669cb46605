"""Where the harness finds each piece of a cell, by its name:

- ``BENCHMARK.json``, beside this folder: the cells, their chips and
  which metrics each reports;
- ``workloads/<cell>.json``: the cell's configuration, its traffic mix
  and why it exists;
- ``configs/<config>.json``: a deployment, the writer of its BED and the
  writer's arguments;
- ``traffic/<traffic>.json``: a traffic mix's parameters;
- ``corpora/<writer>.py``, ``metrics/<metric>.py``, ``kernels/<kernel>.py``:
  code, loaded from its file.

A later cell, configuration, traffic mix, metric or kernel is a new file
and new entries in ``BENCHMARK.json``; no file here changes."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


class Layout:
    """The pieces under ``root`` (this folder, or a copy of it)."""

    def __init__(self, root: Path = HERE, benchmark: Path | None = None):
        self.root = Path(root)
        self.benchmark_path = Path(benchmark) if benchmark else self.root.parent / "BENCHMARK.json"
        self._modules: dict = {}

    def benchmark(self) -> dict:
        return json.loads(self.benchmark_path.read_text())

    def data(self, kind: str, name: str) -> dict:
        return json.loads((self.root / kind / f"{name}.json").read_text())

    def module(self, kind: str, name: str):
        """The module of ``<kind>/<name>.py``, loaded once."""
        key = (kind, name)
        if key not in self._modules:
            path = self.root / kind / f"{name}.py"
            spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{name.replace('.', '_')}", path)
            if spec is None or not path.is_file():
                raise FileNotFoundError(f"no {kind[:-1]} named {name!r}: {path} is missing")
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            self._modules[key] = mod
        return self._modules[key]

    def cell(self, name: str) -> dict:
        """The cell's entry of ``BENCHMARK.json`` with its own file's keys."""
        entries = [w for w in self.benchmark()["workloads"] if w["name"] == name]
        if not entries:
            raise KeyError(f"BENCHMARK.json has no workload named {name!r}")
        return {**self.data("workloads", name), **entries[0]}

    def metrics(self, cell: str, kind: str) -> list[dict]:
        """The entries of ``kind`` (``end_to_end`` or ``per_layer``) that
        ``cell`` reports.  A per-layer metric lists its cells under
        ``workloads``; an end-to-end metric reports in every cell, or in
        those it lists where it has the key (a metric that only some
        traffic has, such as a per-file tail)."""
        spec = self.benchmark()
        if kind == "end_to_end":
            return [m for m in spec["end_to_end"] if cell in m.get("workloads", [cell])]
        unlisted = [m["name"] for m in spec["per_layer"] if "workloads" not in m]
        if unlisted:
            raise ValueError(f"per-layer metrics without 'workloads': {', '.join(unlisted)}")
        return [m for m in spec["per_layer"] if cell in m["workloads"]]
