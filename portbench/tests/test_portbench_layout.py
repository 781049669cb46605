"""The harness is driven by data: a configuration, a traffic mix, a
writer, a cell, a kernel and a per-layer metric added as new files (and
new entries in ``BENCHMARK.json``) to a copy of ``portbench/`` are found
and run by name, with no file of the copy edited.  The last line's shape,
through the harness's own functions on the CPU at the tests' size.  The
command refuses to run without a card; with one, it runs a cell and
refuses in a directory that holds only the benchmark."""

import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

from portbench import run as harness
from portbench.layout import Layout
from portbench.tests.conftest import PORTBENCH, REPO, copy_portbench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _digests(root: Path) -> dict:
    return {p: hashlib.sha256(p.read_bytes()).hexdigest() for p in root.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


NEW_FILES = {
    "corpora/twice_bed.py": '''
from portbench.corpora import genome_bed3


def chunks(target, seed, n_total):
    """genome_bed3's lines, through a writer of its own."""
    for chunk in genome_bed3.chunks(target, seed, n_total=n_total):
        yield chunk
''',
    "configs/tiny_bed3.json": json.dumps({"writer": "twice_bed", "target_bytes": 300_000,
                                          "writer_args": {"n_total": 12_000}, "reduced": []}),
    "traffic/pair.json": json.dumps({"pool": 2, "warm_up_encodes": 2}),
    "workloads/tiny.pair.json": json.dumps({"config": "tiny_bed3", "traffic": "pair", "why": "a test cell"}),
    "kernels/k_any.py": '''
NAMES = (r"kernel",)


def bytes_moved(packs):
    return sum(sum(lens) for _, lens in packs) or None
''',
    "metrics/blocks_per_encode.py": '''
UNIT, BETTER, SOURCE = "blocks", "higher", "program_counter"
LAYER, MOVES = "archive", "encode_MBps"


def read(run):
    run.layout.module("kernels", "k_any")
    return run.blocks / len(run.encodes)
''',
}


def test_added_pieces_are_found_by_name(tmp_path):
    root = copy_portbench(tmp_path)
    before = _digests(tmp_path)
    for rel, text in NEW_FILES.items():
        (root / rel).write_text(text)
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny_bed3", "source": "a test", "file": "portbench/configs/tiny_bed3.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "tiny.pair", "config": "tiny_bed3", "traffic": "pair", "chips": 1,
                              "why": "a test cell"})
    next(m for m in spec["end_to_end"] if m["name"] == "encode_peak_rss_MB")["workloads"].append("tiny.pair")
    spec["per_layer"].append({"name": "blocks_per_encode", "unit": "blocks", "better": "higher",
                              "source": "program_counter", "layer": "archive", "moves": "encode_MBps",
                              "workloads": ["tiny.pair"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    layout = Layout(root)
    for traced in (False, True):
        line, notes = harness.run_cell(layout, "tiny.pair", 77, 2.0, traced, device="cpu", t0=time.perf_counter())
        assert line["correct"] is True, (line, notes)
        assert line["attempted"] >= 1
        assert any(n.startswith("warm-up: 2 encodes") for n in notes), notes  # both files of the pool
        if traced:
            got = line["metrics"]["blocks_per_encode"]
            assert got["unit"] == "blocks" and got["value"] >= 2 and float(got["value"]).is_integer()
            assert "blocks_per_encode" in layout.metrics("tiny.pair", "per_layer")[-1]["name"]
        else:
            assert set(line["metrics"]) == {"encode_MBps", "encode_peak_rss_MB", "setup_s"}
    assert "blocks_per_encode" not in {m["name"] for m in layout.metrics("bed3.bulk", "per_layer")}
    after = _digests(tmp_path)
    assert {p: after[p] for p in before if p.name != "BENCHMARK.json"} == \
        {p: d for p, d in before.items() if p.name != "BENCHMARK.json"}


@pytest.mark.parametrize("extra", [{"clients": 4}, {"loop": "open"}, {"rate_per_s": 2.0}],
                         ids=["clients", "loop", "rate"])
def test_traffic_with_unread_parameter_is_refused(tmp_path, extra):
    """A mix that asks for what the one generator does not do (more
    clients, an open loop, a rate) is refused, not run as one closed-loop
    client under its name."""
    root = copy_portbench(tmp_path)
    (root / "traffic" / "wide.json").write_text(json.dumps({"pool": 1, **extra}))
    (root / "workloads" / "bed3.wide.json").write_text(json.dumps({"config": "wgs_bed3", "traffic": "wide",
                                                                   "why": "a test cell"}))
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "bed3.wide", "config": "wgs_bed3", "traffic": "wide", "chips": 1,
                              "why": "a test cell"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    with pytest.raises(ValueError, match=next(iter(extra))):
        harness.run_cell(Layout(root), "bed3.wide", 1, 0.1, False, device="cpu", t0=time.perf_counter())


@pytest.mark.parametrize("quiet_s, least, most", [(0.0, 2, 2), (0.5, 6, 12)])
def test_warm_up_runs_until_quiet(tiny, monkeypatch, quiet_s, least, most):
    """Set-up encodes until the encodes since the last one that captured
    a CUDA graph took ``WARM_UP_QUIET_S``: here the first captures one,
    and each later encode takes 0.1 s and captures none."""
    from portbench import window
    from portbench.reference import starch

    monkeypatch.setattr(harness, "WARM_UP_QUIET_S", quiet_s)
    real_since, calls = window.since, []

    def since(before):
        calls.append(1)
        return {**real_since(before), **({"graph_captures": 1} if len(calls) == 1 else {})}

    monkeypatch.setattr(window, "since", since)
    archives = {}

    def encode(bed, sink):
        if bed not in archives:
            archives[bed] = starch.archive(bed).data
        time.sleep(0.1)
        sink.write(archives[bed])

    line, notes = harness.run_cell(tiny, "bed3.bulk", 3, 0.0, False, device="cpu", t0=time.perf_counter(),
                                   encoder=encode)
    note = next(n for n in notes if n.startswith("warm-up"))
    count = int(re.search(r"^warm-up: (\d+) encodes", note).group(1))
    assert line["correct"] is True and least <= count <= most, note


def test_per_layer_metric_without_cells_is_refused(tmp_path):
    root = copy_portbench(tmp_path)
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    del spec["per_layer"][0]["workloads"]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    with pytest.raises(ValueError, match=spec["per_layer"][0]["name"]):
        Layout(root).metrics("bed3.bulk", "per_layer")


def _number(x) -> bool:
    return isinstance(x, (int, float)) and not isinstance(x, bool)


@pytest.mark.parametrize("traced", [False, True], ids=["trace0", "trace1"])
@pytest.mark.parametrize("cell", ["bed3.bulk", "reads.bulk"])
def test_last_line_shape(tiny, cell, traced):
    line, notes = harness.run_cell(tiny, cell, 2_200_000_555, 0.3, traced, device="cpu", t0=time.perf_counter())
    line = json.loads(json.dumps(line))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    want = {m["name"]: m["unit"] for m in tiny.metrics(cell, "per_layer" if traced else "end_to_end")}
    assert set(line["metrics"]) <= set(want)
    if not traced:
        assert set(line["metrics"]) == set(want)
    for name, m in line["metrics"].items():
        assert m["unit"] == want[name] and _number(m["value"])
    dev = line["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev) and dev["count"] == 1
    if traced:
        assert _number(dev["busy_s"]) and dev["window_s"] > 0
        for key in ("device_ops", "idle_gaps"):
            rows = line["breakdown"][key]
            assert len(rows) <= 10 and all(isinstance(n, str) and _number(s) for n, s in rows)
    assert all(set(c) == {"value", "limit"} for c in line["checks"].values())
    assert any(n.startswith("window:") for n in notes)


def test_benchmark_json_agrees_with_its_files():
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    layout = Layout()
    assert spec["paths"] == ["portbench"] and spec["command"][:3] == ["python3", "-m", "portbench.run"]
    assert 1 <= spec["run_seconds"] <= 51
    configs = {c["name"]: c for c in spec["configs"]}
    for c in spec["configs"]:
        data = json.loads((REPO / c["file"]).read_text())
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert data["reduced"] == c["reduced"] and data["source"] == c["source"]
    for w in spec["workloads"]:
        own = layout.data("workloads", w["name"])
        assert (own["config"], own["traffic"], own["why"]) == (w["config"], w["traffic"], w["why"])
        assert w["config"] in configs and w["chips"] in (1, 4) and len(w["why"]) <= 200
        layout.data("traffic", w["traffic"])
        cells_end = layout.metrics(w["name"], "end_to_end")
        assert "setup_s" in {m["name"] for m in cells_end} and len(cells_end) >= 2
        assert layout.metrics(w["name"], "per_layer")
    for kind in ("end_to_end", "per_layer"):
        for m in spec[kind]:
            reader = layout.module("metrics", m["name"])
            assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["source"] in SOURCES
            assert (reader.UNIT, reader.BETTER, reader.SOURCE) == (m["unit"], m["better"], m["source"])
            if kind == "per_layer":
                assert (reader.LAYER, reader.MOVES) == (m["layer"], m["moves"])
            else:
                assert 0.01 <= m["bound"] <= 0.25
    for path in PORTBENCH.rglob("*"):
        if "__pycache__" not in path.parts:
            assert re.fullmatch(r"[A-Za-z0-9_./-]+", str(path.relative_to(REPO)))


def test_command_refuses_without_a_card():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "bed3.bulk", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout == ""
    assert "needs 1 CUDA card" in out.stderr


def _command(cwd, *args):
    return subprocess.run([sys.executable, "-m", "portbench.run", *args], cwd=cwd, capture_output=True,
                          text=True, timeout=360)


@pytest.mark.cuda
def test_cell_runs_on_the_card(card):
    out = _command(REPO, "--workload", "bed3.bulk", "--seed", "2200000111", "--seconds", "2", "--trace", "0")
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["kind"] == card
    assert out.stderr.strip().splitlines()[-1].startswith("check metadata_footer_wrong 0 limit 0")


@pytest.mark.cuda
def test_benchmark_alone_refuses(card, tmp_path):
    copy_portbench(tmp_path)
    shutil.rmtree(tmp_path / "portbench" / "tests")
    out = _command(tmp_path, "--workload", "bed3.bulk", "--seed", "1", "--seconds", "1", "--trace", "0")
    assert out.returncode != 0 and not out.stdout.strip()
