"""The port's counters and spans (``starch3_tpu_torch/observability.py``)
and where the encode path counts them: a span adds its seconds, count and
bytes under its dict's lock, opens a ``torch.profiler`` range only while a
profiler runs (on the thread that runs it, in the benchmark's trace), and
keeps nothing per call otherwise.  A hybrid streaming encode on the CPU
counts every block once, on a stealer or on the card, and every card
block once, in the tail or in a tie re-encode.  The benchmark's readers
of these counters (``portbench/metrics/``) on hand-made runs."""

import bz2
import io
import json
import shutil
import threading
import tracemalloc

import pytest
import torch

from portbench import trace as bench_trace
from portbench.layout import Layout
from portbench.reference import starch
from portbench.run import Run
from starch3_tpu_torch import api, corpus, observability
from starch3_tpu_torch.codec import encoder
from starch3_tpu_torch.config import EncodeConfig
from starch3_tpu_torch.observability import Stats, StageTimer, span, span_keys
from starch3_tpu_torch.parallel import host, pipeline


def test_span_counts_seconds_calls_and_bytes(monkeypatch):
    ticks = iter([10.0, 10.25, 20.0, 20.5, 30.0, 31.0])
    monkeypatch.setattr(observability.time, "perf_counter", lambda: next(ticks))
    stats = Stats(span_keys("work", nbytes=True) | span_keys("idle"))
    with span(stats, "work", 100):
        pass
    with span(stats, "work", 28):
        pass
    with pytest.raises(ValueError):
        with span(stats, "idle"):
            raise ValueError("the body's error goes through; the span still counts")
    assert stats == {"work_s": 0.75, "work_n": 2, "work_bytes": 128, "idle_s": 1.0, "idle_n": 1}


def test_stats_add_under_its_lock():
    stats = Stats({"a": 0})
    stats.add(a=2, b=0.5)
    assert stats == {"a": 2, "b": 0.5} and not stats.lock.locked()
    with stats.lock:  # a writer holding the lock keeps the others out
        t = threading.Thread(target=stats.add, kwargs={"a": 1})
        t.start()
        t.join(0.2)
        assert t.is_alive() and stats["a"] == 2
    t.join(10)
    assert not t.is_alive() and stats["a"] == 3


def test_span_sums_from_many_threads():
    stats = Stats(span_keys("s", nbytes=True))

    def work():
        for _ in range(500):
            with span(stats, "s", 3):
                pass

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads)
    assert stats["s_n"] == 4000 and stats["s_bytes"] == 12000 and stats["s_s"] >= 0


def test_span_opens_no_range_and_keeps_nothing_without_a_profiler(monkeypatch):
    calls = []
    real = torch.profiler.record_function

    def counted(name, *args, **kw):
        calls.append(name)
        return real(name, *args, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", counted)
    stats = Stats(span_keys("x", nbytes=True))
    timer = StageTimer()
    for _ in range(100):  # the span's keys, made once
        with span(stats, "x", 1000), timer.stage("stage", 10):
            pass
    assert calls == []
    tracemalloc.start()
    try:
        for _ in range(10_000):
            with span(stats, "x", 1000):
                pass
        kept = tracemalloc.get_traced_memory()[0]
    finally:
        tracemalloc.stop()
    assert kept < 512  # the counters' new values, not a record per span
    assert calls == [] and stats["x_n"] == 10_100
    with bench_trace.profiler("cpu"):
        with span(stats, "x"), timer.stage("stage"):
            pass
    assert calls == ["x", "stage"]
    assert timer.report()["stage"]["bytes"] == 1000 and timer.seconds["stage"] >= 0


def test_ranges_land_on_their_threads(tmp_path):
    """Under the benchmark's profiler each span is a range of its name in
    the Chrome trace, on the thread that ran it."""
    stats = Stats(span_keys("feed_source") | span_keys("steal"))
    prof = bench_trace.profiler("cpu")
    kept = tmp_path / "trace.json"
    export = prof.export_chrome_trace

    def export_and_keep(path):
        export(path)
        shutil.copy(path, kept)

    prof.export_chrome_trace = export_and_keep
    ran = {}

    def work(name):
        ran[name] = threading.get_native_id()
        with span(stats, name):
            pass

    prof.start()
    try:
        with torch.profiler.record_function(bench_trace.SUBWINDOW):
            t = threading.Thread(target=work, args=("feed_source",), name="s3tfeed")
            t.start()
            t.join(60)
            work("steal")
    finally:
        prof.stop()
    assert not t.is_alive()
    got = bench_trace.read(prof)
    assert sorted(name for _a, _b, name in got.ranges) == ["feed_source", "steal"]
    tids = {e["name"]: e["tid"] for e in json.loads(kept.read_text())["traceEvents"]
            if e.get("cat") == "user_annotation" and e["name"] in ran}
    assert tids == ran and ran["feed_source"] != ran["steal"]
    assert stats["feed_source_n"] == stats["steal_n"] == 1


def _hybrid_encode(bed: bytes) -> bytes:
    out = io.BytesIO()
    api.compress_bed_stream(io.BytesIO(bed), out, EncodeConfig(block_size_100k=1), chunk_bytes=1 << 16,
                            device="cpu")
    return out.getvalue()


def test_hybrid_encode_counts_every_block_once(monkeypatch):
    """A hybrid streaming encode on the CPU: each block is encoded by a
    stealer (``steal``) or dispatched to the card, and each card block
    goes to the tail (``tail``) or, tied, back to the driver
    (``tie_reencode``); ``encodes`` and ``first_block_s`` count once per
    encode."""
    bed = corpus.make_bed(("chr1", "chr2", "chr3", "chr4"), 12_000, 7)
    stolen = []  # bytes of each block a stealer encoded
    real = encoder.encode_block_fragment

    def watched(blk):
        if threading.current_thread().name.startswith("s3steal"):
            stolen.append(len(blk.data))
        return real(blk)

    monkeypatch.setattr(encoder, "encode_block_fragment", watched)
    dev0, sched0 = dict(pipeline.device_stats), dict(host.scheduler_stats)
    archive = _hybrid_encode(bed)
    dev = {k: v - dev0[k] for k, v in pipeline.device_stats.items()}
    sched = {k: v - sched0[k] for k, v in host.scheduler_stats.items()}
    ref = starch.archive(bed, level=1)
    assert archive == ref.data
    assert sched["demotions"] == sched["abandoned_batches"] == 0
    assert dev["blocks"] > 0 and sched["steal_n"] > 0
    assert sched["steal_n"] + dev["blocks"] == ref.blocks
    assert sched["tail_n"] + dev["tie_reencodes"] == dev["blocks"]
    assert dev["tie_reencode_n"] == dev["tie_reencodes"]
    assert sched["steal_n"] == len(stolen) and sched["steal_bytes"] == sum(stolen)
    assert dev["pack_n"] == dev["batches"] and dev["launch_n"] == 0  # no launcher on the CPU
    assert dev["encodes"] == 1 and dev["feed_source_n"] >= 5  # 4 chromosomes, then the end
    assert 0 < dev["first_block_s"] and 0 < dev["feed_source_s"]
    assert sched["steal_s"] > 0 and sched["tail_s"] >= 0 and sched["tail_wait_s"] >= 0
    _hybrid_encode(bed)
    assert pipeline.device_stats["encodes"] - dev0["encodes"] == 2


def test_tied_block_is_timed_where_the_driver_reencodes_it():
    """A periodic block's fast sort ties: the driver re-encodes it inside
    the span ``tie_reencode``, whose count is ``tie_reencodes``'s, and the
    tail never sees it."""
    text = b"1723\n481\np100\n" * 1000
    dev0, sched0 = dict(pipeline.device_stats), dict(host.scheduler_stats)
    got = pipeline.encode_streams([text], device="cpu", host_assist=False)[0]
    assert got.data == bz2.compress(text, 9)
    dev = {k: v - dev0[k] for k, v in pipeline.device_stats.items()}
    assert dev["tie_reencodes"] == dev["tie_reencode_n"] == dev["blocks"] == 1
    assert dev["tie_reencode_s"] > 0 and dev["pack_n"] == 1
    assert host.scheduler_stats["tail_n"] == sched0["tail_n"]


def _run(counters: dict, bed_bytes: int = 2_000_000_000) -> Run:
    return Run(setup_s=1.0, window_s=10.0, bed_bytes=bed_bytes, encodes=[(0.0, 10.0, bed_bytes)], rss_start_mb=0.0,
               rss_peak_mb=0.0, counters=counters, blocks=10, timed={}, peaks=None, layout=Layout())


# metric -> (counters of a run over 2e9 bytes of BED, its reading); each
# reading 0 in its counters (or none) gives None
READERS = {
    "feed_source_s_per_GB": ({"feed_source_s": 7.0, "feed_source_n": 30}, 3.5),
    "feed_first_block_ms": ({"first_block_s": 0.6, "encodes": 4}, 150.0),
    "steal_ms_per_MB": ({"scheduler_steal_s": 1.5, "scheduler_steal_bytes": 60_000_000}, 25.0),
    "pack_ms_per_batch": ({"pack_s": 0.02, "pack_n": 8}, 2.5),
    "tail_ms_per_block": ({"scheduler_tail_s": 0.9, "scheduler_tail_n": 12, "scheduler_tail_wait_s": 0.0}, 75.0),
    "tail_wait_ms_per_block": ({"scheduler_tail_wait_s": 0.06, "scheduler_tail_n": 12, "scheduler_tail_s": 1.0},
                               5.0),
    "launch_ms_per_batch": ({"launch_s": 0.03, "launch_n": 6, "launch_wait_s": 0.0}, 5.0),
    "launch_wait_ms_per_batch": ({"launch_wait_s": 0.012, "launch_n": 6, "launch_s": 1.0}, 2.0),
    "tie_reencode_ms_per_block": ({"tie_reencode_s": 0.72, "tie_reencode_n": 9, "tie_reencodes": 9}, 80.0),
}
# the count each reading divides by, which an encode without that work leaves at 0
DENOMINATORS = {
    "feed_source_s_per_GB": "feed_source_n", "feed_first_block_ms": "encodes",
    "steal_ms_per_MB": "scheduler_steal_bytes", "pack_ms_per_batch": "pack_n", "tail_ms_per_block": "scheduler_tail_n",
    "tail_wait_ms_per_block": "scheduler_tail_n", "launch_ms_per_batch": "launch_n",
    "launch_wait_ms_per_batch": "launch_n", "tie_reencode_ms_per_block": "tie_reencode_n",
}


@pytest.mark.parametrize("name", sorted(READERS))
def test_metric_reads_its_counters(name):
    counters, want = READERS[name]
    reader = Layout().module("metrics", name)
    assert reader.read(_run(counters)) == pytest.approx(want)
    assert (reader.SOURCE, reader.MOVES) == ("program_span", "encode_MBps")


@pytest.mark.parametrize("name", sorted(READERS))
def test_metric_reads_none_without_its_work(name):
    """None where the window did none of the work, and where the program
    has no such counter (a run of an older tree)."""
    counters, _ = READERS[name]
    reader = Layout().module("metrics", name)
    assert reader.read(_run({**counters, DENOMINATORS[name]: 0})) is None
    assert reader.read(_run({"blocks": 3, "tie_reencodes": 0})) is None


def test_metrics_list_their_cells():
    """Each reader is a per-layer metric of the benchmark, in the cells
    whose encodes do its work: ``reads.bulk``'s card blocks all tie (no
    tail), ``bed3.bulk``'s none does."""
    spec = {m["name"]: m for m in json.loads(Layout().benchmark_path.read_text())["per_layer"]}
    both = ["bed3.bulk", "reads.bulk"]
    cells = {name: both for name in READERS} | {"tail_ms_per_block": ["bed3.bulk"],
                                               "tail_wait_ms_per_block": ["bed3.bulk"],
                                               "tie_reencode_ms_per_block": ["reads.bulk"]}
    assert {name: spec[name]["workloads"] for name in READERS} == cells
    assert all(spec[name]["source"] == "program_span" for name in READERS)


def test_every_counter_read_is_declared():
    """The program declares each counter a reader reads, at 0, so a fresh
    process's window never lacks one."""
    from portbench import window

    declared = window.counters()
    for name, (counters, _) in READERS.items():
        assert set(counters) <= set(declared), name
