"""``starch3_tpu_torch.profile_lane`` on the CPU at a small size: it records
one rate sample for each batch the driver drained, with the rule's parts,
the GIL probe's long waits with the threads and places it charges them
to, and the torch operations of one batch on the thread that runs the
step, and leaves the driver's names and no thread of its own behind."""

import threading
import time

import pytest

from starch3_tpu_torch import corpus, profile_lane
from starch3_tpu_torch.parallel import host, pipeline


@pytest.fixture(scope="module")
def bed(tmp_path_factory):
    path = tmp_path_factory.mktemp("lane") / "in.bed"
    corpus.gigabyte_bed(path, 700_000, n_per=15_000)
    return str(path)


@pytest.fixture
def held_feed(monkeypatch):
    """The feed held open until the device has claimed a batch: while
    blocks may still arrive, the stealers leave a batch in each bucket to
    the device, so it takes one for certain (without the hold, fast
    stealers under load may take every block once the feed ends)."""

    class Queue(host._BlockQueue):
        def finish_feeding(self):
            deadline = time.monotonic() + 60
            with self.cond:
                while not (self.device_claimed or self.cancelled) and time.monotonic() < deadline:
                    self.cond.wait(0.01)
            super().finish_feeding()

    monkeypatch.setattr(pipeline, "_BlockQueue", Queue)
    monkeypatch.setattr(host, "_class_rate_cache", {})  # no class gated by an earlier encode's rate


@pytest.mark.parametrize("feed", ["file", "paced"])
def test_one_sample_per_drained_batch(bed, feed, held_feed):
    real = (pipeline.pack_batch, pipeline._after_all, pipeline._start_host_stealers)
    before = set(threading.enumerate())
    res = profile_lane.run(bed, feed, rate_mb_s=1.0, device="cpu", level=1)
    assert (pipeline.pack_batch, pipeline._after_all, pipeline._start_host_stealers) == real
    left = [t.name for t in threading.enumerate() if t not in before and not t.name.startswith("s3tail")]
    assert left == []
    assert res["scheduler_stats"]["abandoned_batches"] == 0
    assert len(res["samples"]) == res["device_batches"] >= 1
    assert res["samples"][0]["kind"] == "first"
    for s in res["samples"]:
        assert s["kind"] in ("first", "dry", "queued")  # "once" needs a card's graph
        if s["kind"] != "queued":
            assert s["span_ms"] == max(s["pack_ms"] + s["drain_ms"], s["device_ms"])
        if s["kind"] != "first":  # the driver's rate has a sample by now
            assert s["ema_mb_s"] > 0
    assert len(res["pack_ms"]) == 5 and res["pack_ms"] == sorted(res["pack_ms"])
    assert res["dry"]["n"] + res["queued"]["n"] == len(res["samples"]) - 1
    assert res["mb_per_s"] > 0 and res["gil_wait_ms"]
    assert res["gil_long_waits"] >= 0 and res["gil_long_wait_ms"] >= 0
    assert res["dry_at_or_below_bench"] <= res["dry"]["n"]
    for h in res["gil_holders"]:
        assert set(h) == {"thread", "where", "top", "ms", "waits"}
        assert h["ms"] > 0 and h["waits"] >= 1 and h["thread"] != "gil-probe"
    assert sum(h["ms"] for h in res["gil_holders"]) <= res["gil_long_wait_ms"] + 1e-6
    # no launcher on the CPU: the step runs in the dispatch
    assert len(res["dispatch_ms"]) == 5 and res["dispatch_ms"][0] > 0
    assert res["submit_ms"] == res["launch_ms"] == []
    # the CPU runs the step op by op on the caller; no graph there
    assert res["launcher_ops"]["eager"] > 20 and res["launcher_ops"]["replay"] is None


def test_gil_holders_are_the_threads_that_ran():
    """A long wait is charged to the threads whose innermost frame moved
    while the probe slept, at their places, and to no parked thread."""
    import time

    holders = profile_lane._GilHolders()
    parked, go, stop = threading.Event(), threading.Event(), threading.Event()

    def park():
        parked.wait()

    def spin():
        go.wait()
        while not stop.is_set():
            sum(range(200))

    threads = [threading.Thread(target=park, name="parked_1"), threading.Thread(target=spin, name="busy_7")]
    for t in threads:
        t.start()
    try:
        time.sleep(0.05)
        before = holders.before()
        go.set()
        time.sleep(0.05)
        holders.after(12.0, before)
    finally:
        stop.set()
        parked.set()
        for t in threads:
            t.join()
    top = holders.top()
    assert holders.long_waits == 1 and holders.long_wait_ms == 12.0
    assert [h["thread"] for h in top] == ["busy"]
    assert top[0]["ms"] == 12.0 and "test_torch_profile_lane.py" in top[0]["where"]


@pytest.mark.parametrize("mode", ["fast_huff", "rle2"])
def test_samples_in_another_mode(bed, mode, held_feed):
    """``--mode``: the encode runs in that mode (the exact modes pack
    nothing on the driver: ``raw_batch``), with one rate sample for each
    drained batch, each with the line below which the rule benches the
    card once the stealers have a rate."""
    res = profile_lane.run(bed, "file", device="cpu", level=1, mode=mode)
    assert res["mode"] == mode and res["scheduler_stats"]["abandoned_batches"] == 0
    assert len(res["samples"]) == res["device_batches"] >= 1
    assert all(s["kind"] in ("first", "dry", "queued") for s in res["samples"])
    assert (res["pack_ms"] == []) == (mode == "rle2")
