"""``starch3_tpu_torch.profile_lane`` on the CPU at a small size: it records
one rate sample for each batch the driver drained, with the rule's parts,
and leaves the driver's names and no thread of its own behind."""

import threading

import pytest

from starch3_tpu_torch import corpus, profile_lane
from starch3_tpu_torch.parallel import pipeline


@pytest.fixture(scope="module")
def bed(tmp_path_factory):
    path = tmp_path_factory.mktemp("lane") / "in.bed"
    corpus.gigabyte_bed(path, 700_000, n_per=15_000)
    return str(path)


@pytest.mark.parametrize("feed", ["file", "paced"])
def test_one_sample_per_drained_batch(bed, feed):
    real = (pipeline.pack_batch, pipeline._after_all, pipeline._start_host_stealers)
    res = profile_lane.run(bed, feed, rate_mb_s=1.0, device="cpu", level=1)
    assert (pipeline.pack_batch, pipeline._after_all, pipeline._start_host_stealers) == real
    assert not [t for t in threading.enumerate() if t.name == "gil-probe"]
    assert res["scheduler_stats"]["abandoned_batches"] == 0
    assert len(res["samples"]) == res["device_batches"] >= 1
    assert res["samples"][0]["kind"] == "first"
    for s in res["samples"]:
        assert s["kind"] in ("first", "dry", "queued")
        if s["kind"] != "queued":
            assert s["span_ms"] == max(s["pack_ms"] + s["drain_ms"], s["device_ms"])
        if s["kind"] != "first":  # the driver's rate has a sample by now
            assert s["ema_mb_s"] > 0
    assert len(res["pack_ms"]) == 5 and res["pack_ms"] == sorted(res["pack_ms"])
    assert res["dry"]["n"] + res["queued"]["n"] == len(res["samples"]) - 1
    assert res["mb_per_s"] > 0 and res["gil_wait_ms"]
