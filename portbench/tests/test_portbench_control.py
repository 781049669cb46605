"""The comparison that decides ``correct`` fails what it must, on the
CPU at the tests' size: each control (the reference in the program's
place with the configuration's guarantee broken), and the harness's run
with the timed path broken underneath for each fault a cell can have.
The harness's look for a card is skipped (``run_cell`` on ``cpu``).  One
cell runs on one card, so no exchange between cards can be left out."""

import dataclasses
import time

import pytest

from portbench import control
from portbench import run as harness
from starch3_tpu_torch.parallel import pipeline

CELLS = ("bed3.bulk", "reads.bulk")


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("name", sorted(control.CONTROLS))
def test_control_is_not_correct(tiny, cell, name):
    res = control.run(tiny, cell, 2_200_000_777, name, "cpu")
    assert res["correct"] is False
    assert res["checks"]["archives_wrong"] == 1
    if name == "level8":
        assert res["checks"]["streams_wrong"] >= 1
    else:
        assert res["checks"]["metadata_footer_wrong"] == 1


def _altered(texts, streams):
    for i, enc in enumerate(streams):
        if i == 0:
            data = bytearray(enc.data)
            data[len(data) // 2] ^= 1
            enc = dataclasses.replace(enc, data=bytes(data))
        yield enc


def _half_left_out(texts, streams):
    for i, enc in enumerate(streams):
        if i % 2 == 0:
            yield enc


def _unchanged(texts, streams):
    for enc, text in zip(streams, texts):
        yield dataclasses.replace(enc, data=bytes(text))


def _never_comes(texts, streams):
    raise RuntimeError("the encode never returned its streams")
    yield


FAULTS = {"answer-altered": _altered, "half-left-out": _half_left_out, "state-unchanged": _unchanged,
          "never-comes": _never_comes}


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_broken_timed_path_is_not_correct(tiny, monkeypatch, cell, fault):
    real = pipeline.encode_streams_iter

    def broken(text_iter, **kw):
        texts = []

        def seen():
            for t in text_iter:
                texts.append(t)
                yield t

        return FAULTS[fault](texts, real(seen(), **kw))

    monkeypatch.setattr(pipeline, "encode_streams_iter", broken)
    # broken from the window's first encode: no warm-up, which a fault
    # would end before any result
    line, _ = harness.run_cell(tiny, cell, 2_200_000_999, 0.2, False, device="cpu", t0=time.perf_counter(),
                               warm_up=False)
    assert line["correct"] is False
    checks = {k: c["value"] for k, c in line["checks"].items()}
    if fault == "never-comes":
        assert checks["encodes_failed"] == 1 and line["failed"] == 1
    else:
        assert checks["archives_wrong"] == line["attempted"] >= 1


@pytest.mark.parametrize("cell", CELLS)
def test_sound_timed_path_is_correct(tiny, cell):
    line, _ = harness.run_cell(tiny, cell, 2_200_000_999, 0.2, False, device="cpu", t0=time.perf_counter())
    assert line["correct"] is True and line["attempted"] >= 1
    assert all(c["value"] == 0 for c in line["checks"].values())
