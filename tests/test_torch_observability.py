"""``device_trace`` (``starch3_tpu_torch/observability.py``), the
counterpart of the JAX package's ``jax.profiler`` trace, on the CPU: it
writes one trace file that names the ``StageTimer`` stages of the traced
encode, leaves no profiler running, and refuses ``cuda`` without a card.
On the card, ``chip_smoke.py`` phase 12 (b) finds the kernels in it."""

import json

import pytest
import torch

from starch3_tpu_torch import api, corpus
from starch3_tpu_torch.observability import StageTimer, device_trace


def _profiler_running() -> bool:
    return torch.autograd.profiler._is_profiler_enabled


def test_trace_of_an_encode_names_its_stages(tmp_path):
    bed = corpus.make_bed(corpus.GENOME_CHROMS[:2], 300, seed=1)
    timer = StageTimer()
    with device_trace(tmp_path, device="cpu"):
        archive = api.compress_bed_bytes(bed, api.EncodeConfig(use_jax=True), timer=timer, device="cpu")
    assert not _profiler_running()
    assert archive == api.compress_bed_bytes(bed, api.EncodeConfig(use_jax=False))
    files = list(tmp_path.iterdir())
    assert len(files) == 1 and files[0].name.endswith(".pt.trace.json")
    names = {e.get("name") for e in json.loads(files[0].read_text())["traceEvents"]}
    assert timer.seconds and set(timer.seconds) <= names


def test_cuda_without_a_card_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        with device_trace(tmp_path):
            pass
    assert not list(tmp_path.iterdir()) and not _profiler_running()
