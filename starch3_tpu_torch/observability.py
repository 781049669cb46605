"""Leveled logging, per-stage wall time and bytes, and device traces: the
port's counterpart of ``starch3_tpu/observability.py``.  Each stage is
also a ``torch.profiler.record_function`` range, so it shows in a
``device_trace`` (in place of a ``jax.named_scope``).  STARCH3_TPU_DEBUG
turns on debug logging, as in the JAX package."""

from __future__ import annotations

import contextlib
import json
import logging
import os
import time
from collections import defaultdict

import torch

logger = logging.getLogger("starch3_tpu_torch")
if os.environ.get("STARCH3_TPU_DEBUG"):
    logging.basicConfig(level=logging.DEBUG)


class StageTimer:
    """Accumulates wall time and bytes per pipeline stage."""

    def __init__(self) -> None:
        self.seconds: dict[str, float] = defaultdict(float)
        self.bytes: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, nbytes: int = 0):
        t0 = time.perf_counter()
        try:
            with torch.profiler.record_function(name):
                yield
        finally:
            self.seconds[name] += time.perf_counter() - t0
            self.bytes[name] += nbytes

    def report(self) -> dict:
        out = {}
        for k, s in sorted(self.seconds.items()):
            out[k] = {
                "seconds": round(s, 4),
                "bytes": self.bytes[k],
                "mb_per_s": round(self.bytes[k] / s / 1e6, 2) if s else None,
            }
        return out

    def log(self) -> None:
        logger.info("stage report: %s", json.dumps(self.report()))


@contextlib.contextmanager
def device_trace(log_dir: str, device="cuda"):
    """A ``torch.profiler`` trace of the body, the counterpart of the
    reference's ``jax.profiler`` trace: on exit one Chrome/Perfetto trace
    file (``*.pt.trace.json``) lands in ``log_dir``, for tensorboard or
    Perfetto.  On a CUDA device it records the host and the card (CUPTI
    sees every kernel of the context, those launched through ``ctypes``
    too); with ``device="cpu"`` the host only.  ``cuda`` without a card
    raises."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device_trace(device='cuda') needs a CUDA card; pass device='cpu'")
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev} (use 'cuda' or 'cpu')")
    with torch.profiler.profile(activities=activities,
                                on_trace_ready=torch.profiler.tensorboard_trace_handler(str(log_dir))):
        yield
