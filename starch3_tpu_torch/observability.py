"""Leveled logging and per-stage wall time and bytes, the port's
counterpart of ``starch3_tpu/observability.py``.  Each stage is also a
``torch.profiler.record_function`` range, so it shows in a
``torch.profiler`` trace (in place of a ``jax.named_scope``).
STARCH3_TPU_DEBUG turns on debug logging, as in the JAX package."""

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
