"""Per-stage wall time and bytes, as ``starch3_tpu.observability``,
with each stage a ``torch.profiler.record_function`` range (visible in a
``torch.profiler`` trace) in place of a ``jax.named_scope``."""

from __future__ import annotations

import contextlib
import time

import torch

from starch3_tpu.observability import StageTimer as _StageTimer


class StageTimer(_StageTimer):
    """Accumulates wall time and bytes per pipeline stage."""

    @contextlib.contextmanager
    def stage(self, name: str, nbytes: int = 0):
        t0 = time.perf_counter()
        try:
            with torch.profiler.record_function(name):
                yield
        finally:
            self.seconds[name] += time.perf_counter() - t0
            self.bytes[name] += nbytes
