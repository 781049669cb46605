"""Leveled logging, counters and spans, per-stage wall time and bytes, and
device traces: the port's counterpart of ``starch3_tpu/observability.py``.

A span (``span``) times a piece of work into a counter dict (``Stats``)
and, only while a ``torch.profiler`` runs, opens a
``torch.profiler.record_function`` range of the same name, so the work
shows on the trace's clock beside the card's kernels (in place of a
``jax.named_scope``).  ``StageTimer``'s stages are spans.  STARCH3_TPU_DEBUG
turns on debug logging, as in the JAX package."""

from __future__ import annotations

import contextlib
import logging
import os
import threading
import time

import torch
from torch.autograd import profiler as _autograd_profiler

logger = logging.getLogger("starch3_tpu_torch")
if os.environ.get("STARCH3_TPU_DEBUG"):
    logging.basicConfig(level=logging.DEBUG)


class Stats(dict):
    """A dict of cumulative counters and the lock its writers take: each
    ``add`` and each ``span`` writes under ``lock``.  Readers copy it
    (``dict(stats)``) or read single keys."""

    __slots__ = ("lock",)

    def __init__(self, *args, **kw) -> None:
        super().__init__(*args, **kw)
        self.lock = threading.Lock()

    def add(self, **deltas) -> None:
        with self.lock:
            for k, d in deltas.items():
                self[k] = self.get(k, 0) + d


def span_keys(name: str, nbytes: bool = False) -> dict:
    """The counters of the span ``name`` at 0, to declare them where their
    dict is defined: ``<name>_s``, ``<name>_n`` and, for a span given
    bytes, ``<name>_bytes``."""
    return {f"{name}_s": 0.0, f"{name}_n": 0} | ({f"{name}_bytes": 0} if nbytes else {})


_KEYS: dict = {}  # span name -> (name, its seconds, count and bytes keys), made at its first span


class _Span:
    __slots__ = ("stats", "keys", "nbytes", "t0", "rf", "dt")

    def __init__(self, stats: Stats, name: str, nbytes: int) -> None:
        keys = _KEYS.get(name)
        if keys is None:
            keys = _KEYS.setdefault(name, (name, f"{name}_s", f"{name}_n", f"{name}_bytes"))
        self.stats, self.keys, self.nbytes, self.rf = stats, keys, nbytes, None

    def __enter__(self) -> "_Span":
        if _autograd_profiler._is_profiler_enabled:
            self.rf = torch.profiler.record_function(self.keys[0])
            self.rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.dt = dt = time.perf_counter() - self.t0
        if self.rf is not None:
            self.rf.__exit__(*exc)
        stats, (_name, s, n, b) = self.stats, self.keys
        with stats.lock:
            stats[s] += dt
            stats[n] += 1
            if self.nbytes:
                stats[b] += self.nbytes


def span(stats: Stats, name: str, nbytes: int = 0) -> _Span:
    """A context manager that adds its body's wall time (``perf_counter``)
    to ``stats["<name>_s"]``, 1 to ``stats["<name>_n"]`` and, where given,
    ``nbytes`` to ``stats["<name>_bytes"]``, under ``stats.lock``; the
    keys are declared beforehand (``span_keys``).  Its ``dt`` is then the
    body's seconds.  While a
    ``torch.profiler`` runs (``torch.autograd.profiler._is_profiler_enabled``,
    which every thread's profiler sets) the body is also a
    ``record_function`` range named ``name``, on the thread that runs it;
    otherwise the span costs one flag check and two clock reads, and keeps
    nothing beyond the counters."""
    return _Span(stats, name, nbytes)


class StageTimer:
    """Accumulates wall time and bytes per pipeline stage: each stage is a
    ``span`` into ``stats``."""

    def __init__(self) -> None:
        self.stats = Stats()
        self._names: dict[str, None] = {}  # the stages, in their first use's order

    def stage(self, name: str, nbytes: int = 0) -> _Span:
        if name not in self._names:
            self._names[name] = None
            self.stats.add(**span_keys(name, nbytes=True))
        return span(self.stats, name, nbytes)

    @property
    def seconds(self) -> dict[str, float]:
        return {k: self.stats[f"{k}_s"] for k in self._names}

    def report(self) -> dict:
        out = {}
        for k, s in sorted(self.seconds.items()):
            nbytes = self.stats[f"{k}_bytes"]
            out[k] = {
                "seconds": round(s, 4),
                "bytes": nbytes,
                "mb_per_s": round(nbytes / s / 1e6, 2) if s else None,
            }
        return out


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
