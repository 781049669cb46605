"""The traced run: ``torch.profiler`` over a sub-window, the window's
first whole encode, with the card's kernels and copies and the host
ranges the harness opens around calls into the program's layers
(``HOST_SPANS``), reduced to the card's busy time, kernel times by name
and the longest idle gaps, each named by the host range that covered
most of it."""

from __future__ import annotations

import contextlib
import json
import os
import re
import tempfile
import threading

SUBWINDOW = "portbench.traced"  # the range around the traced encodes
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# the program's functions the traced run wraps in a host range, each
# looked up by name in its module when the program calls it:
# (module, function, the layer's name for the range)
HOST_SPANS = (
    ("starch3_tpu_torch.runtime", "bed_transform_native", "feed.transform"),
    ("starch3_tpu_torch.parallel.pipeline", "pack_batch", "driver.pack"),
    ("starch3_tpu_torch.parallel.pipeline", "_drain_into", "driver.drain"),
    ("starch3_tpu_torch.codec.encoder", "encode_block_fragment", "host.encode_block"),
)


def profiler(device: str):
    """A profiler of the host's threads and the card: every thread's
    ranges and ops, those the program starts after the profiler too
    (``profile_all_threads``; without it a thread started later records
    nothing)."""
    import torch
    from torch._C._profiler import _ExperimentalConfig

    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.startswith("cuda"):
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts, experimental_config=_ExperimentalConfig(profile_all_threads=True))


def warm(device: str) -> None:
    """Start and stop the profiler once on a small op: its first start
    loads what it needs, seconds of set-up that would otherwise fall in
    the traced encode."""
    import torch

    with profiler(device):
        (torch.ones(1024, device=device) + 1).sum().item()


def span(name: str):
    """A host range named for the layer and the program's thread
    (``host.encode_block@s3steal``: the thread's name without its
    number)."""
    import torch

    thread = re.sub(r"[_0-9]+$", "", threading.current_thread().name)
    return torch.profiler.record_function(f"{name}@{thread}")


class Tracer:
    """The traced sub-window: ``start()`` before its encode, the encode
    inside ``encode()``, ``stop()`` after it.  It keeps the program's
    counters over the sub-window and ``packs``, the block lengths of each
    batch the driver packed in it (``(bits, [block bytes])``, from
    ``pipeline.pack_batch``'s arguments)."""

    def __init__(self, device: str):
        self.device, self.prof, self.packs, self.counters = device, None, [], {}

    def start(self) -> None:
        from portbench import window

        self._before = window.counters()
        self.prof = profiler(self.device)
        self.prof.start()

    @contextlib.contextmanager
    def encode(self):
        import importlib

        import torch

        from portbench import window
        from starch3_tpu_torch.parallel import pipeline

        def packed(blocks, n_max, bits, *args, **kw):
            self.packs.append((bits, [memoryview(b).nbytes for b in blocks]))

        with contextlib.ExitStack() as stack:
            for mod, fn, layer in HOST_SPANS:
                stack.enter_context(window.timed_calls(importlib.import_module(mod), fn,
                                                       span=lambda _name, layer=layer: span(layer)))
            stack.enter_context(window.watched(pipeline, "pack_batch", packed))
            stack.enter_context(torch.profiler.record_function(SUBWINDOW))
            yield

    def stop(self) -> None:
        """Stop the profiler, once: after the sub-window, or where an
        encode in it failed."""
        import torch

        from portbench import window

        if self.prof is not None and not self.counters:
            if self.device.startswith("cuda"):
                torch.cuda.synchronize(self.device)
            self.prof.stop()
            self.counters = window.since(self._before)

    def read(self) -> "Trace":
        return read(self.prof)


class Trace:
    """What a profiled sub-window holds, its times in microseconds."""

    def __init__(self, events: list[dict]):
        marks = [e for e in events if e.get("cat") == "user_annotation" and e.get("name") == SUBWINDOW]
        if marks:
            self.t0 = min(e["ts"] for e in marks)
            self.t1 = max(e["ts"] + e.get("dur", 0) for e in marks)
        else:
            self.t0 = self.t1 = 0.0

        def clipped(cats):
            out = []
            for e in events:
                if e.get("cat") in cats and "ts" in e:
                    a, b = max(e["ts"], self.t0), min(e["ts"] + e.get("dur", 0), self.t1)
                    if b > a:
                        out.append((a, b, e.get("name", "")))
            return sorted(out)

        self.device = clipped(DEVICE_CATS)
        self.kernels = clipped(("kernel",))
        self.ranges = [r for r in clipped(("user_annotation",)) if r[2] != SUBWINDOW]
        self.ops = clipped(("cpu_op",))
        self.busy = _union(self.device)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy) / 1e6

    def kernel_seconds(self, patterns) -> float:
        """Seconds of the kernels whose name matches any of ``patterns``."""
        rx = re.compile("|".join(patterns))
        return sum(b - a for a, b, name in self.kernels if rx.search(name)) / 1e6

    def gaps(self) -> list[tuple[float, float]]:
        out, at = [], self.t0
        for a, b in self.busy:
            if a > at:
                out.append((at, a))
            at = max(at, b)
        if self.t1 > at:
            out.append((at, self.t1))
        return out

    def breakdown(self, top: int = 10) -> dict:
        by_name: dict[str, float] = {}
        for a, b, name in self.device:
            by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:top]
        return {"device_ops": [[name[:160], s] for name, s in ops],
                "idle_gaps": [[self._host_during(a, b), (b - a) / 1e6] for a, b in gaps]}

    def _host_during(self, a: float, b: float) -> str:
        """The host range that covered most of ``[a, b)``, else the torch
        op that did, else ``no_host_range``."""
        for pool in (self.ranges, self.ops):
            cover: dict[str, float] = {}
            for ra, rb, name in pool:
                if ra < b and rb > a:
                    cover[name] = cover.get(name, 0.0) + min(rb, b) - max(ra, a)
            if cover:
                return max(cover.items(), key=lambda kv: kv[1])[0][:160]
        return "no_host_range"


def _union(intervals) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b, *_ in intervals:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def read(prof) -> Trace:
    """The ``Trace`` of a stopped profiler, through its Chrome trace in a
    temporary file (``TMPDIR``) that is removed at once."""
    fd, path = tempfile.mkstemp(prefix="portbench-", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        with contextlib.suppress(OSError):
            os.unlink(path)
    return Trace(events)
