"""The measured window and what the harness keeps of it: the archive
sink, the program's counters, the encoder's resident memory and the
harness's timers around functions of the program (copies of
``starch3_tpu_torch/scale_run.py``'s ``timed_calls`` and ``PeakRss``)."""

from __future__ import annotations

import contextlib
import hashlib
import os
import threading
import time


class HashSink:
    """A binary file object that keeps, of each write, its offset, its
    length and its SHA-256, and nothing of its bytes: the window's
    archives are judged after it, against the reference's bytes at the
    same offsets, without holding them in memory."""

    def __init__(self):
        self.writes: list[tuple[int, int, bytes]] = []
        self.size = 0

    def write(self, data) -> int:
        n = memoryview(data).nbytes
        self.writes.append((self.size, n, hashlib.sha256(data).digest()))
        self.size += n
        return n

    def flush(self) -> None:
        pass


def rss_mb() -> float:
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") / 2**20


def release_free_memory() -> None:
    """Collect Python's garbage and give the C heap's free memory back to
    the system (glibc's ``malloc_trim``), so that what the harness made
    and freed before the encoder starts (the BED writer's threads' heaps)
    is not in the memory the encoder is measured from."""
    import ctypes
    import gc

    gc.collect()
    trim = getattr(ctypes.CDLL(None), "malloc_trim", None)
    if trim is not None:
        trim(0)


class PeakRss:
    """The largest resident set of this process that a thread of its own
    reads every ``every_s`` seconds between ``start()`` and ``stop()``
    (``ru_maxrss`` may hold a parent's peak, and ``VmHWM`` is not on every
    kernel)."""

    def __init__(self, every_s: float = 0.02):
        self.every_s = every_s
        self.mb = self.mark_mb = rss_mb()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name="portbench-rss", daemon=True)

    def _run(self) -> None:
        while not self._stop.wait(self.every_s):
            self.read()

    def read(self) -> float:
        """The RSS now, taken into the peak and into ``since_mark``'s."""
        now = rss_mb()
        with self._lock:
            self.mb, self.mark_mb = max(self.mb, now), max(self.mark_mb, now)
        return now

    def mark(self) -> float:
        """The highest RSS since the last mark (or the start)."""
        now = self.read()
        with self._lock:
            seen, self.mark_mb = self.mark_mb, now
        return seen

    def start(self) -> "PeakRss":
        self._thread.start()
        return self

    def stop(self) -> float:
        self._stop.set()
        self._thread.join()
        self.read()
        return self.mb


@contextlib.contextmanager
def timed_calls(module, *names, span=None):
    """Sums, into the dict it yields, the wall time of every call of each
    function ``module.<name>`` made inside it by code that looks the name
    up in ``module`` when it calls it; ``<name>_calls`` counts the calls.
    With ``span(name)`` (a context manager factory) each call also runs
    inside it: the traced run's host ranges."""
    real = {n: getattr(module, n) for n in names}
    spent = dict.fromkeys(names, 0.0) | {f"{n}_calls": 0 for n in names}
    lock = threading.Lock()

    def timed(name):
        def call(*args, **kw):
            t0 = time.perf_counter()
            try:
                with span(name) if span else contextlib.nullcontext():
                    return real[name](*args, **kw)
            finally:
                dt = time.perf_counter() - t0
                with lock:
                    spent[name] += dt
                    spent[f"{name}_calls"] += 1

        return call

    for n in names:
        setattr(module, n, timed(n))
    try:
        yield spent
    finally:
        for n in names:
            setattr(module, n, real[n])


def counters() -> dict:
    """The program's cumulative counters: ``pipeline.device_stats`` and
    ``host.scheduler_stats``, flattened."""
    from starch3_tpu_torch.parallel import host, pipeline

    return {**pipeline.device_stats, **{f"scheduler_{k}": v for k, v in host.scheduler_stats.items()}}


def since(before: dict) -> dict:
    now = counters()
    return {k: now[k] - before.get(k, 0) for k in now}


@contextlib.contextmanager
def watched(module, name: str, on_call):
    """Calls ``on_call(*args, **kw)`` before each call of ``module.<name>``
    made inside it by code that looks the name up when it calls it."""
    real = getattr(module, name)

    def call(*args, **kw):
        on_call(*args, **kw)
        return real(*args, **kw)

    setattr(module, name, call)
    try:
        yield
    finally:
        setattr(module, name, real)



def host_times() -> dict:
    """This process's CPU seconds (``getrusage``) and the time now."""
    import resource

    ru = resource.getrusage(resource.RUSAGE_SELF)
    return {"cpu_s": ru.ru_utime + ru.ru_stime, "wall_s": time.perf_counter()}


def host_since(before: dict) -> dict:
    now = host_times()
    return {k: now[k] - before[k] for k in now}


def host_note(host: dict, bed_bytes: int) -> str:
    """One line of what the host gave the window: the cores this process
    may use, and its CPU seconds (and per GB of BED)."""
    cores = len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity") else os.cpu_count()
    per_gb = f" ({host['cpu_s'] / (bed_bytes / 1e9):.3f} s per GB of BED)" if bed_bytes else ""
    return (f"host: os.cpu_count() {os.cpu_count()}, cores this process may use {cores}; "
            f"process CPU {host['cpu_s']:.3f} s over {host['wall_s']:.3f} s{per_gb}")
