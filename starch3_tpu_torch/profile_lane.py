"""Where the device lane's time goes in a hybrid encode: each drain-rate
sample of the driver (``note_drain`` in ``parallel/pipeline.py``) with its
parts, each batch's pack, and how long a thread that slept 1 ms waits to
run Python again (the GIL's hand-over) while the encode runs.

    python -m starch3_tpu_torch.profile_lane BED [--feed file|texts|paced]
        [--rate MB_PER_S] [--device cuda] [--level 9] [--mode M]

``file`` encodes BED through ``api.compress_bed_file(use_jax=True)``, the
streaming feed of ``scale_run encode --jax`` (without its RSS sampler), in
the encode mode M (``scale_run.MODES``; ``fast`` by default).
``texts`` transforms each chromosome before the encode and feeds the texts
to ``pipeline.encode_streams_iter`` as fast as it takes them; ``paced``
feeds them at ``--rate`` MB/s of text.  The two leave out the file entry's
chunk handling, so they tell the feed's share of the lane's time from the
rest.  Prints one JSON line: the rate in MB/s (of BED for ``file``, of text
otherwise), ``scheduler_stats``, the device's blocks and batches, every
rate sample (``dry`` when its batch found the pipeline empty, ``queued``
when it ran behind another, ``first`` when no drain came before it,
``once`` when it warmed up or captured its key's CUDA graph, which the
rule does not rate) with
the pack, drain and device ms, the rate the rule gives it, the driver's
rate after it and the line below which it benches the device (half the
stealers' aggregate), the medians of
each kind, the dry samples rated at or below the bench line, and the
10th, 50th, 90th and 99th percentiles and the maximum of the pack's ms
over every batch and of the GIL probe's wait, and the same quantiles of
the wall ms of the driver's ``_dispatch_chunk`` (``dispatch_ms``, the
pack included), of its hand-over to the launcher (``submit_ms``,
``_launch``) and of the launcher's work on a batch (``launch_ms``).
On a card the device ms are CUDA-event times; on the CPU the step's wall
time.

Who holds the GIL: the probe snapshots every thread's innermost frame
before each 1 ms sleep; when it wakes more than ``LONG_WAIT_MS`` late,
the threads whose innermost frame moved meanwhile ran while it waited,
and one of them held the GIL.  The wait is shared equally among them,
each at the innermost frame of this repository it stands in now and the
innermost frame of all (which is where it let the GIL go, or near it).
``gil_holders`` lists the top places by the summed share.  A sampler
inside the process cannot see a thread while that thread holds the GIL,
so this names where a holder stood when it let go, not the line that
held it; a holder in one long C call (a ``bytes`` copy) stands on the
line after it.

``launcher_ops`` counts the torch operations one batch of the main
path's class (bits 4, the first full blocks of the corpus, 3 a batch)
issues on the thread that runs its step (the launcher on a card, the
caller on the CPU), by a ``TorchDispatchMode``: each one lets the GIL go
and takes it back.  ``eager`` is a batch run op by op; ``replay`` a
batch of the fast step's CUDA graph (None where there is none: on the
CPU).  The counts leave out calls that are not torch operations (the
events, the graph's launch, an eager kernel's own launch).
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import sys
import threading
import time

LONG_WAIT_MS = 5.0  # a probe wait longer than this is attributed to the threads that ran
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _quantiles(values, fractions=(0.1, 0.5, 0.9, 0.99, 1.0)):
    v = sorted(values)
    return [round(v[int(f * (len(v) - 1))], 3) for f in fractions] if v else []


class _Split:
    """The wall ms of each call of a wrapped function."""

    def __init__(self):
        self.ms = []

    def wrap(self, fn):
        def timed(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                self.ms.append((time.perf_counter() - t0) * 1e3)

        return timed


def _chromosome_texts(path: str) -> list[bytes]:
    from starch3_tpu_torch.runtime import bed_transform_native
    from starch3_tpu_torch.scale_run import iter_chromosome_raw

    with open(path, "rb") as f:
        return [bed_transform_native(raw)[0][1] for _chrom, raw in iter_chromosome_raw(f)]


def _paced(texts, rate: float | None):
    t0, sent = time.monotonic(), 0
    for text in texts:
        if rate:
            wait = t0 + sent / rate - time.monotonic()
            if wait > 0:
                time.sleep(wait)
        sent += len(text)
        yield text


def _where(frame) -> tuple[str, str]:
    """A thread's innermost frame in this repository and its innermost
    frame of all, each as ``file:line function``."""
    def fmt(f):
        path = f.f_code.co_filename
        rel = os.path.relpath(path, _ROOT) if path.startswith(_ROOT) else os.path.basename(path)
        return f"{rel}:{f.f_lineno} {f.f_code.co_name}"

    top, own = fmt(frame), None
    f = frame
    while f is not None and own is None:
        if f.f_code.co_filename.startswith(_ROOT):
            own = fmt(f)
        f = f.f_back
    return own or "-", top


def _thread_kind(name: str) -> str:
    """A thread's name without its pool index (``s3steal3`` -> ``s3steal``,
    ``ThreadPoolExecutor-2_5`` -> ``ThreadPoolExecutor``)."""
    return re.sub(r"[-_]?\d+([-_]\d+)*$", "", name) or name


class _GilHolders:
    """The probe's attribution of its long waits (module docstring)."""

    def __init__(self):
        self.me = None  # the probe's own thread, which before() names
        self.held = collections.defaultdict(lambda: [0.0, 0])  # (thread, own, top) -> [ms, waits]
        self.long_waits = 0
        self.long_wait_ms = 0.0

    def before(self) -> dict:
        self.me = threading.get_ident()
        return {tid: (f.f_code, f.f_lasti) for tid, f in sys._current_frames().items() if tid != self.me}

    def after(self, wait_ms: float, before: dict) -> None:
        frames = sys._current_frames()
        ran = [(tid, f) for tid, f in frames.items()
               if tid != self.me and before.get(tid) != (f.f_code, f.f_lasti)]
        self.long_waits += 1
        self.long_wait_ms += wait_ms
        if not ran:
            return
        names = {t.ident: t.name for t in threading.enumerate()}
        for tid, f in ran:
            entry = self.held[(_thread_kind(names.get(tid, "?")),) + _where(f)]
            entry[0] += wait_ms / len(ran)
            entry[1] += 1

    def top(self, n: int = 15) -> list:
        rows = sorted(self.held.items(), key=lambda kv: -kv[1][0])[:n]
        return [{"thread": k[0], "where": k[1], "top": k[2], "ms": v[0], "waits": v[1]}
                for k, v in rows]


class _OpCounter:
    """Counts the torch operations dispatched on the thread that enters
    it (a ``TorchDispatchMode``, whose stack is the thread's own)."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        counter = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                counter.n += 1
                return func(*args, **(kwargs or {}))

        self.n = 0
        self.mode = Mode()

    def __enter__(self):
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self.mode.__exit__(*exc)


def _first_batch(path: str, level: int):
    """The first three blocks of the main path's class (bits 4) in one
    bucket, from the corpus's first 12 MB: ``(datas, (n_max, bits))``."""
    from starch3_tpu_torch.parallel import host
    from starch3_tpu_torch.runtime import bed_transform_native

    with open(path, "rb") as f:
        raw = f.read(12 << 20)
    raw = raw[: raw.rfind(b"\n") + 1]
    by_key = collections.defaultdict(list)
    for g in bed_transform_native(raw):
        blocks, classes = host._split_classify(g[1], level)
        for blk, bits in zip(blocks, classes):
            by_key[(host._bucket_for(len(blk.data)), bits)].append(blk.data)
    nm, datas = max(by_key.items(), key=lambda kv: (kv[0][1] == 4, len(kv[1]) >= 3, kv[0][0]))
    return datas[:3], nm


def launcher_ops(path: str, device: str = "cuda", level: int = 9) -> dict:
    """The torch operations of one batch on the thread that runs its step
    (module docstring): ``{"eager": n, "replay": n or None}``; ``replay``
    is the third batch through the fast step's graph (the first warms the
    step up, the second captures it)."""
    import torch

    from starch3_tpu_torch.parallel import pipeline

    datas, (n_max, bits) = _first_batch(path, level)
    packed, lens, nsyms, _useds = pipeline.pack_batch(datas, n_max, bits, 3)
    inputs = (packed, torch.from_numpy(lens), torch.from_numpy(nsyms))

    def step(*args):
        return pipeline.step_for_class(*args, bits, n_max), ()

    dev = torch.device(device)
    if dev.type != "cuda":
        with _OpCounter() as c:
            step(*inputs)
        return {"eager": c.n, "replay": None}

    def counted(**kw) -> int:
        # the launcher runs the batch's torch work: count there
        real, counts = pipeline._launcher, []

        class Counting:
            def submit(self, fn, *args):
                def run():
                    with _OpCounter() as c:
                        try:
                            return fn(*args)
                        finally:
                            counts.append(c.n)

                return real().submit(run)

        pipeline._launcher = Counting
        try:
            pipeline._launch(dev, inputs, step, **kw).synchronize()
        finally:
            pipeline._launcher = real
        return counts[0]

    eager = counted()
    return {"eager": eager, "replay": [counted(graph_key=(bits, n_max)) for _ in range(3)][-1]}


def run(path: str, feed: str = "file", rate_mb_s: float = 35.0, device: str = "cuda", level: int = 9,
        mode: str = "fast") -> dict:
    """One hybrid encode of ``path`` under ``feed`` in the encode ``mode``
    (``scale_run.MODES``), with the driver's rate samples, the packs and
    the GIL probe recorded; the patched names are restored and the probe
    thread joined before it returns."""
    from starch3_tpu_torch.parallel import host, pipeline
    from starch3_tpu_torch.scale_run import MODES, _zero_counters

    texts = _chromosome_texts(path) if feed != "file" else None
    samples, packs, probe, queues = [], [], [], []
    last_drain = [None]
    real_pack, real_after_all = pipeline.pack_batch, pipeline._after_all
    real_stealers = pipeline._start_host_stealers
    real_dispatch, real_launcher = pipeline._dispatch_chunk, pipeline._launcher
    dispatches, submits, launches = _Split(), _Split(), _Split()
    real_launch = pipeline._launch

    class Launcher:
        def submit(self, fn, *args):
            return real_launcher().submit(launches.wrap(fn), *args)

    def start_stealers(q, *args):
        queues.append(q)
        return real_stealers(q, *args)

    def pack_batch(*args, **kw):
        t0 = time.perf_counter()
        try:
            return real_pack(*args, **kw)
        finally:
            packs.append((time.perf_counter() - t0) * 1e3)

    def after_all(n, note):
        # ``note`` is note_drain bound to (nbytes, bits, t_dispatch, pack_s, handle)
        nbytes, _bits, t_dispatch, pack_s, handle = note.args

        def record(work_s: float, device_s: float) -> None:
            now, prev = time.monotonic(), last_drain[0]
            last_drain[0] = now
            kind = ("first" if prev is None else "once" if pipeline._first_of_key(handle)
                    else "queued" if t_dispatch < prev else "dry")
            span = now - prev if kind == "queued" else max(pack_s + work_s, device_s)
            note(work_s, device_s)
            q = queues[-1]
            samples.append({"kind": kind, "pack_ms": pack_s * 1e3, "drain_ms": work_s * 1e3,
                            "device_ms": device_s * 1e3, "span_ms": span * 1e3,
                            "mb_per_s": nbytes / span / 1e6 if span > 0 else None,
                            "ema_mb_s": q.device_rate and q.device_rate / 1e6,
                            "bench_mb_s": q.stealer_rate and host._DEMOTE_FRACTION * q.stealer_rate
                            * q.n_stealers / 1e6, "benched": q.device_demoted})

        return real_after_all(n, record)

    stop = threading.Event()
    holders = _GilHolders()

    def gil_probe():
        while not stop.is_set():
            before = holders.before()
            t0 = time.perf_counter()
            time.sleep(0.001)
            wait = (time.perf_counter() - t0 - 0.001) * 1e3
            probe.append(wait)
            if wait > LONG_WAIT_MS:
                holders.after(wait, before)
            time.sleep(0.01)

    _zero_counters()
    pipeline.pack_batch, pipeline._after_all = pack_batch, after_all
    pipeline._start_host_stealers = start_stealers
    pipeline._dispatch_chunk, pipeline._launcher = dispatches.wrap(real_dispatch), Launcher
    pipeline._launch = submits.wrap(real_launch)
    prober = threading.Thread(target=gil_probe, name="gil-probe", daemon=True)
    prober.start()
    try:
        t0 = time.perf_counter()
        if feed == "file":
            from starch3_tpu_torch import api
            from starch3_tpu_torch.config import EncodeConfig

            with open(os.devnull, "wb") as out:
                api.compress_bed_file(path, out, EncodeConfig(use_jax=True, block_size_100k=level, **MODES[mode]),
                                      device=device)
            n = os.path.getsize(path)
        else:
            rate = rate_mb_s * 1e6 if feed == "paced" else None
            for _ in pipeline.encode_streams_iter(_paced(texts, rate), level=level, device=device, **MODES[mode]):
                pass
            n = sum(map(len, texts))
        seconds = time.perf_counter() - t0
    finally:
        stop.set()
        prober.join()
        pipeline.pack_batch, pipeline._after_all = real_pack, real_after_all
        pipeline._start_host_stealers = real_stealers
        pipeline._dispatch_chunk, pipeline._launcher = real_dispatch, real_launcher
        pipeline._launch = real_launch
    res = {"feed": feed, "mode": mode, "device": device, "level": level, "seconds": seconds,
           "mb_per_s": n / seconds / 1e6,
           "rate_mb_s": rate_mb_s if feed == "paced" else None,
           "scheduler_stats": dict(host.scheduler_stats),
           "device_blocks": pipeline.device_stats["blocks"], "device_batches": pipeline.device_stats["batches"],
           "samples": samples, "pack_ms": _quantiles(packs), "gil_wait_ms": _quantiles(probe),
           "gil_long_waits": holders.long_waits, "gil_long_wait_ms": holders.long_wait_ms,
           "gil_holders": holders.top(), "dispatch_ms": _quantiles(dispatches.ms),
           "submit_ms": _quantiles(submits.ms), "launch_ms": _quantiles(launches.ms)}
    for kind in ("dry", "queued"):
        of = [s for s in samples if s["kind"] == kind]
        res[kind] = {"n": len(of), **{k: (_quantiles([s[k] for s in of], (0.5,)) or [None])[0]
                                      for k in ("pack_ms", "drain_ms", "device_ms", "span_ms")}}
    res["dry_at_or_below_bench"] = sum(
        1 for s in samples if s["kind"] == "dry" and s["bench_mb_s"] and (s["mb_per_s"] or 0) <= s["bench_mb_s"])
    res["launcher_ops"] = launcher_ops(path, device, level)
    if device.startswith("cuda"):
        import torch

        res["card"] = torch.cuda.get_device_name(0)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("bed")
    ap.add_argument("--feed", choices=("file", "texts", "paced"), default="file")
    ap.add_argument("--rate", type=float, default=35.0, help="MB/s of text for --feed paced")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--level", type=int, default=9)
    ap.add_argument("--mode", default="fast", help="the encode mode: fast, fast_huff, ranks or rle2")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.bed, args.feed, args.rate, args.device, args.level, args.mode)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
