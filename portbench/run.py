"""Run one cell of the benchmark once, in a process of its own:

    python3 -m portbench.run --workload CELL --seed N --seconds S --trace 0|1

from the root of a checkout that holds ``starch3_tpu_torch``.  Set-up
(``setup_s``: from this module's start to the window's) imports the
port, initialises CUDA, makes the cell's BED in memory from the seed and
warms up by encoding it.  The window is one client's closed loop of
``starch3_tpu_torch.api.compress_bed_stream`` with the default
``EncodeConfig()`` on ``cuda``: encodes start until ``S`` seconds have
passed and the last one runs to its end.  Every archive of the window is
then held to the plain reference's (``reference/``).  ``--trace 1``
profiles the window's first whole encode and reports the per-layer
metrics instead of the end-to-end ones.

The last line of standard output is the result, one JSON object; the
last lines of standard error are the numbers compared, each beside its
limit.  Without a card, or with fewer cards than the cell asks for, or
when JAX or the JAX package was loaded, it exits non-zero and prints no
result."""

import time

_T0 = time.perf_counter()  # set-up is timed from here

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import io  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from pathlib import Path  # noqa: E402

from portbench import traffic  # noqa: E402
from portbench.layout import Layout  # noqa: E402

# top-level module names that no run may load: JAX and the JAX package
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "starch3_tpu"})
# set-up ends once every file has been encoded and the encodes since the
# last one that captured a new CUDA graph took this long: where an encode
# is short, the scheduler may reach a graph's key only in a later one
WARM_UP_QUIET_S = 1.0


def pin_caches(checkout: Path) -> None:
    """Kernel caches of the libraries the port and the profiler use, at
    fixed paths inside the checkout (``build/``, which git ignores; the
    port builds its own kernels there too)."""
    cache = checkout / "build" / "portbench-cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(cache / "inductor")


def forbidden_modules() -> list[str]:
    return sorted({m.partition(".")[0] for m in list(sys.modules)} & FORBIDDEN)


@dataclass
class Run:
    """What the metric readers read (``metrics/<name>.py``'s ``read``)."""

    setup_s: float
    window_s: float  # the first encode's start to the last one's end
    bed_bytes: int  # BED bytes of the window's encodes
    encodes: list  # (start s, end s from the window's start, BED bytes) of each
    rss_start_mb: float  # once the BED was made, before the first encode
    rss_peak_mb: float  # the window's highest
    counters: dict  # the program's counters over the window
    blocks: int  # bzip2 blocks of the window's archives (the reference's count)
    timed: dict  # the harness's timers over the window (traced runs)
    peaks: dict | None  # the card's published peaks (``peaks.py``)
    layout: Layout
    trace: object = None  # trace.Trace of the traced encodes
    trace_counters: dict = field(default_factory=dict)  # the counters over them
    packs: list = field(default_factory=list)  # (bits, [block bytes]) of each batch packed in them


def port_encoder(device: str):
    """The timed path: the port's streaming entry with the default
    ``EncodeConfig()`` on ``device``, from the BED's bytes into ``sink``."""
    from starch3_tpu_torch import api
    from starch3_tpu_torch.config import EncodeConfig

    def encode(bed: bytes, sink) -> None:
        api.compress_bed_stream(io.BytesIO(bed), sink, EncodeConfig(), device=device)

    return encode


def run_cell(layout: Layout, name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t0: float = _T0, encoder=None, warm_up: bool = True) -> tuple[dict, list[str]]:
    """One run of the cell ``name``; returns the result and the lines of
    standard error that come before the numbers compared.  ``encoder``
    (``(bed, sink)``; the port's ``port_encoder(device)`` by default)
    stands in for the timed path in the checks' controls, which also
    leave out the warm-up."""
    cell = layout.cell(name)
    config = layout.data("configs", cell["config"])
    mix = traffic.load(layout, cell["traffic"])

    import torch

    from starch3_tpu_torch import runtime

    from portbench import check, peaks, window
    from portbench import trace as tracing
    from portbench.reference import starch

    on_card = device.startswith("cuda")
    if on_card:
        torch.cuda.init()
        torch.zeros(1, device=device)
        torch.cuda.synchronize(device)
    files = traffic.files(layout, config, mix, seed)
    window.release_free_memory()
    rss_start = window.rss_mb()
    notes = []

    timed_path = encoder or port_encoder(device)

    def encode(k: int) -> tuple[int, window.HashSink]:
        i = traffic.order(mix, k)
        sink = window.HashSink()
        timed_path(files[i], sink)
        return i, sink

    captures, quiet_s = [], 0.0  # the encoding seconds since the last encode that captured a CUDA graph
    for k in range(max(1, int(mix.get("warm_up_encodes", 1))) if warm_up else 0):
        before, t = window.counters(), time.perf_counter()
        encode(k)
        captures.append(window.since(before)["graph_captures"])
        quiet_s = 0.0 if captures[-1] else quiet_s + time.perf_counter() - t
        if k + 1 >= len(files) and captures[-1] == 0 and quiet_s >= WARM_UP_QUIET_S:
            break
    notes.append(f"warm-up: {len(captures)} encodes, CUDA graphs captured in each: {captures}; RSS after it "
                 f"{(window.rss_mb() - rss_start) * 2**20 / 1e6:.1f} MB above the start")
    if trace:
        tracing.warm(device)
    encodes, archives, failed, marks = [], [], 0, []
    tracer = tracing.Tracer(device) if trace else None
    peak = window.PeakRss().start()
    before, host_before = window.counters(), window.host_times()
    with contextlib.ExitStack() as whole:
        timed = whole.enter_context(window.timed_calls(runtime, "bed_transform_native")) if trace else {}
        start = time.perf_counter()
        k = 0
        while True:
            traced = trace and k == 0  # the traced sub-window: the first encode
            try:
                if traced:
                    tracer.start()
                with tracer.encode() if traced else contextlib.nullcontext():
                    a = time.perf_counter() - start
                    i, sink = encode(k)
                    b = time.perf_counter() - start
                if traced:
                    tracer.stop()
            except Exception:  # an encode that fails ends the window; the run is not correct
                failed += 1
                notes.append(traceback.format_exc())
                break
            encodes.append((a, b, len(files[i])))
            marks.append(peak.mark())
            archives.append((i, sink))
            k += 1
            if b >= seconds:
                break
    rss_peak = peak.stop()
    counts, host = window.since(before), window.host_since(host_before)
    kind = torch.cuda.get_device_name(device) if on_card else "cpu"
    dev = {"platform": "gpu" if on_card else "cpu", "kind": kind, "count": cell["chips"],
           "memory_peak_bytes": torch.cuda.max_memory_reserved(device) if on_card else 0}
    traced = None
    if tracer is not None:
        tracer.stop()
        traced = tracer.read() if failed == 0 else None
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    refs = {i: starch.archive(files[i]) for i in sorted({i for i, _ in archives})}
    checks = check.judge(archives, refs, failed)
    run = Run(setup_s=start - t0, window_s=encodes[-1][1] - encodes[0][0] if encodes else 0.0,
              bed_bytes=sum(e[2] for e in encodes), encodes=encodes, rss_start_mb=rss_start,
              rss_peak_mb=rss_peak, counters=counts, blocks=sum(refs[i].blocks for i, _ in archives),
              timed=timed, peaks=peaks.of(kind), layout=layout, trace=traced,
              trace_counters=tracer.counters if tracer else {}, packs=tracer.packs if tracer else [])
    metrics = {}
    for m in layout.metrics(name, "per_layer" if trace else "end_to_end"):
        value = layout.module("metrics", m["name"]).read(run) if encodes else None
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if traced is not None:
        dev["busy_s"], dev["window_s"] = traced.busy_s, traced.window_s
    notes.append("window: seconds of each encode " + " ".join(f"{b - a:.3f}" for a, b, _ in encodes)
                 + "; peak RSS in each, MB above the start "
                 + " ".join(f"{(m - rss_start) * 2**20 / 1e6:.1f}" for m in marks))
    notes.append(f"window: {len(encodes)} encodes in {run.window_s:.3f} s, {failed} failed; "
                 f"device blocks {counts['blocks']} of {run.blocks}, batches {counts['batches']}, "
                 f"tie re-encodes {counts['tie_reencodes']}, graph captures {counts['graph_captures']}, "
                 f"replays {counts['graph_replays']}, demotions {counts['scheduler_demotions']}")
    notes.append(window.host_note(host, run.bed_bytes))
    line = {"correct": check.passed(checks) and bool(archives), "attempted": len(encodes) + failed,
            "failed": failed, "metrics": metrics, "device": dev}
    if traced is not None:
        line["breakdown"] = traced.breakdown()
    line["checks"] = checks
    return line, notes


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    layout = Layout()
    pin_caches(layout.root.parent)
    chips = layout.cell(args.workload)["chips"]

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell {args.workload} needs {chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    line, notes = run_cell(layout, args.workload, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}; no result", file=sys.stderr)
        return 3
    print(json.dumps(line))
    sys.stdout.flush()
    for note in notes:
        print(note, file=sys.stderr)
    for k, c in line["checks"].items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
