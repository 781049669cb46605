"""Milliseconds the card was busy (the union of its kernels, copies and
sets in the profiler's trace) over the traced encodes, per device batch
dispatched in them (``device_stats["batches"]``)."""

UNIT, BETTER, SOURCE = "ms", "lower", "device_trace"
LAYER, MOVES = "device steps", "encode_MBps"


def read(run):
    batches = run.trace_counters.get("batches", 0)
    if run.trace is None or not batches or not run.trace.device:
        return None
    return 1e3 * run.trace.busy_s / batches
