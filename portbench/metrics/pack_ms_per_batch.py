"""Milliseconds the driver's thread (``s3tdevice``) spent packing a
device batch (``pipeline.pack_batch``), over the window: the program's
span ``pack`` (``device_stats["pack_s"]`` over ``["pack_n"]``)."""

UNIT, BETTER, SOURCE = "ms", "lower", "program_span"
LAYER, MOVES = "host tail, pack", "encode_MBps"


def read(run):
    n = run.counters.get("pack_n")
    return 1e3 * run.counters["pack_s"] / n if n else None
