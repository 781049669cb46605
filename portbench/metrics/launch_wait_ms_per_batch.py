"""Milliseconds from the driver's submit of a batch to the launcher's
start on it (the launcher's queue and the hand-over of the GIL), over
the window: ``device_stats["launch_wait_s"]`` over ``["launch_n"]``."""

UNIT, BETTER, SOURCE = "ms", "lower", "program_span"
LAYER, MOVES = "driver", "encode_MBps"


def read(run):
    n = run.counters.get("launch_n")
    return 1e3 * run.counters["launch_wait_s"] / n if n else None
