"""Milliseconds the launcher's thread (``s3tlaunch``) spent on a batch
(pins and stages its inputs, enqueues its uploads, its step or graph
replay and its rows' copy), over the window: the program's span
``launch`` (``device_stats["launch_s"]`` over ``["launch_n"]``)."""

UNIT, BETTER, SOURCE = "ms", "lower", "program_span"
LAYER, MOVES = "driver", "encode_MBps"


def read(run):
    n = run.counters.get("launch_n")
    return 1e3 * run.counters["launch_s"] / n if n else None
