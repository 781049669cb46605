"""Milliseconds a host stealer (``s3steal*``) spent encoding a block, per
MB (1e6 bytes) of the blocks it stole, over the window: the program's
span ``steal`` (``scheduler_stats["steal_s"]`` over
``["steal_bytes"]``)."""

UNIT, BETTER, SOURCE = "ms/MB", "lower", "program_span"
LAYER, MOVES = "queue and scheduler", "encode_MBps"


def read(run):
    nbytes = run.counters.get("scheduler_steal_bytes")
    return 1e3 * run.counters["scheduler_steal_s"] / (nbytes / 1e6) if nbytes else None
