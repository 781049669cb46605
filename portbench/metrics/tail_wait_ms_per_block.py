"""Milliseconds a card block's tail task waited in the tail pool's queue,
from the driver's submit to a thread's start on it, over the window:
``scheduler_stats["tail_wait_s"]`` over ``["tail_n"]``.  It reads the
pool's width (2 by default) against the drain's pace."""

UNIT, BETTER, SOURCE = "ms", "lower", "program_span"
LAYER, MOVES = "host tail, pack", "encode_MBps"


def read(run):
    n = run.counters.get("scheduler_tail_n")
    return 1e3 * run.counters["scheduler_tail_wait_s"] / n if n else None
