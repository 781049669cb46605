"""Milliseconds from a streaming encode's start to its first block in the
block queue, on average over the window's encodes:
``device_stats["first_block_s"]`` over ``device_stats["encodes"]``.  No
stealer and no card has work before it."""

UNIT, BETTER, SOURCE = "ms", "lower", "program_span"
LAYER, MOVES = "entry and feed", "encode_MBps"


def read(run):
    encodes = run.counters.get("encodes")
    return 1e3 * run.counters["first_block_s"] / encodes if encodes else None
