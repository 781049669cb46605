"""Milliseconds the driver's thread spent re-encoding on the host a card
block whose fast sort tied, over the window: the program's span
``tie_reencode`` (``device_stats["tie_reencode_s"]`` over its count
``["tie_reencode_n"]``, which equals ``["tie_reencodes"]`` in fast
mode)."""

UNIT, BETTER, SOURCE = "ms", "lower", "program_span"
LAYER, MOVES = "driver", "encode_MBps"


def read(run):
    n = run.counters.get("tie_reencode_n")
    return 1e3 * run.counters["tie_reencode_s"] / n if n else None
