"""Share of the card's blocks whose fast sort tied and which the driver
re-encoded on the host: ``device_stats["tie_reencodes"]`` over
``device_stats["blocks"]``, over the window."""

UNIT, BETTER, SOURCE = "%", "lower", "program_counter"
LAYER, MOVES = "driver", "encode_MBps"


def read(run):
    blocks = run.counters["blocks"]
    return 100.0 * run.counters["tie_reencodes"] / blocks if blocks else None
