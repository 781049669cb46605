"""Share of the window's bzip2 blocks that the scheduler gave the card:
``device_stats["blocks"]`` over the window, over the blocks of all the
window's archives (the reference's count)."""

UNIT, BETTER, SOURCE = "%", "higher", "program_counter"
LAYER, MOVES = "queue and scheduler", "encode_MBps"


def read(run):
    return 100.0 * run.counters["blocks"] / run.blocks if run.blocks else None
