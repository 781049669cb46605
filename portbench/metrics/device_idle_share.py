"""Share of the traced encodes' time in which nothing ran on the card:
1 minus the union of its kernels, copies and sets over the traced
sub-window, from the profiler's trace."""

UNIT, BETTER, SOURCE = "%", "lower", "device_trace"
LAYER, MOVES = "device", "encode_MBps"


def read(run):
    if run.trace is None or not run.trace.device or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
