"""BED bytes encoded in the window, in MB (1e6 bytes), over the window's
time: from the first encode's start to the last encode's end, every
encode counted whole."""

UNIT, BETTER, SOURCE = "MB/s", "higher", "host_clock"


def read(run):
    return run.bed_bytes / 1e6 / run.window_s if run.window_s > 0 else None
