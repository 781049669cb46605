"""Seconds from the harness's start to the window's: imports, CUDA's
start, the BED made from the seed, and the warm-up encodes (the kernels'
first build, in a checkout's first run)."""

UNIT, BETTER, SOURCE = "s", "lower", "host_clock"


def read(run):
    return run.setup_s
