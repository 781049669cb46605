"""``encode_peak_rss_MB`` in the cells whose encoder's held memory
differs from process to process by more than a tight bound allows (the
warm-up's retained heap of long encodes): the same reading, held to a
bound of its own."""

UNIT, BETTER, SOURCE = "MB", "lower", "host_clock"


def read(run):
    return run.layout.module("metrics", "encode_peak_rss_MB").read(run)
