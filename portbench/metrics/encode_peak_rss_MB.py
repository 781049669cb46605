"""The encoder's own resident memory, in MB (1e6 bytes): the highest RSS
sampled (every 20 ms) from the window's first encode to its last, minus
the RSS the process had once its BED was made and before its first
(warm-up) encode; what the warm-up left held counts."""

UNIT, BETTER, SOURCE = "MB", "lower", "host_clock"


def read(run):
    return (run.rss_peak_mb - run.rss_start_mb) * 2**20 / 1e6
