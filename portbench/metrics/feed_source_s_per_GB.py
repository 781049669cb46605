"""Seconds the streaming feed's thread (``s3tfeed``) waited on its source,
the program's span ``feed_source`` (``device_stats["feed_source_s"]``:
in ``api.compress_bed_stream`` the read, the native transform and the
carry), over the window, per GB (1e9 bytes) of BED encoded."""

UNIT, BETTER, SOURCE = "s/GB", "lower", "program_span"
LAYER, MOVES = "entry and feed", "encode_MBps"


def read(run):
    if not run.counters.get("feed_source_n") or not run.bed_bytes:
        return None
    return run.counters["feed_source_s"] / (run.bed_bytes / 1e9)
