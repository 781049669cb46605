"""Seconds the streaming feed spent in the port's native transform
(``starch3_tpu_torch.runtime.bed_transform_native``, timed by the
harness around every call in the window) per GB (1e9 bytes) of BED
encoded.  The feed's one thread paces the encode where this reaches the
window's seconds per GB."""

UNIT, BETTER, SOURCE = "s/GB", "lower", "host_clock"
LAYER, MOVES = "entry and feed", "encode_MBps"


def read(run):
    calls = run.timed.get("bed_transform_native_calls", 0)
    return run.timed["bed_transform_native"] / (run.bed_bytes / 1e9) if calls else None
