"""K1's share of its roofline over the traced encodes (``kernels/k1.py``):
the least time the card could take for the bytes the kernel's work
needs, one byte read per input symbol and one written per rank of each
block's real length, at the card's HBM bandwidth, over the time its
kernels took in the profiler's trace."""

UNIT, BETTER, SOURCE = "%", "higher", "device_trace"
LAYER, MOVES = "MTF kernels", "encode_MBps"


def read(run):
    if run.trace is None or run.peaks is None:
        return None
    k1 = run.layout.module("kernels", "k1")
    seconds, nbytes = run.trace.kernel_seconds(k1.NAMES), k1.bytes_moved(run.packs)
    if not seconds or not nbytes:
        return None
    return 100.0 * nbytes / run.peaks["hbm_bytes_per_s"] / seconds
