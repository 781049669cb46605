"""Milliseconds a tail-pool thread (``s3tail*``) spent on a card block's
native RLE2, Huffman and bit emission, over the window: the program's
span ``tail`` (``scheduler_stats["tail_s"]`` over ``["tail_n"]``)."""

UNIT, BETTER, SOURCE = "ms", "lower", "program_span"
LAYER, MOVES = "host tail, pack", "encode_MBps"


def read(run):
    n = run.counters.get("scheduler_tail_n")
    return 1e3 * run.counters["scheduler_tail_s"] / n if n else None
