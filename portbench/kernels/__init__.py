"""One file per kernel: ``NAMES``, the regular expressions that match
its launches' names in the profiler's trace, and ``bytes_moved(packs)``,
the bytes its work needs for the batches packed in the traced encodes
(``(bits, [block bytes])`` each), or None where it ran on none."""
