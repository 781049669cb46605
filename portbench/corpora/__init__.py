"""Seeded BED writers, one module per writer, each yielding its bytes in
chunks: ``reads_scale_bed`` is a copy of ``starch3_tpu_torch/corpus.py``'s
writer, so that a change to the program cannot move the benchmark's
inputs; ``genome_bed3`` is the benchmark's own.  A writer module has
``chunks(target, seed, **shape)``; ``columns`` holds the NumPy
formatting they share."""
