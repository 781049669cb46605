"""The benchmark of ``starch3_tpu_torch``, the PyTorch and CUDA port.

One run is one cell of ``BENCHMARK.json`` (a configuration under a
traffic mix), started as ``python3 -m portbench.run --workload CELL
--seed N --seconds S --trace 0|1`` from the root of a checkout.  The
harness finds every piece of a cell by its name: ``configs/<config>.json``,
``workloads/<cell>.json``, ``corpora/<writer>.py``,
``metrics/<metric>.py`` and ``kernels/<kernel>.py``.  ``reference/``
is the plain reference that decides ``correct``.  Nothing here imports
JAX or the JAX package.
"""
