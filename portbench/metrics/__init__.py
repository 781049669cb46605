"""One reader per metric, named as in ``BENCHMARK.json``: ``read(run)``
takes the harness's ``run.Run`` and returns the metric's value, or None
where the run holds nothing to read (then the metric is left out of the
result line).  Each file also states the metric's unit, source, layer and
the end-to-end metric it should move; which cells report it is
``BENCHMARK.json``'s to say."""
