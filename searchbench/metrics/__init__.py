"""One reader a metric, found by the metric's name in ``BENCHMARK.json``:
``metrics/<name>.py`` with ``read(run) -> float | None``. ``run`` is a
:class:`searchbench.run.RunData`; a reader that finds nothing to read
returns None, and the metric is left out of the result."""
