"""The benchmark of the PyTorch/CUDA port of Spatial Parquet (``repro_torch``).

One run is one cell of ``BENCHMARK.json`` (a configuration under a traffic
mix), run once from the root of a checkout::

    python3 spbench/run.py --workload porto-bbox-large --seed 7 --seconds 51 --trace 0

Layout, found by name so that a new cell, configuration, mix or metric is a
new file and a new entry in ``BENCHMARK.json``, never an edit:

* ``configs/<config>.json``: a deployment (source, generator and sizes,
  writer settings, extra columns);
* ``traffic/<mix>.json``: a mix (its parameters, and the names of its
  query generator and its driver);
* ``queries/<name>.py``: a query generator, ``make(mix, oracle, seed)``;
* ``drivers/<name>.py``: a driver: the entry point it calls, what the
  reference expects of it, and the loop of the window;
* ``metrics/<metric>.py``: one reader a metric, ``read(run) -> float | None``;
* ``reference/``: the plain NumPy reference (generators, Hilbert order,
  page layout, the expected answer of every read); it imports nothing of
  the port;
* ``harness.py`` (set-up, window, check), ``traffic.py`` (what generators
  and drivers share, and how they are found), ``check.py`` (the comparison
  that decides ``correct``), ``devtrace.py`` (the profiler's device
  timeline), ``roofline.py`` (peaks and the bytes each kernel needs).

Nothing here imports ``jax`` or the JAX package.
"""
