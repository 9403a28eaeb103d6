"""The benchmark of the PyTorch/CUDA port (``monte_carlo_localization_tpu_torch``).

``python3 -m mcl_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once on the card and prints its
result as the last line of standard output. A cell is a configuration
(``configs/``, naming a map and a trace of the checkout's ``maps/`` and
``traces/``), a traffic mix (``traffic/``, read by the driver it names
in ``drivers/``: by default ``generator.py``), its limits (``limits/``)
and the metrics it reports (``metrics/``), all found by name. The
driver's comparison (by default ``check.py``) holds what the window
produced against the plain reference in ``reference/``; ``card.py`` and
``devtrace.py`` are the fixed yardstick. ``calibrate.py`` and ``sweep.py`` are tools for the
card, not part of a run. CPU tests: ``python -m pytest mcl_bench/tests``.
"""
