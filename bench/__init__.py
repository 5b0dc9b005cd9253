"""The port's benchmark: one cell of ``BENCHMARK.json`` per run.

``python bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
serves the cell's traffic through ``repro_torch`` on one card and prints one
JSON line of results.  See ``bench/README.md``.
"""
