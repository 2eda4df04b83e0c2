"""The port's benchmark: one cell of ``BENCHMARK.json`` a run.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

See ``benchmark/README.md``.
"""
