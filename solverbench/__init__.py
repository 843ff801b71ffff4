"""The benchmark of ``pysolvers_tpu_torch`` on an NVIDIA GPU.

``python3 solverbench/run.py --workload <config>.<mix> --seed <n>
--seconds <s> --trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and
prints one JSON line.  See ``solverbench/README.md``.
"""
