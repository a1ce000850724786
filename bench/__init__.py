"""The serving benchmark of the PyTorch and CUDA port (``repro_torch``).

``python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell of ``BENCHMARK.json`` once. Everything that belongs to
one configuration, traffic mix or per-layer metric is a file of its own
(``configs/``, ``traffic/``, ``metrics/``, ``reference/``), found by the
names in ``BENCHMARK.json``.
"""
