"""The benchmark of ``octproz_tpu_torch`` on one CUDA GPU.

``python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
from the root of a checkout runs one cell of ``BENCHMARK.json`` and prints
one JSON line.  Configurations, traffic mixes and per-layer metrics are
files of their own under ``configs/``, ``traffic/`` and ``metrics/``, found
by the names ``BENCHMARK.json`` gives (``README.md``).
"""
