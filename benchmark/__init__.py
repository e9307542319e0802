"""The benchmark of the PyTorch and CUDA port (``vsearch_tpu_torch``).

One command runs one cell once::

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Cells, configurations, traffic mixes and per-layer metrics are listed in
``BENCHMARK.json`` at the repository root and found by name: a
configuration is ``configs/<name>.json``, a traffic mix
``traffic/<name>.json`` (whose ``generator`` names ``generators/<name>.py``)
and a per-layer metric ``metrics/<name>.py``. Nothing here imports JAX or
the JAX package; ``reference/`` imports nothing of the port either.
"""
