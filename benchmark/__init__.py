"""The benchmark of ``unmore_tpu_torch``, the PyTorch/CUDA port, on NVIDIA
cards: ``python3 -m benchmark.run --workload <cell> --seed <n> --seconds
<s> --trace <0|1>`` runs one cell of ``BENCHMARK.json`` once.

Configurations (``configs/``), traffic mixes (``traffic/``), limits of the
correctness check (``limits/``) and per-layer metric readers
(``metrics/``) are files found by name; the plain reference lives in
``reference/`` and imports nothing of the system under test.
"""
