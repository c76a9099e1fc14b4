"""The benchmark of the PyTorch and CUDA port (``repro_torch``) on one H100.

``python3 h100_bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one JSON
line. Cells, configurations, traffic, drivers and metric readers are found
by name in ``configs/``, ``workloads/``, ``drivers/`` and ``metrics/``.
"""
