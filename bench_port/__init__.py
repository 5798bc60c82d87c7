"""The benchmark of ``fluidsolver_tpu_torch`` on one NVIDIA H100.

``python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once; README.md says
how the folder is laid out and how a configuration, a traffic mix or a
per-layer metric is added.
"""
