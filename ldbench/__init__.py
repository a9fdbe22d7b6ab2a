"""The benchmark of the PyTorch and CUDA port (``ld_tools_tpu_torch``).

``python3 ldbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell once; ``BENCHMARK.json`` at the root lists
the cells and metrics, and ``PERF.md`` says why each is there.
"""
