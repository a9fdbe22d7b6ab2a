"""The port's measurement path: counterparts of the JAX package's
``bench.py``, ``scripts/bench_*.py``, ``scripts/scaling_model.py`` and
``scripts/tpu_smoke.py``.

- ``python -m ld_tools_tpu_torch.bench``               the headline sweep
                                                       (``headline``, bench.py)
- ``python -m ld_tools_tpu_torch.bench.microkernels``  K8's stage split
- ``python -m ld_tools_tpu_torch.bench.kernels``       triangle variants
- ``python -m ld_tools_tpu_torch.bench.suite``         the config suite
- ``python -m ld_tools_tpu_torch.bench.scaling_model`` measured components
                                                       composed into T(N)
- ``python -m ld_tools_tpu_torch.bench.scaling``       the scan at 1-8 shards
- ``python -m ld_tools_tpu_torch.bench.smoke``         kernel configurations
                                                       against host oracles

Each runs on the card (``--device cuda``, the default) and raises without
one; ``--device cpu`` runs the plain PyTorch versions and says so.  No
entry point falls back to the CPU or carries on past a failed variant,
but for the smoke suite, which records a failed configuration, goes on
to the next and then exits 1.
"""
