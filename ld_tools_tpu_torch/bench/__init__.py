"""The port's measurement path: counterparts of the JAX package's
``bench.py`` and ``scripts/bench_*.py``.

- ``python -m ld_tools_tpu_torch.bench``              the headline sweep
                                                      (``headline``, bench.py)
- ``python -m ld_tools_tpu_torch.bench.microkernels`` K8's stage split
- ``python -m ld_tools_tpu_torch.bench.kernels``      triangle variants
- ``python -m ld_tools_tpu_torch.bench.suite``        the config suite

Each runs on the card (``--device cuda``, the default) and raises without
one; ``--device cpu`` runs the plain PyTorch versions and says so.  No
entry point falls back to the CPU or carries on past a failed variant.
"""
