"""tpu-ld on PyTorch and CUDA: the port of ``ld_tools_tpu`` to an NVIDIA H100.

The JAX package stays the reference; this package imports nothing of it
(and no JAX).  Modules it needs from there, even JAX-free ones, are kept
here as copies with their imports pointed into the port.

- ``ingest``  copies of the host data plane: VCF -> packed store, cohort SQL.
- ``ops``     ``ld_kernels`` (the hand-written CUDA kernels of csrc/ and
              their plain PyTorch versions), ``ld_stream`` (the
              chromosome-scale threshold scan) and the exact f64 finisher.
- ``tools``   the four tools, ``lite``, ``area``, ``triangle`` and
              ``scan``, with their entry points (``python -m
              ld_tools_tpu_torch.ld_<tool>``) and the multiplexer
              (``python -m ld_tools_tpu_torch <command>``).
- ``parallel`` the all-pairs sweeps over devices and processes;
              ``entry`` the compile-check and dry-run entry points.
- ``io``, ``cli``, ``utils``  writers (the heatmap's too), argparse
              front-end, device choice, logging and the profiler hook.

Entry points run on ``cuda`` unless the caller asks for the CPU, and
raise when ``cuda`` is asked for and no card is present.
"""
