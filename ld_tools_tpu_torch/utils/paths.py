"""Where the port puts what it compiles at run time.

Every library the port builds (the CUDA kernels, the exact finisher,
the VCF scanner) goes to ``ld_tools_tpu_torch/_build/``, which git
ignores.  Nothing is written next to a source under ``native/``: the
libraries there belong to the JAX package.
"""

from __future__ import annotations

import os

PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_ROOT = os.path.dirname(PKG_ROOT)
BUILD_DIR = os.path.join(PKG_ROOT, "_build")
