"""Build and bind the hand-written CUDA kernels (csrc/ld_kernels.cu).

nvcc compiles the source into a shared library with a plain C interface,
loaded with ctypes: no PyTorch headers, so the build takes seconds.  The
library goes to ``ld_tools_tpu_torch/_build/`` at first use, through a
per-process temporary name and an atomic rename (concurrent builds never
expose a half-written library), and is rebuilt when the source is
newer.  Pointers and the stream cross as ``ctypes.c_void_p``; every entry
point returns ``cudaGetLastError()`` and :func:`check` raises on a
non-zero code.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time

from ld_tools_tpu_torch.utils.paths import BUILD_DIR, PKG_ROOT

SRC = os.path.join(PKG_ROOT, "csrc", "ld_kernels.cu")
LIB = os.path.join(BUILD_DIR, "libld_kernels.so")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3",
    # the f32 epilogues must round each product and sum on its own, as
    # the plain versions do op by op: FMA contraction would let the f32
    # fallback masks of the count and fetch passes disagree
    "-fmad=false",
    "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_lib = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "ldk_band_count": (
        _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _F, _I,
        _I, _I, _I, _I, _P, _P,
    ),
    "ldk_band_sweep": (
        _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F,
        _I, _I, _P, _P, _P, _P, _P,
    ),
    "ldk_triangle": (
        _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _I, _I, _P, _P, _P,
    ),
}

# operand forms of the rows (enum Form in csrc/ld_kernels.cu)
FORM_S8 = 0     # int8 {0,1} haplotypes
FORM_BITS = 1   # the store's bitpacked bytes, 8 haplotypes per byte
FORM_BF16 = 2   # int8 rows, bf16 tensor-core products (triangle only)
FORM_TF32 = 3   # int8 rows, tf32 tensor-core products (triangle only)


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
        shutil.which("nvcc") or "",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH); the CUDA kernels are built from csrc/ on the GPU machine"
    )


def build(force: bool = False, verbose: bool = False) -> dict:
    """Compile the kernels if the library is missing or older than the
    source.  Returns {"seconds": build time (0.0 when up to date),
    "log": nvcc's output}; ``verbose`` adds ``-Xptxas -v`` (registers,
    shared memory and spills per kernel)."""
    if (not force and os.path.exists(LIB)
            and os.path.getmtime(LIB) >= os.path.getmtime(SRC)):
        return {"seconds": 0.0, "log": ""}
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIB}.tmp.{os.getpid()}"
    cmd = [_nvcc(), *NVCC_FLAGS]
    if verbose:
        cmd += ["-Xptxas", "-v"]
    cmd += [SRC, "-o", tmp]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, LIB)
    return {"seconds": time.perf_counter() - t0,
            "log": proc.stdout + proc.stderr}


def lib():
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            build()
            handle = ctypes.CDLL(LIB)
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            handle.ldk_error_string.argtypes = [ctypes.c_int]
            handle.ldk_error_string.restype = ctypes.c_char_p
            _lib = handle
        return _lib


def check(err: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = lib().ldk_error_string(err).decode()
        raise RuntimeError(f"{kernel} launch failed: CUDA error {err}: {msg}")
