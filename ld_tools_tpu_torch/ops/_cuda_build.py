"""Build and bind the hand-written CUDA kernels (every csrc/*.cu).

nvcc compiles each source into an object, all of them at once, and links
them into one shared library with a plain C interface, loaded with
ctypes: no PyTorch headers, so the build takes seconds.  The library goes
to ``ld_tools_tpu_torch/_build/`` at first use, through a per-process
temporary name and an atomic rename (concurrent builds never expose a
half-written library), and is rebuilt when any source or header under
csrc/ is newer, or when the set of sources differs from the one it was
built from (a manifest beside it lists them).  Pointers and the stream cross as ``ctypes.c_void_p``;
every entry point returns ``cudaGetLastError()`` (or its own refusal)
and :func:`check` raises on a non-zero code.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading
import time

from ld_tools_tpu_torch.utils.paths import BUILD_DIR, PKG_ROOT

CSRC = os.path.join(PKG_ROOT, "csrc")
# ld_block_sm90.cu: the wgmma / TMA triangle (K1, K8; on packed bytes K2;
# bf16 and tf32, K1b) and band sweeps (K3, K4); ld_count_sm90.cu: the
# wgmma / TMA count pass (K5, K6); both on ld_sm90_core.cuh;
# ld_gather_rows.cu: the scan's resident from the store's packed rows
SOURCES = tuple(sorted(glob.glob(os.path.join(CSRC, "*.cu"))))
HEADERS = tuple(sorted(glob.glob(os.path.join(CSRC, "*.cuh"))))
LIB = os.path.join(BUILD_DIR, "libld_kernels.so")
# the names of the sources and headers LIB was built from, one a line
MANIFEST = LIB + ".sources"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3",
    # the f32 epilogues must round each product and sum on its own, as
    # the plain versions do op by op: FMA contraction would let the f32
    # fallback masks of the count and fetch passes disagree
    "-fmad=false",
    "-std=c++17", "-Xcompiler", "-fPIC",
)
# cuTensorMapEncodeTiled (the wgmma kernels' TMA descriptors) comes through
# cudaGetDriverEntryPoint*, so the library links the runtime only
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")

_lock = threading.Lock()
_lib = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "ldk_band_count": (
        _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _F, _I,
        _I, _I, _I, _I, _I, _P, _P,
    ),
    "ldk_block_triangle": (
        _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _I, _I, _I, _P, _P, _P,
    ),
    "ldk_block_sweep": (
        _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F,
        _I, _I, _I, _P, _P, _P, _P, _P,
    ),
    "ldk_gather_rows": (_P, _I, _I, _P, _I, _I, _I, _I, _P, _P, _P),
}

# operand forms of the rows (enum Form in csrc/ld_common.cuh)
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


def _manifest() -> str:
    return "".join(os.path.basename(f) + "\n" for f in SOURCES + HEADERS)


def _stale() -> bool:
    """True when the library is missing, older than any source or header
    under csrc/, or built from another set of them (a source added or
    deleted: a library from an older tree keeps the entry points of a
    deleted source)."""
    if not os.path.exists(LIB):
        return True
    try:
        with open(MANIFEST) as f:
            if f.read() != _manifest():
                return True
    except OSError:
        return True
    newest = max(os.path.getmtime(f) for f in SOURCES + HEADERS)
    return os.path.getmtime(LIB) < newest


def _remove(paths) -> None:
    for path in paths:
        try:
            os.unlink(path)
        except OSError:
            pass


def build(force: bool = False, verbose: bool = False) -> dict:
    """Compile the kernels if the library is stale (:func:`_stale`): one
    nvcc per source, all started together, then one link.  Returns
    {"seconds": build time (0.0 when up to date), "log": nvcc's output};
    ``verbose`` adds ``-Xptxas -v`` (registers, shared memory and spills
    per kernel)."""
    if not force and not _stale():
        return {"seconds": 0.0, "log": ""}
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    tag = f"tmp.{os.getpid()}"
    objs = [os.path.join(BUILD_DIR, f"{os.path.basename(src)}.{tag}.o")
            for src in SOURCES]
    tmp = f"{LIB}.{tag}"
    extra = ["-Xptxas", "-v"] if verbose else []
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [nvcc, *NVCC_FLAGS, *extra, "-c", src, "-o", obj],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src, obj in zip(SOURCES, objs)]
    logs, failed = [], []
    try:
        for src, proc in zip(SOURCES, procs):
            out = proc.communicate(timeout=600)[0]
            logs.append(out)
            if proc.returncode != 0:
                failed.append(
                    f"{os.path.basename(src)} ({proc.returncode}):\n{out}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    try:
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        link = subprocess.run([nvcc, *LINK_FLAGS, *objs, "-o", tmp],
                              capture_output=True, text=True, timeout=600)
        if link.returncode != 0:
            _remove([tmp])
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{link.stdout}{link.stderr}")
    finally:
        _remove(objs)
    os.replace(tmp, LIB)
    with open(f"{MANIFEST}.{tag}", "w") as f:
        f.write(_manifest())
    os.replace(f"{MANIFEST}.{tag}", MANIFEST)
    return {"seconds": time.perf_counter() - t0,
            "log": "".join(logs) + link.stdout + link.stderr}


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
