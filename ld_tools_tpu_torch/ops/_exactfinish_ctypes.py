"""ctypes bindings for native/exactfinish.cpp, built on demand with g++.

Same build pattern as ingest/_vcfpack_ctypes.py: pybind11 is not
available, so the finisher exposes a flat C API and this module marshals
numpy arrays.  The build deliberately avoids -ffast-math/-march and
forces -ffp-contract=off — the whole point of the native path is
bit-identical IEEE f64 results to the numpy reference order (and through
it to reference backend/calc_ld.py), just without numpy's dozen
full-matrix temporaries.  ops/exact.py falls back to numpy when the
toolchain is missing or $TPU_LD_NATIVE_FINISH=0.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

from ld_tools_tpu_torch.utils.paths import BUILD_DIR, REPO_ROOT

_SRC = os.environ.get(
    "TPU_LD_EXACTFINISH_SRC",
    os.path.join(REPO_ROOT, "native", "exactfinish.cpp"),
)
# the port's own build directory, never next to the source: the library
# in native/ belongs to the JAX package
_LIB = os.path.join(BUILD_DIR, "libexactfinish.so")

_lock = threading.Lock()
_lib_handle = None


class NativeUnavailable(RuntimeError):
    pass


def _build() -> None:
    # compile to a per-process temp path and rename into place: several
    # pool workers may race to build, and dlopen of a half-written .so
    # fails confusingly (rename is atomic; losers just overwrite with an
    # identical library)
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{_LIB}.tmp.{os.getpid()}"
    cmd = [
        "g++", "-O2", "-std=c++17", "-shared", "-fPIC",
        "-ffp-contract=off",  # REQUIRED: FMA contraction breaks f64 parity
        _SRC, "-o", tmp, "-lpthread",
    ]
    try:
        subprocess.run(
            cmd, check=True, capture_output=True, text=True, timeout=300
        )
        os.replace(tmp, _LIB)
    except (subprocess.CalledProcessError, FileNotFoundError,
            subprocess.TimeoutExpired, OSError) as exc:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        detail = getattr(exc, "stderr", "") or str(exc)
        raise NativeUnavailable(f"exactfinish build failed: {detail}") from exc


def _load():
    global _lib_handle
    with _lock:
        if _lib_handle is not None:
            return _lib_handle
        if os.environ.get("TPU_LD_NATIVE_FINISH", "1") == "0":
            raise NativeUnavailable("disabled via TPU_LD_NATIVE_FINISH=0")
        if not os.path.exists(_SRC):
            raise NativeUnavailable("native/exactfinish.cpp missing")
        if (not os.path.exists(_LIB)
                or os.path.getmtime(_LIB) < os.path.getmtime(_SRC)):
            _build()
        try:
            lib = ctypes.CDLL(_LIB)
        except OSError as exc:
            raise NativeUnavailable(str(exc)) from exc
        dbl_p = ctypes.POINTER(ctypes.c_double)
        i32_p = ctypes.POINTER(ctypes.c_int32)
        u8_p = ctypes.POINTER(ctypes.c_uint8)
        lib.ef_finish_block.restype = None
        lib.ef_finish_block.argtypes = [
            i32_p, dbl_p, dbl_p, ctypes.c_double,
            ctypes.c_int64, ctypes.c_int64,
            dbl_p, dbl_p, u8_p, u8_p, ctypes.c_int32,
        ]
        lib.ef_finish_pairs.restype = None
        lib.ef_finish_pairs.argtypes = [
            dbl_p, dbl_p, dbl_p, ctypes.c_double, ctypes.c_int64,
            dbl_p, dbl_p, u8_p, u8_p,
        ]
        lib.ef_round4.restype = None
        lib.ef_round4.argtypes = [dbl_p, ctypes.c_int64, dbl_p, u8_p]
        lib.ef_finish_block_measure.restype = None
        lib.ef_finish_block_measure.argtypes = [
            i32_p, dbl_p, dbl_p, ctypes.c_double,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
            dbl_p, u8_p, u8_p, ctypes.c_int32,
        ]
        lib.ef_finish_block_measures2.restype = None
        lib.ef_finish_block_measures2.argtypes = [
            i32_p, dbl_p, dbl_p, ctypes.c_double,
            ctypes.c_int64, ctypes.c_int64,
            dbl_p, u8_p, u8_p, dbl_p, u8_p, u8_p, ctypes.c_int32,
        ]
        _lib_handle = lib
        return lib


def available() -> bool:
    try:
        _load()
        return True
    except NativeUnavailable:
        return False


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def finish_block(c_ab, c1_rows, c1_cols, n: float, n_threads=None):
    """(r2, dp, r2_iz, dp_iz) f64/bool for an (nr, nc) int32 count block."""
    lib = _load()
    c_ab = np.ascontiguousarray(c_ab, dtype=np.int32)
    c1_rows = np.ascontiguousarray(c1_rows, dtype=np.float64)
    c1_cols = np.ascontiguousarray(c1_cols, dtype=np.float64)
    nr, nc = c_ab.shape
    r2 = np.empty((nr, nc), dtype=np.float64)
    dp = np.empty((nr, nc), dtype=np.float64)
    r2_iz = np.empty((nr, nc), dtype=np.uint8)
    dp_iz = np.empty((nr, nc), dtype=np.uint8)
    if n_threads is None:
        n_threads = os.cpu_count() or 1
    lib.ef_finish_block(
        _ptr(c_ab, ctypes.c_int32),
        _ptr(c1_rows, ctypes.c_double),
        _ptr(c1_cols, ctypes.c_double),
        float(n), nr, nc,
        _ptr(r2, ctypes.c_double), _ptr(dp, ctypes.c_double),
        _ptr(r2_iz, ctypes.c_uint8), _ptr(dp_iz, ctypes.c_uint8),
        int(n_threads),
    )
    return r2, dp, r2_iz.view(bool), dp_iz.view(bool)


def finish_block_measure(c_ab, c1_rows, c1_cols, n: float, sel: int,
                         n_threads=None):
    """(rounded, int_zero, risky) for ONE measure of an int32 count block.

    ``sel``: 0 = r_square, 1 = d_prime.  ``rounded`` is the 4-dp fast
    round (int-0 cells hold 0.0); ``risky`` marks near-decimal-tie cells
    the caller must re-round with Python's round().
    """
    lib = _load()
    c_ab = np.ascontiguousarray(c_ab, dtype=np.int32)
    c1_rows = np.ascontiguousarray(c1_rows, dtype=np.float64)
    c1_cols = np.ascontiguousarray(c1_cols, dtype=np.float64)
    nr, nc = c_ab.shape
    rounded = np.empty((nr, nc), dtype=np.float64)
    iz = np.empty((nr, nc), dtype=np.uint8)
    risky = np.empty((nr, nc), dtype=np.uint8)
    if n_threads is None:
        n_threads = os.cpu_count() or 1
    lib.ef_finish_block_measure(
        _ptr(c_ab, ctypes.c_int32),
        _ptr(c1_rows, ctypes.c_double),
        _ptr(c1_cols, ctypes.c_double),
        float(n), nr, nc, int(sel),
        _ptr(rounded, ctypes.c_double),
        _ptr(iz, ctypes.c_uint8), _ptr(risky, ctypes.c_uint8),
        int(n_threads),
    )
    return rounded, iz.view(bool), risky.view(bool)


def finish_block_measures2(c_ab, c1_rows, c1_cols, n: float,
                           n_threads=None):
    """(r2_rounded, r2_iz, r2_risky, dp_rounded, dp_iz, dp_risky) —
    BOTH measures of an int32 count block, 4-dp fast-rounded, in one
    native pass (the columnar-heatmap path needs both; two
    single-measure passes repeat the shared per-cell finish)."""
    lib = _load()
    c_ab = np.ascontiguousarray(c_ab, dtype=np.int32)
    c1_rows = np.ascontiguousarray(c1_rows, dtype=np.float64)
    c1_cols = np.ascontiguousarray(c1_cols, dtype=np.float64)
    nr, nc = c_ab.shape
    r2r = np.empty((nr, nc), dtype=np.float64)
    r2_iz = np.empty((nr, nc), dtype=np.uint8)
    r2_risky = np.empty((nr, nc), dtype=np.uint8)
    dpr = np.empty((nr, nc), dtype=np.float64)
    dp_iz = np.empty((nr, nc), dtype=np.uint8)
    dp_risky = np.empty((nr, nc), dtype=np.uint8)
    if n_threads is None:
        n_threads = os.cpu_count() or 1
    lib.ef_finish_block_measures2(
        _ptr(c_ab, ctypes.c_int32),
        _ptr(c1_rows, ctypes.c_double),
        _ptr(c1_cols, ctypes.c_double),
        float(n), nr, nc,
        _ptr(r2r, ctypes.c_double),
        _ptr(r2_iz, ctypes.c_uint8), _ptr(r2_risky, ctypes.c_uint8),
        _ptr(dpr, ctypes.c_double),
        _ptr(dp_iz, ctypes.c_uint8), _ptr(dp_risky, ctypes.c_uint8),
        int(n_threads),
    )
    return (r2r, r2_iz.view(bool), r2_risky.view(bool),
            dpr, dp_iz.view(bool), dp_risky.view(bool))


def round4_fast(x):
    """(rounded, risky) one-pass rint(x * 1e4) / 1e4 with tie flags."""
    lib = _load()
    x = np.ascontiguousarray(x, dtype=np.float64)
    flat = x.ravel()
    out = np.empty(flat.shape[0], dtype=np.float64)
    risky = np.empty(flat.shape[0], dtype=np.uint8)
    lib.ef_round4(
        _ptr(flat, ctypes.c_double), flat.shape[0],
        _ptr(out, ctypes.c_double), _ptr(risky, ctypes.c_uint8),
    )
    return out.reshape(x.shape), risky.view(bool).reshape(x.shape)


def finish_pairs(c_ab, c1_a, c1_b, n: float):
    """(r2, dp, r2_iz, dp_iz) for elementwise pair counts (1-D)."""
    lib = _load()
    c_ab = np.ascontiguousarray(c_ab, dtype=np.float64)
    c1_a = np.ascontiguousarray(c1_a, dtype=np.float64)
    c1_b = np.ascontiguousarray(c1_b, dtype=np.float64)
    k = c_ab.shape[0]
    r2 = np.empty(k, dtype=np.float64)
    dp = np.empty(k, dtype=np.float64)
    r2_iz = np.empty(k, dtype=np.uint8)
    dp_iz = np.empty(k, dtype=np.uint8)
    lib.ef_finish_pairs(
        _ptr(c_ab, ctypes.c_double),
        _ptr(c1_a, ctypes.c_double),
        _ptr(c1_b, ctypes.c_double),
        float(n), k,
        _ptr(r2, ctypes.c_double), _ptr(dp, ctypes.c_double),
        _ptr(r2_iz, ctypes.c_uint8), _ptr(dp_iz, ctypes.c_uint8),
    )
    return r2, dp, r2_iz.view(bool), dp_iz.view(bool)
