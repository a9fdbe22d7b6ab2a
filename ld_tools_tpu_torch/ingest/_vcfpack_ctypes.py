"""ctypes bindings for native/vcfpack.cpp, built on demand with g++.

pybind11 is not available in this environment, so the native scanner
exposes a flat C API and this module marshals it into numpy arrays.  If
the toolchain or zlib is missing, NativeUnavailable tells the caller to
fall back to the pure-Python parser (ingest/vcf.py).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

from ld_tools_tpu_torch.utils.paths import BUILD_DIR, REPO_ROOT

_SRC = os.environ.get(
    "TPU_LD_NATIVE_SRC", os.path.join(REPO_ROOT, "native", "vcfpack.cpp")
)
# the port's own build directory, never next to the source
_LIB = os.path.join(BUILD_DIR, "libvcfpack.so")

_lock = threading.Lock()
_lib_handle = None


class NativeUnavailable(RuntimeError):
    pass


class NativeScanError(RuntimeError):
    pass


def _build() -> None:
    # compile to a per-process temp path and rename into place: several
    # pool workers may race to build, and dlopen of a half-written .so
    # fails confusingly (rename is atomic; losers just overwrite with an
    # identical library)
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{_LIB}.tmp.{os.getpid()}"
    cmd = [
        "g++", "-O3", "-std=c++17", "-shared", "-fPIC",
        _SRC, "-o", tmp, "-lz", "-lpthread",
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
        raise NativeUnavailable(f"vcfpack build failed: {detail}") from exc


def _load():
    global _lib_handle
    with _lock:
        if _lib_handle is not None:
            return _lib_handle
        if not os.path.exists(_SRC):
            raise NativeUnavailable("native/vcfpack.cpp missing")
        if (not os.path.exists(_LIB)
                or os.path.getmtime(_LIB) < os.path.getmtime(_SRC)):
            _build()
        try:
            lib = ctypes.CDLL(_LIB)
        except OSError as exc:
            raise NativeUnavailable(str(exc)) from exc
        lib.vp_scan.restype = ctypes.c_void_p
        lib.vp_scan.argtypes = [ctypes.c_char_p]
        lib.vp_scan_mt.restype = ctypes.c_void_p
        lib.vp_scan_mt.argtypes = [ctypes.c_char_p, ctypes.c_int32]
        for name in ("vp_n_variants", "vp_n_haplotypes", "vp_row_bytes",
                     "vp_n_profiles"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int64
            fn.argtypes = [ctypes.c_void_p]
        # packed rows live in fixed-size native blocks (no contiguous
        # native copy ever exists); vp_packed_copy drains them straight
        # into the numpy buffer — peak RSS ~= one packed copy, not three
        lib.vp_packed_copy.restype = None
        lib.vp_packed_copy.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8)
        ]
        lib.vp_positions.restype = ctypes.POINTER(ctypes.c_int64)
        lib.vp_positions.argtypes = [ctypes.c_void_p]
        lib.vp_profiles.restype = ctypes.POINTER(ctypes.c_uint8)
        lib.vp_profiles.argtypes = [ctypes.c_void_p]
        lib.vp_pgroups.restype = ctypes.POINTER(ctypes.c_int16)
        lib.vp_pgroups.argtypes = [ctypes.c_void_p]
        for name in ("vp_rsids", "vp_refs", "vp_alts", "vp_vts",
                     "vp_samples", "vp_error"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_char_p
            fn.argtypes = [ctypes.c_void_p]
        lib.vp_free.restype = None
        lib.vp_free.argtypes = [ctypes.c_void_p]
        _lib_handle = lib
        return lib


def _split(raw: bytes) -> list:
    text = raw.decode("utf-8")
    return text.split("\n")[:-1] if text else []


def scan_packed(path: str, n_threads: int | None = None):
    """Native scan -> (packed uint8 (V, ceil(H/8)), n_haplotypes, pos,
    rsid, ref, alt, vt, samples, pgroup, profiles) — no unpacked matrix
    is materialized.

    ``pgroup`` ((V,) int16 ploidy-profile ids) and ``profiles``
    ((P, n_samples) uint8 per-sample allele counts) are None for
    all-diploid files (the dominant case); chrX/chrY scans return the
    real arrays (profile 0 is always all-diploid).

    ``n_threads`` > 1 engages the BGZF block-parallel scanner (bgzip
    members inflate+parse concurrently; non-BGZF inputs fall back to the
    single-threaded path inside the library).  Defaults to the CPU count.
    """
    if n_threads is None:
        n_threads = os.cpu_count() or 1
    lib = _load()
    handle = lib.vp_scan_mt(os.fspath(path).encode(), int(n_threads))
    if not handle:
        raise NativeScanError("vp_scan returned null")
    try:
        err = lib.vp_error(handle)
        if err:
            raise NativeScanError(err.decode())
        v = lib.vp_n_variants(handle)
        h = lib.vp_n_haplotypes(handle)
        row_bytes = lib.vp_row_bytes(handle)
        if v > 0:
            packed = np.empty((v, row_bytes), dtype=np.uint8)
            lib.vp_packed_copy(
                handle,
                packed.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            )
            pos = np.ctypeslib.as_array(
                lib.vp_positions(handle), shape=(v,)
            ).copy()
        else:
            packed = np.zeros((0, (h + 7) // 8), dtype=np.uint8)
            pos = np.zeros((0,), dtype=np.int64)
        rsid = _split(lib.vp_rsids(handle))
        ref = _split(lib.vp_refs(handle))
        alt = _split(lib.vp_alts(handle))
        vt = _split(lib.vp_vts(handle))
        samples = _split(lib.vp_samples(handle))
        n_profiles = int(lib.vp_n_profiles(handle))
        pgroup = profiles = None
        if n_profiles > 1:
            profiles = np.ctypeslib.as_array(
                lib.vp_profiles(handle), shape=(n_profiles, len(samples))
            ).copy()
            if v > 0:
                pgroup = np.ctypeslib.as_array(
                    lib.vp_pgroups(handle), shape=(v,)
                ).copy()
            else:
                pgroup = np.zeros((0,), dtype=np.int16)
        return (packed, int(h), pos, rsid, ref, alt, vt, samples,
                pgroup, profiles)
    finally:
        lib.vp_free(handle)


def scan(path: str, n_threads: int | None = None):
    """Native scan -> (genotypes int8 (V, H), pos, rsid, ref, alt, vt,
    samples), matching ingest/vcf.py's record semantics."""
    packed, h, pos, rsid, ref, alt, vt, samples, _, _ = scan_packed(
        path, n_threads=n_threads)
    genotypes = np.unpackbits(packed, axis=1, count=h).astype(np.int8)
    return genotypes, pos, rsid, ref, alt, vt, samples
