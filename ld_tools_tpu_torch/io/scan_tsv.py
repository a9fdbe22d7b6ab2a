"""The ld_scan pair-list TSV, written from the hits' integer columns.

:func:`write_scan_tsv` writes the two header lines as text, then renders
the hit lines straight to bytes with a native writer of the port's own
(``csrc/scan_tsv.cpp``, built with g++ into ``_build/`` and bound with
ctypes), a few MB at a time into one reused buffer: no Python object per
line or per value.  Each LD value reaches it as its 4-place integer
``m = rint(round4(v) * 1e4)`` and a flag (int 0, negative zero), from
which it prints ``str(round(v, 4))``.

The plain writer (:func:`_write_plain`: ``format_rounded`` and one
f-string a line) writes the same bytes.  It writes the whole file where
the input holds what the native writer cannot render, and says why in
``stats["tsv_plain_reason"]``: ``"value"`` (a value that is not finite,
or |m| >= 10^15, past which a double's shortest repr need not be the
4-place decimal), ``"rsid"`` (an rsID past ASCII: the file's text is then
the locale's encoding) or ``"toolchain"`` (no working g++).
``stats["tsv_native"]`` is 1 where the native writer wrote the file.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

from ld_tools_tpu_torch.ops.exact import format_rounded, round4
from ld_tools_tpu_torch.utils.paths import BUILD_DIR, PKG_ROOT
from ld_tools_tpu_torch.utils.profiling import span

_SRC = os.path.join(PKG_ROOT, "csrc", "scan_tsv.cpp")
_LIB = os.path.join(BUILD_DIR, "libscan_tsv.so")
_CXX = "g++"
_BUF_BYTES = 4 << 20  # the render buffer, reused for every chunk
_M_LIMIT = 10.0 ** 15  # |m| below it: at most 15 significant digits
_FLAG_INT_ZERO, _FLAG_NEG_ZERO = 1, 2

_lib = None  # the bound library, or the NativeUnavailable of its build


class NativeUnavailable(RuntimeError):
    pass


def _build() -> None:
    # compile to a per-process temp path and rename into place: several
    # processes may race to build, and a half-written library fails to
    # load (rename is atomic; the loser overwrites with the same bytes)
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{_LIB}.tmp.{os.getpid()}"
    cmd = [_CXX, "-O2", "-std=c++17", "-shared", "-fPIC", _SRC, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True,
                       timeout=300)
        os.replace(tmp, _LIB)
    except (subprocess.CalledProcessError, subprocess.TimeoutExpired,
            OSError) as exc:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        detail = getattr(exc, "stderr", "") or str(exc)
        raise NativeUnavailable(f"scan_tsv build failed: {detail}") from exc


def _load():
    """The bound library, built first where it is missing or older than
    its source; raises NativeUnavailable (once a process tried, again
    without a second build)."""
    global _lib
    if _lib is None:
        try:
            if (not os.path.exists(_LIB)
                    or os.path.getmtime(_LIB) < os.path.getmtime(_SRC)):
                _build()
            lib = ctypes.CDLL(_LIB)
        except (NativeUnavailable, OSError) as exc:
            _lib = exc if isinstance(exc, NativeUnavailable) else (
                NativeUnavailable(str(exc)))
        else:
            i64, i64_p = ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)
            u8_p = ctypes.POINTER(ctypes.c_uint8)
            lib.st_line_max.restype = i64
            lib.st_line_max.argtypes = [i64]
            lib.st_render.restype = i64
            lib.st_render.argtypes = [
                i64_p, ctypes.POINTER(ctypes.c_uint32), i64, i64_p, i64_p,
                i64_p, u8_p, i64_p, u8_p, i64, i64, ctypes.c_char_p, i64,
                i64_p,
            ]
            _lib = lib
    if isinstance(_lib, NativeUnavailable):
        raise _lib
    return _lib


def _value_column(values, int_zero):
    """(m, flags) of one measure: the 4-place integers and the int-0 /
    negative-zero flags, or None where a value the native writer prints
    (not an int 0) is not finite or has |m| >= 10^15."""
    v = round4(np.asarray(values, dtype=np.float64).ravel())
    y = np.rint(v * 1e4)
    flags = np.zeros(v.shape, dtype=np.uint8)
    if int_zero is not None:
        iz = np.asarray(int_zero, dtype=bool).ravel()
        flags[iz] = _FLAG_INT_ZERO
        y[iz] = 0.0
    if not np.all(np.abs(y) < _M_LIMIT):  # NaN fails too
        return None
    m = y.astype(np.int64)
    flags[(m == 0) & np.signbit(v) & (flags == 0)] = _FLAG_NEG_ZERO
    return m, flags


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _write_header(path, header_lines) -> None:
    with open(path, "w") as fh:
        for line in header_lines:
            fh.write(line + "\n")


def _write_native(lib, path, header_lines, pos, rsid, i, j, r2_col,
                  dp_col) -> bool:
    """Write the file, its body rendered by the native writer; False (the
    file then holds part of it) where an rsID is past ASCII."""
    # UCS4 code points in the host's byte order, as the writer reads them
    rsid = np.asarray(rsid, dtype=str)
    rsid = np.ascontiguousarray(rsid, dtype=rsid.dtype.newbyteorder("="))
    width = rsid.dtype.itemsize // 4
    pos = np.ascontiguousarray(pos, dtype=np.int64)
    i = np.ascontiguousarray(i, dtype=np.int64)
    j = np.ascontiguousarray(j, dtype=np.int64)
    (m_r2, f_r2), (m_dp, f_dp) = r2_col, dp_col
    # the native writer reads pos[i[k]], rsid[j[k]], ... unchecked
    if not len(i) == len(j) == len(m_r2) == len(m_dp):
        raise ValueError("the hits' columns differ in length")
    rows = min(len(pos), len(rsid))
    if len(i) and (min(i.min(), j.min()) < 0
                   or max(i.max(), j.max()) >= rows):
        raise IndexError(f"a hit's row is outside the {rows} rows")
    buf = ctypes.create_string_buffer(_BUF_BYTES + lib.st_line_max(width))
    view = memoryview(buf).cast("B")
    n_bytes = ctypes.c_int64(0)
    args = (_ptr(pos, ctypes.c_int64), _ptr(rsid, ctypes.c_uint32), width,
            _ptr(i, ctypes.c_int64), _ptr(j, ctypes.c_int64),
            _ptr(m_r2, ctypes.c_int64), _ptr(f_r2, ctypes.c_uint8),
            _ptr(m_dp, ctypes.c_int64), _ptr(f_dp, ctypes.c_uint8))
    n, k = len(i), 0
    _write_header(path, header_lines)
    with open(path, "ab") as fh:
        while k < n:
            k = lib.st_render(*args, k, n, buf, len(buf),
                              ctypes.byref(n_bytes))
            if k < 0:
                return False
            fh.write(view[:n_bytes.value])
    return True


def _write_plain(path, header_lines, pos, rsid, i, j, r2, r2_int_zero, dp,
                 dp_int_zero, stats) -> None:
    """Write the file one Python line at a time."""
    with span("scan.format", stats, "format_s"):
        r2_s = format_rounded(r2, r2_int_zero)
        dp_s = format_rounded(dp, dp_int_zero)
    with span("scan.emit", stats, "emit_s"):
        ia = np.asarray(i, dtype=np.int64)
        jb = np.asarray(j, dtype=np.int64)
        pa = pos[ia].astype(np.int64)
        pb = pos[jb].astype(np.int64)
        rs = np.asarray(rsid)
        rows = zip(pa.tolist(), rs[ia].tolist(), pb.tolist(),
                   rs[jb].tolist(), (pa - pb).tolist(), r2_s.tolist(),
                   dp_s.tolist())
        _write_header(path, header_lines)
        with open(path, "a") as fh:
            for pa_k, ra, pb_k, rb, d, r2k, dpk in rows:
                fh.write(f"{pa_k}\t{ra}\t{pb_k}\t{rb}\t{d}\t{r2k}\t{dpk}\n")


def write_scan_tsv(path, header_lines, pos, rsid, i, j, r2, r2_int_zero,
                   dp, dp_int_zero, stats) -> None:
    """Write the scan's TSV: ``header_lines`` (each without its newline),
    then one line per hit k: ``pos[i[k]]``, ``rsid[i[k]]``, ``pos[j[k]]``,
    ``rsid[j[k]]``, their distance, r² and D′ as ``str(round(v, 4))``
    (``0`` where the int-0 flag is set).  Adds ``format_s`` (span
    ``scan.format``: the 4-place integers and flags, or the plain path's
    strings), ``emit_s`` (span ``scan.emit``: the rendering and the
    writes), ``tsv_native`` and, on the plain path, ``tsv_plain_reason``
    to ``stats``."""
    with span("scan.format", stats, "format_s"):
        r2_col = _value_column(r2, r2_int_zero)
        dp_col = _value_column(dp, dp_int_zero)
    reason = None
    if r2_col is None or dp_col is None:
        reason = "value"
    else:
        try:
            lib = _load()
        except NativeUnavailable:
            reason = "toolchain"
        else:
            with span("scan.emit", stats, "emit_s"):
                if not _write_native(lib, path, header_lines, pos, rsid, i,
                                     j, r2_col, dp_col):
                    reason = "rsid"
    if reason is not None:
        _write_plain(path, header_lines, pos, rsid, i, j, r2, r2_int_zero,
                     dp, dp_int_zero, stats)
        stats["tsv_plain_reason"] = reason
    stats["tsv_native"] = int(reason is None)
