"""Bindings to the native C++ VCF scanner (native/vcfpack.cpp).

The reference gets its parsing performance from pysam/htslib (C); here the
equivalent native component is a small zlib-based scanner that applies the
same filters as ingest/vcf.py and emits packed arrays.  The shared library
is built on demand with g++; if the toolchain or zlib is unavailable the
caller falls back to the pure-Python parser.
"""

from __future__ import annotations


def scan_vcf(path: str, n_threads: int | None = None):
    """Scan a VCF with the native parser.

    Returns (genotypes int8 (V, H), pos, rsid, ref, alt, vt, samples) or
    None if the native library is unavailable.  ``n_threads`` (default:
    CPU count) > 1 runs the BGZF block-parallel scanner; non-BGZF inputs
    degrade to the single-threaded path automatically.
    """
    try:
        from ld_tools_tpu_torch.ingest import _vcfpack_ctypes
    except Exception:
        return None
    try:
        return _vcfpack_ctypes.scan(path, n_threads=n_threads)
    except _vcfpack_ctypes.NativeUnavailable:
        return None


def scan_vcf_packed(path: str, n_threads: int | None = None):
    """Scan a VCF natively into the bitpacked form (chromosome-scale
    safe: no unpacked matrix).  Returns (packed, n_haplotypes, pos, rsid,
    ref, alt, vt, samples, pgroup, profiles) — the last two are the
    mixed-ploidy sidecars (None for all-diploid files) — or None when
    the native library is missing.  ``n_threads`` as in :func:`scan_vcf`.
    """
    try:
        from ld_tools_tpu_torch.ingest import _vcfpack_ctypes
    except Exception:
        return None
    try:
        return _vcfpack_ctypes.scan_packed(path, n_threads=n_threads)
    except _vcfpack_ctypes.NativeUnavailable:
        return None
