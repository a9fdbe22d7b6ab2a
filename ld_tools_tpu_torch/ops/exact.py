"""Bit-exact host-side LD finisher.

The device fast path (ops/ld_kernels.py) computes r^2 / D' in f32.  For output
files the framework must *bit-match* the reference, whose per-pair math runs
in Python f64 with a specific operation order and a trailing
``round(x, 4)`` (reference backend/calc_ld.py:50-97).  Haplotype counts are
exact integers on both sides, so bit-matching reduces to replaying the same
IEEE-f64 operations on the host:

  p_ab = c_ab / n                                    (calc_ld.py:33)
  p1 = c1 / n,  q1 = c0_1 / n  (c0 = n - c1 for {0,1} genotypes)
                                                      (calc_ld.py:41-44)
  d = p_ab - p1 * p2                                  (calc_ld.py:50)
  d >= 0: den = min(p1 * q2, q1 * p2)                 (calc_ld.py:64-65)
  d <  0: den = max((-p1) * p2, (-q1) * q2)           (calc_ld.py:71-72)
  den == 0        -> d' = int 0   (ZeroDivisionError) (calc_ld.py:66-76)
  d' == 0         -> r^2 = int 0                      (calc_ld.py:89-90)
  else r^2 = d**2 / (((p1 * q1) * p2) * q2)           (calc_ld.py:87-88)

The int-0 cases matter for formatting parity: the reference emits ``0``
(int) there, but ``0.0`` when a float zero flows through division, and the
writers stringify values verbatim (e.g. ld_area.py:274, ld_triangle.py:357).

Rounding parity: Python's ``round(x, 4)`` performs correct decimal rounding;
numpy's ``np.round`` uses a scaled-multiply shortcut that can differ near
decimal ties.  ``round4`` below is vectorized but defers the rare tie-adjacent
values to Python's round, so it is bit-identical to applying ``round(x, 4)``
elementwise.
"""

from __future__ import annotations

import dataclasses

import numpy as np

try:  # native one-pass finisher (native/exactfinish.cpp); numpy fallback
    from ld_tools_tpu_torch.ops import _exactfinish_ctypes as _native
except Exception:  # pragma: no cover - import machinery failures only
    _native = None

_native_ok = None


def _native_finish_available() -> bool:
    global _native_ok
    if _native_ok is None:
        _native_ok = bool(_native is not None and _native.available())
    return _native_ok


@dataclasses.dataclass
class ExactLD:
    """Exact f64 LD values for a block of variant pairs, pre-rounding.

    ``r_square``/``d_prime`` hold the f64 values (0.0 where the reference
    would hold int 0); ``d_prime_is_int_zero`` / ``r_square_is_int_zero``
    mark the entries where the reference produces the *int* 0 sentinel.
    ``p1`` / ``p2`` are the alt-allele frequencies of the row / column
    variants.
    """

    r_square: np.ndarray
    d_prime: np.ndarray
    p1: np.ndarray
    p2: np.ndarray
    d_prime_is_int_zero: np.ndarray
    r_square_is_int_zero: np.ndarray
    _r2_rounded_cache: object = dataclasses.field(
        default=None, repr=False, compare=False
    )
    _dp_rounded_cache: object = dataclasses.field(
        default=None, repr=False, compare=False
    )

    def r_square_rounded(self):
        """round(r^2, 4) with the reference's int-0 sentinel preserved."""
        if self._r2_rounded_cache is None:
            self._r2_rounded_cache = _rounded_object_array(
                self.r_square, self.r_square_is_int_zero
            )
        return self._r2_rounded_cache

    def d_prime_rounded(self):
        if self._dp_rounded_cache is None:
            self._dp_rounded_cache = _rounded_object_array(
                self.d_prime, self.d_prime_is_int_zero
            )
        return self._dp_rounded_cache

    def pair(self, i: int, j: int) -> dict:
        """The reference calc_ld return dict for pair (i, j).

        Matches backend/calc_ld.py:94-97 in both values and types.
        """
        return {
            "r_square": _rounded_scalar(
                self.r_square[i, j], self.r_square_is_int_zero[i, j]
            ),
            "d_prime": _rounded_scalar(
                self.d_prime[i, j], self.d_prime_is_int_zero[i, j]
            ),
            "var_1_alt_freq": round(float(self.p1[i]), 4),
            "var_2_alt_freq": round(float(self.p2[j]), 4),
        }


def exact_ld_from_counts(
    c_ab, c1, c2, n_haplotypes: int, len1=None, len2=None
) -> ExactLD:
    """Finish LD in f64 from exact integer counts, reference op order.

    ``c_ab``: (V1, V2) alt+alt co-occurrence counts (any exact dtype);
    ``c1``: (V1,), ``c2``: (V2,) alt counts; ``n_haplotypes``: the pair
    walk length (reference ``htypes_quan``, calc_ld.py:31-33).

    ``len1``/``len2`` are each side's OWN genotype-list length; they
    differ from ``n_haplotypes`` only for mixed-ploidy cross-group pairs
    (chrX PAR x non-PAR), where the reference zips the two lists down to
    the shorter one but counts ref alleles over each full list
    (calc_ld.py:30-44 + ld_area.py:230-235): q_k = (len_k - c_k) / n.
    Default (None) means len_k == n, the uniform-ploidy case.

    Integer count blocks route through the native one-pass finisher
    (native/exactfinish.cpp — bit-identical IEEE order, no full-matrix
    temporaries, threaded); everything else runs the numpy reference
    implementation below.
    """
    n = float(n_haplotypes)
    len1 = n if len1 is None else float(len1)
    len2 = n if len2 is None else float(len2)
    c1 = np.asarray(c1, dtype=np.float64)
    c2 = np.asarray(c2, dtype=np.float64)
    c_raw = np.asarray(c_ab)
    if (
        len1 == n
        and len2 == n
        and c_raw.ndim == 2
        and c_raw.size >= 4096
        and np.issubdtype(c_raw.dtype, np.integer)
        and _native_finish_available()
    ):
        r2, dp, r2_iz, dp_iz = _native.finish_block(c_raw, c1, c2, n)
        return ExactLD(
            r_square=r2,
            d_prime=dp,
            p1=c1 / n,
            p2=c2 / n,
            d_prime_is_int_zero=dp_iz,
            r_square_is_int_zero=r2_iz,
        )
    c_ab = np.asarray(c_ab, dtype=np.float64)

    p_ab = c_ab / n
    p1 = (c1 / n)[:, None]
    q1 = ((len1 - c1) / n)[:, None]
    p2 = (c2 / n)[None, :]
    q2 = ((len2 - c2) / n)[None, :]

    d = p_ab - p1 * p2
    den_pos = np.minimum(p1 * q2, q1 * p2)
    den_neg = np.maximum((-p1) * p2, (-q1) * q2)
    nonneg = d >= 0
    den = np.where(nonneg, den_pos, den_neg)
    den_zero = den == 0
    with np.errstate(divide="ignore", invalid="ignore"):
        d_prime = np.where(den_zero, 0.0, d / np.where(den_zero, 1.0, den))

    dp_zero = d_prime == 0
    r2_den = ((p1 * q1) * p2) * q2
    with np.errstate(divide="ignore", invalid="ignore"):
        r_square = np.where(
            dp_zero, 0.0, (d * d) / np.where(dp_zero, 1.0, r2_den)
        )
    return ExactLD(
        r_square=r_square,
        d_prime=d_prime,
        p1=c1 / n,
        p2=c2 / n,
        d_prime_is_int_zero=den_zero,
        r_square_is_int_zero=dp_zero,
    )


def exact_ld_elementwise(
    c_ab, c1, c2, n_haplotypes: int, len1=None, len2=None
) -> ExactLD:
    """Elementwise (paired) variant of exact_ld_from_counts.

    ``c_ab``, ``c1``, ``c2`` are 1-D arrays of per-PAIR counts (pair k is
    variant-with-count c1[k] vs variant-with-count c2[k]) — used by the
    streamed scan to re-finish threshold hits exactly.  Same f64 op order
    as the outer-product form.  ``len1``/``len2`` as in
    exact_ld_from_counts (mixed-ploidy cross-group pairs only).
    """
    n = float(n_haplotypes)
    len1 = n if len1 is None else float(len1)
    len2 = n if len2 is None else float(len2)
    c_ab = np.asarray(c_ab, dtype=np.float64)
    c1 = np.asarray(c1, dtype=np.float64)
    c2 = np.asarray(c2, dtype=np.float64)
    if (len1 == n and len2 == n and c_ab.size >= 65536
            and _native_finish_available()):
        r2, dp, r2_iz, dp_iz = _native.finish_pairs(c_ab, c1, c2, n)
        return ExactLD(
            r_square=r2,
            d_prime=dp,
            p1=c1 / n,
            p2=c2 / n,
            d_prime_is_int_zero=dp_iz,
            r_square_is_int_zero=r2_iz,
        )

    p_ab = c_ab / n
    p1 = c1 / n
    q1 = (len1 - c1) / n
    p2 = c2 / n
    q2 = (len2 - c2) / n

    d = p_ab - p1 * p2
    den_pos = np.minimum(p1 * q2, q1 * p2)
    den_neg = np.maximum((-p1) * p2, (-q1) * q2)
    den = np.where(d >= 0, den_pos, den_neg)
    den_zero = den == 0
    with np.errstate(divide="ignore", invalid="ignore"):
        d_prime = np.where(den_zero, 0.0, d / np.where(den_zero, 1.0, den))
    dp_zero = d_prime == 0
    r2_den = ((p1 * q1) * p2) * q2
    with np.errstate(divide="ignore", invalid="ignore"):
        r_square = np.where(
            dp_zero, 0.0, (d * d) / np.where(dp_zero, 1.0, r2_den)
        )
    return ExactLD(
        r_square=r_square,
        d_prime=d_prime,
        p1=p1,
        p2=p2,
        d_prime_is_int_zero=den_zero,
        r_square_is_int_zero=dp_zero,
    )


def measure_rounded_block(c_ab, c1, c2, n_haplotypes, measure: str):
    """4-dp-rounded block of ONE measure + the int-0 sentinel mask.

    The streamed triangle table only prints ``str(round(v, 4))`` of the
    chosen measure (or '0'); computing both measures plus a separate
    round pass through full-matrix temporaries doubles the host cost of
    a 10k-variant table.  The native one-pass variant
    (ef_finish_block_measure) emits the fast-rounded measure directly;
    near-decimal-tie cells are recomputed exactly and re-rounded with
    Python's round (same contract as round4).  Falls back to the full
    finish + round4 — bit-identical either way.

    Returns ``(rounded f64 with 0.0 at int-0 cells, int_zero bool)``.
    """
    sel = 0 if measure == "r_square" else 1
    c_raw = np.asarray(c_ab)
    if (
        c_raw.ndim == 2
        and c_raw.size >= 4096
        and np.issubdtype(c_raw.dtype, np.integer)
        and _native_finish_available()
    ):
        rounded, iz, risky = _native.finish_block_measure(
            c_raw, np.asarray(c1, np.float64), np.asarray(c2, np.float64),
            float(n_haplotypes), sel,
        )
        if risky.any():
            ri, rj = np.nonzero(risky)
            ex = exact_ld_elementwise(
                c_raw[ri, rj],
                np.asarray(c1, np.float64)[ri],
                np.asarray(c2, np.float64)[rj],
                n_haplotypes,
            )
            raw = ex.r_square if sel == 0 else ex.d_prime
            rounded[ri, rj] = [round(float(v), 4) for v in raw]
        return rounded, iz
    ex = exact_ld_from_counts(c_ab, c1, c2, n_haplotypes)
    vals = ex.r_square if sel == 0 else ex.d_prime
    iz = ex.r_square_is_int_zero if sel == 0 else ex.d_prime_is_int_zero
    rounded = round4(vals)
    rounded[iz] = 0.0
    return rounded, iz


def measures_rounded_block_both(c_ab, c1, c2, n_haplotypes):
    """(r2_rounded, r2_iz, dp_rounded, dp_iz) — BOTH measures of a count
    block, 4-dp rounded, in one native pass (the columnar-heatmap path;
    two `measure_rounded_block` calls repeat the shared per-cell
    finish).  Same rounding contract (near-tie cells re-rounded with
    Python's round); falls back to the single-measure path — bit-
    identical either way."""
    c_raw = np.asarray(c_ab)
    if (
        c_raw.ndim == 2
        and c_raw.size >= 4096
        and np.issubdtype(c_raw.dtype, np.integer)
        and _native_finish_available()
    ):
        c1f = np.asarray(c1, np.float64)
        c2f = np.asarray(c2, np.float64)
        (r2r, r2iz, r2_risky, dpr, dpiz, dp_risky) = (
            _native.finish_block_measures2(
                c_raw, c1f, c2f, float(n_haplotypes)
            )
        )
        for risky, rounded, sel in ((r2_risky, r2r, 0), (dp_risky, dpr, 1)):
            if risky.any():
                ri, rj = np.nonzero(risky)
                ex = exact_ld_elementwise(
                    c_raw[ri, rj], c1f[ri], c2f[rj], n_haplotypes,
                )
                raw = ex.r_square if sel == 0 else ex.d_prime
                rounded[ri, rj] = [round(float(v), 4) for v in raw]
        return r2r, r2iz, dpr, dpiz
    r2r, r2iz = measure_rounded_block(c_ab, c1, c2, n_haplotypes,
                                      "r_square")
    dpr, dpiz = measure_rounded_block(c_ab, c1, c2, n_haplotypes,
                                      "d_prime")
    return r2r, r2iz, dpr, dpiz


_FMT_TABLE = None


def _fmt_table():
    """str(round(v, 4)) for every 4-dp value in [-1, 1], indexed by
    round(v * 1e4) + 10000.  Built once; turns LD-value formatting into a
    single object-array take, which is what lets a 10k x 10k triangle TSV
    (10^8 cells) format in seconds instead of minutes."""
    global _FMT_TABLE
    if _FMT_TABLE is None:
        tbl = np.empty(20001, dtype=object)
        for mk in range(-10000, 10001):
            sign = "-" if mk < 0 else ""
            whole, frac = divmod(abs(mk), 10000)
            s = f"{whole}.{frac:04d}".rstrip("0")
            tbl[mk + 10000] = sign + (s + "0" if s.endswith(".") else s)
        _FMT_TABLE = tbl
    return _FMT_TABLE


def format_rounded(values, int_zero=None, assume_rounded: bool = False):
    """Vectorized reference-faithful string formatting of LD values.

    Every emitted string equals ``str(round(v, 4))`` (the reference
    stringifies rounded values verbatim, ld_area.py:274 etc.), including
    negative D' ('-0.25') and the IEEE negative-zero round ('-0.0');
    int-0 sentinel entries print as '0'.  Returns a 1-D object ndarray.

    Values are round4'd first: callers pass RAW f64 (scan hits,
    hovertext), and a bare rint(v * 1e4) differs from Python's correct
    decimal rounding near half-ties (e.g. 0.00005 -> '0.0' instead of
    the reference's '0.0001') — round4 re-rounds exactly those cells
    with Python's round.  Callers whose values already went through
    round4/measure_rounded_block pass ``assume_rounded=True`` to skip
    the redundant pass (4-dp values are never near a tie).
    """
    values = np.asarray(values, dtype=np.float64).ravel()
    if not assume_rounded:
        values = round4(values)
    m = np.rint(values * 1e4).astype(np.int64)
    out = _fmt_table()[np.clip(m, -10000, 10000) + 10000]
    oob = (m < -10000) | (m > 10000)
    if oob.any():  # LD values live in [-1, 1]; guard anyway
        for k in np.nonzero(oob)[0]:
            out[k] = str(round(float(values[k]), 4))
    negzero = (m == 0) & np.signbit(values)
    if negzero.any():  # str(round(-0.00001, 4)) == '-0.0'
        out[negzero] = "-0.0"
    if int_zero is not None:
        out[np.asarray(int_zero, dtype=bool).ravel()] = "0"
    return out


def round4(x: np.ndarray) -> np.ndarray:
    """Vectorized bit-exact equivalent of applying Python round(v, 4).

    Fast path: rint(x * 1e4) / 1e4.  That matches Python's correct decimal
    rounding except possibly where x * 1e4 lands within float error of a
    half-integer tie; those entries (vanishingly rare) are recomputed with
    Python's round.
    """
    x = np.asarray(x, dtype=np.float64)
    if x.size >= 65536 and _native_finish_available():
        fast, risky = _native.round4_fast(x)
    else:
        y = x * 1e4
        fast = np.rint(y) / 1e4
        frac = y - np.floor(y)
        risky = np.abs(frac - 0.5) < 1e-6
    if np.any(risky):
        idx = np.nonzero(risky)
        vals = x[idx]
        fixed = np.array([round(float(v), 4) for v in vals], dtype=np.float64)
        fast = fast.copy()
        fast[idx] = fixed
    return fast


def _rounded_scalar(value: float, is_int_zero) -> object:
    if is_int_zero:
        return 0
    return round(float(value), 4)


def _rounded_object_array(values: np.ndarray, int_zero: np.ndarray):
    """Object array of round(v, 4) floats with int 0 where flagged."""
    out = round4(values).astype(object)
    out[int_zero] = 0
    return out


def format_ld_value(value) -> str:
    """str() of a reference-style value (int 0 vs float), verbatim.

    The reference writers pass values straight through str() / f-strings
    (ld_area.py:274, ld_triangle.py:201-213, :357), so "0" (monomorphic)
    and "0.0" (float zero) are distinct on disk.
    """
    return str(value)
