"""LD math on whole blocks of variant pairs: the counterpart of
ld_tools_tpu/ops/ld_math.py.

``G`` is a (variants, haplotypes) {0, 1} matrix.  The alt+alt
co-occurrence counts of every pair are one integer product ``G_i . G_j^T``
(the reference counts ``(1, 1)`` tuples pair by pair, calc_ld.py:30-33),
allele counts are row sums, and D, D', r^2 are branchless elementwise
epilogues over exact counts, in f32.  Every file output finishes from the
integer counts in f64 instead (``ops/exact.py``).

The JAX module has no Pallas kernel: its products are plain XLA
``dot_general``s.  Here the int8 product is ``torch._int_mm`` on the card
(exact int32 counts; it wants the depth and the column count in
multiples of 8 and more than 16 rows, so the operands are zero-padded,
which leaves every count unchanged) and an int32 ``matmul`` on the CPU.
No float product: TF32, if enabled, would round the operands.
"""

from __future__ import annotations

import torch


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _pad2(a: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    if a.shape == (rows, cols):
        return a.contiguous()
    out = torch.zeros((rows, cols), dtype=a.dtype, device=a.device)
    out[:a.shape[0], :a.shape[1]] = a
    return out


def haplotype_counts_int8(g1: torch.Tensor, g2: torch.Tensor) -> torch.Tensor:
    """(V1, V2) exact int32 alt+alt co-occurrence counts of the {0, 1}
    rows of ``g1`` (V1, H) and ``g2`` (V2, H), any dtype
    (ld_math.haplotype_counts_int8)."""
    a = g1.to(torch.int8)
    b = g2.to(torch.int8)
    if a.device.type != "cuda":
        return torch.matmul(a.to(torch.int32), b.to(torch.int32).t())
    m, k = a.shape
    n = b.shape[0]
    kp = _round_up(max(k, 8), 8)
    out = torch._int_mm(_pad2(a, max(_round_up(m, 8), 24), kp),
                        _pad2(b, _round_up(max(n, 8), 8), kp).t())
    return out[:m, :n]


def haplotype_counts(g1: torch.Tensor, g2: torch.Tensor) -> torch.Tensor:
    """The same counts as f32 (ld_math.haplotype_counts, whose bf16
    product is exact for {0, 1}); exact below 2^24 haplotypes."""
    return haplotype_counts_int8(g1, g2).to(torch.float32)


def allele_counts(g: torch.Tensor) -> torch.Tensor:
    """Per-variant alt counts (row sums), exact in f32
    (ld_math.allele_counts)."""
    return g.to(torch.float32).sum(dim=-1)


def ld_from_counts(c_ab, c1, c2, n_haplotypes) -> dict:
    """f32 LD epilogue from exact counts (ld_math.ld_from_counts), op for
    op: ``c_ab`` (V1, V2) co-occurrence counts, ``c1`` (V1,) and ``c2``
    (V2,) alt counts, ``n_haplotypes`` the real haplotype count.  Returns
    {"r_square", "d_prime": (V1, V2) f32, "p1", "p2": alt frequencies}.

      d      = p_ab - p1*p2                              (calc_ld.py:50)
      d >= 0: den = min(p1*q2, q1*p2)                    (calc_ld.py:63-65)
      d <  0: den = max(-p1*p2, -q1*q2)                  (calc_ld.py:70-72)
      den == 0 (monomorphic) -> d' = 0                   (calc_ld.py:66-76)
      d' == 0 -> r^2 = 0, else d^2/(p1*q1*p2*q2)         (calc_ld.py:86-90)
    """
    n = torch.tensor(float(n_haplotypes), dtype=torch.float32,
                     device=c_ab.device)
    return _epilogue(c_ab, c1, c2, n, lambda x: x / n)


def ld_from_counts_static_n(c_ab, c1, c2, n_haplotypes) -> dict:
    """:func:`ld_from_counts` as XLA compiles it when ``n_haplotypes`` is
    a constant of the traced program (the sweeps of parallel/sweep.py):
    each division by n becomes a product with the f32 reciprocal 1/n."""
    n = torch.tensor(float(n_haplotypes), dtype=torch.float32,
                     device=c_ab.device)
    inv = 1.0 / n
    return _epilogue(c_ab, c1, c2, n, lambda x: x * inv)


def _epilogue(c_ab, c1, c2, n, per_n) -> dict:
    dev = c_ab.device
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    one = torch.ones((), dtype=torch.float32, device=dev)
    p_ab = per_n(c_ab.to(torch.float32))
    c1 = c1.to(torch.float32)
    c2 = c2.to(torch.float32)
    p1 = per_n(c1)[:, None]
    q1 = per_n(n - c1)[:, None]
    p2 = per_n(c2)[None, :]
    q2 = per_n(n - c2)[None, :]
    d = p_ab - p1 * p2
    den_pos = torch.minimum(p1 * q2, q1 * p2)
    den_neg = torch.maximum(-(p1 * p2), -(q1 * q2))
    den = torch.where(d >= 0, den_pos, den_neg)
    den_is_zero = den == 0
    d_prime = torch.where(den_is_zero, zero,
                          d / torch.where(den_is_zero, one, den))
    r2_den = p1 * q1 * p2 * q2
    dp_zero = d_prime == 0
    r_square = torch.where(dp_zero, zero,
                           (d * d) / torch.where(dp_zero, one, r2_den))
    return {"r_square": r_square, "d_prime": d_prime, "p1": per_n(c1),
            "p2": per_n(c2)}


def ld_block(g1: torch.Tensor, g2: torch.Tensor, n_haplotypes=None) -> dict:
    """Counts and the f32 epilogue for a block pair (ld_math.ld_block);
    ``n_haplotypes`` defaults to the trailing dim (zero padding of the
    haplotype axis leaves every count unchanged)."""
    if n_haplotypes is None:
        n_haplotypes = g1.shape[-1]
    return ld_from_counts(haplotype_counts(g1, g2), allele_counts(g1),
                          allele_counts(g2), n_haplotypes)


def round4_f32(x: torch.Tensor) -> torch.Tensor:
    """4-decimal rounding in f32, halves to even (ld_math.round4_f32); the
    exact path (``ops/exact.py``) reproduces Python's round() instead."""
    return torch.round(x * 1e4) / 1e4
