"""The reference's per-pair LD kernel in pure Python: the baseline of the
headline benchmark (``vs_baseline``).

An independent reimplementation of the math of the reference's
backend/calc_ld.py: given two sequences of phased single-allele genotypes
(0 = ref, 1 = alt), r^2, D' and the two alt-allele frequencies, rounded
to 4 decimals, with the reference's monomorphic conventions (D' = int 0
on a zero denominator, r^2 = int 0 whenever D' == 0).  Mixed-ploidy
lists of different lengths are zipped to the shorter, while each
variant's allele counts run over its own full list and every frequency
divides by the zip length, as the reference does.
"""


def oracle_ld(genotypes_a, genotypes_b):
    n = min(len(genotypes_a), len(genotypes_b))
    if n <= 0:
        raise ValueError("oracle_ld needs two non-empty genotype lists")

    both_alt = 0
    for a, b in zip(genotypes_a, genotypes_b):
        if a == 1 and b == 1:
            both_alt += 1
    p_ab = both_alt / n

    alt_a = sum(1 for g in genotypes_a if g == 1)
    ref_a = sum(1 for g in genotypes_a if g == 0)
    alt_b = sum(1 for g in genotypes_b if g == 1)
    ref_b = sum(1 for g in genotypes_b if g == 0)
    p_a, q_a = alt_a / n, ref_a / n
    p_b, q_b = alt_b / n, ref_b / n

    d = p_ab - p_a * p_b
    if d >= 0:
        den = min(p_a * q_b, q_a * p_b)
    else:
        den = max(-p_a * p_b, -q_a * q_b)
    if den == 0:
        d_prime = 0
    else:
        d_prime = d / den

    if d_prime != 0:
        r_square = (d ** 2) / (p_a * q_a * p_b * q_b)
    else:
        r_square = 0

    return {
        "r_square": round(r_square, 4),
        "d_prime": round(d_prime, 4),
        "var_1_alt_freq": round(p_a, 4),
        "var_2_alt_freq": round(p_b, 4),
    }
