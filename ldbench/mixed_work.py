"""The yardstick's arithmetic for a mixed-ploidy chromosome (chrX, chrY):
the work a scan over its ploidy segments needs, beside ``ldbench/work.py``,
which counts a chromosome of one profile.

A segment is a maximal run of rows of one ploidy profile.  The scan
evaluates every pair inside a segment (within ``-w`` where given), each
pair's count a product over the cohort's alleles of that profile, and
every pair across two segments (i in the later one, j in the earlier one,
within ``-w``), each count a product over the shorter of the two lists:
the zip that the reference tool walks (calc_ld.py:30-33).  Two operations
an allele, at the card's int8 peak (``work.peaks``).  It names no kernel,
so a change that replaces one reads against the same work; for one
segment it is ``work.scan_ops``.
"""

from __future__ import annotations

import numpy as np

from ldbench import work


def segments(pgroup, n_variants: int) -> list:
    """[(start, stop, profile)] of the maximal runs of one profile (one
    run of profile 0 where ``pgroup`` is None)."""
    if pgroup is None:
        return [(0, int(n_variants), 0)]
    pgroup = np.asarray(pgroup)
    cuts = (np.flatnonzero(np.diff(pgroup)) + 1).tolist()
    starts, stops = [0, *cuts], [*cuts, int(pgroup.size)]
    return [(a, b, int(pgroup[a])) for a, b in zip(starts, stops)]


def profile_alleles(profiles, cohort, n_profiles: int) -> list:
    """Each profile's list length for ``cohort``: the alleles its samples
    carry under that profile (two a diploid sample, one a haploid one)."""
    cohort = np.asarray(cohort, dtype=np.int64)
    if profiles is None:
        return [2 * int(cohort.size)] * n_profiles
    return [int(np.asarray(profiles[p], dtype=np.int64)[cohort].sum())
            for p in range(n_profiles)]


def cross_pairs(pos, earlier, later, max_dist=None) -> int:
    """Pairs (i in rows ``later``, j in rows ``earlier``), both (start,
    stop) with every earlier row before every later one, that a scan must
    evaluate: all of them, or those with pos[i] - pos[j] <= max_dist."""
    (a0, a1), (b0, b1) = earlier, later
    if max_dist is None:
        return (b1 - b0) * (a1 - a0)
    pos = np.asarray(pos, dtype=np.int64)
    first = np.searchsorted(pos[a0:a1], pos[b0:b1] - max_dist, side="left")
    return int(((a1 - a0) - first).sum())


def mixed_scan_ops(pos, pgroup, profiles, cohort, max_dist=None) -> float:
    """Integer operations of a scan's counts over its ploidy segments: 2
    an allele for each pair inside a segment (its profile's list) and for
    each pair across two segments (the shorter list)."""
    pos = np.asarray(pos, dtype=np.int64)
    segs = segments(pgroup, pos.size)
    n = profile_alleles(profiles, cohort, 1 + max(p for _, _, p in segs))
    ops = 0.0
    for k, (b0, b1, pb) in enumerate(segs):
        ops += 2.0 * n[pb] * work.scan_pairs(pos[b0:b1], max_dist)
        for a0, a1, pa in segs[:k]:
            ops += 2.0 * min(n[pa], n[pb]) * cross_pairs(
                pos, (a0, a1), (b0, b1), max_dist)
    return ops


def mixed_least_s(run):
    """The least time of one scan of the window over a mixed-ploidy
    chromosome: :func:`mixed_scan_ops` at the card's int8 peak; None for a
    chromosome of one profile (``readers.scan_least_s`` reads those), a
    job that is no scan, or a card without a published peak."""
    ds, job = run.ds, run.job
    prm = getattr(job, "prm", None)
    if ds.pgroup is None or not hasattr(prm, "max_dist"):
        return None
    pk = work.peaks(run.kind)
    if pk is None:
        return None
    ops = mixed_scan_ops(ds.pos, ds.pgroup, ds.profiles, job.cohort,
                         prm.max_dist)
    return ops / pk["int8_ops_per_s"]
