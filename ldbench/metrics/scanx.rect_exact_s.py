"""scanx.rect_exact_s: the part of ``scanx.rect_finish_s`` spent in the
exact f64 finish of each cross-segment rectangle's counts
(ops/exact.exact_ld_from_counts, span ``scanx.rect_exact``,
``stats["rect_exact_s"]``), the mean over the window's jobs."""

from ldbench.readers import mean_stat


def read(run):
    return mean_stat(run, "rect_exact_s")
