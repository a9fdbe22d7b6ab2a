"""scanx.merge_s: seconds a mixed-ploidy scan spends merging its
segments' hits and its rectangles' into one set sorted by (i, j)
(ops/segment_scan.py, span ``scanx.merge``, ``stats["merge_s"]``), the
mean over the window's jobs; None for a chromosome of one profile."""

from ldbench.readers import mean_stat


def read(run):
    return mean_stat(run, "merge_s")
