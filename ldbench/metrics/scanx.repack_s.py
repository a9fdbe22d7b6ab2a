"""scanx.repack_s: seconds the mixed-ploidy scan spends repacking columns
(every ``pack.pack_columns`` call: each segment's rows, each earlier
segment's at its rectangles, the rectangles' row blocks; span
``scanx.repack``, ``stats["repack_s"]``), the mean over the window's
jobs."""

from ldbench.readers import mean_stat


def read(run):
    return mean_stat(run, "repack_s")
