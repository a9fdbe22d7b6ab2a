"""scan.open_s: seconds a scan spends opening its chromosome in the store,
its cohort's ploidy profiles and column layout, and any repack of a
subset's columns (tools/scan.py, span ``scan.open``,
``ScanReport.stats["open_s"]``), the mean over the window's jobs."""

from ldbench.readers import mean_stat


def read(run):
    return mean_stat(run, "open_s")
