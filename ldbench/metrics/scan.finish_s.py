"""scan.finish_s: seconds of the exact f64 finish of a scan's hits
(ops/exact.py through ``ld_stream._exact_refilter_counts``,
``ScanHits.stats["finish_s"]``), the mean over the window's jobs."""

from ldbench.readers import mean_stat


def read(run):
    return mean_stat(run, "finish_s")
