"""scan.format_s: the part of ``scan.write_s`` that turns both measures of
every hit into their 4-place strings (ops/exact.format_rounded, span
``scan.format``, ``ScanReport.stats["format_s"]``), the mean over the
window's jobs."""

from ldbench.readers import mean_stat


def read(run):
    return mean_stat(run, "format_s")
