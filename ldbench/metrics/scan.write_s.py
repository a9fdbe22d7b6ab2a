"""scan.write_s: seconds a scan spends assembling and writing its TSV
(tools/scan.py, ``ScanReport.stats["write_s"]``), the mean over the
window's jobs."""

from ldbench.readers import mean_stat


def read(run):
    return mean_stat(run, "write_s")
