"""scan.cohort_repack_s: seconds a scan of one ploidy profile spends
repacking a population subset's bit columns on the host
(``pack.pack_columns`` over every row; tools/scan.py, span
``scan.cohort_repack`` inside ``scan.open``,
``ScanReport.stats["cohort_repack_s"]``, 0 where the cohort is read
zero-copy), the mean over the window's jobs."""

from ldbench.readers import mean_stat


def read(run):
    return mean_stat(run, "cohort_repack_s")
