"""scan.upload_s: seconds the scan driver (ops/ld_stream.py) spends
preparing and uploading the resident rows and waiting for them
(``ScanHits.stats["upload_s"]``; a mixed-ploidy chromosome sums its
segments), the mean over the window's jobs."""

from ldbench.readers import mean_stat


def read(run):
    return mean_stat(run, "upload_s")
