"""scan.upload_host_s: the host part of ``scan.upload_s``: the alt-allele
popcounts over the store's rows (where its pages are read) and the padded
host arrays (ops/ld_stream.prepare_resident, span ``scan.upload_host``,
``ScanHits.stats["upload_host_s"]``), the mean over the window's jobs."""

from ldbench.readers import mean_stat


def read(run):
    return mean_stat(run, "upload_host_s")
