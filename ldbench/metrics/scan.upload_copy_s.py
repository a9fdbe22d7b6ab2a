"""scan.upload_copy_s: the copy part of ``scan.upload_s``: the host-to-device
copies, any unpack on the device and the wait for them (ops/ld_stream.py,
span ``scan.upload_copy``, ``ScanHits.stats["upload_copy_s"]``), the mean
over the window's jobs."""

from ldbench.readers import mean_stat


def read(run):
    return mean_stat(run, "upload_copy_s")
