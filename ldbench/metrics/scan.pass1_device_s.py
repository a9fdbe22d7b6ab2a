"""scan.pass1_device_s: the device time of the scan's pass 1 (the count
kernels), between two CUDA events on the stream they launch on
(ops/ld_stream.py, ``ScanHits.stats["pass1_device_s"]``), the mean over
the window's jobs; None on the CPU, where the program keeps no such
timer."""

from ldbench.readers import mean_stat


def read(run):
    return mean_stat(run, "pass1_device_s")
