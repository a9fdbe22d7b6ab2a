"""scan.kernel_roofline: the least time of the scans' work (2 operations a
haplotype for every pair the scan must evaluate, within ``-w`` where given,
at the card's int8 peak) over the device time of every CUDA kernel the
trace holds inside the jobs, in %.  It names no kernel: a change that
replaces one reads against the same work."""

from ldbench.readers import scan_least_s


def read(run):
    least = scan_least_s(run)
    if least is None or run.trace is None:
        return None
    kernel_s = sum(run.trace.kernel_s(a, b) for a, b in run.jobs)
    if kernel_s <= 0:
        return None
    return 100.0 * least * len(run.records) / kernel_s
