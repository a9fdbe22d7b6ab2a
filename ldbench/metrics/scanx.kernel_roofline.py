"""scanx.kernel_roofline: the least time of a mixed-ploidy scan's work
(as ``mfu.scanx`` counts it, ``ldbench.mixed_work``) over the device time
of every CUDA kernel the trace holds inside the jobs, in %, as
``scan.kernel_roofline`` divides for a one-profile chromosome.  It names
no kernel; None for a chromosome of one profile or a trace without
kernels."""

from ldbench.mixed_work import mixed_least_s


def read(run):
    least = mixed_least_s(run)
    if least is None or run.trace is None:
        return None
    kernel_s = sum(run.trace.kernel_s(a, b) for a, b in run.jobs)
    if kernel_s <= 0:
        return None
    return 100.0 * least * len(run.records) / kernel_s
