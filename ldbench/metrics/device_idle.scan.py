"""device_idle.scan: the share of a scan job's wall in which the
device ran nothing (no kernel, copy or fill in the trace), over the
window's jobs, in %."""

from ldbench.readers import idle_share


def read(run):
    return idle_share(run)
