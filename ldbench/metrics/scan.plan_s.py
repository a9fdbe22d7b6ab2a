"""scan.plan_s: seconds the scan driver (ops/ld_stream.py) spends planning
a scan on the host: the blocks that can hold a kept pair, the tiles, and
each block's batch (``ScanHits.stats["plan_s"]``, the span ``scan.plan``;
a mixed-ploidy chromosome sums its segments), the mean over the window's
jobs."""

from ldbench.readers import mean_stat


def read(run):
    return mean_stat(run, "plan_s")
