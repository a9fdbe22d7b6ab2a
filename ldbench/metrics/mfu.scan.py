"""mfu.scan: the whole scan's share of the card's int8 peak: the least time
of the scans' work (as scan.kernel_roofline counts it) over the jobs' wall
on the host clock, in %.  It bounds every kernel's share: a change that
takes a kernel off the path still reads against it."""

from ldbench.readers import scan_least_s


def read(run):
    least = scan_least_s(run)
    if least is None:
        return None
    return 100.0 * least * len(run.records) / sum(r.wall_s for r in run.records)
