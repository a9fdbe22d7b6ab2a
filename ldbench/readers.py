"""What the per-layer metrics' readers (``ldbench/metrics/<name>.py``)
share: a phase of the tool's own stats, averaged over the window's jobs,
and the device's idle share inside the jobs, from the trace."""

from __future__ import annotations


def mean_stat(run, key: str):
    """The mean over the window's jobs of ``stats[key]``, or None where no
    job reports it."""
    vals = [r.stats[key] for r in run.records if key in r.stats]
    return sum(vals) / len(vals) if vals else None


def idle_share(run):
    """100 x (1 - the device's busy time inside the jobs / the jobs'
    length), from the trace; None where the trace holds no device work."""
    if run.trace is None:
        return None
    spans = [s for s in run.jobs if s is not None]
    busy = sum(run.trace.busy_s(a, b) for a, b in spans)
    length = sum(b - a for a, b in spans) / 1e6
    if busy <= 0 or length <= 0:
        return None
    return 100.0 * (1.0 - busy / length)


def scan_least_s(run):
    """The least time of one scan of the window: its counts' operations
    (``ldbench.work.scan_ops``) at the card's int8 peak; None for a
    mixed-ploidy chromosome or a card without a published peak."""
    from ldbench import work

    pk = work.peaks(run.kind)
    if pk is None or run.ds.pgroup is not None:
        return None
    ops = work.scan_ops(run.ds.pos, run.job.prm.max_dist,
                        2 * len(run.job.cohort))
    return ops / pk["int8_ops_per_s"]
