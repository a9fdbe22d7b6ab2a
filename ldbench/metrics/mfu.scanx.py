"""mfu.scanx: a mixed-ploidy scan's share of the card's int8 peak: the
least time of the scans' work over their ploidy segments and across them
(``ldbench.mixed_work``: 2 operations an allele of each pair's list, the
shorter list across two segments, at the int8 peak) over the jobs' wall
on the host clock, in %.  The whole step's share, as ``mfu.scan`` is a
one-profile chromosome's; None for a chromosome of one profile."""

from ldbench.mixed_work import mixed_least_s


def read(run):
    least = mixed_least_s(run)
    if least is None:
        return None
    return 100.0 * least * len(run.records) / sum(r.wall_s for r in run.records)
