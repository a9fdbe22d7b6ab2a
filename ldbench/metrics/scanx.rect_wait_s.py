"""scanx.rect_wait_s: the part of ``scanx.rect_finish_s`` spent waiting for
the count engine's counts of each cross-segment rectangle (ops/engine.py,
span ``engine.wait``, ``stats["rect_wait_s"]``), the mean over the
window's jobs."""

from ldbench.readers import mean_stat


def read(run):
    return mean_stat(run, "rect_wait_s")
