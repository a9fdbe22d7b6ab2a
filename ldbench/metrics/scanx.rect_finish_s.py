"""scanx.rect_finish_s: seconds the mixed-ploidy scan
(tools/scan._scan_mixed_chromosome) spends finishing its cross-segment
rectangles on the host: the wait for the engine's counts, the exact f64
finish, the 4-place rounding and the threshold and distance filter
(``stats["rect_finish_s"]``), the mean over the window's jobs."""

from ldbench.readers import mean_stat


def read(run):
    return mean_stat(run, "rect_finish_s")
