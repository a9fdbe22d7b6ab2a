"""scanx.rect_dispatch_s: seconds the mixed-ploidy scan
(tools/scan._scan_mixed_chromosome) spends issuing its cross-segment
rectangles: the host unpack and column repack, the upload and the issue of
the engine's counts (``stats["rect_dispatch_s"]``), the mean over the
window's jobs."""

from ldbench.readers import mean_stat


def read(run):
    return mean_stat(run, "rect_dispatch_s")
