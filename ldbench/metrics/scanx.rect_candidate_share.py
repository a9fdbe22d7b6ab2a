"""scanx.rect_candidate_share: the share of the mixed-ploidy scan's
cross-segment rectangle cells that the engine's threshold test on the
counts passes to the host's f64 finish (tools/scan._scan_mixed_chromosome,
``stats["rect_candidates"]`` of ``stats["rect_cells"]``): 100 x the mean
over the window's jobs of the candidates / the mean of the cells.  None
where no job reports them, or no rectangle cell was counted."""

from ldbench.readers import mean_stat


def read(run):
    cells = mean_stat(run, "rect_cells")
    cands = mean_stat(run, "rect_candidates")
    if not cells or cands is None:
        return None
    return 100.0 * cands / cells
