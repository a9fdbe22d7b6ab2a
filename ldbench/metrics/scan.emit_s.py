"""scan.emit_s: the part of ``scan.write_s`` that gathers the hits' positions
and rsIDs, turns the columns into lists and writes every line of the TSV
(tools/scan.py, span ``scan.emit``, ``ScanReport.stats["emit_s"]``), the
mean over the window's jobs."""

from ldbench.readers import mean_stat


def read(run):
    return mean_stat(run, "emit_s")
