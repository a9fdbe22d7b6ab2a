"""scan.unspanned_s: seconds of a scan job that no program span names: the
job's wall less ``ScanReport.stats["spanned_s"]`` (the summed time of the
direct children of the tool's ``scan.chromosome`` span), the mean over the
window's jobs; the job's prelude (argument parsing, the prep check) is in
it.  None where the program keeps no ``spanned_s``."""


def read(run):
    vals = [r.wall_s - r.stats["spanned_s"] for r in run.records
            if "spanned_s" in r.stats]
    return sum(vals) / len(vals) if vals else None
