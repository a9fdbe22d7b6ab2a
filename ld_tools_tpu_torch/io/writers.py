"""Output writers: byte-compatible with the reference's file formats.

Run settings are persisted into output headers (a real reproducibility
feature of the reference kept intact — SURVEY.md §5 'Config' row):
UCSC-style ``##key=val`` header lines for ld_area files
(reference ld_area.py:3-14, :139-141) and the double-header TSV matrix
layout for ld_triangle (reference ld_triangle.py:344-360).
"""

from __future__ import annotations

import json
import os


def build_ucsc_header(header_key, header_val) -> str:
    """One ``key=val`` element; strings quoted, tuples comma-joined-quoted.

    Matches reference ld_area.py:3-14 including its type-name dispatch.
    """
    if isinstance(header_val, str):
        header_val = f'"{header_val}"'
    elif isinstance(header_val, tuple):
        header_val = ",".join(f'"{v}"' for v in header_val)
    return f"{header_key}={header_val}"


def ucsc_header_line(meta_keys, meta_vals) -> str:
    return "##" + " ".join(map(build_ucsc_header, meta_keys, meta_vals))


AREA_HEADER_ROW = [
    "hg38_pos",
    "rsID",
    "ref",
    "alt",
    "type",
    "alt_freq",
    "r2",
    "D'",
    "dist",
]


class AreaResultWriter:
    """One ld_area result file (per query variant).

    The reference opens the file eagerly, appends as hits stream in, and
    deletes it afterwards if only headers were written
    (ld_area.py:200-292).  Here rows accumulate in memory and the file is
    only created when at least one opponent row exists — same observable
    end state, no delete dance.
    """

    def __init__(self, path: str, file_type: str, meta_keys, meta_vals, query_ann):
        self.path = path
        self.file_type = file_type
        self.meta_keys = list(meta_keys)
        self.meta_vals = list(meta_vals)
        self.query_ann = list(query_ann)
        self.rows = []

    def add_opponent(self, ann_row) -> None:
        self.rows.append(list(ann_row))

    def flush(self) -> bool:
        """Write the file; returns False (and writes nothing) if no hits.

        A pre-existing file at the path is REMOVED in the no-hits case:
        reruns into the same target dir must end like the reference's
        create-then-delete-if-empty (ld_area.py:291-292), never with a
        stale result file from a previous run surviving."""
        if not self.rows:
            try:
                os.remove(self.path)
            except OSError:
                pass
            return False
        if self.file_type not in ("rsids", "tsv", "json"):
            # validate BEFORE open('w') truncates a pre-existing result
            raise ValueError(f"unknown target file type {self.file_type}")
        header_line = ucsc_header_line(self.meta_keys, self.meta_vals)
        with open(self.path, "w") as fh:
            if self.file_type == "rsids":
                fh.write(header_line + "\n")
                fh.write("#rsID\n")
                fh.write(str(self.query_ann[1]) + "\n")
                for row in self.rows:
                    fh.write(str(row[1]) + "\n")
            elif self.file_type == "tsv":
                fh.write(header_line + "\n")
                fh.write("#" + "\t".join(AREA_HEADER_ROW) + "\n")
                fh.write("\t".join(map(str, self.query_ann)) + "\n")
                for row in self.rows:
                    fh.write("\t".join(map(str, row)) + "\n")
            elif self.file_type == "json":
                obj = [
                    dict(zip(self.meta_keys, self.meta_vals)),
                    dict(zip(AREA_HEADER_ROW, self.query_ann)),
                ]
                obj.extend(dict(zip(AREA_HEADER_ROW, row)) for row in self.rows)
                json.dump(obj, fh, indent=4)
            else:
                raise ValueError(f"unknown target file type {self.file_type}")
        return True


def write_triangle_header(fh, ld_measure, chrom, pop_names, gend_names,
                          rs_ids_srtd, poss_str) -> None:
    """The triangle TSV's ##General + rsIDs + Positions prologue
    (reference ld_triangle.py:344-353) — ONE home for the byte contract,
    shared by this module's square writer and the streamed table writer
    (tools/triangle.py), which must never diverge."""
    tab = "\t"
    fh.write(
        f"##General\tinfo:\t{ld_measure}\tchr{chrom}\t"
        f"{tab.join(pop_names)}\t{tab.join(gend_names)}\n\n"
    )
    fh.write("rsIDs\t\t" + "\t".join(rs_ids_srtd) + "\n")
    fh.write("\tPositions\t" + "\t".join(poss_str) + "\n")


def write_triangle_tsv(
    path: str,
    ld_measure: str,
    chrom: str,
    pop_names,
    gend_names,
    rs_ids_srtd,
    poss_srtd,
    ld_two_dim,
) -> None:
    """Triangle matrix TSV: reference ld_triangle.py:344-360 layout."""
    poss_str = [str(p) for p in poss_srtd]
    with open(path, "w") as fh:
        write_triangle_header(fh, ld_measure, chrom, pop_names,
                              gend_names, rs_ids_srtd, poss_str)
        for i, rsid in enumerate(rs_ids_srtd):
            line = "\t".join(map(str, ld_two_dim[i]))
            fh.write(f"{rsid}\t{poss_str[i]}\t{line}\n")


def makedirs(path: str) -> None:
    """exist_ok makedirs (the reference's bare os.makedirs crashes on
    reruns — ld_area.py:123, a quirk not replicated per SURVEY.md §7.0)."""
    os.makedirs(path, exist_ok=True)
