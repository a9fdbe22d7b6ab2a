"""Input resolution: source table -> {chrom: [[pos, rsID], ...]}.

Reference behavior (backend/create_src_dict.py:5-64): skip
``meta_lines_quan`` leading lines, take the left-most ``rs\\d+`` token of
each remaining line into a set, resolve all of them with one SQL IN-query
against the ``variants`` table, group [pos, rsID] rows by chromosome in
database row order.  Unknown / multiallelic rsIDs silently drop (they are
absent from the table).
"""

from __future__ import annotations

import os
import re
import sqlite3

_RS_TOKEN = re.compile(r"rs\d+\b")


def create_src_dict(
    src_dir_path: str,
    src_file_name: str,
    meta_lines_quan: int,
    intgen_convdb_path: str,
) -> dict:
    rs_ids = set()
    with open(os.path.join(src_dir_path, src_file_name)) as fh:
        for _ in range(meta_lines_quan):
            fh.readline()
        for line in fh:
            match = _RS_TOKEN.search(line)
            if match is not None:
                rs_ids.add(match.group())
    if not rs_ids:
        return {}

    # Chunk the IN list: SQLite caps bound parameters per statement
    # (999 on pre-3.32 builds) and a full GWAS summary table can carry
    # hundreds of thousands of rsIDs — the reference's interpolated SQL
    # had no such cap, so neither may this.  Chunk results concatenate
    # in database row order per chunk; the tools sort by position anyway
    # (the reference's own order is its single-query row order).
    rs_ids = tuple(rs_ids)
    chunk = 500
    data_by_chrs = {}
    with sqlite3.connect(intgen_convdb_path) as conn:
        cursor = conn.cursor()
        for lo in range(0, len(rs_ids), chunk):
            part = rs_ids[lo : lo + chunk]
            marks = ", ".join("?" for _ in part)
            for chrom, pos, rs_id in cursor.execute(
                f"SELECT CHROM, POS, ID FROM variants WHERE ID IN ({marks})",
                part,
            ):
                data_by_chrs.setdefault(chrom, []).append([pos, rs_id])
        cursor.close()
    return data_by_chrs
