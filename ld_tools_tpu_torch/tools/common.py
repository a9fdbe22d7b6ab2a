"""Shared tool plumbing: config resolution, rsID checks, annotations.

Mirrors the per-tool setup blocks of the reference (ld_lite.py:69-99,
ld_area.py:24-60, ld_triangle.py:10-50): resolve the data directory,
run/skip the bootstrap, expand gender/population selections, select the
cohort, and freeze everything into an immutable config object.
"""

from __future__ import annotations

import dataclasses
import os
import re
import sqlite3

from ld_tools_tpu_torch.ingest import get_sample_names, prep_intgen_data
from ld_tools_tpu_torch.ingest.store import HaplotypeStore


class NotRsIdError(Exception):
    """Identifier does not look like a reference SNP ID
    (reference ld_lite.py:3-10)."""

    def __init__(self, rs_id):
        super().__init__(f"{rs_id} is non-rs identifier")


class NotInIntgenConvDbError(Exception):
    """rsID absent from the 1000 Genomes conversion index
    (reference ld_lite.py:12-20)."""

    def __init__(self, rs_id):
        super().__init__(f"{rs_id} is not available in 1000 Genomes")


class DifChrsError(Exception):
    """LD is undefined across chromosomes (reference ld_lite.py:22-31)."""

    def __init__(self, rs_id_1, rs_id_2):
        super().__init__(
            f"{rs_id_1} and {rs_id_2} belong to different chromosomes"
        )


def expand_gend_names(gend_names: str) -> tuple:
    if gend_names == "male":
        return ("male",)
    if gend_names == "female":
        return ("female",)
    return ("male", "female")


def expand_pop_names(pop_names: str) -> tuple:
    return tuple(pop_names.upper().split(","))


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Frozen data-plane configuration shared by all three tools."""

    intgen_dir_path: str
    intgen_convdb_path: str
    gend_names: tuple
    pop_names: tuple
    sample_names: tuple

    @staticmethod
    def resolve(intgen_dir_path, skip_intgen_data_ver, gend_names, pop_names):
        intgen_dir_path = os.path.normpath(intgen_dir_path)
        if skip_intgen_data_ver:
            db = os.path.join(intgen_dir_path, "conversion.db")
            if not os.path.exists(db):
                # sqlite3.connect would CREATE an empty stray db and
                # fail later with a cryptic 'no such table'
                raise FileNotFoundError(
                    f"{db} does not exist — this data dir has not been "
                    "prepared; run without -f first (or check the -D "
                    "path)"
                )
        else:
            db = prep_intgen_data(intgen_dir_path)
        gends = expand_gend_names(gend_names)
        pops = expand_pop_names(pop_names)
        samples = tuple(get_sample_names(gends, pops, db))
        if not samples:
            # the reference crashes later with an uncaught
            # ZeroDivisionError in calc_ld (htypes_quan == 0); fail at
            # selection time with an actionable message instead
            raise ValueError(
                f"no samples match genders={gends} populations={pops}; "
                "check -g/-e against the samples table"
            )
        return DataConfig(
            intgen_dir_path=intgen_dir_path,
            intgen_convdb_path=db,
            gend_names=gends,
            pop_names=pops,
            sample_names=samples,
        )

    def store(self) -> HaplotypeStore:
        return HaplotypeStore(self.intgen_dir_path)


def map_files(fn, names, max_proc_quan) -> list:
    """Reference-compatible source-file fan-out (-p/--max-proc-quan).

    The reference runs up to ``min(max_proc_quan, n_files, 8)`` worker
    PROCESSES over source files (ld_area.py:324-339,
    ld_triangle.py:394-408).  Here the workers are threads: device work
    serializes on the accelerator queue either way, while the host-side
    stages (input-table parsing, bit-exact f64 finish, cell formatting,
    file writes) all release the GIL inside numpy/JAX/native code — so
    file N's host work overlaps file N+1's device compute.  Results keep
    input order.
    """
    names = list(names)
    n = min(int(max_proc_quan or 1), len(names), 8)
    if n <= 1 or len(names) <= 1:
        return [fn(x) for x in names]
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=n) as pool:
        return list(pool.map(fn, names))


def check_rs_id(rs_id: str, cursor):
    """Validate an input rsID and return (CHROM, POS)
    (reference ld_lite.py:33-45; the UNANCHORED rs\\d+ search is the
    reference's own regex — 'xrs123' passes it and then fails the DB
    lookup, same as there)."""
    if re.search(r"rs\d+\b", rs_id) is None:
        raise NotRsIdError(rs_id)
    cursor.execute("SELECT CHROM, POS FROM variants WHERE ID = ?", (rs_id,))
    info = cursor.fetchone()
    if info is None:
        raise NotInIntgenConvDbError(rs_id)
    return info


def lookup_pair(db_path: str, rs_id_1: str, rs_id_2: str):
    # contextlib.closing: sqlite3's context manager scopes the
    # TRANSACTION, not the connection — without it every lookup leaked
    # a file descriptor until GC
    import contextlib

    with contextlib.closing(sqlite3.connect(db_path)) as conn:
        cursor = conn.cursor()
        info_1 = check_rs_id(rs_id_1, cursor)
        info_2 = check_rs_id(rs_id_2, cursor)
        cursor.close()
    if info_1[0] != info_2[0]:
        raise DifChrsError(rs_id_1, rs_id_2)
    return info_1, info_2


def variant_annotations(chrom_data, row: int):
    """(alleles 'REF/ALT0', first VT) for one store row
    (reference ld_lite.py:117-118 builds the same from the VCF record)."""
    ref = str(chrom_data.annotation("ref")[row])
    alt = str(chrom_data.annotation("alt")[row])
    vt = str(chrom_data.annotation("vt")[row])
    alleles = ref + "/" + alt.split(",")[0]
    vtype = vt.split(",")[0]
    return alleles, vtype
