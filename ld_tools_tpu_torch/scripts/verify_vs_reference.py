"""End-to-end value parity of the port's tools against a LIVE reference
checkout (the counterpart of scripts/verify_vs_reference.py).

    python -m ld_tools_tpu_torch.scripts.verify_vs_reference
        --reference DIR [-E cuda|torch]

Builds synthetic fixtures with the port's ingest (an autosome and a
mixed-ploidy chrX with males haploid outside the PAR bands), runs every
tool of the port (``ld_lite``, ``ld_area``, ``ld_triangle``, ``ld_scan``)
through its real code path on the engine ``-E`` names, and checks every
emitted LD value, value types included (the reference's int-0
monomorphic sentinel prints ``0``, a float zero ``0.0``), against the
reference's own ``DIR/backend/calc_ld.py`` executed live, fed the flat
genotype lists its tools would gather (ploidy-agnostic append,
ld_area.py:230-235).

Prints ``{"checks_ok": N, "mismatches": M}`` and exits 1 on any mismatch,
2 when DIR holds no ``backend/calc_ld.py``.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import sys
import tempfile
import types

import numpy as np


class Checks:
    """The tally of one run."""

    def __init__(self):
        self.ok = 0
        self.bad = 0

    def __call__(self, cond, what):
        if cond:
            self.ok += 1
        else:
            self.bad += 1
            print(f"MISMATCH: {what}")


def flat_lists(G, hap, names, cohort):
    """Reference-style flat genotype lists per variant row index."""
    col_of = {n: i for i, n in enumerate(names)}
    out = []
    for vi in range(G.shape[0]):
        row = []
        for name in cohort:
            s = col_of.get(name)
            if s is None:
                continue
            if hap is not None and hap[vi, s]:
                row.append(int(G[vi, 2 * s]))
            else:
                row += [int(G[vi, 2 * s]), int(G[vi, 2 * s + 1])]
        out.append(row)
    return out


def verify_chrom(check, calc_ld, d, db, chrom, G, hap, names, rs_map, work,
                 engine):
    from ld_tools_tpu_torch.ingest import HaplotypeStore, get_sample_names
    from ld_tools_tpu_torch.tools import area, lite, scan, triangle

    cohort = get_sample_names(("male", "female"), ("ALL",), db)
    gl_rows = flat_lists(G, hap, names, cohort)
    cd = HaplotypeStore(d).chrom(chrom)
    rsids = list(rs_map)
    gl = {r: gl_rows[cd.row_of(r)] for r in rsids}

    # ld_lite on two pairs (across the PAR bound on chrX): the values are
    # taken from the rendered sub-table's cells and compared as exact
    # strings
    for a, b in ((rsids[0], rsids[-1]), (rsids[1], rsids[len(rsids) // 2])):
        table = lite.run(types.SimpleNamespace(
            rs_id_1=a, rs_id_2=b, intgen_dir_path=d,
            skip_intgen_data_ver=True, gend_names="both", pop_names="all",
            engine=engine,
        ))
        ref = calc_ld(gl[a], gl[b])
        m_r2 = re.search(r"r2\s*│\s*(\S+)", table)
        m_dp = re.search(r"D'\s*│\s*(\S+)", table)
        check(m_r2 is not None and m_r2.group(1) == str(ref["r_square"]),
              f"lite r2 {chrom} {a} {b}")
        check(m_dp is not None and m_dp.group(1) == str(ref["d_prime"]),
              f"lite D' {chrom} {a} {b}")

    src = os.path.join(work, f"src_{chrom}")
    os.makedirs(src, exist_ok=True)
    with open(os.path.join(src, "q.txt"), "w") as fh:
        fh.write("\n".join(rsids) + "\n")
    common = dict(
        src_dir_path=src, intgen_dir_path=d, trg_top_dir_path=None,
        meta_lines_quan=0, skip_intgen_data_ver=True, gend_names="both",
        pop_names="all", max_proc_quan=1, engine=engine,
    )

    # ld_area TSV: every opponent row against the live calc_ld
    trg = os.path.join(work, f"area_{chrom}")
    area.run(types.SimpleNamespace(**dict(
        common, trg_top_dir_path=trg, flank_size=10**8,
        ld_thres_measure="r_square", ld_low_thres=0.3,
        trg_file_type="tsv",
    )))
    chr_dir = os.path.join(trg, "q_in_LD", chrom)
    for q in rsids:
        path = os.path.join(chr_dir, f"{q}_chr{chrom}_r_0.3.tsv")
        all_refs = {o: calc_ld(gl[q], gl[o]) for o in rsids if o != q}
        expected = {o: ref for o, ref in all_refs.items()
                    if ref["r_square"] >= 0.3}
        if not expected:
            check(not os.path.exists(path), f"area no-file {chrom} {q}")
            continue
        if not os.path.exists(path):
            check(False, f"area file missing {chrom} {q}")
            continue
        with open(path) as fh:
            lines = fh.read().splitlines()
        got = {f[1]: f for f in (ln.split("\t") for ln in lines[3:])}
        check(set(got) == set(expected), f"area hit set {chrom} {q}")
        for o, ref in expected.items():
            if o not in got:
                continue
            check(got[o][6] == str(ref["r_square"]), f"area r2 {q} {o}")
            check(got[o][7] == str(ref["d_prime"]), f"area D' {q} {o}")
            check(got[o][5] == str(ref["var_2_alt_freq"]),
                  f"area freq {q} {o}")

    # ld_triangle TSV: every lower-triangle cell
    trg = os.path.join(work, f"tri_{chrom}")
    triangle.run(types.SimpleNamespace(**dict(
        common, trg_top_dir_path=trg, ld_measure="r_square",
        ld_low_thres=None, matrix_type="table", heatmap_json=False,
        disp_letters=False, color_pal="greens", font_size=None,
        square_shape=False, dont_disp_footer=True,
    )))
    path = os.path.join(trg, "q_LD_matr", f"q_chr{chrom}_r.tsv")
    if not os.path.exists(path):
        check(False, f"triangle file missing {chrom}")
        return
    with open(path) as fh:
        lines = fh.read().splitlines()
    order = lines[2].split("\t")[2:]
    body = {ln.split("\t")[0]: ln.split("\t")[2:] for ln in lines[4:]}
    for i, yrs in enumerate(order):
        for j, xrs in enumerate(order[:i]):
            ref = calc_ld(gl[yrs], gl[xrs])
            check(body[yrs][j] == str(ref["r_square"]),
                  f"triangle {chrom} {yrs} {xrs}")

    # ld_scan: every emitted pair row
    trg = os.path.join(work, f"scan_{chrom}")
    scan.run(types.SimpleNamespace(
        chroms=chrom, trg_dir_path=trg, intgen_dir_path=d,
        skip_intgen_data_ver=True, gend_names="both", pop_names="all",
        ld_measure="r_square", ld_low_thres=0.25, max_dist=None,
        checkpoint_dir=None, devices=None, engine=engine,
    ))
    path = os.path.join(trg, f"ld_scan_chr{chrom}_r_0.25.tsv")
    if not os.path.exists(path):
        check(False, f"scan file missing {chrom}")
        return
    with open(path) as fh:
        rows = [ln.rstrip("\n").split("\t") for ln in fh
                if not ln.startswith("#")]
    expected_pairs = set()
    by_pos = sorted(rsids, key=lambda r: rs_map[r])
    for ai in range(len(by_pos)):
        for bi in range(ai):
            ra, rb = by_pos[ai], by_pos[bi]
            if calc_ld(gl[ra], gl[rb])["r_square"] >= 0.25:
                expected_pairs.add((ra, rb))
    check({(r[1], r[3]) for r in rows} == expected_pairs,
          f"scan hit set {chrom}")
    for r in rows:
        if r[1] not in gl or r[3] not in gl:
            check(False, f"scan unexpected rsID {r[1]}/{r[3]}")
            continue
        ref = calc_ld(gl[r[1]], gl[r[3]])
        check(float(r[5]) == ref["r_square"], f"scan r2 {r[1]} {r[3]}")
        check(float(r[6]) == ref["d_prime"], f"scan D' {r[1]} {r[3]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m ld_tools_tpu_torch.scripts.verify_vs_reference",
        description="Every tool's values against a live reference "
                    "checkout's backend/calc_ld.py.")
    ap.add_argument("--reference", required=True,
                    help="the reference checkout (holds backend/calc_ld.py)")
    ap.add_argument("-E", "--engine", choices=("cuda", "torch"),
                    default="cuda",
                    help="cuda: the card (default); torch: the plain "
                         "PyTorch versions on the CPU")
    args = ap.parse_args(argv)
    if not os.path.exists(os.path.join(args.reference, "backend",
                                       "calc_ld.py")):
        print(f"reference checkout not found under {args.reference}")
        return 2
    from ld_tools_tpu_torch.utils.device import engine_device, resolve_device

    resolve_device(engine_device(args.engine))  # no card: fail before work
    sys.path.insert(1, os.path.abspath(args.reference))
    from backend.calc_ld import calc_ld  # the LIVE reference kernel

    from ld_tools_tpu_torch.ingest import prep_intgen_data, synth

    check = Checks()
    work = tempfile.mkdtemp(prefix="tpu_ld_verify_")
    try:
        d = os.path.join(work, "data")
        os.makedirs(d)
        rng = np.random.default_rng(2024)
        panel = synth.make_panel(28, rng)
        panel[0] = (panel[0][0], panel[0][1], panel[0][2], "male")
        panel[1] = (panel[1][0], panel[1][1], panel[1][2], "female")
        synth.write_panel(os.path.join(d, "samples.txt"), panel)
        names = [r[0] for r in panel]
        genders = [r[3] for r in panel]

        G7 = synth.correlated_haplotypes(rng, 30, 2 * len(names))
        rs7 = synth.write_vcf(os.path.join(d, "7.vcf.gz"), "7", names, G7)
        GX, hapX = synth.make_chrx_layout(rng, 32, genders)
        rsX = synth.write_vcf(
            os.path.join(d, "X.vcf.gz"), "X", names, GX,
            haploid_masks=hapX, rsids=[f"rs55{i:04d}" for i in range(32)],
        )
        db = prep_intgen_data(d)

        verify_chrom(check, calc_ld, d, db, "7", G7, None, names, rs7, work,
                     args.engine)
        verify_chrom(check, calc_ld, d, db, "X", GX, hapX, names, rsX, work,
                     args.engine)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"checks_ok": check.ok, "mismatches": check.bad}))
    return 1 if check.bad else 0


if __name__ == "__main__":
    sys.exit(main())
