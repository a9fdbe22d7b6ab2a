"""Write the gallery's example output files from synthetic data with the
port's tools (the counterpart of scripts/make_gallery.py).

    python -m ld_tools_tpu_torch.scripts.make_gallery --out DIR
        [-E cuda|torch]

The files are those of the repository's ``gallery/`` (self-contained
heatmap HTML, triangle TSV and JSON, area TSV, pair tables, a scan TSV),
made from the same deterministic synthetic datasets, and written into
DIR, so that a diff against ``gallery/`` shows any change of format or
value.
"""

from __future__ import annotations

import argparse
import os
import shutil
import tempfile
import types

import numpy as np


def _copy(src, dst):
    with open(src) as s, open(dst, "w") as d:
        d.write(s.read())


def make(out, engine):
    from ld_tools_tpu_torch.ingest import prep_intgen_data, synth
    from ld_tools_tpu_torch.io import heatmap as heatmap_io
    from ld_tools_tpu_torch.tools import area, lite, triangle
    from ld_tools_tpu_torch.tools import scan as scan_tool
    from ld_tools_tpu_torch.utils.device import engine_device, resolve_device

    resolve_device(engine_device(engine))  # no card: fail before any work
    os.makedirs(out, exist_ok=True)
    work = tempfile.mkdtemp(prefix="tpu_ld_gallery_")
    try:
        data_dir = os.path.join(work, "data")
        src_dir = os.path.join(work, "src")
        os.makedirs(src_dir)
        rs = synth.generate_dataset(
            data_dir, n_samples=60, chrom_variant_counts={"14": 24}, seed=14
        )
        prep_intgen_data(data_dir)
        rsids = list(rs["14"])
        with open(os.path.join(src_dir, "example.txt"), "w") as fh:
            fh.write("\n".join(rsids) + "\n")

        common = dict(
            intgen_dir_path=data_dir, skip_intgen_data_ver=True,
            gend_names="both", pop_names="all", engine=engine,
        )
        table = lite.run(types.SimpleNamespace(
            rs_id_1=rsids[0], rs_id_2=rsids[3], **common))
        with open(os.path.join(out, "ld_lite_pair_table.txt"), "w") as fh:
            fh.write(table + "\n")

        triangle.run(types.SimpleNamespace(
            src_dir_path=src_dir, trg_top_dir_path=work, meta_lines_quan=0,
            ld_measure="r_square", ld_low_thres=None, matrix_type="both",
            heatmap_json=True, disp_letters=True, color_pal="ylgnbu",
            font_size=None, square_shape=True, dont_disp_footer=False,
            max_proc_quan=4, **common))
        matr = os.path.join(work, "example_LD_matr")
        for name in os.listdir(matr):
            _copy(os.path.join(matr, name),
                  os.path.join(out, "ld_triangle_" + name))

        area.run(types.SimpleNamespace(
            src_dir_path=src_dir, trg_top_dir_path=work, meta_lines_quan=0,
            flank_size=10**6, ld_thres_measure="r_square", ld_low_thres=0.5,
            trg_file_type="tsv", max_proc_quan=4, **common))
        area_dir = os.path.join(work, "example_in_LD", "14")
        picked = sorted(os.listdir(area_dir))[0]
        _copy(os.path.join(area_dir, picked),
              os.path.join(out, "ld_area_" + picked))

        # mixed-ploidy chrX: ld_lite across the PAR boundary (male-haploid
        # non-PAR x diploid PAR: genotype lists of unequal length, the zip
        # semantics of the reference's calc_ld.py:30-33)
        rng = np.random.default_rng(23)
        xdir = os.path.join(work, "xdata")
        os.makedirs(xdir)
        panel = synth.make_panel(40, rng)
        synth.write_panel(os.path.join(xdir, "samples.txt"), panel)
        names = [r[0] for r in panel]
        GX, hapX = synth.make_chrx_layout(
            rng, 30, [r[3] for r in panel], par_bounds=(0.3, 0.7)
        )
        rs_x = synth.write_vcf(
            os.path.join(xdir, "X.vcf.gz"), "X", names, GX,
            haploid_masks=hapX
        )
        prep_intgen_data(xdir)
        rsx = list(rs_x)
        table_x = lite.run(types.SimpleNamespace(
            rs_id_1=rsx[2], rs_id_2=rsx[15], intgen_dir_path=xdir,
            skip_intgen_data_ver=True, gend_names="both", pop_names="all",
            engine=engine,
        ))
        with open(os.path.join(out, "ld_lite_chrx_par_x_nonpar.txt"),
                  "w") as fh:
            fh.write(table_x + "\n")

        # the columnar heatmap (past 500 variants: O(n) hover strings,
        # assembled in the browser; io/heatmap.py)
        bigdir = os.path.join(work, "bigdata")
        os.makedirs(bigdir)
        synth.write_panel(os.path.join(bigdir, "samples.txt"), panel)
        Gb = synth.correlated_haplotypes(rng, 560, 80)
        rs_b = synth.write_vcf(
            os.path.join(bigdir, "9.vcf.gz"), "9", names, Gb,
            rsids=[f"rs77{i:04d}" for i in range(560)],
        )
        prep_intgen_data(bigdir)
        bsrc = os.path.join(work, "bigsrc")
        os.makedirs(bsrc)
        with open(os.path.join(bsrc, "big.txt"), "w") as fh:
            fh.write("\n".join(rs_b) + "\n")
        triangle.run(types.SimpleNamespace(
            src_dir_path=bsrc, trg_top_dir_path=work, meta_lines_quan=0,
            ld_measure="r_square", ld_low_thres=None, matrix_type="heatmap",
            heatmap_json=False, disp_letters=False, color_pal="sunsetdark",
            font_size=None, square_shape=True, dont_disp_footer=False,
            max_proc_quan=1, intgen_dir_path=bigdir,
            skip_intgen_data_ver=True, gend_names="both", pop_names="all",
            engine=engine,
        ))
        _copy(os.path.join(work, "big_LD_matr", "big_chr9_r.html"),
              os.path.join(out, "ld_triangle_columnar_560_chr9_r.html"))

        # the pooled overview heatmap (past 4,096 variants in production;
        # its thresholds shrunk here so that the sample stays near 1 MB
        # while it runs the real pooling and representative-pair path)
        ov_min, ov_p = heatmap_io._OVERVIEW_MIN, heatmap_io._OVERVIEW_P
        heatmap_io._OVERVIEW_MIN, heatmap_io._OVERVIEW_P = 500, 150
        try:
            ovdir = os.path.join(work, "ovdata")
            os.makedirs(ovdir)
            synth.write_panel(os.path.join(ovdir, "samples.txt"), panel)
            Gv = synth.correlated_haplotypes(rng, 1200, 80)
            rs_v = synth.write_vcf(
                os.path.join(ovdir, "7.vcf.gz"), "7", names, Gv,
                rsids=[f"rs88{i:04d}" for i in range(1200)],
            )
            prep_intgen_data(ovdir)
            vsrc = os.path.join(work, "ovsrc")
            os.makedirs(vsrc)
            with open(os.path.join(vsrc, "ov.txt"), "w") as fh:
                fh.write("\n".join(rs_v) + "\n")
            triangle.run(types.SimpleNamespace(
                src_dir_path=vsrc, trg_top_dir_path=work, meta_lines_quan=0,
                ld_measure="r_square", ld_low_thres=None,
                matrix_type="heatmap", heatmap_json=False,
                disp_letters=False, color_pal="ylgnbu", font_size=None,
                square_shape=True, dont_disp_footer=False, max_proc_quan=1,
                intgen_dir_path=ovdir, skip_intgen_data_ver=True,
                gend_names="both", pop_names="all", engine=engine,
            ))
            _copy(os.path.join(work, "ov_LD_matr", "ov_chr7_r.html"),
                  os.path.join(out, "ld_triangle_overview_1200_chr7_r.html"))
        finally:
            heatmap_io._OVERVIEW_MIN, heatmap_io._OVERVIEW_P = ov_min, ov_p

        # ld_scan: the windowed whole-chromosome threshold scan, on the
        # 560-variant chr9 store above
        scan_out = os.path.join(work, "scan_out")
        scan_tool.run(types.SimpleNamespace(
            intgen_dir_path=bigdir, skip_intgen_data_ver=True,
            gend_names="both", pop_names="all", chroms="9",
            trg_dir_path=scan_out, ld_measure="r_square", ld_low_thres=0.5,
            max_dist=100_000, checkpoint_dir=None, engine=engine,
            devices=None,
        ))
        picked_scan = sorted(os.listdir(scan_out))[0]
        _copy(os.path.join(scan_out, picked_scan),
              os.path.join(out, picked_scan))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"gallery written to {out}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m ld_tools_tpu_torch.scripts.make_gallery",
        description="The gallery's example output files, written into a "
                    "directory.")
    ap.add_argument("--out", required=True,
                    help="directory to write the files into")
    ap.add_argument("-E", "--engine", choices=("cuda", "torch"),
                    default="cuda",
                    help="cuda: the card (default); torch: the plain "
                         "PyTorch versions on the CPU")
    args = ap.parse_args(argv)
    make(args.out, args.engine)


if __name__ == "__main__":
    main()
