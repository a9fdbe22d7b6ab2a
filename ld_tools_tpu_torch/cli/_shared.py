"""Shared CLI construction: one flag surface, two languages (a copy of
ld_tools_tpu/cli/_shared.py for the ported tools: lite, area and
triangle).

The reference ships six argparse modules ({ld_area,ld_lite,ld_triangle} x
{ru,en}) whose argument sets are pairwise identical — only help text
differs (SURVEY.md §1 L5).  Here the flag surface is defined once per tool
and each locale module supplies a text table, which keeps RU/EN drift
impossible by construction.  Flag names, defaults, and choices match the
reference (SURVEY.md §2a).

The one flag beyond the JAX surface is ``-E/--engine {cuda,torch}`` on
every tool (ld_scan's own parser has it too): cuda (the default) counts
on the card, torch runs the plain PyTorch versions on the CPU.  There is no automatic choice, so a run never falls back to
the CPU without being asked to.
"""

from __future__ import annotations

from argparse import ArgumentParser, RawTextHelpFormatter


def _common_data_args(parser: ArgumentParser, text: dict) -> None:
    parser.add_argument(
        "-D", "--intgen-dir-path", metavar="str", dest="intgen_dir_path",
        type=str, help=text["intgen_dir"],
    )
    parser.add_argument(
        "-f", "--skip-intgen-data-ver", dest="skip_intgen_data_ver",
        action="store_true", help=text["skip_ver"],
    )
    parser.add_argument(
        "-g", "--gend-names", metavar="[both]",
        choices=["male", "female", "both"], default="both",
        dest="gend_names", type=str, help=text["gends"],
    )
    parser.add_argument(
        "-e", "--pop-names", metavar="[all]", default="all",
        dest="pop_names", type=str, help=text["pops"],
    )


def _common_batch_args(parser: ArgumentParser, text: dict) -> None:
    parser.add_argument(
        "-S", "--src-dir-path", metavar="str", dest="src_dir_path",
        type=str, help=text["src_dir"],
    )
    parser.add_argument(
        "-t", "--trg-top-dir-path", metavar="[None]", dest="trg_top_dir_path",
        type=str, help=text["trg_dir"],
    )
    parser.add_argument(
        "-m", "--meta-lines-quan", metavar="[0]", default=0,
        dest="meta_lines_quan", type=int, help=text["meta_lines"],
    )


def _engine_arg(parser: ArgumentParser, text: dict) -> None:
    parser.add_argument(
        "-E", "--engine", metavar="[cuda]",
        choices=["cuda", "torch"], default="cuda", dest="engine",
        type=str, help=text["engine"],
    )


def _max_proc_arg(parser: ArgumentParser, text: dict) -> None:
    parser.add_argument(
        "-p", "--max-proc-quan", metavar="[4]", default=4,
        dest="max_proc_quan", type=int, help=text["max_proc"],
    )


def build_lite_parser(ver: str, text: dict) -> ArgumentParser:
    parser = ArgumentParser(
        description=text["description"].format(ver=ver),
        formatter_class=RawTextHelpFormatter,
    )
    parser.add_argument("rs_id_1", metavar="str", type=str, help=text["rs1"])
    parser.add_argument("rs_id_2", metavar="str", type=str, help=text["rs2"])
    _common_data_args(parser, text)
    _engine_arg(parser, text)
    return parser


def build_area_parser(ver: str, text: dict) -> ArgumentParser:
    parser = ArgumentParser(
        description=text["description"].format(ver=ver),
        formatter_class=RawTextHelpFormatter,
    )
    _common_batch_args(parser, text)
    _common_data_args(parser, text)
    parser.add_argument(
        "-w", "--flank-size", metavar="[100000]", default=100000,
        dest="flank_size", type=int, help=text["flank"],
    )
    parser.add_argument(
        "-l", "--ld-thres-measure", metavar="[r_square]",
        choices=["r_square", "d_prime"], default="r_square",
        dest="ld_thres_measure", type=str, help=text["measure"],
    )
    parser.add_argument(
        "-z", "--ld-low-thres", metavar="[0.8]", default=0.8,
        dest="ld_low_thres", type=float, help=text["thres"],
    )
    parser.add_argument(
        "-o", "--trg-file-type", metavar="[tsv]",
        choices=["tsv", "json", "rsids"], default="tsv",
        dest="trg_file_type", type=str, help=text["file_type"],
    )
    _max_proc_arg(parser, text)
    _engine_arg(parser, text)
    return parser


def build_triangle_parser(ver: str, text: dict) -> ArgumentParser:
    parser = ArgumentParser(
        description=text["description"].format(ver=ver),
        formatter_class=RawTextHelpFormatter,
    )
    _common_batch_args(parser, text)
    _common_data_args(parser, text)
    parser.add_argument(
        "-l", "--ld-measure", metavar="[r_square]",
        choices=["r_square", "d_prime"], default="r_square",
        dest="ld_measure", type=str, help=text["measure"],
    )
    parser.add_argument(
        "-z", "--ld-low-thres", metavar="[None]", dest="ld_low_thres",
        type=float, help=text["thres"],
    )
    parser.add_argument(
        "-o", "--matrix-type", metavar="[heatmap]",
        choices=["heatmap", "table", "both"], default="heatmap",
        dest="matrix_type", type=str, help=text["matrix_type"],
    )
    parser.add_argument(
        "-j", "--heatmap-json", dest="heatmap_json", action="store_true",
        help=text["heatmap_json"],
    )
    parser.add_argument(
        "-i", "--disp-letters", dest="disp_letters", action="store_true",
        help=text["disp_letters"],
    )
    parser.add_argument(
        "-c", "--color-pal", metavar="[greens]", default="greens",
        dest="color_pal", type=str, help=text["color_pal"],
    )
    parser.add_argument(
        "-k", "--font-size", metavar="[None]", dest="font_size", type=int,
        help=text["font_size"],
    )
    parser.add_argument(
        "-q", "--square-shape", dest="square_shape", action="store_true",
        help=text["square"],
    )
    parser.add_argument(
        "-s", "--dont-disp-footer", dest="dont_disp_footer",
        action="store_true", help=text["no_footer"],
    )
    _max_proc_arg(parser, text)
    _engine_arg(parser, text)
    return parser
