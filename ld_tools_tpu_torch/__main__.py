"""The port's unified CLI: ``python -m ld_tools_tpu_torch <command> [args]``.

The commands and their help are tpu_ld.py's: each tool's own entry point
(``ld_tools_tpu_torch.ld_lite``, ``.ld_area``, ``.ld_triangle``,
``.ld_scan``) and the explicit data-prep stage, which packs the 1000G
VCFs with the port's own ingest.  Tool commands print their kernels' and
the engine's launch counts as one JSON line on stderr at the end.
"""

import sys

COMMANDS = {
    "lite": ("ld_lite", "pair LD to the terminal"),
    "area": ("ld_area", "LD-threshold neighborhood search"),
    "triangle": ("ld_triangle", "all-pairs LD matrices"),
    "scan": ("ld_scan", "whole-chromosome threshold scan"),
    "prep": (None, "pack 1000G VCFs into the haplotype store"),
}

PROG = "python -m ld_tools_tpu_torch"


def prep(argv=None) -> int:
    """The data-prep stage (scripts/prep_data.py): pack the VCFs and
    samples.txt of a folder into the haplotype store; idempotent."""
    import argparse

    parser = argparse.ArgumentParser(
        prog=f"{PROG} prep",
        description="Pack per-chromosome VCFs + samples.txt into the "
        "tpu-ld haplotype store (idempotent, resumable).",
    )
    parser.add_argument(
        "-D", "--intgen-dir-path", required=True, dest="intgen_dir_path",
        help="Folder with {N}.vcf.gz files and samples.txt",
    )
    args = parser.parse_args(argv)
    from ld_tools_tpu_torch.ingest import prep_intgen_data

    db = prep_intgen_data(args.intgen_dir_path)
    print(f"ready: {db}")
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(f"usage: {PROG} <command> [args]\n\ncommands:")
        for name, (_, desc) in COMMANDS.items():
            print(f"  {name:<9} {desc}")
        print(f"\nrun '{PROG} <command> --help' for command flags")
        return 0
    cmd, rest = argv[0], argv[1:]
    if cmd not in COMMANDS:
        print(f"unknown command {cmd!r}; try --help", file=sys.stderr)
        return 2
    if cmd == "prep":
        return prep(rest)
    import importlib

    from ld_tools_tpu_torch.bench.common import log_launches
    from ld_tools_tpu_torch.ops.engine import count_on_device

    sys.argv = [f"{PROG} {cmd}"] + rest  # argparse's prog in the help
    importlib.import_module(f"ld_tools_tpu_torch.{COMMANDS[cmd][0]}").main(rest)
    log_launches(engine=count_on_device.launches)
    return 0


if __name__ == "__main__":
    sys.exit(main())
