"""English CLI for ld_area in the port (reference cli/ld_area_cli_en.py flag surface)."""

from ld_tools_tpu_torch.cli._shared import build_area_parser

TEXT = {
    "description": """
Searches, for each source variant, the variants within a window that are
in linkage disequilibrium above the threshold value.

Version: {ver}
GPU (PyTorch/CUDA) rework of ld-tools' ld_area.
License: MIT

Supported source files are tables containing a column with rsIDs.
If there is more than 1 rsID column, the program uses the left one.

tpu-ld uses 1000 Genomes project data for LD calculation.
Downloading and packing is done only once (see the prep stage).

CLI help legend:
- a short form with a capital letter: mandatory argument;
- in square brackets: default value;
- in curly brackets: list of possible values.
""",
    "src_dir": "Path to folder with source tables",
    "trg_dir": "Path to target folder (default: path to source folder)",
    "meta_lines": "Number of meta-information lines (including line with column names)",
    "intgen_dir": "Path to folder for 1000G data",
    "skip_ver": "Do not check 1000G data completeness (start main calculations immediately)",
    "gends": "{male, female, both} Belonging of 1000G samples to genders (for selection of genotypes that determine LD)",
    "pops": "Belonging of 1000G samples to populations (separated by commas without space)",
    "flank": "The size of *each* of the flanks, where to look for in-LD variants",
    "measure": "{r_square, d_prime} Measure for setting the lower LD threshold",
    "thres": "Lower LD threshold",
    "file_type": "{tsv, json, rsids} Target file format",
    "max_proc": "Maximum number of tables to be processed in parallel",
    "engine": "{cuda, torch} Count engine (cuda: the GPU; torch: the plain PyTorch versions on the CPU)",
}


def add_args_en(ver, argv=None):
    return build_area_parser(ver, TEXT).parse_args(argv)
