"""English CLI for ld_lite in the port (reference cli/ld_lite_cli_en.py flag surface)."""

from ld_tools_tpu_torch.cli._shared import build_lite_parser

TEXT = {
    "description": """
Prints, in tabular form, the LD and the distance between two variants,
plus the essential characteristics of each variant.

Version: {ver}
GPU (PyTorch/CUDA) rework of ld-tools' ld_lite.
License: MIT

tpu-ld uses 1000 Genomes project data for LD calculation.
Downloading and packing is done only once (see the prep stage).

CLI help legend:
- a short form with a capital letter: mandatory argument;
- in square brackets: default value;
- in curly brackets: list of possible values.
""",
    "rs1": "rsID of the first variant",
    "rs2": "rsID of the second variant",
    "intgen_dir": "Path to folder for 1000G data",
    "skip_ver": "Do not check 1000G data completeness (start main calculations immediately)",
    "gends": "{male, female, both} Belonging of 1000G samples to genders (for selection of genotypes that determine LD)",
    "pops": "Belonging of 1000G samples to populations (separated by commas without space)",
    "engine": "{cuda, torch} Count engine (cuda: the GPU; torch: the plain PyTorch versions on the CPU)",
}


def add_args_en(ver, argv=None):
    return build_lite_parser(ver, TEXT).parse_args(argv)
