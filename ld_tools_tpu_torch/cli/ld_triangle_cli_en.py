"""English CLI for ld_triangle in the port (reference
cli/ld_triangle_cli_en.py flag surface)."""

from ld_tools_tpu_torch.cli._shared import build_triangle_parser

TEXT = {
    "description": """
Builds LD matrices for all pairs of each set of variants as triangle
heatmaps and/or tables.

Version: {ver}
GPU (PyTorch/CUDA) rework of ld-tools' ld_triangle.
License: MIT

Supported source files are tables containing a column with rsIDs.
If there is more than 1 rsID column, the program uses the left one.

One source file may contain data from different chromosomes.
The program builds a separate matrix for each chromosome.

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
    "measure": "{r_square, d_prime} LD measure for building matrices and for setting the lower threshold",
    "thres": "Lower LD threshold (subthreshold values will be zeroed)",
    "matrix_type": "{heatmap, table, both} Type of LD value matrices",
    "heatmap_json": "Save heatmap objects as JSON (useful for debug)",
    "disp_letters": "Print LD values and rsID axis labels onto heatmap",
    "color_pal": "Color palette of heatmap (45 sequential palettes supported; default greens)",
    "font_size": "Font size of texts on the heatmap (default: 12; make the font smaller for large diagrams)",
    "square": "Square shape of the heatmap",
    "no_footer": "Do not display information about the program on the heatmap",
    "max_proc": "Maximum number of tables to be processed in parallel",
    "engine": "{cuda, torch} Count engine (cuda: the GPU; torch: the plain PyTorch versions on the CPU)",
}


def add_args_en(ver, argv=None):
    return build_triangle_parser(ver, TEXT).parse_args(argv)
