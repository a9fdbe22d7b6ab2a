"""ld_triangle entry point of the port: all-pairs LD matrices (heatmaps
and/or tables) of every table in a source folder.

    python -m ld_tools_tpu_torch.ld_triangle -S <src dir> -D <data dir> -t <out dir>

``-E cuda`` (the default) counts on the card and raises without one;
``-E torch`` runs the plain PyTorch counts on the CPU.  ``-o
heatmap|table|both`` picks the outputs and ``-p N`` runs N source files
at once on threads.  Locale selects RU/EN help like the reference
(ld_triangle.py:386-389).  Run as a module it prints the kernels' and
the engine's launch counts as one JSON line on stderr at the end.
"""

__version__ = "V1.0-torch"


def main(argv=None, stats: dict = None) -> int:
    """Parse ``argv`` (default: sys.argv[1:]) and build the matrices;
    returns the number of matrices built (``stats``, where given,
    receives their phase sums: tools.triangle.TriangleRunner)."""
    from ld_tools_tpu_torch.utils.locale_detect import ui_language

    if ui_language() == "ru":
        from ld_tools_tpu_torch.cli.ld_triangle_cli_ru import add_args_ru as add_args
    else:
        from ld_tools_tpu_torch.cli.ld_triangle_cli_en import add_args_en as add_args
    args = add_args(__version__, argv)
    from ld_tools_tpu_torch.tools.triangle import run

    return run(args, stats)


if __name__ == "__main__":
    main()
    from ld_tools_tpu_torch.bench.common import log_launches
    from ld_tools_tpu_torch.ops.engine import count_on_device

    log_launches(engine=count_on_device.launches)
