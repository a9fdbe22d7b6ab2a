"""ld_area entry point of the port: LD-threshold neighbourhood search
around the query variants of every table in a source folder.

    python -m ld_tools_tpu_torch.ld_area -S <src dir> -D <data dir> -t <out dir>

``-E cuda`` (the default) counts on the card and raises without one;
``-E torch`` runs the plain PyTorch counts on the CPU.  ``-p N`` runs N
source files at once on threads.  Locale selects RU/EN help like the
reference (ld_area.py:316-319).  Run as a module it prints the kernels'
and the engine's launch counts as one JSON line on stderr at the end.
"""

__version__ = "V1.0-torch"


def main(argv=None, stats: dict = None) -> int:
    """Parse ``argv`` (default: sys.argv[1:]) and run the search; returns
    the number of result files written (``stats``, where given, receives
    the search's phase sums: tools.area.AreaRunner)."""
    from ld_tools_tpu_torch.utils.locale_detect import ui_language

    if ui_language() == "ru":
        from ld_tools_tpu_torch.cli.ld_area_cli_ru import add_args_ru as add_args
    else:
        from ld_tools_tpu_torch.cli.ld_area_cli_en import add_args_en as add_args
    args = add_args(__version__, argv)
    from ld_tools_tpu_torch.tools.area import run

    return run(args, stats)


if __name__ == "__main__":
    main()
    from ld_tools_tpu_torch.bench.common import log_launches
    from ld_tools_tpu_torch.ops.engine import count_on_device

    log_launches(engine=count_on_device.launches)
