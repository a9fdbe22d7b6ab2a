"""ld_lite entry point of the port: LD and distance of one variant pair,
printed as a table.

    python -m ld_tools_tpu_torch.ld_lite rs1 rs2 -D <data dir>

``-E cuda`` (the default) asks for the card and raises without one;
``-E torch`` runs on the CPU.  One pair is below the engine's host cutoff
(ops/engine.py), so its counts run on the host either way.  Locale
selects RU/EN help like the reference (ld_lite.py:64-67).
"""

__version__ = "V1.0-torch"


def main(argv=None) -> str:
    """Parse ``argv`` (default: sys.argv[1:]), run the query and print
    its table; returns the table."""
    from ld_tools_tpu_torch.utils.locale_detect import ui_language

    if ui_language() == "ru":
        from ld_tools_tpu_torch.cli.ld_lite_cli_ru import add_args_ru as add_args
    else:
        from ld_tools_tpu_torch.cli.ld_lite_cli_en import add_args_en as add_args
    args = add_args(__version__, argv)
    from ld_tools_tpu_torch.tools.lite import run

    table = run(args)
    print(table)
    return table


if __name__ == "__main__":
    main()
