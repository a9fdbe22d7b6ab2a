"""ld_scan entry point of the port: whole-chromosome all-pairs LD threshold
scan on the GPU.

    python -m ld_tools_tpu_torch.ld_scan -C 21 -D <data dir> -t <out dir> -z 0.8

``-E cuda`` (the default) runs the hand-written kernels on the card;
``-E torch`` runs their plain PyTorch versions on the CPU.  ``-d N``
shards each scan over N local devices, ``-k <dir>`` keeps per-batch
checkpoints to resume from, and under ``torchrun`` (gloo) the processes
scan one chromosome together:

    torchrun --nproc_per_node 2 -m ld_tools_tpu_torch.ld_scan -C 21 ...

Run as a module it prints its kernel launch counts as one JSON line on
stderr at the end.
"""

__version__ = "V1.0-torch"


def main(argv=None):
    """Parse ``argv`` (default: sys.argv[1:]) and run the scan; returns
    the per-chromosome ScanReports."""
    from ld_tools_tpu_torch.cli.ld_scan_cli import add_args_en, add_args_ru
    from ld_tools_tpu_torch.utils.locale_detect import ui_language

    add_args = add_args_ru if ui_language() == "ru" else add_args_en
    args = add_args(__version__, argv)
    from ld_tools_tpu_torch.tools.scan import run

    return run(args)


if __name__ == "__main__":
    main()
    from ld_tools_tpu_torch.bench.common import log_launches

    log_launches()
