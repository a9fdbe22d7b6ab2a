"""ld_lite: LD + distance for one variant pair, printed as a nested table
(port of ld_tools_tpu/tools/lite.py).

Both variants' cohort haplotype rows come from the packed store and the
LD values from the engine's counts (ops/engine.py), finished bit-exactly
on the host.  One pair is far below the engine's host cutoff, so it never
touches the card; ``-E cuda`` (the default) still raises without one.
``tabulate`` is imported by the render step only, so the engine path
imports without it.
"""

from __future__ import annotations

from ld_tools_tpu_torch.ops.engine import mixed_pair_ld
from ld_tools_tpu_torch.tools.common import (
    DataConfig,
    NotInIntgenConvDbError,
    lookup_pair,
    variant_annotations,
)


def run(args) -> str:
    """Execute the pair query; returns the rendered table (also printed
    by the CLI entry point)."""
    return render(**pair_query(args))


def pair_query(args) -> dict:
    """The pair's values and annotations, the keyword arguments of
    :func:`render`: everything but the table."""
    from ld_tools_tpu_torch.utils.device import engine_device, resolve_device

    device = engine_device(getattr(args, "engine", "cuda"))
    resolve_device(device)  # no card for -E cuda: fail before prep
    config = DataConfig.resolve(
        args.intgen_dir_path,
        args.skip_intgen_data_ver,
        args.gend_names,
        args.pop_names,
    )
    (chrom, var_1_pos), (_, var_2_pos) = lookup_pair(
        config.intgen_convdb_path, args.rs_id_1, args.rs_id_2
    )

    chrom_data = config.store().chrom(chrom)
    row_1 = chrom_data.row_of(args.rs_id_1)
    row_2 = chrom_data.row_of(args.rs_id_2)
    if row_1 is None:
        raise NotInIntgenConvDbError(args.rs_id_1)
    if row_2 is None:
        raise NotInIntgenConvDbError(args.rs_id_2)
    var_1_alleles, var_1_type = variant_annotations(chrom_data, row_1)
    var_2_alleles, var_2_type = variant_annotations(chrom_data, row_2)

    # Ploidy-aware pair LD: on autosomes this is the plain cohort-column
    # count matmul; on chrX/chrY the two variants' profiles may differ
    # (PAR vs non-PAR) and the mixed engine truncates to the shorter
    # genotype list exactly like the reference (calc_ld.py:30-33).
    cp = chrom_data.cohort_ploidy(config.sample_names)
    exact = mixed_pair_ld(chrom_data, cp, [row_1], [row_2], device)
    return dict(rs_id_1=args.rs_id_1, rs_id_2=args.rs_id_2, chrom=chrom,
                var_1_pos=var_1_pos, var_2_pos=var_2_pos,
                var_1_alleles=var_1_alleles, var_2_alleles=var_2_alleles,
                var_1_type=var_1_type, var_2_type=var_2_type,
                trg_vals=exact.pair(0, 0))


def render(rs_id_1, rs_id_2, chrom, var_1_pos, var_2_pos, var_1_alleles,
           var_2_alleles, var_1_type, var_2_type, trg_vals) -> str:
    """The nested fancy_grid table of one pair."""
    from tabulate import tabulate

    # Nested fancy_grid layout of reference ld_lite.py:148-159: the LD
    # values + distance render as a sub-table in the corner header cell.
    table = tabulate(
        [
            ["chrom", chrom, chrom],
            ["hg38_pos", var_1_pos, var_2_pos],
            ["alleles", var_1_alleles, var_2_alleles],
            ["type", var_1_type, var_2_type],
            [
                "alt_freq",
                trg_vals["var_1_alt_freq"],
                trg_vals["var_2_alt_freq"],
            ],
        ],
        headers=[
            tabulate(
                [
                    ["r2", trg_vals["r_square"]],
                    ["D'", trg_vals["d_prime"]],
                    ["abs_dist", abs(var_1_pos - var_2_pos)],
                ],
                tablefmt="fancy_grid",
                disable_numparse=True,
            ),
            f"\n\n\n{rs_id_1}",
            f"\n\n\n{rs_id_2}",
        ],
        tablefmt="fancy_grid",
    )
    return table
