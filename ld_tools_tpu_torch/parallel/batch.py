"""Multi-chromosome batch scheduling across processes: the counterpart of
ld_tools_tpu/parallel/batch.py.

Chromosome-level data parallelism: each process takes a round-robin slice
of the chromosome list and runs its sweeps on its own card, with no
traffic between processes (results land in per-chromosome files).  Under
an initialised ``torch.distributed`` process group the slice follows the
rank; a single process takes the whole list.
"""

from __future__ import annotations

from ld_tools_tpu_torch.utils.logging import get_logger

log = get_logger("parallel.batch")


def chromosomes_for_this_process(chroms) -> list:
    """Round-robin slice of the chromosome list for this process.

    Single-process runs get the whole list; under an initialised
    ``torch.distributed`` group the work splits by rank.  Round-robin
    (not a contiguous split) balances the very different chromosome
    sizes.
    """
    import torch.distributed as dist

    chroms = list(chroms)
    if not (dist.is_available() and dist.is_initialized()):
        return chroms
    n = dist.get_world_size()
    if n <= 1:
        return chroms
    k = dist.get_rank()
    mine = chroms[k::n]
    log.info("process %d/%d takes chromosomes %s", k, n, mine)
    return mine
