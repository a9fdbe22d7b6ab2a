"""Multi-process initialisation: the counterpart of
ld_tools_tpu/utils/distributed.py over torch.distributed.

Every process of a launcher (``torchrun``, or the four variables set by
hand) calls ``initialize_if_needed()``; the group is gloo on the card as
on the CPU.  What crosses processes is host data (a cooperative scan's
hits, ``ops/ld_stream._allgather_hits``), and NCCL refuses two ranks on
one card, which is how a one-card machine runs a cooperative scan.  The
kernels still run on each process's own card (:func:`local_device`).
"""

from __future__ import annotations

import datetime
import os

import torch

from ld_tools_tpu_torch.utils.logging import get_logger

log = get_logger("utils.distributed")

# torchrun's variables; all four or none
_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def initialize_if_needed() -> bool:
    """Join the torch.distributed group the launcher's variables describe.

    Returns True once a group is initialised (here or before).  With none
    of ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK`` set
    it does nothing and returns False; with only some of them it warns,
    as the JAX helper does, and stays single-process.
    ``$TPU_LD_DIST_TIMEOUT_S`` (default 600) bounds every collective, so a
    process whose peer died does not wait for ever.
    """
    import torch.distributed as dist

    if dist.is_initialized():
        return True
    provided = {k: os.environ.get(k) for k in _ENV}
    missing = [k for k, v in provided.items() if not v]
    if missing:
        if len(missing) < len(provided):
            # some variables set is a multi-process intent: N independent
            # full runs must not look like a deliberate single-process run
            log.warning(
                "partial torch.distributed configuration: %s missing; "
                "running single-process; set all of %s (or none)",
                ", ".join(missing), "/".join(_ENV),
            )
        return False
    timeout_s = float(os.environ.get("TPU_LD_DIST_TIMEOUT_S", "600"))
    world, rank = int(provided["WORLD_SIZE"]), int(provided["RANK"])
    dist.init_process_group(
        "gloo",
        init_method=f"tcp://{provided['MASTER_ADDR']}:{provided['MASTER_PORT']}",
        world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    log.info("torch.distributed initialised: process %d/%d (gloo) via %s:%s",
             rank, world, provided["MASTER_ADDR"], provided["MASTER_PORT"])
    return True


def process_count() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def local_device(device):
    """This process's card under a multi-process launcher,
    ``cuda:(LOCAL_RANK % device_count)``, for a CUDA ``device`` when
    ``WORLD_SIZE`` > 1; else None (the process may use every card)."""
    if torch.device(device).type != "cuda":
        return None
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return None
    local = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", local % torch.cuda.device_count())
