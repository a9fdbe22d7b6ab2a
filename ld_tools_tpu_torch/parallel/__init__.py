from ld_tools_tpu_torch.parallel.sweep import (
    all_pairs_replicated,
    all_pairs_ring,
    all_pairs_trapezoid,
    make_mesh,
)

__all__ = [
    "make_mesh",
    "all_pairs_replicated",
    "all_pairs_ring",
    "all_pairs_trapezoid",
]
