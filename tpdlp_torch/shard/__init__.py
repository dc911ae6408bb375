"""Sharded solves over torch.distributed (counterpart of tpdlp/shard)."""

from tpdlp_torch.shard.launch import run_ranks
from tpdlp_torch.shard.mesh import (
    Mesh,
    Placement,
    gather_state,
    init_distributed,
    make_solver_mesh,
    pad_problem_arrays,
    pad_vectors,
    padded_sizes,
    padded_sizes_band,
    padded_sizes_sparse,
    placement,
    shard_device_problem,
    shard_state,
)

__all__ = [
    "Mesh",
    "Placement",
    "gather_state",
    "init_distributed",
    "make_solver_mesh",
    "pad_problem_arrays",
    "pad_vectors",
    "padded_sizes",
    "padded_sizes_band",
    "padded_sizes_sparse",
    "placement",
    "run_ranks",
    "shard_device_problem",
    "shard_state",
]
