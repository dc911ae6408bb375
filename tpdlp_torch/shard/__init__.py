"""Sharded solves over torch.distributed (counterpart of tpdlp/shard)."""

from tpdlp_torch.shard.launch import run_ranks
from tpdlp_torch.shard.mesh import (
    Mesh,
    init_distributed,
    make_solver_mesh,
    pad_problem_arrays,
    pad_vectors,
    padded_sizes,
    padded_sizes_band,
    padded_sizes_sparse,
    shard_device_problem,
    shard_state,
)

__all__ = [
    "Mesh",
    "init_distributed",
    "make_solver_mesh",
    "pad_problem_arrays",
    "pad_vectors",
    "padded_sizes",
    "padded_sizes_band",
    "padded_sizes_sparse",
    "run_ranks",
    "shard_device_problem",
    "shard_state",
]
