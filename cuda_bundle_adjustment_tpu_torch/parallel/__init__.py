"""Bundle adjustment across ``torch.distributed`` ranks (``distributed.py``)."""

from .distributed import (
    RankSolver,
    ShardedProblem,
    distributed_optimize,
    gather_landmarks,
    make_distributed_lm_step,
    make_distributed_optimize_fused,
    make_distributed_update_edges,
    shard_problem,
)

__all__ = [
    "RankSolver",
    "ShardedProblem",
    "distributed_optimize",
    "gather_landmarks",
    "make_distributed_lm_step",
    "make_distributed_optimize_fused",
    "make_distributed_update_edges",
    "shard_problem",
]
