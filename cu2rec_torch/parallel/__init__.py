"""Multi-device training over a (dp × ip) grid of ``torch.distributed``
ranks: the sharded SGD engine, sharded BPR, the launcher."""

from cu2rec_torch.parallel.sharded import (  # noqa: F401
    Mesh, ShardedEngine, ShardedRatings, make_mesh, pad_model,
    shard_ratings, trim_model,
)

__all__ = ["Mesh", "ShardedEngine", "ShardedRatings", "make_mesh",
           "pad_model", "shard_ratings", "trim_model"]
