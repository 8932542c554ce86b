"""The meta-parallel wrappers of the port (paddle_tpu/distributed/fleet/
meta_parallel): `ShardingParallel`; the pipeline, segment and tensor
wrappers are not ported (ROADMAP A8).  The tensor-parallel layers are
re-exported, as JAX's package does."""
from ..mp_layers import (ColumnParallelLinear,  # noqa: F401
                         ParallelCrossEntropy, RowParallelLinear,
                         VocabParallelEmbedding)
from .sharding_parallel import ShardingParallel  # noqa: F401

__all__ = ["ColumnParallelLinear", "ParallelCrossEntropy",
           "RowParallelLinear", "ShardingParallel", "VocabParallelEmbedding"]
