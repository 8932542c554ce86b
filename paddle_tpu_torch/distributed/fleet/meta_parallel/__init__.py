"""The meta-parallel wrappers of the port (paddle_tpu/distributed/fleet/
meta_parallel): the pipeline (`PipelineLayer` and its descriptors,
`PipelineParallel`, `PipelineParallelWithInterleave`), `TensorParallel`,
`SegmentParallel` (sep 1) and `ShardingParallel`.  The tensor-parallel
layers are re-exported, as JAX's package does."""
from ..mp_layers import (ColumnParallelLinear,  # noqa: F401
                         ParallelCrossEntropy, RowParallelLinear,
                         VocabParallelEmbedding)
from .pipeline_parallel import (PipelineParallel,  # noqa: F401
                                PipelineParallelWithInterleave)
from .pp_layers import LayerDesc, PipelineLayer, SharedLayerDesc  # noqa: F401
from .segment_parallel import SegmentParallel  # noqa: F401
from .sharding_parallel import ShardingParallel  # noqa: F401
from .tensor_parallel import TensorParallel  # noqa: F401

__all__ = ["ColumnParallelLinear", "LayerDesc", "ParallelCrossEntropy",
           "PipelineLayer", "PipelineParallel",
           "PipelineParallelWithInterleave", "RowParallelLinear",
           "SegmentParallel", "ShardingParallel", "SharedLayerDesc",
           "TensorParallel", "VocabParallelEmbedding"]
