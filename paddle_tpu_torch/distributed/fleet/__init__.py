"""Fleet: the hybrid-parallel training facade of the port
(paddle_tpu/distributed/fleet): ``init``, ``distributed_model``,
``distributed_optimizer``, the tensor-parallel layers, ZeRO sharding
(``group_sharded_parallel``, `ShardingParallel`), the pipeline
(`PipelineLayer`, `LayerDesc`, `SharedLayerDesc`, `PipelineParallel`,
`PipelineParallelWithInterleave`), `TensorParallel`, `SegmentParallel`,
``recompute`` and `Fleet`, `Role`, `UtilBase`."""
from . import meta_parallel, mp_layers, sharding, utils
from .base import (DistributedStrategy, Fleet, HybridConfig,
                   PaddleCloudRoleMaker, Role, UserDefinedRoleMaker,
                   UtilBase, barrier_worker, distributed_model,
                   distributed_optimizer, init, is_first_worker,
                   worker_index, worker_num)
from .meta_parallel import (LayerDesc, PipelineLayer, PipelineParallel,
                            PipelineParallelWithInterleave, SegmentParallel,
                            ShardingParallel, SharedLayerDesc,
                            TensorParallel)
from .mp_layers import (ColumnParallelLinear, ColumnSequenceParallelLinear,
                        GatherOp, ParallelCrossEntropy, RowParallelLinear,
                        RowSequenceParallelLinear, ScatterOp,
                        VocabParallelEmbedding,
                        mark_as_sequence_parallel_parameter)
from .sharding import (DygraphShardingOptimizer, group_sharded_parallel,
                       save_group_sharded_model, shard_optimizer_states,
                       shard_parameters)
from ..topology import (CommunicateTopology, HybridCommunicateGroup,
                        get_hybrid_communicate_group,
                        set_hybrid_communicate_group)
from .utils import recompute

__all__ = ["ColumnParallelLinear", "ColumnSequenceParallelLinear",
           "CommunicateTopology", "DistributedStrategy",
           "DygraphShardingOptimizer", "Fleet", "GatherOp",
           "HybridCommunicateGroup", "HybridConfig", "LayerDesc",
           "PaddleCloudRoleMaker", "ParallelCrossEntropy", "PipelineLayer",
           "PipelineParallel", "PipelineParallelWithInterleave", "Role",
           "RowParallelLinear", "RowSequenceParallelLinear", "ScatterOp",
           "SegmentParallel", "ShardingParallel", "SharedLayerDesc",
           "TensorParallel", "UserDefinedRoleMaker", "UtilBase",
           "VocabParallelEmbedding",
           "barrier_worker", "distributed_model", "distributed_optimizer",
           "get_hybrid_communicate_group", "group_sharded_parallel", "init",
           "is_first_worker", "mark_as_sequence_parallel_parameter",
           "meta_parallel", "mp_layers", "recompute",
           "save_group_sharded_model", "set_hybrid_communicate_group",
           "shard_optimizer_states", "shard_parameters", "sharding",
           "utils", "worker_index", "worker_num"]
