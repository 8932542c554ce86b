"""Fleet: the hybrid-parallel training facade of the port
(paddle_tpu/distributed/fleet): ``init``, ``distributed_model``,
``distributed_optimizer``, the tensor-parallel layers, ``recompute``."""
from . import mp_layers, utils
from .base import (DistributedStrategy, HybridConfig, PaddleCloudRoleMaker,
                   UserDefinedRoleMaker, barrier_worker, distributed_model,
                   distributed_optimizer, init, is_first_worker,
                   worker_index, worker_num)
from .mp_layers import (ColumnParallelLinear, ColumnSequenceParallelLinear,
                        GatherOp, ParallelCrossEntropy, RowParallelLinear,
                        RowSequenceParallelLinear, ScatterOp,
                        VocabParallelEmbedding,
                        mark_as_sequence_parallel_parameter)
from ..topology import (CommunicateTopology, HybridCommunicateGroup,
                        get_hybrid_communicate_group,
                        set_hybrid_communicate_group)
from .utils import recompute

__all__ = ["ColumnParallelLinear", "ColumnSequenceParallelLinear",
           "CommunicateTopology", "DistributedStrategy", "GatherOp",
           "HybridCommunicateGroup", "HybridConfig", "PaddleCloudRoleMaker",
           "ParallelCrossEntropy", "RowParallelLinear",
           "RowSequenceParallelLinear", "ScatterOp", "UserDefinedRoleMaker",
           "VocabParallelEmbedding", "barrier_worker", "distributed_model",
           "distributed_optimizer", "get_hybrid_communicate_group", "init",
           "is_first_worker", "mark_as_sequence_parallel_parameter",
           "mp_layers", "recompute", "set_hybrid_communicate_group",
           "utils", "worker_index", "worker_num"]
