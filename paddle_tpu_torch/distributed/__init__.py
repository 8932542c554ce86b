"""Distributed training of the port (paddle_tpu/distributed): the
process-group environment (`env`), the collectives (`collective`) under
the hang and failure guardian (`watchdog`: the collective watchdog, the
cross-rank error trap, the desync check; `host_collectives`, the store
lane), the launcher (`launch`: ``python -m
paddle_tpu_torch.distributed.launch``, the restart and quarantine loop)
and `spawn`, the mesh, placements and hybrid topology, `DataParallel`,
``fleet`` (init, distributed_model, the tensor-parallel layers,
``recompute``, ``elastic``: `ElasticManager` and `PreemptionHandler`),
and the serving fleet's transports: the rpc plane (`rpc`) and the
key-value stores (`store`: `TCPStore` over ``csrc/tcp_store.cpp``,
`FileKVStore`, `TCPElasticStore`)."""
from . import env, watchdog  # noqa: E402,F401
from .collective import (Group, P2POp, ReduceOp, all_gather, all_reduce,
                         all_to_all, barrier, batch_isend_irecv, broadcast,
                         get_group, irecv, isend, new_group, recv, reduce,
                         reduce_scatter, scatter, send)
from .env import (ParallelEnv, device_count, get_rank, get_world_size,
                  init_parallel_env, is_initialized, local_device_count)
from .mesh import ProcessMesh, get_mesh, init_mesh, set_mesh
from .parallel import DataParallel
from .placement import Partial, Placement, Replicate, Shard
from .topology import (HybridCommunicateGroup, get_hybrid_communicate_group,
                       set_hybrid_communicate_group)
from .watchdog import (CollectiveTimeoutError, DesyncError, GuardianError,
                       PeerFailureError)
from . import fleet  # noqa: E402,F401
from . import launch  # noqa: E402,F401
from . import spawn as spawn_mod  # noqa: E402,F401
from .spawn import spawn  # noqa: E402,F401

__all__ = ["CollectiveTimeoutError", "DataParallel", "DesyncError",
           "Group", "GuardianError", "HybridCommunicateGroup", "P2POp",
           "PeerFailureError",
           "ParallelEnv", "Partial", "Placement", "ProcessMesh", "ReduceOp",
           "Replicate", "Shard", "all_gather", "all_reduce", "all_to_all",
           "barrier", "batch_isend_irecv", "broadcast", "device_count",
           "env", "fleet", "get_group", "get_hybrid_communicate_group",
           "get_mesh", "get_rank", "get_world_size", "init_mesh",
           "init_parallel_env", "irecv", "is_initialized", "isend",
           "local_device_count", "new_group", "recv", "reduce",
           "reduce_scatter", "scatter", "send", "set_hybrid_communicate_group",
           "set_mesh", "spawn", "watchdog"]
