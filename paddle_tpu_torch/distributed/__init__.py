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
`FileKVStore`, `TCPElasticStore`), and sharded checkpoints with the
elastic reshard (`checkpoint`, `reshard`); `compat`: the object
collectives, `alltoall`, `gather`, the backend calls and the gloo shims
(its `isend` / `irecv` return a task, as JAX's exports do);
`functional`: the collectives as differentiable ops over a mesh axis's
group; `context_parallel`: ring attention and Ulysses over the sep
axis."""
from . import env, functional, watchdog  # noqa: E402,F401
from .collective import (Group, P2POp, ReduceOp, all_gather, all_reduce,
                         all_to_all, barrier, batch_isend_irecv, broadcast,
                         get_group, irecv, isend, new_group, recv, reduce,
                         reduce_scatter, scatter, send)
from .env import (ParallelEnv, device_count, get_rank, get_world_size,
                  init_parallel_env, is_initialized, local_device_count)
from .mesh import ProcessMesh, get_mesh, init_mesh, set_mesh
from .parallel import DataParallel
from .placement import (Partial, Placement, Replicate, Shard,
                        placements_to_spec, spec_to_placements)
from .api import (dtensor_from_fn, reshard, shard_constraint, shard_layer,
                  shard_tensor, unshard_dtensor)
from .topology import (HybridCommunicateGroup, get_hybrid_communicate_group,
                       set_hybrid_communicate_group)
from .watchdog import (CollectiveTimeoutError, DesyncError, GuardianError,
                       PeerFailureError)
from . import checkpoint  # noqa: E402,F401
from .checkpoint import (CheckpointManager, DistributedSaver,  # noqa: E402
                         load_state_dict, restore_latest, save_checkpoint,
                         save_state_dict)
from .reshard import (LayoutError, LayoutMismatchError,  # noqa: E402
                      MeshSpec, ShardedCheckpointer, offer_shards,
                      restore_latest_resharded, restore_resharded)
# importing .reshard rebinds this package's `reshard` to the module; the
# public distributed.reshard(tensor, mesh, placements) stays the move (the
# module imports by its path, through sys.modules), as in JAX
from .api import reshard  # noqa: E402,F811
from . import fleet  # noqa: E402,F401
from . import launch  # noqa: E402,F401
from . import spawn as spawn_mod  # noqa: E402,F401
from .spawn import spawn  # noqa: E402,F401
from . import compat  # noqa: E402,F401
from . import context_parallel  # noqa: E402,F401
from .context_parallel import (ring_flash_attention,  # noqa: E402,F401
                               split_sequence, ulysses_attention)
from .compat import (  # noqa: E402,F401
    CountFilterEntry, DistAttr, ParallelMode, ProbabilityEntry,
    ShowClickEntry, all_gather_object, alltoall, alltoall_single,
    broadcast_object_list, destroy_process_group, gather, get_backend,
    gloo_barrier, gloo_init_parallel_env, gloo_release, irecv, is_available,
    isend, scatter_object_list, split, wait)

__all__ = ["CheckpointManager", "CollectiveTimeoutError", "DataParallel",
           "DesyncError", "DistributedSaver",
           "Group", "GuardianError", "HybridCommunicateGroup",
           "LayoutError", "LayoutMismatchError", "MeshSpec", "P2POp",
           "PeerFailureError", "ShardedCheckpointer", "checkpoint",
           "load_state_dict", "offer_shards", "restore_latest",
           "restore_latest_resharded", "restore_resharded",
           "save_checkpoint", "save_state_dict",
           "ParallelEnv", "Partial", "Placement", "ProcessMesh", "ReduceOp",
           "Replicate", "Shard", "all_gather", "all_reduce", "all_to_all",
           "barrier", "batch_isend_irecv", "broadcast", "context_parallel",
           "device_count",
           "env", "fleet", "functional", "get_group",
           "get_hybrid_communicate_group",
           "get_mesh", "get_rank", "get_world_size", "init_mesh",
           "init_parallel_env", "irecv", "is_initialized", "isend",
           "local_device_count", "new_group", "recv", "reduce",
           "reduce_scatter", "ring_flash_attention", "scatter", "send",
           "set_hybrid_communicate_group", "split_sequence",
           "ulysses_attention",
           "set_mesh", "spawn", "watchdog", "dtensor_from_fn",
           "placements_to_spec", "shard_constraint", "shard_layer",
           "shard_tensor", "spec_to_placements", "unshard_dtensor",
           "CountFilterEntry", "DistAttr", "ParallelMode", "ProbabilityEntry",
           "ShowClickEntry", "all_gather_object", "alltoall",
           "alltoall_single", "broadcast_object_list", "compat",
           "destroy_process_group", "gather", "get_backend", "gloo_barrier",
           "gloo_init_parallel_env", "gloo_release", "is_available",
           "scatter_object_list", "split", "wait"]
