"""Distributed utilities of the port (paddle_tpu/distributed):
``fleet.utils.recompute``, ``fleet.elastic.PreemptionHandler``, the
watchdog's thread helpers (``watchdog.async_raise``,
``watchdog.all_thread_stacks``), the rank and world size the input
pipeline and ``hapi.Model`` read, and the serving fleet's transports:
the rpc plane (`rpc`) and the key-value stores (`store`: `TCPStore` over
``csrc/tcp_store.cpp``, `FileKVStore`, `TCPElasticStore`)."""
from . import fleet, watchdog  # noqa: E402,F401


def get_rank(group=None):
    """This process's rank: ``torch.distributed``'s when it is
    initialised, else 0."""
    import torch.distributed as dist
    return dist.get_rank() if dist.is_available() and \
        dist.is_initialized() else 0


def get_world_size(group=None):
    """The number of processes: ``torch.distributed``'s when it is
    initialised, else 1."""
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_available() and \
        dist.is_initialized() else 1
