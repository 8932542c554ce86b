"""The rpc plane of the port (`rpc`)."""
from .rpc import (  # noqa: F401
    RAW_THRESHOLD, Blob, init_rpc, rpc_sync, rpc_async, shutdown,
    get_worker_info, get_all_worker_infos, get_current_worker_info,
    WorkerInfo, RpcServer, connect_worker, forget_worker,
)
