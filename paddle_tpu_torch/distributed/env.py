"""The distributed environment (port of paddle_tpu/distributed/env.py):
one process per rank over a ``torch.distributed`` process group.

``init_parallel_env(backend=None, device=None)`` reads the JAX package's
variables: the master address from ``PADDLE_MASTER`` (``host:port``; or
``MASTER_ADDR`` and ``MASTER_PORT``), the world size from
``PADDLE_TRAINERS_NUM`` or ``WORLD_SIZE``, the rank from
``PADDLE_TRAINER_ID`` or ``RANK``; the caller may pass ``init_method``,
``world_size`` and ``rank`` instead.  ``backend=None`` means ``"nccl"``
with local rank r on ``cuda:r`` (the local rank from ``LOCAL_RANK`` or
``PADDLE_LOCAL_RANK``, else the rank).  Nothing falls back on its own:

- without CUDA, ``nccl`` raises; the CPU tests ask for ``"gloo"``;
- with fewer cards than local ranks, the default device raises; a caller
  that names ``device`` explicitly may put several ranks on one card.
  NCCL refuses two ranks on one device, so ranks that share a card get
  NCCL's socket transport on the loopback interface, each with a host id
  of its own (`one_card_nccl_env`), before the communicator exists.
  Ranks share a card only when ``device`` is named and this host runs
  more ranks than it has cards: the host's ranks from ``LOCAL_WORLD_SIZE``
  or ``PADDLE_LOCAL_SIZE`` (a job over several hosts sets one), else the
  whole world (one host).  A rank a card keeps NCCL's own transports
  (and NCCL refuses two ranks named onto one card of a host that has a
  card for each).

A world of one needs no master: its group lives in a ``HashStore``.
With ``device`` None, ``FLAGS_selected_gpus`` (a card index, which the
launcher exports when this host's ranks outnumber its cards) names the
card as an explicit ``device`` would.

**The hang guardian** (`distributed.watchdog`) is armed by the launch
contract: the guardian store ``PADDLE_GUARDIAN_DIR`` or
``PADDLE_GUARDIAN_STORE`` (the launcher exports one to every rank), or
``FLAGS_collective_timeout_s`` above 0.  Armed, `init_parallel_env`
installs the error trap (and its ``sys.excepthook`` chain) before the
first collective, and keeps torch's own NCCL error handling from
deciding first, so that the guardian, not torch, sets the exit code
(101 after a peer's failure, 107 after a timeout):

- ``TORCH_NCCL_ASYNC_ERROR_HANDLING=0`` unless the caller set it: torch's
  NCCL watchdog otherwise tears the process down with SIGABRT when the
  socket transport sees a dead peer's connection close, or when an op
  outlives the group's timeout, racing the guardian's poll;
- the process group's ``timeout``, when the caller passes none, is the
  larger of torch's default (1800 s gloo, 600 s NCCL) and four times
  ``FLAGS_collective_timeout_s``: a gloo op blocked past it raises in C,
  which must come after the guardian's abort.
"""
from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

_state = {"initialized": False, "device": None, "local_rank": 0}


def one_card_nccl_env(rank):
    """NCCL's environment for a rank that shares its card with other
    ranks: a host id of its own (NCCL then sees one GPU on each "host",
    not a duplicate) and the socket transport on ``lo``; no InfiniBand,
    no NVLink SHARP (one card has no NVSwitch)."""
    return {"NCCL_HOSTID": f"paddle-tpu-torch-rank-{rank}",
            "NCCL_SOCKET_IFNAME": "lo", "NCCL_IB_DISABLE": "1",
            "NCCL_NVLS_ENABLE": "0"}


def _env_int(*names, default=None):
    for name in names:
        val = os.environ.get(name)
        if val not in (None, ""):
            return int(val)
    return default


def _master():
    addr = os.environ.get("PADDLE_MASTER") or \
        os.environ.get("COORDINATOR_ADDRESS")
    if addr:
        return addr
    host, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
    return f"{host}:{port}" if host and port else None


def init_parallel_env(coordinator_address=None, num_processes=None,
                      process_id=None, *, backend=None, device=None,
                      init_method=None, world_size=None, rank=None,
                      timeout=None):
    """Join the process group (once; a later call returns the same
    `ParallelEnv`).  JAX's ``coordinator_address`` (``host:port``),
    ``num_processes`` and ``process_id`` are the master, the world size and
    the rank, as ``init_method="tcp://host:port"``, ``world_size`` and
    ``rank`` (naming a fact both ways raises).  ``timeout`` in seconds
    (None: torch's default)."""
    for jax_name, val, name, other in (
            ("coordinator_address", coordinator_address, "init_method",
             init_method),
            ("num_processes", num_processes, "world_size", world_size),
            ("process_id", process_id, "rank", rank)):
        if val is not None and other is not None:
            raise ValueError(f"init_parallel_env: pass {jax_name} or {name},"
                             " not both")
    if coordinator_address is not None:
        init_method = f"tcp://{coordinator_address}"
    if num_processes is not None:
        world_size = int(num_processes)
    if process_id is not None:
        rank = int(process_id)
    if _state["initialized"] or (dist.is_available()
                                 and dist.is_initialized()):
        _state["initialized"] = True
        return ParallelEnv()
    world = world_size if world_size is not None else _env_int(
        "PADDLE_TRAINERS_NUM", "WORLD_SIZE", default=1)
    rank = rank if rank is not None else _env_int(
        "PADDLE_TRAINER_ID", "RANK", default=0)
    backend = backend or "nccl"
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError("init_parallel_env: CUDA is not available for "
                           "the nccl backend; pass backend='gloo' to run "
                           "the ranks on the CPU")
    local = _env_int("LOCAL_RANK", "PADDLE_LOCAL_RANK", default=rank)
    selected = _env_int("FLAGS_selected_gpus")
    if device is None and selected is not None and backend == "nccl":
        device = torch.device("cuda", selected)
    named = device is not None
    if device is None:
        if backend == "nccl":
            if local >= torch.cuda.device_count():
                raise RuntimeError(
                    f"init_parallel_env: local rank {local} has no card of "
                    f"its own ({torch.cuda.device_count()} visible); name "
                    "`device` to put several ranks on one card")
            device = torch.device("cuda", local)
        else:
            device = torch.device("cpu")
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
        if backend == "nccl" and named and _env_int(
                "LOCAL_WORLD_SIZE", "PADDLE_LOCAL_SIZE",
                default=world) > torch.cuda.device_count():
            for key, val in one_card_nccl_env(rank).items():
                os.environ.setdefault(key, val)
    armed = _guardian_armed()
    if armed and timeout is None:
        timeout = max(1800.0 if backend == "gloo" else 600.0,
                      4 * _guardian_timeout())
    if armed and backend == "nccl":
        os.environ.setdefault("TORCH_NCCL_ASYNC_ERROR_HANDLING", "0")
    kw = {}
    if timeout is not None:
        kw["timeout"] = datetime.timedelta(seconds=float(timeout))
    if backend == "nccl":
        kw["device_id"] = device
    if init_method is None and world == 1:
        kw["store"] = dist.HashStore()
    elif init_method is None:
        master = _master()
        if master is None:
            raise RuntimeError(
                f"init_parallel_env: a world of {world} needs a master "
                "(PADDLE_MASTER=host:port, MASTER_ADDR/MASTER_PORT or "
                "init_method=)")
        init_method = f"tcp://{master}"
    if init_method is not None:
        kw["init_method"] = init_method
    dist.init_process_group(backend, world_size=world, rank=rank, **kw)
    _state.update(initialized=True, device=device, local_rank=local)
    if armed:
        from . import watchdog
        watchdog.get_watchdog()      # the trap and its excepthook, now
    return ParallelEnv()


def _guardian_timeout():
    from ..utils.flags import flag
    try:
        return float(flag("FLAGS_collective_timeout_s", 0) or 0)
    except (TypeError, ValueError):
        return 0.0


def _guardian_armed():
    """Whether the launch contract or the flags arm the hang guardian."""
    return bool(os.environ.get("PADDLE_GUARDIAN_STORE")
                or os.environ.get("PADDLE_GUARDIAN_DIR")
                or _guardian_timeout() > 0)


def get_rank(group=None):
    """This process's rank: the process group's when it is initialised,
    else 0; with ``group``, the rank within it (-1 outside it)."""
    if not (dist.is_available() and dist.is_initialized()):
        return 0
    if group is not None:
        return group.rank
    return dist.get_rank()


def get_world_size(group=None):
    """The number of ranks (of ``group``): 1 without a process group."""
    if group is not None:
        return group.nranks
    return dist.get_world_size() if dist.is_available() and \
        dist.is_initialized() else 1


def device_count():
    """The ranks of the world: one device each, as JAX's
    ``jax.device_count()`` counts a process's chip."""
    return get_world_size()


def local_device_count():
    """The cards this process sees (1 without CUDA: the CPU)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 1


def is_initialized():
    return _state["initialized"] or (dist.is_available()
                                     and dist.is_initialized())


def current_device():
    """The rank's device: the one `init_parallel_env` bound, else the
    card (CPU without CUDA)."""
    if _state["device"] is not None:
        return _state["device"]
    return torch.device("cuda") if torch.cuda.is_available() \
        else torch.device("cpu")


class ParallelEnv:
    """reference: paddle.distributed.ParallelEnv."""

    @property
    def rank(self):
        return get_rank()

    @property
    def world_size(self):
        return get_world_size()

    @property
    def dev_id(self):
        dev = _state["device"]
        return dev.index if dev is not None and dev.index is not None else 0

    @property
    def device(self):
        return current_device()

    @property
    def nranks(self):
        return get_world_size()

    @property
    def local_rank(self):
        return _state["local_rank"]
