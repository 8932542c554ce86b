"""Collective communication (port of paddle_tpu/distributed/collective.py)
over ``torch.distributed`` process groups.

A rank is a process (`distributed.env.init_parallel_env`), and a `Group`
an ordered subset of the world's ranks backed by a torch process group:
NCCL on the card, gloo on the CPU.  The JAX module runs each collective
as a small cross-process XLA program or, where the backend cannot, on a
host lane through its store (``FLAGS_collective_backend``); here the
process group is the one lane, so that flag has nothing to select and
is not read.

Every call takes the JAX package's argument names and its semantics: a
collective updates its tensor in place and returns it; a group of one
rank returns at once (send/recv queue their payload, as JAX's do);
``ReduceOp.AVG`` of an integer tensor gives float32 (``_np_reduce``'s
rule), rebinding the tensor's data.  Each call adds one to
``dist.collective_calls{op}`` on the registry, and to
``dist.collective_bytes{op}`` the bytes this rank contributes.  A call
inside a CUDA graph capture counts once, at the capture: the replays run
the collective without Python.

`new_group` is collective, as torch's: every rank of the world calls it,
with the same ranks, in the same order.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from . import env as _env


class ReduceOp:
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    PROD = "prod"
    AVG = "avg"


_TORCH_OPS = {ReduceOp.SUM: "SUM", ReduceOp.MAX: "MAX", ReduceOp.MIN: "MIN",
              ReduceOp.PROD: "PRODUCT", ReduceOp.AVG: "SUM"}


def _torch_op(op):
    try:
        return getattr(dist.ReduceOp, _TORCH_OPS[op])
    except KeyError:
        raise ValueError(f"unknown ReduceOp {op!r}") from None


class Group:
    """An ordered subset of the world's ranks (reference:
    communication/group.py) with its torch process group (None: the
    world's default group, or a group of one)."""

    _next_id = 0

    def __init__(self, ranks, process_group=None):
        self.ranks = list(ranks)
        self.nranks = len(self.ranks)
        self.process_group = process_group
        self.id = Group._next_id
        Group._next_id += 1

    @property
    def world_size(self):
        return self.nranks

    @property
    def rank(self):
        """This process's rank within the group, or -1 if not a member."""
        try:
            return self.ranks.index(_env.get_rank())
        except ValueError:
            return -1

    def get_group_rank(self, global_rank):
        return self.ranks.index(global_rank)

    def __repr__(self):
        return f"Group(id={self.id}, ranks={self.ranks})"


_default = {"group": None, "world": None}


def _get_default_group() -> Group:
    world = _env.get_world_size()
    if _default["group"] is None or _default["world"] != world:
        _default.update(group=Group(list(range(world))), world=world)
    return _default["group"]


def new_group(ranks=None, backend=None, timeout=None) -> Group:
    """A group over ``ranks`` (None: the world), sorted as JAX's.
    Collective: every rank of the world calls it alike."""
    world = _env.get_world_size()
    ranks = sorted(range(world) if ranks is None else ranks)
    if any(not 0 <= r < world for r in ranks):
        raise ValueError(f"new_group: ranks {ranks} outside the world of "
                         f"{world}")
    pg = None
    if len(ranks) > 1 and len(ranks) < world:
        kw = {} if timeout is None else {"timeout": timeout}
        pg = dist.new_group(ranks, backend=backend, **kw)
    return Group(ranks, pg)


def get_group(gid=0):
    return _get_default_group()


_COUNTERS = {}


def _count(op, tensor=None):
    """``dist.collective_calls{op}`` (JAX's `_count_collective`) and the
    port's ``dist.collective_bytes{op}``."""
    if not _COUNTERS:
        from ..observability import registry as _metrics
        _COUNTERS["calls"] = _metrics.counter(
            "dist.collective_calls", "collective ops issued",
            labelnames=("op",))
        _COUNTERS["bytes"] = _metrics.counter(
            "dist.collective_bytes", "bytes a rank contributes to its "
            "collectives", labelnames=("op",))
    _COUNTERS["calls"].labels(op=op).inc()
    if tensor is not None:
        _COUNTERS["bytes"].labels(op=op).inc(
            tensor.numel() * tensor.element_size())


def _resolve(group):
    group = group or _get_default_group()
    if group.nranks > 1 and group.rank < 0:
        raise ValueError(
            f"process rank {_env.get_rank()} is not a member of {group}; "
            "collectives must only be called by group members (reference: "
            "ProcessGroup membership contract, process_group.h:53)")
    return group


def _set(tensor, value):
    """Rebind ``tensor``'s data to ``value`` (a dtype change: AVG of
    integers)."""
    if value.dtype == tensor.dtype:
        tensor.copy_(value)
    else:
        tensor.data = value
    return tensor


_all_gather_single = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_reduce_scatter_single = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


def all_reduce(tensor, op=ReduceOp.SUM, group=None, sync_op=True):
    """In-place all-reduce of ``tensor`` across the group (reference:
    communication/all_reduce.py)."""
    _count("all_reduce", tensor)
    group = _resolve(group)
    if group.nranks <= 1:
        if op == ReduceOp.AVG and not tensor.is_floating_point():
            _set(tensor, tensor.float())
        return tensor
    avg_int = op == ReduceOp.AVG and not tensor.is_floating_point()
    buf = tensor.double() if avg_int else tensor
    dist.all_reduce(buf, op=_torch_op(op), group=group.process_group)
    if op == ReduceOp.AVG:
        if avg_int:
            return _set(tensor, (buf / group.nranks).float())
        buf.div_(group.nranks)
    return tensor


def all_gather(tensor_list, tensor, group=None, sync_op=True, axis=0):
    """Gather ``tensor`` from every rank into ``tensor_list`` (returned;
    a new list when None), one part a rank in group order (reference:
    communication/all_gather.py).  ``axis`` is JAX's argument, unused
    there too: the parts are the list's items (`all_gather_concat`
    joins them)."""
    _count("all_gather", tensor)
    group = _resolve(group)
    out = [] if tensor_list is None else tensor_list
    if group.nranks <= 1:
        out.append(tensor.clone())
        return out
    src = tensor.contiguous().unsqueeze(0)
    stacked = torch.empty((group.nranks,) + tuple(src.shape[1:]),
                          dtype=src.dtype, device=src.device)
    _all_gather_single(stacked, src, group=group.process_group)
    out.extend(stacked.unbind(0))
    return out


def all_gather_concat(tensor, axis=0, group=None):
    """The group's tensors joined along ``axis``, in group order (one
    all-gather into one buffer)."""
    _count("all_gather", tensor)
    group = _resolve(group)
    if group.nranks <= 1:
        return tensor
    src = tensor.movedim(axis, 0).contiguous()
    out = torch.empty((group.nranks * src.shape[0],) + tuple(src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    _all_gather_single(out, src, group=group.process_group)
    return out.movedim(0, axis)


def broadcast(tensor, src=0, group=None, sync_op=True):
    """``tensor`` from global rank ``src`` to every rank of the group
    (reference: communication/broadcast.py)."""
    _count("broadcast", tensor)
    group = _resolve(group)
    if group.nranks <= 1:
        return tensor
    if src not in group.ranks:
        raise ValueError(f"broadcast src={src} is not a member of {group}")
    dist.broadcast(tensor, src=src, group=group.process_group)
    return tensor


def reduce(tensor, dst=0, op=ReduceOp.SUM, group=None, sync_op=True):
    """Reduce to global rank ``dst``: every rank takes part, only dst's
    tensor changes (process_group.h:172; the others keep theirs)."""
    _count("reduce", tensor)
    group = _resolve(group)
    if group.nranks <= 1:
        return tensor
    if dst not in group.ranks:
        raise ValueError(f"reduce dst={dst} is not a member of {group}")
    mine = _env.get_rank() == dst
    buf = tensor.clone() if not mine else tensor
    avg_int = op == ReduceOp.AVG and not tensor.is_floating_point()
    if avg_int:
        buf = buf.double()
    dist.reduce(buf, dst=dst, op=_torch_op(op), group=group.process_group)
    if mine and op == ReduceOp.AVG:
        if avg_int:
            return _set(tensor, (buf / group.nranks).float())
        tensor.div_(group.nranks)
    return tensor


def scatter(tensor, tensor_list=None, src=0, group=None, sync_op=True):
    """Rank i of the group receives ``tensor_list[i]`` of global rank
    ``src`` into ``tensor``."""
    _count("scatter", tensor)
    group = _resolve(group)
    if group.nranks <= 1:
        if tensor_list:
            tensor.copy_(tensor_list[0])
        return tensor
    parts = None
    if _env.get_rank() == src:
        parts = [t.contiguous() for t in tensor_list]
    dist.scatter(tensor, parts, src=src, group=group.process_group)
    return tensor


def reduce_scatter(tensor, tensor_list, op=ReduceOp.SUM, group=None,
                   sync_op=True):
    """Rank i receives the reduction over the group of every rank's
    ``tensor_list[i]`` (reference: communication/reduce_scatter.py)."""
    _count("reduce_scatter", tensor)
    group = _resolve(group)
    if group.nranks <= 1:
        return _set(tensor, tensor_list[0].clone())
    stacked = torch.stack([t.to(tensor.dtype) for t in tensor_list])
    avg_int = op == ReduceOp.AVG and not tensor.is_floating_point()
    if avg_int:
        stacked = stacked.double()
    out = torch.empty_like(stacked[:1])
    _reduce_scatter_single(out, stacked.contiguous(), op=_torch_op(op),
                           group=group.process_group)
    out = out[0]
    if op == ReduceOp.AVG:
        out = out / group.nranks
        if avg_int:
            out = out.float()
    return _set(tensor, out)


def reduce_scatter_concat(tensor, axis=0, group=None):
    """The sum over the group of ``tensor``, split along ``axis`` into
    group-size parts: this rank's part (one reduce-scatter)."""
    _count("reduce_scatter", tensor)
    group = _resolve(group)
    if group.nranks <= 1:
        return tensor
    src = tensor.movedim(axis, 0).contiguous()
    if src.shape[0] % group.nranks:
        raise ValueError(f"reduce_scatter_concat: dim {axis} of size "
                         f"{src.shape[0]} does not split over "
                         f"{group.nranks} ranks")
    out = torch.empty((src.shape[0] // group.nranks,) + tuple(src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    _reduce_scatter_single(out, src, op=dist.ReduceOp.SUM,
                           group=group.process_group)
    return out.movedim(0, axis)


def all_to_all(out_tensor_list, in_tensor_list, group=None, sync_op=True):
    """Rank i sends ``in_tensor_list[j]`` to rank j and receives rank j's
    ``in_tensor_list[i]`` as ``out_tensor_list[j]`` (reference:
    communication/all_to_all.py)."""
    _count("all_to_all", in_tensor_list[0] if in_tensor_list else None)
    group = _resolve(group)
    if group.nranks <= 1:
        out_tensor_list.extend(t.clone() for t in in_tensor_list)
        return out_tensor_list
    outs = [torch.empty_like(t) for t in in_tensor_list]
    dist.all_to_all(outs, [t.contiguous() for t in in_tensor_list],
                    group=group.process_group)
    out_tensor_list.extend(outs)
    return out_tensor_list


#: world-of-one send/recv queues: (group id, destination) -> payloads
_P2P_BUF: dict = {}


def send(tensor, dst=0, group=None, sync_op=True):
    """Point-to-point send to global rank ``dst``.  A group of one queues
    the payload for the matching `recv` (as JAX's); `p2p_drained` says
    whether every queued send was received."""
    _count("send", tensor)
    group = _resolve(group)
    if group.nranks <= 1:
        _P2P_BUF.setdefault((id(group), dst), []).append(tensor.clone())
        return tensor
    dist.send(tensor.contiguous(), dst=dst, group=group.process_group)
    return tensor


def recv(tensor, src=0, group=None, sync_op=True):
    """Receive into ``tensor`` from global rank ``src``."""
    _count("recv", tensor)
    group = _resolve(group)
    if group.nranks <= 1:
        q = _P2P_BUF.get((id(group), _env.get_rank()))
        if q:
            tensor.copy_(q.pop(0))
        return tensor
    dist.recv(tensor, src=src, group=group.process_group)
    return tensor


def p2p_drained():
    """True when no world-of-one send waits for its recv."""
    return not any(_P2P_BUF.values())


def p2p_reset():
    _P2P_BUF.clear()


def barrier(group=None):
    """Every rank of the group waits for the others: as JAX's, an
    all-reduce of a one-element token on the rank's device, waited for
    (torch's NCCL ``barrier`` is not used: it hangs ranks that share a
    card)."""
    _count("barrier")
    group = _resolve(group)
    if group.nranks <= 1:
        return
    tok = torch.zeros(1, device=_env.current_device())
    dist.all_reduce(tok, group=group.process_group)
    if tok.is_cuda:
        torch.cuda.current_stream(tok.device).synchronize()


class P2POp:
    """One send or recv of `batch_isend_irecv`: ``op`` is `send`/`isend`
    or `recv`/`irecv`, ``peer`` a global rank."""

    def __init__(self, op, tensor, peer, group=None):
        self.op, self.tensor, self.peer, self.group = op, tensor, peer, group


def isend(tensor, dst, group=None):
    return send(tensor, dst, group=group, sync_op=False)


def irecv(tensor, src, group=None):
    return recv(tensor, src, group=group, sync_op=False)


def batch_isend_irecv(p2p_op_list):
    """Issue the sends and receives together (no ordering deadlock
    between peers that send to each other) and wait for them; returns
    the finished works (a world of one: none, its queues)."""
    if not p2p_op_list:
        return []
    group = _resolve(p2p_op_list[0].group)
    if group.nranks <= 1:
        for op in p2p_op_list:
            op.op(op.tensor, op.peer, group=op.group)
        return []
    ops = []
    for op in p2p_op_list:
        is_send = op.op in (send, isend)
        _count("send" if is_send else "recv", op.tensor)
        ops.append(dist.P2POp(dist.isend if is_send else dist.irecv,
                              op.tensor, op.peer,
                              group=_resolve(op.group).process_group))
    works = dist.batch_isend_irecv(ops)
    for w in works:
        w.wait()
    return works
