"""Collective communication (port of paddle_tpu/distributed/collective.py)
over ``torch.distributed`` process groups.

A rank is a process (`distributed.env.init_parallel_env`), and a `Group`
an ordered subset of the world's ranks backed by a torch process group:
NCCL on the card, gloo on the CPU.

**One choke point** (JAX's ``_multiproc_collective``): every multi-rank
op goes through `_collective`, which runs the hang guardian
(`distributed.watchdog`) around it: ``begin`` → ``preflight`` (fault
points, the fail-fast peer check, the arrival and desync records) → the
op → ``end`` (on the card: an event after the enqueue, so the entry
stays in flight until the transfer ran), with ``translate`` on the way
out.  With the guardian off ``begin`` returns None after a few lookups.
A call inside a CUDA graph capture is not registered (its replays run
without Python).  Point-to-point ops register under their pair of ranks
(op ``p2p``), as JAX's broadcasts over a pair group.

**Backends** (``FLAGS_collective_backend``): ``auto`` (the default) and
``xla`` run every op on the process group; ``host`` routes the ops the
JAX module's host lane serves (all_reduce, all_gather, broadcast,
reduce, scatter, reduce_scatter, all_to_all, barrier) through the
store-mediated gather of `distributed.host_collectives` (16-bit floats
travel and reduce as fp32, then round once); send and recv keep the
process group.

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

import numpy as np
import torch
import torch.distributed as dist

from ..utils.flags import flag as _flag
from . import env as _env
from . import watchdog as _wd


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

    def __init__(self, ranks, *, process_group=None):
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
    return Group(ranks, process_group=pg)


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


def counts():
    """{op: (calls, bytes)} of ``dist.collective_calls`` /
    ``dist.collective_bytes`` so far (ops never called are left out)."""
    if not _COUNTERS:
        return {}
    return {key[0]: (child.value, _COUNTERS["bytes"].labels(op=key[0]).value)
            for key, child in list(_COUNTERS["calls"]._children.items())}


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


# ---------------------------------------------------------------------------
# the choke point
# ---------------------------------------------------------------------------


def _np_reduce(op, stacked):
    """Reduce a host-gathered ``[nranks, ...]`` stack with JAX's dtype
    rule: sum, max, min and prod keep the dtype, the mean of integers is
    float32."""
    reducers = {ReduceOp.SUM: np.sum, ReduceOp.MAX: np.max,
                ReduceOp.MIN: np.min, ReduceOp.PROD: np.prod,
                ReduceOp.AVG: np.mean}
    if op not in reducers:
        raise ValueError(f"unknown ReduceOp {op!r}")
    res = np.asarray(reducers[op](stacked, axis=0))
    if op == ReduceOp.AVG and stacked.dtype.kind not in "fc":
        return res.astype(np.float32)
    return res.astype(stacked.dtype)


def _host_lane():
    return str(_flag("FLAGS_collective_backend", "auto")) == "host"


def _to_host(t):
    """``t`` as a numpy array for the store (16-bit floats as fp32)."""
    t = t.detach().cpu()
    if t.dtype in (torch.bfloat16, torch.float16):
        t = t.float()
    return t.numpy()


def _from_host(arr, like):
    """``arr`` on ``like``'s device, in ``like``'s dtype unless the host
    rule changed the dtype (AVG of integers: float32)."""
    out = torch.from_numpy(np.ascontiguousarray(arr)).to(like.device)
    return out.to(like.dtype) if out.dtype == _host_dtype(like) else out


def _host_dtype(t):
    return {torch.bfloat16: torch.float32,
            torch.float16: torch.float32}.get(t.dtype, t.dtype)


def _host_gather(group, local):
    """The group's ``local`` arrays stacked ``[nranks, ...]`` through the
    store (`host_collectives.HostCollectives.gather`)."""
    from . import host_collectives as _hc
    host = _hc.bootstrap()
    if host is None:
        raise RuntimeError(
            "FLAGS_collective_backend=host: no store to gather through; "
            "launch through paddle_tpu_torch.distributed.launch (the "
            "guardian store) or join a process group first")
    return host.gather(group, local)


def _done_event(tensor):
    """A CUDA event recorded on the current stream after ``tensor``'s op
    was enqueued (torch makes that stream wait for the collective's), or
    None off the card."""
    if tensor is None or not tensor.is_cuda:
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(tensor.device))
    return ev


def _collective(name, group, tensor, run):
    """Run ``run()`` (one multi-rank op of ``group`` on ``tensor``) under
    the hang guardian: begin, preflight, the op, end, with translate on
    the way out (JAX's ``_multiproc_collective``)."""
    if tensor is not None and tensor.is_cuda and \
            torch.cuda.is_current_stream_capturing():
        return run()                # replays run without Python
    token = _wd.begin(name, group)
    if token is None:
        return run()
    try:
        _wd.preflight(token)
        out = run()
    except BaseException as exc:
        rich = _wd.translate(token, exc)
        _wd.end(token)
        if rich is exc:
            raise
        # a bare asynchronously raised class becomes its rich instance; a
        # backend error keeps its cause under the peer's
        raise rich from (None if isinstance(exc, _wd.GuardianError)
                         else exc)
    _wd.end(token, _done_event(tensor))
    return out


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


def all_reduce(tensor, op=ReduceOp.SUM, group=None, sync_op=True):
    """In-place all-reduce of ``tensor`` across the group (reference:
    communication/all_reduce.py)."""
    _count("all_reduce", tensor)
    group = _resolve(group)
    avg_int = op == ReduceOp.AVG and not tensor.is_floating_point()
    if group.nranks <= 1:
        if avg_int:
            _set(tensor, tensor.float())
        return tensor
    _torch_op(op)                   # an unknown op raises before the call

    def run():
        if _host_lane():
            res = _np_reduce(op, _host_gather(group, _to_host(tensor)))
            return _set(tensor, _from_host(res, tensor))
        buf = tensor.double() if avg_int else tensor
        dist.all_reduce(buf, op=_torch_op(op), group=group.process_group)
        if op == ReduceOp.AVG:
            if avg_int:
                return _set(tensor, (buf / group.nranks).float())
            buf.div_(group.nranks)
        return tensor
    return _collective("all_reduce", group, tensor, run)


def _gathered(group, src):
    """``[nranks, *src.shape]``: every rank's ``src`` in group order."""
    if _host_lane():
        return _from_host(_host_gather(group, _to_host(src)), src)
    stacked = torch.empty((group.nranks,) + tuple(src.shape),
                          dtype=src.dtype, device=src.device)
    _all_gather_single(stacked, src.unsqueeze(0), group=group.process_group)
    return stacked


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
    stacked = _collective("all_gather", group, tensor,
                          lambda: _gathered(group, tensor.contiguous()))
    out.extend(stacked.unbind(0))
    return out


def all_gather_concat(tensor, axis=0, group=None, *, out=None):
    """The group's tensors joined along ``axis``, in group order (one
    all-gather into one buffer; ``out``, a contiguous tensor of the
    joined shape, receives it when ``axis`` is 0)."""
    _count("all_gather", tensor)
    group = _resolve(group)
    if out is not None and (axis != 0 or not out.is_contiguous()):
        raise ValueError("all_gather_concat: out= takes axis 0 into a "
                         "contiguous tensor")
    if group.nranks <= 1:
        return tensor if out is None else out.copy_(tensor)
    src = tensor.movedim(axis, 0).contiguous()

    def run():
        if _host_lane():
            joined = _gathered(group, src).flatten(0, 1)
            return joined if out is None else out.copy_(joined)
        dst = out if out is not None else torch.empty(
            (group.nranks * src.shape[0],) + tuple(src.shape[1:]),
            dtype=src.dtype, device=src.device)
        _all_gather_single(dst, src, group=group.process_group)
        return dst
    return _collective("all_gather", group, tensor, run).movedim(0, axis)


def broadcast(tensor, src=0, group=None, sync_op=True):
    """``tensor`` from global rank ``src`` to every rank of the group
    (reference: communication/broadcast.py)."""
    _count("broadcast", tensor)
    group = _resolve(group)
    if group.nranks <= 1:
        return tensor
    if src not in group.ranks:
        raise ValueError(f"broadcast src={src} is not a member of {group}")

    def run():
        if _host_lane():             # JAX's: an all-gather, src's part
            parts = _gathered(group, tensor.contiguous())
            return _set(tensor, parts[group.get_group_rank(src)])
        dist.broadcast(tensor, src=src, group=group.process_group)
        return tensor
    return _collective("broadcast", group, tensor, run)


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
    avg_int = op == ReduceOp.AVG and not tensor.is_floating_point()

    def run():
        if _host_lane():
            res = _np_reduce(op, _host_gather(group, _to_host(tensor)))
            return _set(tensor, _from_host(res, tensor)) if mine \
                else tensor
        buf = tensor.clone() if not mine else tensor
        if avg_int:
            buf = buf.double()
        dist.reduce(buf, dst=dst, op=_torch_op(op),
                    group=group.process_group)
        if mine and op == ReduceOp.AVG:
            if avg_int:
                return _set(tensor, (buf / group.nranks).float())
            tensor.div_(group.nranks)
        return tensor
    return _collective("reduce", group, tensor, run)


def scatter(tensor, tensor_list=None, src=0, group=None, sync_op=True):
    """Rank i of the group receives ``tensor_list[i]`` of global rank
    ``src`` into ``tensor``."""
    _count("scatter", tensor)
    group = _resolve(group)
    if group.nranks <= 1:
        if tensor_list:
            tensor.copy_(tensor_list[0])
        return tensor
    is_src = _env.get_rank() == src

    def run():
        if _host_lane():             # JAX's: src's stack, broadcast
            stacked = torch.stack([t.to(tensor.dtype) for t in tensor_list]) \
                if is_src and tensor_list else \
                torch.zeros((group.nranks,) + tuple(tensor.shape),
                            dtype=tensor.dtype, device=tensor.device)
            parts = _gathered(group, stacked)
            return _set(tensor, parts[group.get_group_rank(src)]
                        [group.rank])
        parts = [t.contiguous() for t in tensor_list] if is_src else None
        dist.scatter(tensor, parts, src=src, group=group.process_group)
        return tensor
    return _collective("scatter", group, tensor, run)


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

    def run():
        if _host_lane():
            res = _np_reduce(op, _host_gather(group, _to_host(stacked)))
            return _set(tensor, _from_host(res[group.rank], tensor))
        src = stacked.double() if avg_int else stacked
        out = torch.empty_like(src[:1])
        _reduce_scatter_single(out, src.contiguous(), op=_torch_op(op),
                               group=group.process_group)
        out = out[0]
        if op == ReduceOp.AVG:
            out = out / group.nranks
            if avg_int:
                out = out.float()
        return _set(tensor, out)
    return _collective("reduce_scatter", group, tensor, run)


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
    rows = src.shape[0] // group.nranks

    def run():
        if _host_lane():
            res = _np_reduce(ReduceOp.SUM, _host_gather(group,
                                                        _to_host(src)))
            part = res[group.rank * rows:(group.rank + 1) * rows]
            return _from_host(part, src)
        out = torch.empty((rows,) + tuple(src.shape[1:]), dtype=src.dtype,
                          device=src.device)
        _reduce_scatter_single(out, src, op=dist.ReduceOp.SUM,
                               group=group.process_group)
        return out
    return _collective("reduce_scatter", group, tensor, run).movedim(0,
                                                                     axis)


def all_to_all(out_tensor_list, in_tensor_list, group=None, sync_op=True):
    """Rank i sends ``in_tensor_list[j]`` to rank j and receives rank j's
    ``in_tensor_list[i]`` as ``out_tensor_list[j]`` (reference:
    communication/all_to_all.py)."""
    first = in_tensor_list[0] if in_tensor_list else None
    _count("all_to_all", first)
    group = _resolve(group)
    if group.nranks <= 1:
        out_tensor_list.extend(t.clone() for t in in_tensor_list)
        return out_tensor_list

    def run():
        if _host_lane():
            stacked = torch.stack(list(in_tensor_list))
            st = _host_gather(group, _to_host(stacked))
            res = _from_host(np.swapaxes(st, 0, 1)[group.rank], stacked)
            return list(res.unbind(0))
        outs = [torch.empty_like(t) for t in in_tensor_list]
        dist.all_to_all(outs, [t.contiguous() for t in in_tensor_list],
                        group=group.process_group)
        return outs
    out_tensor_list.extend(_collective("all_to_all", group, first, run))
    return out_tensor_list


#: world-of-one send/recv queues: (group id, destination) -> payloads
_P2P_BUF: dict = {}


class _Pair:
    """The guardian's view of a point-to-point link: its two global ranks
    (JAX's cached pair group, keyed the same on both ends)."""

    def __init__(self, a, b):
        lo, hi = min(a, b), max(a, b)
        self.id = f"p{lo}.{hi}"
        self.ranks = [lo, hi]
        self.nranks = 2


def send(tensor, dst=0, group=None, sync_op=True):
    """Point-to-point send to global rank ``dst``.  A group of one queues
    the payload for the matching `recv` (as JAX's); `p2p_drained` says
    whether every queued send was received."""
    _count("send", tensor)
    group = _resolve(group)
    if group.nranks <= 1:
        _P2P_BUF.setdefault((id(group), dst), []).append(tensor.clone())
        return tensor
    src = tensor.contiguous()
    _collective("p2p", _Pair(_env.get_rank(), dst), src,
                lambda: dist.send(src, dst=dst, group=group.process_group))
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
    _collective("p2p", _Pair(_env.get_rank(), src), tensor,
                lambda: dist.recv(tensor, src=src,
                                  group=group.process_group))
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

    def run():
        if _host_lane():
            _host_gather(group, _to_host(tok))
            return
        dist.all_reduce(tok, group=group.process_group)
        if tok.is_cuda:
            torch.cuda.current_stream(tok.device).synchronize()
    _collective("barrier", group, tok, run)


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
    the finished works (a world of one: none, its queues).  Each op
    registers with the guardian under its pair of ranks."""
    if not p2p_op_list:
        return []
    group = _resolve(p2p_op_list[0].group)
    if group.nranks <= 1:
        for op in p2p_op_list:
            op.op(op.tensor, op.peer, group=op.group)
        return []
    me = _env.get_rank()
    ops, tokens = [], []
    try:
        for op in p2p_op_list:
            is_send = op.op in (send, isend)
            _count("send" if is_send else "recv", op.tensor)
            capturing = op.tensor.is_cuda and \
                torch.cuda.is_current_stream_capturing()
            token = None if capturing else _wd.begin(
                "p2p", _Pair(me, op.peer))
            tokens.append(token)
            _wd.preflight(token)
            ops.append(dist.P2POp(dist.isend if is_send else dist.irecv,
                                  op.tensor, op.peer,
                                  group=_resolve(op.group).process_group))
        works = dist.batch_isend_irecv(ops)
        for w in works:
            w.wait()
    except BaseException as exc:
        live = [t for t in tokens if t is not None]
        rich = _wd.translate(live[0], exc) if live else exc
        for token in live:
            _wd.end(token)
        if rich is exc:
            raise
        raise rich from (None if isinstance(exc, _wd.GuardianError)
                         else exc)
    for token, op in zip(tokens, p2p_op_list):
        _wd.end(token, _done_event(op.tensor) if token is not None
                else None)
    return works
