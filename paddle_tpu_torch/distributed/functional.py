"""In-graph named-axis collectives (port of
paddle_tpu/distributed/functional.py): the collectives as differentiable
ops, the layer ring attention, an MoE all-to-all and the pipeline's stage
hand-off build on.

JAX calls them inside ``shard_map``, where ``axis_name`` names a mesh
axis in scope.  Here a rank is a process: ``axis_name`` resolves to this
rank's process group along that axis of the hybrid topology (``"dp"``,
``"mp"``, ``"pp"``, ``"sharding"``, ``"sep"``; `fleet.init` first), or
is a `collective.Group` itself.

Each op is a ``torch.autograd.Function`` whose backward is the transpose
``shard_map`` gives when a rank's output is its own (``out_specs`` over
the axis: the global loss is the sum of the ranks' losses):

- ``all_reduce`` sum: forward psum, backward psum of the cotangents; mean
  (``"avg"`` / ``"mean"``): the mean of the cotangents; max and min have
  no differentiation rule, in JAX as here (the backward raises);
- ``all_gather``: backward reduce-scatter (tiled or not, as the forward);
- ``reduce_scatter``: backward all-gather;
- ``all_to_all``: backward the all-to-all with the split and concat axes
  swapped;
- ``ppermute``: backward the inverse permutation.  A rank no pair sends to
  receives zeros, as in JAX; the sends and receives run as one
  `collective.batch_isend_irecv`;
- ``broadcast_from``: backward the sum of the cotangents on ``src``, zeros
  elsewhere.

``axis_index`` and ``axis_size`` are this rank's index in the group and
the group's size (Python ints).
"""
from __future__ import annotations

import torch

from . import collective as C


def _group(axis_name):
    """The `collective.Group` of this rank along ``axis_name``."""
    if isinstance(axis_name, C.Group):
        return axis_name
    from . import topology
    hcg = topology.get_hybrid_communicate_group()
    if hcg is None:
        raise RuntimeError(f"axis {axis_name!r}: no hybrid topology (call "
                           "fleet.init first) and no Group given")
    groups = {"dp": hcg.get_data_parallel_group,
              "mp": hcg.get_model_parallel_group,
              "pp": hcg.get_pipe_parallel_group,
              "sharding": hcg.get_sharding_parallel_group,
              "sep": hcg.get_sep_parallel_group}
    if axis_name not in groups:
        raise ValueError(f"unknown mesh axis {axis_name!r}; one of "
                         f"{sorted(groups)}")
    return groups[axis_name]()


_OPS = {"sum": C.ReduceOp.SUM, "max": C.ReduceOp.MAX,
        "min": C.ReduceOp.MIN, "avg": C.ReduceOp.AVG,
        "mean": C.ReduceOp.AVG}


def _reduce(x, group, op):
    y = x.contiguous().clone()
    C.all_reduce(y, op=op, group=group)
    return y


def _gather(x, group, axis, tiled):
    if tiled:
        return C.all_gather_concat(x.contiguous(), axis=axis, group=group)
    return C.all_gather_concat(x.unsqueeze(axis).contiguous(), axis=axis,
                               group=group)


def _scatter(x, group, axis, tiled):
    if tiled:
        return C.reduce_scatter_concat(x.contiguous(), axis=axis,
                                       group=group)
    if x.shape[axis] != group.nranks:
        raise ValueError(f"reduce_scatter(tiled=False): dim {axis} of "
                         f"{tuple(x.shape)} must equal the axis size "
                         f"{group.nranks}")
    return C.reduce_scatter_concat(x.contiguous(), axis=axis,
                                   group=group).squeeze(axis)


def _a2a(x, group, split_axis, concat_axis, tiled):
    n = group.nranks
    if x.shape[split_axis] % n:
        raise ValueError(f"all_to_all: dim {split_axis} of {tuple(x.shape)}"
                         f" does not split over {n} ranks")
    if not tiled and x.shape[split_axis] != n:
        raise ValueError(f"all_to_all(tiled=False): dim {split_axis} of "
                         f"{tuple(x.shape)} must equal the axis size {n}")
    parts = [p.contiguous() for p in x.chunk(n, dim=split_axis)]
    if not tiled:
        parts = [p.squeeze(split_axis) for p in parts]
    outs = C.all_to_all([], parts, group=group)
    if tiled:
        return torch.cat(outs, dim=concat_axis)
    return torch.stack(outs, dim=concat_axis)


def _permute(x, group, perm):
    """Rank ``dst`` of each ``(src, dst)`` pair receives rank ``src``'s
    ``x`` (axis indices); zeros where nothing arrives."""
    me = group.rank
    out = torch.zeros_like(x)
    x = x.contiguous()
    ops = []
    for src, dst in perm:
        if src == me and dst == me:
            out = x.clone()
        elif src == me:
            ops.append(C.P2POp(C.isend, x, group.ranks[dst], group))
        elif dst == me:
            ops.append(C.P2POp(C.irecv, out, group.ranks[src], group))
    if ops:
        C.batch_isend_irecv(ops)
    return out


def _check_perm(perm, n):
    perm = [(int(s), int(d)) for s, d in perm]
    srcs, dsts = [s for s, _ in perm], [d for _, d in perm]
    if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts) or \
            any(not 0 <= i < n for i in srcs + dsts):
        raise ValueError(f"ppermute: {perm} is not a permutation of "
                         f"{n} indices (sources and destinations unique)")
    return perm


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, op):
        ctx.group, ctx.op = group, op
        return _reduce(x, group, op)

    @staticmethod
    def backward(ctx, g):
        if ctx.op in (C.ReduceOp.MAX, C.ReduceOp.MIN):
            name = "pmax" if ctx.op == C.ReduceOp.MAX else "pmin"
            raise NotImplementedError(
                f"Differentiation rule for '{name}' not implemented")
        return _reduce(g, ctx.group, ctx.op), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, axis, tiled):
        ctx.cfg = (group, axis, tiled)
        return _gather(x, group, axis, tiled)

    @staticmethod
    def backward(ctx, g):
        group, axis, tiled = ctx.cfg
        return _scatter(g, group, axis, tiled), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, axis, tiled):
        ctx.cfg = (group, axis, tiled)
        return _scatter(x, group, axis, tiled)

    @staticmethod
    def backward(ctx, g):
        group, axis, tiled = ctx.cfg
        return _gather(g, group, axis, tiled), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis, tiled):
        ctx.cfg = (group, split_axis, concat_axis, tiled)
        return _a2a(x, group, split_axis, concat_axis, tiled)

    @staticmethod
    def backward(ctx, g):
        group, split_axis, concat_axis, tiled = ctx.cfg
        return _a2a(g, group, concat_axis, split_axis, tiled), None, None, \
            None, None


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, perm):
        ctx.group, ctx.perm = group, perm
        return _permute(x, group, perm)

    @staticmethod
    def backward(ctx, g):
        inverse = [(d, s) for s, d in ctx.perm]
        return _permute(g, ctx.group, inverse), None, None


class _BroadcastFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, src):
        ctx.group, ctx.src = group, src
        y = x.contiguous().clone()
        C.broadcast(y, src=group.ranks[src], group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        total = _reduce(g, ctx.group, C.ReduceOp.SUM)
        if ctx.group.rank != ctx.src:
            total = torch.zeros_like(total)
        return total, None, None


def _axis(axis, x, extra=0):
    """``axis`` made non-negative for a result of ``x.dim() + extra``
    dims."""
    return axis % (x.dim() + extra)


def all_reduce(x, axis_name, op="sum"):
    """reference: phi/kernels/all_reduce_kernel.h:24"""
    if op not in _OPS:
        raise ValueError(f"unsupported reduce op {op}")
    group = _group(axis_name)
    if group.nranks <= 1:
        return x.clone()
    return _AllReduce.apply(x, group, _OPS[op])


def all_gather(x, axis_name, axis=0, tiled=True):
    """Concatenate shards along ``axis`` (reference:
    phi/kernels/all_gather_kernel.h); ``tiled=False`` stacks them on a new
    axis there."""
    group = _group(axis_name)
    axis = _axis(axis, x, 0 if tiled else 1)
    if group.nranks <= 1:
        return x.clone() if tiled else x.unsqueeze(axis)
    return _AllGather.apply(x, group, axis, tiled)


def reduce_scatter(x, axis_name, axis=0, tiled=True):
    """reference: phi/kernels/reduce_scatter_kernel.h"""
    group = _group(axis_name)
    axis = _axis(axis, x)
    if group.nranks <= 1:
        return x.clone() if tiled else x.squeeze(axis)
    return _ReduceScatter.apply(x, group, axis, tiled)


def all_to_all(x, axis_name, split_axis=0, concat_axis=0, tiled=True):
    """MoE dispatch primitive (reference:
    paddle/fluid/operators/collective/alltoall_op.cc)."""
    group = _group(axis_name)
    split_axis = _axis(split_axis, x)
    concat_axis = _axis(concat_axis, x)
    if group.nranks <= 1:
        return x.clone()
    return _AllToAll.apply(x, group, split_axis, concat_axis, tiled)


def ppermute(x, axis_name, perm):
    """Neighbour exchange along the axis (reference analog: p_send/p_recv
    kernels, pp_utils/p2p_communication.py): for each ``(src, dst)`` of
    ``perm`` (axis indices) rank ``dst`` receives rank ``src``'s ``x``."""
    group = _group(axis_name)
    perm = _check_perm(perm, group.nranks)
    if group.nranks <= 1:
        return x.clone() if (0, 0) in perm else torch.zeros_like(x)
    return _PPermute.apply(x, group, perm)


def shift_right(x, axis_name, size):
    """Ring shift src→src+1 (wraps); the ring-attention step."""
    perm = [(i, (i + 1) % size) for i in range(size)]
    return ppermute(x, axis_name, perm)


def shift_left(x, axis_name, size):
    perm = [(i, (i - 1) % size) for i in range(size)]
    return ppermute(x, axis_name, perm)


def axis_index(axis_name):
    return max(_group(axis_name).rank, 0)


def axis_size(axis_name):
    return _group(axis_name).nranks


def broadcast_from(x, axis_name, src=0):
    """Rank ``src``'s value everywhere (in-graph broadcast)."""
    group = _group(axis_name)
    if group.nranks <= 1:
        return x.clone()
    return _BroadcastFrom.apply(x, group, int(src))
