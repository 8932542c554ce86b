"""ZeRO sharded training, stages 1, 2 and 3 (port of
paddle_tpu/distributed/fleet/sharding.py): ``shard_parameters``,
``shard_optimizer_states``, ``DygraphShardingOptimizer``,
``group_sharded_parallel`` (levels ``os``, ``os_g``, ``p_g_os``) and
``save_group_sharded_model``.

In JAX ZeRO is a layout that GSPMD turns into collectives.  A torch
process holds no global array, so here each stage is the collectives
themselves, over the sharding group (the mesh axis ``sharding``, or
``dp`` when the mesh has no sharding axis above 1):

- **The layout is JAX's**, parameter by parameter (fleet/base.py
  ``_commit_params``): a parameter is split ``Shard(0)`` over the axis
  only when its dim 0 tiles evenly and tensor parallelism does not split
  dim 0 already; so the row-parallel weights and the vocabulary
  embeddings stay whole over the sharding axis.
- **Stage 3** (``p_g_os``): such a parameter keeps its rows; its module
  gathers it when it reads it (`api.gather_on_use`: once a forward, freed
  after, gathered again in the backward to rebuild what the forward
  saved, and again under recompute).  Its gradient comes back reduce-
  scattered as an average over the group, as the rows' gradient; a
  parameter used twice sums both uses first.
- **Stages 1 and 2** (``os``, ``os_g``; and stage 3's whole parameters):
  the parameter stays whole; its moments and fp32 master are the rank's
  rows, born sharded as JAX's accumulator hook makes them.  Stage 1
  all-reduces the gradient (an average) and takes the rows, stage 2
  reduce-scatters it.  Each rank updates its rows (`Optimizer.
  _apply_update`: the Adam kernel on a contiguous buffer of the rows),
  then all-gathers the updated parameter.  A parameter whose dim 0 does
  not tile stays whole, its gradient averaged, every rank updating it.

The sharding ranks see the same rows of the batch (``shard_tensor``
with ``Shard(0)`` on dp only, as the JAX recipe places it), or each its
own rows (``Shard(0)`` on both); either way the average over the group
is the gradient JAX's global program computes.  With dp above 1 the
rows are averaged over dp after; sequence-parallel gradients are summed
over mp first.  The global-norm clip counts each part once
(`nn.clip.global_norm`: summed over the groups that split it).
ZeRO runs eagerly: `framework.CompiledTrainStep` takes JAX's eager lane.
"""
from __future__ import annotations

import torch

from .. import collective as C
from .. import env as _env
from .. import topology
from ..api import gather_on_use
from ..mesh import get_mesh
from ..parallel import allreduce_tensors
from ..placement import (Shard, commit_param, held_placements, shard_bounds,
                         shardable_on)

LEVELS = {"os": 1, "os_g": 2, "p_g_os": 3}


def _axis_of(mesh):
    """JAX's choice: ``sharding`` when the mesh has it above 1, else
    ``dp``."""
    return "sharding" if (mesh is not None and "sharding" in mesh.dim_names
                          and mesh.get_dim_size("sharding") > 1) else "dp"


def _mesh(mesh):
    mesh = mesh or get_mesh()
    if mesh is None:
        raise ValueError("ZeRO sharding needs a mesh: call fleet.init (or "
                         "set_mesh) first")
    return mesh


def _stage3_steps(mesh, axis):
    idx = mesh.dim_names.index(axis)
    group = mesh.get_group(axis)

    def steps(p):
        placements = getattr(p, "placements", None)
        if placements and placements[idx] == Shard(0) and group.nranks > 1:
            return [(group, 0)]
        return None
    return steps


def shard_parameters(parameters, axis="sharding", mesh=None, *, layer=None):
    """Commit each parameter ``Shard(0)`` over ``axis`` where JAX's rule
    allows it (the ZeRO-3 layout): the rank keeps its rows.  ``layer``
    (the model the parameters belong to; `group_sharded_parallel` and
    ``fleet.distributed_model`` pass it) then gathers each one on use."""
    mesh = _mesh(mesh)
    idx = mesh.dim_names.index(axis)
    for p in parameters:
        placements = held_placements(p, mesh)
        if shardable_on(tuple(p.shape), mesh, axis) and not any(
                isinstance(pl, Shard) and pl.dim == 0 for pl in placements):
            placements[idx] = Shard(0)
        commit_param(p, mesh, placements)
    if layer is not None:
        gather_on_use(layer, _stage3_steps(mesh, axis))
    return parameters


def aligned_rows(g, lo, hi):
    """Rows ``[lo, hi)`` of ``g``: the view when it starts on a 16-byte
    boundary, else a copy of its own (the Adam kernel's vector path
    wants its pointers so aligned)."""
    rows = g[lo:hi]
    return rows if rows.data_ptr() % 16 == 0 else rows.clone()


class ZeroState:
    """The ZeRO plan of one optimizer (the counterpart of JAX's
    accumulator commit hook), installed as ``optimizer._zero``: each
    parameter's kind — ``"param"`` (stage 3: it is its rows), ``"rows"``
    (whole, its state the rows ``[lo, hi)``) or ``"whole"`` — the
    gradient sync before the update and the gather after it."""

    def __init__(self, group, stage, dp_group=None, mp_group=None,
                 mesh=None, axis="sharding"):
        self.group = group
        self.stage = stage
        self.dp_group = dp_group
        self.mp_group = mp_group
        self.mesh = mesh
        self.axis = axis
        self._kinds = {}
        self._bufs = {}

    def kind(self, p):
        """``(kind, lo, hi)`` of parameter ``p``."""
        k = self._kinds.get(id(p))
        if k is None:
            n = self.group.nranks
            placements = getattr(p, "placements", None)
            idx = self.mesh.dim_names.index(self.axis) if self.mesh else -1
            if n > 1 and placements and idx >= 0 and \
                    placements[idx] == Shard(0):
                k = ("param", 0, p.shape[0])
            elif n > 1 and p.dim() and p.shape[0] % n == 0 and \
                    p.shape[0] >= n:
                lo, hi = shard_bounds(p.shape[0], n, self.group.rank)
                k = ("rows", lo, hi)
            else:
                k = ("whole", 0, 0)
            self._kinds[id(p)] = k
        return k

    def full_shape(self, p):
        """The shape of ``p`` whole on this rank's mp part."""
        kind = self.kind(p)[0]
        if kind == "param":
            return (p.shape[0] * self.group.nranks,) + tuple(p.shape[1:])
        return tuple(p.shape)

    def state_view(self, p):
        """The part of ``p`` this rank's optimizer state covers."""
        kind, lo, hi = self.kind(p)
        return p.detach()[lo:hi] if kind == "rows" else p.detach()

    def rows_of(self, t, p):
        """A state tensor made for the whole ``p`` cut to its rows (as
        it is when it is rows already)."""
        kind, lo, hi = self.kind(p)
        if t is None or not t.dim() or kind == "whole":
            return t
        if kind == "param" and t.shape[0] == self.full_shape(p)[0] != \
                p.shape[0]:
            lo, hi = shard_bounds(t.shape[0], self.group.nranks,
                                  self.group.rank)
        elif kind == "param" or t.shape[0] != p.shape[0]:
            return t
        return t[lo:hi].clone()

    @torch.no_grad()
    def sync_gradients(self, params_grads):
        """``[(p, g)]`` → ``[(p, the rows' gradient)]``: sequence-parallel
        gradients summed over mp, then averaged over the group (stage 1
        all-reduce, stage 2 reduce-scatter; stage-3 rows came reduce-
        scattered from the backward), then over dp."""
        sp = [g for p, g in params_grads
              if getattr(p, "is_sequence_parallel", False)]
        if sp and self.mp_group is not None:
            allreduce_tensors(sp, self.mp_group, average=False)
        out, whole, stage1 = [], [], []
        for p, g in params_grads:
            kind, lo, hi = self.kind(p)
            if kind == "whole":
                whole.append(g)
            elif kind == "rows" and self.stage == 1:
                stage1.append(g)
        allreduce_tensors(whole + stage1, self.group)
        for p, g in params_grads:
            kind, lo, hi = self.kind(p)
            if kind == "rows":
                if self.stage == 1:
                    g = aligned_rows(g, lo, hi)
                else:
                    g = C.reduce_scatter_concat(g.contiguous(), axis=0,
                                                group=self.group)
                    g.div_(self.group.nranks)
            out.append((p, g))
        allreduce_tensors([g for _, g in out], self.dp_group)
        return out

    def target(self, p):
        """What the update writes for ``p``: ``p`` itself, or for a
        ``"rows"`` parameter a contiguous buffer of its rows (their
        current values), all-gathered into ``p`` by `gather_params`."""
        kind, lo, hi = self.kind(p)
        if kind != "rows":
            return p
        buf = self._bufs.get(id(p))
        if buf is None:
            buf = self._bufs[id(p)] = torch.empty(
                (hi - lo,) + tuple(p.shape[1:]), dtype=p.dtype,
                device=p.device)
        buf.copy_(p.detach()[lo:hi])
        return buf

    @torch.no_grad()
    def gather_params(self, params):
        """Each ``"rows"`` parameter of ``params`` all-gathered from every
        rank's updated rows."""
        for p in params:
            if self.kind(p)[0] == "rows":
                C.all_gather_concat(self._bufs[id(p)], axis=0,
                                    group=self.group, out=p.data)

    def resident_bytes(self, optimizer):
        """(parameter bytes, optimizer-state bytes) this rank holds."""
        params = optimizer._all_params()
        pbytes = sum(p.numel() * p.element_size() for p in params)
        sbytes = sum(t.numel() * t.element_size()
                     for vals in optimizer._state.values() for t in vals
                     if t is not None)
        return pbytes, sbytes


def shard_optimizer_states(optimizer, axis="sharding", mesh=None, *,
                           level="os"):
    """Install the ZeRO plan on ``optimizer`` (in place; returned):
    existing state is cut to the rank's rows, new state is born as rows
    (JAX's accumulator hook).  ``level`` (the port's): ``"os"`` syncs
    gradients by all-reduce, ``"os_g"`` and ``"p_g_os"`` by reduce-
    scatter."""
    if level not in LEVELS:
        raise ValueError(f"level must be one of {sorted(LEVELS)}, not "
                         f"{level!r}")
    mesh = _mesh(mesh)
    inner = getattr(optimizer, "_inner", optimizer)
    zero = ZeroState(mesh.get_group(axis), LEVELS[level],
                     dp_group=None if axis == "dp" else topology.dp_group(),
                     mp_group=topology.mp_group(), mesh=mesh, axis=axis)
    old = getattr(inner, "_zero", None)
    if old is not None:
        zero.stage = max(zero.stage, old.stage)
    inner._zero = zero
    for p in inner._all_params():
        if zero.kind(p)[0] != "whole":
            p.zero_group = zero.group
    for vals in inner._state.values():
        for i, p in enumerate(inner._all_params()):
            vals[i] = zero.rows_of(vals[i], p)
    return optimizer


class DygraphShardingOptimizer:
    """reference: dygraph_sharding_optimizer.py:39 — the stage-1 wrapper
    (`shard_optimizer_states` at level ``os``)."""

    def __init__(self, optimizer, hcg=None, axis="sharding"):
        self._inner = optimizer
        self._axis = axis
        shard_optimizer_states(optimizer, axis=axis)

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def step(self):
        return self._inner.step()

    def clear_grad(self, *a, **k):
        return self._inner.clear_grad(*a, **k)


def group_sharded_parallel(model, optimizer, level="os_g", scaler=None,
                           group=None, offload=False, sync_buffers=False,
                           buffer_max_size=2 ** 23, segment_size=2 ** 20,
                           sync_comm=False, dp_group=None,
                           exclude_layer=None):
    """reference: python/paddle/distributed/sharding/group_sharded.py
    group_sharded_parallel(level='os'|'os_g'|'p_g_os'): stage 1, 2 or 3
    over the sharding axis (dp when the mesh has none above 1).  The
    other arguments are accepted, as in JAX, and change nothing."""
    if level not in LEVELS:
        raise ValueError(f"level must be one of {sorted(LEVELS)}, not "
                         f"{level!r}")
    mesh = _mesh(None)
    axis = _axis_of(mesh)
    if level == "p_g_os":
        shard_parameters(list(model.parameters()), axis=axis, mesh=mesh,
                         layer=model)
    shard_optimizer_states(optimizer, axis=axis, mesh=mesh, level=level)
    return model, optimizer, scaler


def save_group_sharded_model(model, output, optimizer=None):
    """reference: group_sharded.py save_group_sharded_model: the full
    (unsharded) state, JAX's names, at ``output`` (``.pdparams`` added
    unless it ends so) and the optimizer's at ``output + ".pdopt"``.
    Every rank takes part in the gathers; rank 0 writes."""
    from ... import convert
    from ...framework.io import save
    path = output if output.endswith(".pdparams") else output + ".pdparams"
    state = convert.gather_paddle_tpu_state(model, dst=0)
    ostate = None if optimizer is None else \
        convert.gather_paddle_tpu_optimizer_state(model, optimizer, dst=0)
    if _env.get_rank() == 0:
        save(state, path)
        if ostate is not None:
            save(ostate, output + ".pdopt")
    C.barrier()
    return path


__all__ = ["DygraphShardingOptimizer", "LEVELS", "ZeroState", "aligned_rows",
           "group_sharded_parallel", "save_group_sharded_model",
           "shard_optimizer_states", "shard_parameters"]
