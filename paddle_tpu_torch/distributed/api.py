"""The semi-auto parallel API (port of paddle_tpu/distributed/api.py):
``shard_tensor``, ``dtensor_from_fn``, ``reshard``, ``shard_constraint``,
``shard_layer``, ``unshard_dtensor``.

In JAX a distributed tensor is one global ``jax.Array`` committed to a
``NamedSharding``, and XLA picks the collective of each move.  A torch
process holds no global array: here a distributed tensor is the rank's
part, an ordinary tensor that records ``placements``, ``process_mesh``
and ``is_dist_param`` (`placement.local_slice` names the part), and
each move is a collective over the process group of one mesh axis
(`ProcessMesh.get_group`), with its autograd:

- Shard(d) → Replicate: an all-gather along d; backward the gradient
  reduce-scattered along d as an average over the group (the ranks of a
  replicated tensor compute alike, so each holds the whole gradient);
- Replicate → Shard(d): this rank's part; backward an all-gather;
- Shard(i) → Shard(j): one all-to-all; backward the reverse one;
- ``Partial`` raises as JAX's does: it is a state inside a reshard, not
  a placement a caller passes.

A dim split over several axes is split in mesh-axis order (the outer
axis takes the coarse part): such moves gather the dim whole, innermost
axis first, and split it again, outermost first.  A tensor without
``placements`` is taken as the global value (every axis replicated), so
``shard_tensor`` takes the same global tensor on every rank.

`shard_layer` keeps each parameter at its placement and gathers it on
use (`gather_on_use`): reading the attribute inside the layer's forward
gives the global parameter, gathered once a forward, and its gradient
comes back as the part's.  ZeRO stage 3 (`fleet.sharding`) rides the
same machinery.  The tensor-parallel layers keep their own region
functions (`fleet.mp_layers`).
"""
from __future__ import annotations

import contextlib
import weakref

import torch

from ..kernels import graph_state
from . import collective as C
from .mesh import get_mesh
from .placement import (Partial, Replicate, Shard, commit_param,
                        shard_bounds, spec_to_placements)

_PARTIAL = ("Partial placements are an internal reshard state; pass Shard/"
            "Replicate here (XLA GSPMD materializes partials internally)")


# ---------------------------------------------------------------------------
# the moves of one mesh axis, with their autograd
# ---------------------------------------------------------------------------

def _avg_scatter(g, dim, group):
    """The gradient of an all-gather: reduce-scattered along ``dim``, the
    sum divided by the group's size."""
    return C.reduce_scatter_concat(g.contiguous(), axis=dim,
                                   group=group).div_(group.nranks)


class _AxisGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.cfg = (group, dim)
        return C.all_gather_concat(x, axis=dim, group=group)

    @staticmethod
    def backward(ctx, g):
        group, dim = ctx.cfg
        return _avg_scatter(g, dim, group), None, None


def _part(x, group, dim):
    lo, hi = shard_bounds(x.shape[dim], group.nranks, group.rank)
    return x.narrow(dim, lo, hi - lo).contiguous().clone()


class _AxisSlice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.cfg = (group, dim)
        return _part(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        group, dim = ctx.cfg
        return C.all_gather_concat(g.contiguous(), axis=dim,
                                   group=group), None, None


def _all_to_all(x, group, src, dst):
    """Split on ``src`` → split on ``dst``: chunk k of ``dst`` to rank k,
    the pieces received joined along ``src`` in rank order."""
    outs = []
    C.all_to_all(outs, [c.contiguous() for c in
                        x.chunk(group.nranks, dim=dst)], group=group)
    return torch.cat(outs, dim=src)


class _AxisAllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, src, dst):
        ctx.cfg = (group, src, dst)
        return _all_to_all(x, group, src, dst)

    @staticmethod
    def backward(ctx, g):
        group, src, dst = ctx.cfg
        return _all_to_all(g, group, dst, src), None, None, None


def _dims(placements, ndim):
    return [p.dim % ndim if isinstance(p, Shard) else None
            for p in placements]


def _move(x, mesh, src, dst):
    """``x``, this rank's part under ``src``, as its part under ``dst``
    (autograd through every collective)."""
    for p in list(src) + list(dst):
        if isinstance(p, Partial):
            raise NotImplementedError(_PARTIAL)
    if x.dim() == 0:
        return x
    sd, dd = _dims(src, x.dim()), _dims(dst, x.dim())
    changed = [a for a in range(len(sd)) if sd[a] != dd[a]]
    if not changed:
        return x
    multi = {d for dims in (sd, dd) for d in dims if d is not None
             and sum(1 for e in dims if e == d) > 1}
    if len(changed) == 1 and sd[changed[0]] is not None and \
            dd[changed[0]] is not None and not multi & {
                sd[changed[0]], dd[changed[0]]}:
        a = changed[0]
        group = mesh.get_group(mesh.dim_names[a])
        if group.nranks <= 1:
            return x
        return _AxisAllToAll.apply(x, group, sd[a], dd[a])
    # gather every axis that changes, and every axis splitting a dim such
    # an axis touches, innermost first; then split, outermost first
    touched = {d for a in changed for d in (sd[a], dd[a]) if d is not None}
    redo = [a for a in range(len(sd)) if a in changed
            or sd[a] in touched or dd[a] in touched]
    for a in reversed(redo):
        if sd[a] is not None:
            group = mesh.get_group(mesh.dim_names[a])
            if group.nranks > 1:
                x = _AxisGather.apply(x, group, sd[a])
    for a in redo:
        if dd[a] is not None:
            group = mesh.get_group(mesh.dim_names[a])
            if group.nranks > 1:
                x = _AxisSlice.apply(x, group, dd[a])
    return x


def _held(tensor, mesh):
    """The placements ``tensor`` holds on ``mesh`` (every axis replicated
    for a tensor that records none or another mesh)."""
    held = getattr(tensor, "placements", None)
    if held and getattr(tensor, "process_mesh", None) == mesh:
        return list(held)
    return [Replicate() for _ in mesh.dim_names]


def _mark(t, mesh, placements):
    t.placements = list(placements)
    t.process_mesh = mesh
    t.is_dist_param = True
    return t


def _mesh_of(mesh, who):
    mesh = mesh or get_mesh()
    if mesh is None:
        raise ValueError(f"{who}: no mesh given and no default mesh set")
    return mesh


# ---------------------------------------------------------------------------
# the API
# ---------------------------------------------------------------------------

def shard_tensor(tensor, mesh=None, placements=None, dtype=None,
                 stop_gradient=None):
    """This rank's part of ``tensor`` on ``mesh`` under ``placements``
    (one a mesh axis; None: replicated): ``tensor`` is the global value
    (the same on every rank), or a distributed tensor, which moves from
    the placements it records.  ``stop_gradient`` None keeps the input's
    (a tensor that requires no gradient stops it).

    reference: python/paddle/distributed/auto_parallel/api.py:94
    """
    mesh = _mesh_of(mesh, "shard_tensor")
    placements = list(placements or [Replicate() for _ in mesh.dim_names])
    if any(isinstance(p, Partial) for p in placements):
        raise NotImplementedError(_PARTIAL)
    t = tensor if torch.is_tensor(tensor) else torch.as_tensor(tensor)
    if dtype is not None:
        from ..device import to_torch_dtype
        t = t.to(to_torch_dtype(dtype))
    out = _move(t, mesh, _held(t, mesh), placements)
    if out is t:
        out = t.view_as(t) if t.requires_grad else t.detach().clone()
    if stop_gradient:
        out = out.detach()
    return _mark(out, mesh, placements)


def dtensor_from_fn(fn, mesh, placements, *args, **kwargs):
    """reference: python/paddle/distributed/auto_parallel/api.py:165"""
    return shard_tensor(fn(*args, **kwargs), mesh, placements)


def reshard(tensor, mesh=None, placements=None):
    """``tensor`` moved to ``placements`` (the collectives of the module
    docstring).

    reference: python/paddle/distributed/auto_parallel/api.py:198
    """
    return shard_tensor(tensor, mesh, placements)


def shard_constraint(tensor, mesh=None, placements=None, spec=None):
    """The move to ``placements`` (or to ``spec``, a tuple with an entry
    a tensor dim) inside a forward, with its autograd; no mesh: the
    tensor as it is."""
    mesh = mesh or get_mesh()
    if mesh is None:
        return tensor
    if spec is not None:
        placements = spec_to_placements(mesh, tuple(spec), tensor.dim())
    placements = list(placements or [Replicate() for _ in mesh.dim_names])
    out = _move(tensor, mesh, _held(tensor, mesh), placements)
    if out is tensor:
        out = tensor.view_as(tensor)
    return _mark(out, mesh, placements)


def unshard_dtensor(tensor):
    """The global tensor of a distributed one, on every rank (no
    autograd, as JAX's copy)."""
    mesh = getattr(tensor, "process_mesh", None)
    if mesh is None:
        return tensor.detach().clone()
    src = tensor.detach()
    with torch.no_grad():
        out = _move(src, mesh, _held(tensor, mesh),
                    [Replicate() for _ in mesh.dim_names])
    return src.clone() if out is src else out


# ---------------------------------------------------------------------------
# parameters gathered on use
# ---------------------------------------------------------------------------

class _Slot:
    """One parameter kept as its part and gathered on use: ``steps`` are
    ``(group, dim)`` in gather order (innermost axis first).  The
    gradients of its uses in a backward pass are summed, and reduce-
    scattered (averaged over each group) once the last use's came."""

    def __init__(self, steps):
        self.steps = list(steps)
        self.param = None             # weakref of the parameter
        self.uses = 0
        self.acc = None

    def gather(self, x):
        for group, dim in self.steps:
            x = C.all_gather_concat(x, axis=dim, group=group)
        return x

    def scatter(self, g):
        for group, dim in reversed(self.steps):
            g = _avg_scatter(g, dim, group)
        return g

    def collect(self, g):
        self.acc = g if self.acc is None else self.acc + g
        self.uses -= 1
        if self.uses > 0:
            _queue_flush()
            return None
        acc, self.acc, self.uses = self.acc, None, 0
        return self.scatter(acc)


#: every slot (weakly), in the order they were made (every rank alike)
_SLOTS: list = []
#: storage address → (the gathered tensor, its slot, its part), weakly
_LIVE: dict = {}
_FLUSH = [False]
#: gathers made again in a backward to rebuild a saved tensor
stats = {"regathers": 0}


def _queue_flush():
    if not _FLUSH[0]:
        _FLUSH[0] = True
        torch.autograd.Variable._execution_engine.queue_callback(_flush)


@torch.no_grad()
def _flush():
    """The end of a backward pass: the sums of parameters whose last use
    sent no gradient (a use outside the loss, a recompute run without a
    draw log) are scattered into their gradients; every count restarts."""
    _FLUSH[0] = False
    _SLOTS[:] = [ref for ref in _SLOTS if ref() is not None]
    for slot in [ref() for ref in _SLOTS]:
        if slot is None:
            continue
        p = slot.param()
        if slot.acc is not None and p is not None:
            g = slot.scatter(slot.acc)
            if p.grad is None:
                p.grad = g
            else:
                p.grad.add_(g)
        slot.acc, slot.uses = None, 0


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, part, slot):
        ctx.slot = slot
        return slot.gather(part)

    @staticmethod
    def backward(ctx, g):
        return ctx.slot.collect(g.contiguous()), None


def _full(part, slot):
    """The global value of ``part``: through `_Gather` (counted as a use)
    when its gradient is wanted, else a plain gather."""
    if not (torch.is_grad_enabled() and part.requires_grad):
        with torch.no_grad():
            return slot.gather(part.detach())
    if not graph_state.recomputing():
        slot.uses += 1
    full = _Gather.apply(part, slot)
    _LIVE[full.untyped_storage().data_ptr()] = (
        weakref.ref(full), slot, weakref.ref(part))
    return full


def _pack(t):
    """Saved-tensor hook: a gathered parameter is saved as a note to
    gather it again in the backward (it is freed after its use)."""
    if not t.is_floating_point():
        return t
    ptr = t.untyped_storage().data_ptr()
    hit = _LIVE.get(ptr)
    if hit is None:
        return t
    full, slot, part = hit[0](), hit[1], hit[2]()
    if full is None or part is None or full.dtype != t.dtype:
        _LIVE.pop(ptr, None)
        return t
    return ("regather", slot, part, tuple(t.shape), t.stride(),
            t.storage_offset())


def _unpack(packed):
    if torch.is_tensor(packed):
        return packed
    _, slot, part, size, stride, offset = packed
    stats["regathers"] += 1
    with torch.no_grad():
        full = slot.gather(part.detach())
    return full.as_strided(size, stride, offset)


_CLASSES: dict = {}


def _gathering_class(cls):
    """``cls`` with its gathered parameters read through `_use` and its
    forward in `_gathering_forward` (made once a class)."""
    sub = _CLASSES.get(cls)
    if sub is not None:
        return sub

    def __getattr__(self, name):
        slots = self.__dict__.get("_gathered")
        if slots is not None and name in slots:
            return _use(self, name, slots[name])
        return cls.__getattr__(self, name)

    def forward(self, *args, **kwargs):
        return _gathering_forward(self, cls.forward, args, kwargs)

    sub = type(cls.__name__, (cls,), {
        "__getattr__": __getattr__, "forward": forward,
        "__module__": cls.__module__, "__qualname__": cls.__qualname__})
    _CLASSES[cls] = sub
    return sub


def _use(module, name, slot):
    live = module.__dict__.get("_gathered_live")
    if live is not None and name in live:
        return live[name]
    full = _full(module._parameters[name], slot)
    if live is not None:
        live[name] = full
    return full


def _gathering_forward(module, forward, args, kwargs):
    """The layer's forward with its gathered parameters kept for the
    call (each gathered once a forward, freed after); a root layer also
    saves its forward's gathered parameters as notes (`_pack`)."""
    d = module.__dict__
    outer = d.get("_gathered_live")
    d["_gathered_live"] = {}
    hooks = contextlib.nullcontext()
    if d.get("_gathered_root") and torch.is_grad_enabled():
        hooks = torch.autograd.graph.saved_tensors_hooks(_pack, _unpack)
    try:
        with hooks:
            return forward(module, *args, **kwargs)
    finally:
        d["_gathered_live"] = outer
        for ptr in [k for k, v in _LIVE.items() if v[0]() is None]:
            del _LIVE[ptr]


def _install(module):
    if type(module) not in _CLASSES.values():
        module.__class__ = _gathering_class(type(module))


def gather_on_use(layer, steps_of):
    """Keep each parameter of ``layer`` that ``steps_of(param)`` gives
    gather steps for (``[(group, dim), ...]``, innermost axis first; None
    or empty: used as it is) as its part, gathered when its module reads
    it.  ``layer`` is the root a step calls: its forward saves the
    gathered parameters as notes to gather again in the backward."""
    for module in layer.modules():
        for name, p in list(module._parameters.items()):
            if p is None or (module.__dict__.get("_gathered") or {}).get(
                    name) is not None:
                continue
            steps = steps_of(p)
            if not steps:
                continue
            slot = getattr(p, "_gather_slot", None)
            if slot is None:
                slot = _Slot(steps)
                slot.param = weakref.ref(p)
                p._gather_slot = slot
                _SLOTS.append(weakref.ref(slot))
            module.__dict__.setdefault("_gathered", {})[name] = slot
            _install(module)
    layer.__dict__["_gathered_root"] = True
    _install(layer)
    return layer


def _axis_steps(mesh, placements, ndim):
    """Gather steps of a part under ``placements``, innermost axis
    first."""
    steps = []
    for a in reversed(range(len(placements))):
        p = placements[a]
        if isinstance(p, Shard):
            group = mesh.get_group(mesh.dim_names[a])
            if group.nranks > 1:
                steps.append((group, p.dim % ndim))
    return steps


def shard_layer(layer, process_mesh=None, shard_fn=None, input_fn=None,
                output_fn=None):
    """Every parameter of ``layer`` committed to the mesh (reference:
    python/paddle/distributed/auto_parallel/api.py shard_layer):
    ``shard_fn(name, sublayer, mesh)`` may set ``param.placements`` (the
    rest stay replicated); each rank keeps its part and the layer
    gathers a sharded parameter on use, so it computes the global
    output, as GSPMD makes JAX's.  ``input_fn(args, mesh)`` and
    ``output_fn(out, mesh)`` wrap the forward."""
    mesh = process_mesh or get_mesh()
    if shard_fn is not None:
        for name, sub in layer.named_modules():
            shard_fn(name, sub, mesh)
    for _, param in layer.named_parameters():
        want = getattr(param, "placements", None)
        if want and getattr(param, "process_mesh", None) is None:
            del param.placements      # a request, not what it holds
        commit_param(param, mesh, want)
    gather_on_use(layer, lambda p: _axis_steps(mesh, p.placements,
                                               p.dim()))
    if input_fn is not None or output_fn is not None:
        orig_forward = layer.forward

        def forward(*args, **kwargs):
            if input_fn is not None:
                args = input_fn(args, mesh)
            out = orig_forward(*args, **kwargs)
            if output_fn is not None:
                out = output_fn(out, mesh)
            return out
        layer.forward = forward
    return layer


__all__ = ["dtensor_from_fn", "gather_on_use", "reshard",
           "shard_constraint", "shard_layer", "shard_tensor",
           "unshard_dtensor"]
