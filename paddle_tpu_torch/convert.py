"""Weights and optimizer state across the two packages.

The port keeps paddle_tpu's parameter names and layouts (``Linear`` is
``[in, out]``), so a paddle_tpu state dict, taken to numpy arrays, maps
name for name onto a port model with no transpose::

    np_state = {k: np.asarray(v._data_) for k, v in jax_model.state_dict().items()}
    load_paddle_tpu_state(torch_model, np_state)

An optimizer's state (``moment1.<i>``, ``moment2.<i>``, ``master.<i>``,
``step_count``, ``step_tensor``, and ``LR_Scheduler`` with a schedule) is
indexed by the position of the parameter in the optimizer's list;
`load_paddle_tpu_optimizer_state` carries it over when the port's
optimizer lists the port model's parameters in the JAX optimizer's order
(``model.parameters()`` on both sides: the port's modules register them in
the JAX package's order).  The step counter lands in the optimizer's
device tensor and the schedule's state in its `LRScheduler`;
`load_paddle_tpu_scaler_state` adopts a ``GradScaler.state_dict()``.  A
run resumed so continues as the JAX compiled step does.

A model split over mp (the tensor-parallel layers) or sharded by ZeRO
(`distributed.fleet.sharding`) holds a part of each such parameter:
`shard_paddle_tpu_state` cuts the global arrays to the rank's parts
(mp first, then the rows over the sharding group) and
`gather_paddle_tpu_state` joins them back (the rows, then mp) bit for
bit; the optimizer's state the same way, its ZeRO rows included.

A pipeline model (`GPTForCausalLMPipe`, any `PipelineLayer`) holds its
stage's entries under JAX's global names: `shard_pipeline_state` takes
the global state to this rank's (its stage's names, each cut to its mp
part) and `gather_pipeline_state` puts the whole model's back together
over mp and pp.
"""
from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device, to_torch_dtype


def state_dict_from_paddle_tpu(np_state, device=None, dtype=None):
    """``{name: np.ndarray}`` → ``{name: torch.Tensor}`` on ``device``
    (None → the card), cast to ``dtype`` when given."""
    dev = resolve_device(device)
    dt = to_torch_dtype(dtype) if dtype is not None else None
    out = {}
    for name, arr in np_state.items():
        t = torch.tensor(np.asarray(arr))     # a copy the caller cannot alias
        out[name] = t.to(device=dev, dtype=dt if dt is not None else t.dtype)
    return out


def load_paddle_tpu_state(model, np_state):
    """Copy a paddle_tpu state dict (numpy arrays) into ``model`` in
    place, on the model's device and in its dtype.  Raises on a missing,
    unexpected or mis-shaped key."""
    own = model.state_dict()
    missing = sorted(set(own) - set(np_state))
    unexpected = sorted(set(np_state) - set(own))
    if missing or unexpected:
        raise KeyError(f"state dict mismatch: missing {missing}, "
                       f"unexpected {unexpected}")
    for name, arr in np_state.items():
        if tuple(arr.shape) != tuple(own[name].shape):
            raise ValueError(f"{name}: shape {tuple(arr.shape)} != model's "
                             f"{tuple(own[name].shape)}")
    ref = next(iter(own.values()))
    tensors = state_dict_from_paddle_tpu(np_state, device=ref.device,
                                         dtype=ref.dtype)
    with torch.no_grad():
        for name, t in tensors.items():
            own[name].copy_(t)
    return model


def load_paddle_tpu_optimizer_state(optimizer, np_state):
    """Adopt a paddle_tpu optimizer's ``state_dict()`` (values taken to
    numpy arrays or Python numbers) into a port optimizer of the same
    kind, copying each tensor onto its parameter's device.  Raises on a
    key the port optimizer has no slot for."""
    optimizer._ensure_state()
    n = len(optimizer._all_params())
    names = set(optimizer._state)
    for key in np_state:
        if key in ("step_count", "step_tensor", "LR_Scheduler"):
            continue
        name, _, idx = key.rpartition(".")
        if name not in names or not idx.isdigit() or int(idx) >= n:
            raise KeyError(f"optimizer state key {key!r} has no slot in "
                           f"{type(optimizer).__name__} (state "
                           f"{sorted(names)}, {n} parameters)")
    optimizer.set_state_dict(dict(np_state))
    return optimizer


def load_paddle_tpu_scaler_state(scaler, state):
    """Adopt a paddle_tpu ``GradScaler.state_dict()`` (``scale``,
    ``good_steps``, ``bad_steps``; numbers or 0-dim arrays) into a port
    `amp.GradScaler`."""
    scaler.load_state_dict({k: np.asarray(state[k]).item()
                            for k in ("scale", "good_steps", "bad_steps")})
    return scaler


# ---------------------------------------------------------------------------
# a model split over mp (the tensor-parallel layers)
# ---------------------------------------------------------------------------

def _bare(model):
    """The model a data-axis wrapper (`DataParallel`, `SegmentParallel`)
    holds, else ``model``: the names of its state dict are the model's."""
    from .distributed.parallel import DataParallel
    return model._layers if isinstance(model, DataParallel) else model


def _splits(model):
    """``{parameter name: (dim, chunks)}`` of ``model``'s parameters that a
    tensor-parallel layer splits over mp (the rest are copies)."""
    from .distributed.fleet.mp_layers import _MPLayer
    model = _bare(model)
    out = {}
    for prefix, mod in model.named_modules():
        if isinstance(mod, _MPLayer):
            for pname, (dim, chunks) in mod._split.items():
                if dim is not None and \
                        mod._parameters.get(pname) is not None:
                    out[f"{prefix}.{pname}" if prefix else pname] = \
                        (dim, chunks)
    return out


def _mp():
    from .distributed import topology
    g = topology.mp_group()
    return g, (1 if g is None else g.nranks), (0 if g is None else g.rank)


def _gather_steps(model):
    """``{parameter name: gather steps}`` of the parameters ``model``
    gathers on use (ZeRO stage 3, `distributed.api.shard_layer`): the
    ``(group, dim)`` joins from the rank's part to the parameter its
    module reads."""
    return {name: p._gather_slot.steps
            for name, p in _bare(model).named_parameters()
            if getattr(p, "_gather_slot", None) is not None}


def _cut(arr, steps):
    """The rank's part of ``arr`` (numpy) under gather ``steps``
    (outermost join first)."""
    from .distributed.placement import shard_bounds
    for group, dim in reversed(steps):
        lo, hi = shard_bounds(arr.shape[dim], group.nranks, group.rank)
        arr = np.take(arr, np.arange(lo, hi), axis=dim)
    return arr


def _join(t, steps):
    """The parameter ``t`` (a part) makes under gather ``steps``."""
    from .distributed import collective
    for group, dim in steps:
        t = collective.all_gather_concat(t.contiguous(), axis=dim,
                                         group=group)
    return t


def shard_paddle_tpu_state(np_state, model):
    """A paddle_tpu state dict of the global model (numpy, JAX names) →
    this rank's part: each parameter that a tensor-parallel layer of
    ``model`` splits cut by its placement (`distributed.fleet.mp_layers.
    shard_of`), then each that ``model`` gathers on use (ZeRO stage 3)
    cut to its rows; the others whole.  Load it with
    `load_paddle_tpu_state`."""
    from .distributed.fleet.mp_layers import shard_of
    splits = _splits(model)
    steps = _gather_steps(model)
    _, n, r = _mp()
    out = {}
    for name, arr in np_state.items():
        arr = np.asarray(arr)
        if name in splits and n > 1:
            dim, chunks = splits[name]
            arr = shard_of(torch.from_numpy(np.ascontiguousarray(arr)), dim,
                           n, r, chunks).numpy()
        if name in steps:
            arr = np.ascontiguousarray(_cut(arr, steps[name]))
        out[name] = arr
    return out


def _gather_part(t, split):
    """The global tensor of a part ``t`` split as ``split`` (every rank of
    the mp group takes part)."""
    from .distributed import collective
    from .distributed.fleet.mp_layers import unshard
    g, n, _ = _mp()
    if split is None or n <= 1:
        return t
    dim, chunks = split
    parts = collective.all_gather(None, t.contiguous(), group=g)
    return unshard(list(parts), dim, chunks)


def gather_paddle_tpu_state(model, dst=None):
    """The global model's state dict as numpy arrays (JAX names), put
    together over the mp group: on every rank, or with ``dst`` (a global
    rank) on that rank only (the others get None).  Every rank of the
    group calls it."""
    from .distributed import env
    splits = _splits(model)
    steps = _gather_steps(model)
    keep = dst is None or env.get_rank() == dst
    out = {}
    for name, t in model.state_dict().items():
        t = _join(t.detach(), steps.get(name, ()))
        full = _gather_part(t, splits.get(name))
        if not keep:
            continue
        if full.dtype == torch.bfloat16:     # numpy has no bf16: its
            full = full.float()              # values exactly, in fp32
        out[name] = full.cpu().numpy()
    return out if keep else None


def _param_splits(model, optimizer):
    """The split of each of the optimizer's parameters (by position)."""
    splits = _splits(model)
    by_id = {id(p): splits.get(name)
             for name, p in _bare(model).named_parameters()}
    return [by_id.get(id(p)) for p in optimizer._all_params()]


def shard_paddle_tpu_optimizer_state(np_state, model, optimizer):
    """A paddle_tpu optimizer state of the global model → this rank's
    part: each per-parameter tensor (``moment1.<i>``, ``master.<i>``, ...)
    whose shape is its parameter's global one cut as the parameter is.
    Load it with `load_paddle_tpu_optimizer_state`."""
    from .distributed.fleet.mp_layers import shard_of
    splits = _param_splits(model, optimizer)
    params = optimizer._all_params()
    zero = getattr(optimizer, "_zero", None)
    _, n, r = _mp()
    out = {}
    for key, val in np_state.items():
        name, _, idx = key.rpartition(".")
        if not (idx.isdigit() and int(idx) < len(params)):
            out[key] = val
            continue
        p = params[int(idx)]
        local = _local_shape(zero, p)
        if n > 1 and splits[int(idx)] is not None:
            arr = np.asarray(val)
            dim, chunks = splits[int(idx)]
            if arr.ndim == p.dim() and arr.shape[dim] == local[dim] * n:
                val = shard_of(torch.from_numpy(np.ascontiguousarray(arr)),
                               dim, n, r, chunks).numpy()
        if zero is not None and np.shape(val) == local and \
                zero.kind(p)[0] != "whole":
            g = zero.group
            val = np.ascontiguousarray(_cut(np.asarray(val), [(g, 0)]))
        out[key] = val
    return out


def _local_shape(zero, p):
    """The shape of ``p`` whole on this rank's mp part."""
    return tuple(p.shape) if zero is None else zero.full_shape(p)


def gather_paddle_tpu_optimizer_state(model, optimizer, dst=None):
    """The optimizer's state for the global model (numpy, JAX keys), put
    together over the mp group as `gather_paddle_tpu_state` does."""
    from .distributed import env
    splits = _param_splits(model, optimizer)
    params = optimizer._all_params()
    zero = getattr(optimizer, "_zero", None)
    out = {}
    for key, val in optimizer.state_dict().items():
        name, _, idx = key.rpartition(".")
        if torch.is_tensor(val):
            split = None
            val = val.detach()
            if idx.isdigit() and int(idx) < len(params):
                p = params[int(idx)]
                if zero is not None and val.dim() and \
                        zero.kind(p)[0] != "whole" and \
                        tuple(val.shape) == tuple(zero.state_view(p).shape):
                    val = _join(val, [(zero.group, 0)])
                if tuple(val.shape) == _local_shape(zero, p):
                    split = splits[int(idx)]
            val = _gather_part(val, split).cpu().numpy()
        out[key] = val
    if dst is not None and env.get_rank() != dst:
        return None
    return out


# ---------------------------------------------------------------------------
# a pipeline model (each rank its stage)
# ---------------------------------------------------------------------------

def _pipeline_layer(model):
    """The `PipelineLayer` of ``model`` (a `PipelineParallel` wraps it)."""
    return getattr(model, "_layers", model)


def shard_pipeline_state(np_state, model):
    """A paddle_tpu state dict of the global pipeline model (numpy, JAX's
    ``run_function.<i>`` names) → this rank's: the entries its stage
    holds (a tied layer's copy under its first name, as JAX names it),
    each cut to the rank's mp part (`shard_paddle_tpu_state`).  Load it
    with `load_paddle_tpu_state`."""
    layers = _pipeline_layer(model)
    own = layers.state_dict()
    return shard_paddle_tpu_state(
        {k: v for k, v in np_state.items() if k in own}, layers)


def gather_pipeline_state(model, dst=None):
    """The global pipeline model's state dict (numpy, JAX's names): each
    stage's entries joined over mp (`gather_paddle_tpu_state`), then the
    stages' gathered over the pp group (a tied layer's copies hold the
    same values: the first stage's is kept); on every rank, or with
    ``dst`` on that global rank only (the others get None).  Every rank
    calls it."""
    from .distributed import env
    from .distributed.compat import all_gather_object
    layers = _pipeline_layer(model)
    mine = gather_paddle_tpu_state(layers)
    group = layers._pp_group
    parts = [mine]
    if group is not None:
        parts = []
        all_gather_object(parts, mine, group=group)
    out = {}
    for part in parts:
        for k, v in part.items():
            out.setdefault(k, v)
    return out if dst is None or env.get_rank() == dst else None
