"""Pipeline-parallel model description (port of paddle_tpu/distributed/
fleet/meta_parallel/pp_layers.py): `LayerDesc`, `SharedLayerDesc`,
`segment_uniform`, `segment_by_layer` and `PipelineLayer`.

A model is a flat list of layer descriptors cut into ``num_stages ×
num_virtual_pipeline_stages`` contiguous parts, numbered as JAX numbers
them: chunk c of stage s is part ``c·S + s``.  JAX's single controller
builds every part and commits each to its stage's sub-mesh; here a rank
is a process, and **it builds only its own stage's parts** (the stage is
its pp coordinate in the hybrid topology) and the shared layers they
use.  Without a pp axis above 1 (no `fleet.init`, or pp 1) the one
process builds every part.

Names: the rank's built layers are ``run_function.<i>`` with i the
layer's index in JAX's ``run_function`` list (the descriptors that make
a layer, in order, over the whole model), so a rank's `state_dict`
carries its entries under JAX's global names.  A `SharedLayerDesc` key
that appears twice (GPT's embedding, reused as its head) is one layer in
JAX, named at its first appearance; the port's copy on a later stage is
named the same way (``run_function.0.…``), and both copies hold the same
values (their gradients are summed over the stages that hold them before
each update: `pipeline_parallel.PipelineParallel`).

`stage_layers` of a stage this rank does not hold lists the parts'
descriptors in place of built layers (the same length as JAX's list).

`PipelineLayer.forward` is JAX's global-view forward: stage by stage,
each stage's output sent to the next stage's rank of the same
dp/sharding/mp place (`collective.send` / `recv`, its shape first), and
the last stage's output broadcast over the pp group, so every rank
returns what JAX returns.  No gradient crosses ranks there: training
runs through `PipelineParallel.train_batch`.
"""
from __future__ import annotations

import re

import torch
from torch import nn

from ... import collective as C
from ... import env as _env


class LayerDesc:
    """Deferred layer constructor (reference: pp_layers.py:56)."""

    def __init__(self, layer_cls, *args, **kwargs):
        self.layer_cls = layer_cls
        self.args = args
        self.kwargs = kwargs
        if not issubclass(layer_cls, nn.Module):
            raise TypeError(f"{layer_cls} must be a torch.nn.Module")

    def build_layer(self):
        return self.layer_cls(*self.args, **self.kwargs)

    def __repr__(self):
        return f"LayerDesc({self.layer_cls.__name__})"


class SharedLayerDesc(LayerDesc):
    """A layer whose parameters are shared between pipeline stages
    (reference: pp_layers.py SharedLayerDesc — e.g. tied embeddings).
    Each stage that uses it holds a copy; the copies are kept equal."""

    def __init__(self, key, layer_cls, *args, forward_func=None,
                 shared_weight_attr="weight", **kwargs):
        super().__init__(layer_cls, *args, **kwargs)
        self.layer_name = key
        self.forward_func = forward_func
        self.shared_weight_attr = shared_weight_attr


def segment_uniform(num_items, num_parts):
    """Balanced contiguous partition: item counts differ by at most 1
    (reference: pp_layers.py SegmentLayers uniform strategy)."""
    base, rem = divmod(num_items, num_parts)
    bounds = [0]
    for i in range(num_parts):
        bounds.append(bounds[-1] + base + (1 if i < rem else 0))
    return bounds


def segment_by_layer(descs, num_parts, layer_name):
    """'layer:Pattern' strategy — split so each part gets an equal share of
    the layers whose class name matches ``layer_name``."""
    weights = [1 if re.search(layer_name, type(d).__name__
                              if not isinstance(d, LayerDesc)
                              else d.layer_cls.__name__) else 0
               for d in descs]
    total = sum(weights)
    if total == 0:
        return segment_uniform(len(descs), num_parts)
    per = segment_uniform(total, num_parts)
    bounds, acc, part = [0], 0, 1
    for i, w in enumerate(weights):
        acc += w
        while part < num_parts and acc >= per[part] + 1 \
                and len(bounds) <= part:
            bounds.append(i)
            part += 1
    while len(bounds) < num_parts:
        bounds.append(len(descs))
    bounds.append(len(descs))
    return bounds[:num_parts + 1]


def _is_layer(d):
    return isinstance(d, (LayerDesc, nn.Module))


_DTYPES = [torch.float32, torch.bfloat16, torch.float16, torch.float64,
           torch.int64, torch.int32, torch.bool, torch.uint8, torch.int8]
_MAX_DIMS = 8


def tensor_head(x, device):
    """An int64 head naming ``x``'s dtype and shape (zeros for None), for
    a peer that must allocate the tensor before it receives it."""
    head = torch.zeros(2 + _MAX_DIMS, dtype=torch.int64, device=device)
    if x is not None:
        meta = [_DTYPES.index(x.dtype), x.dim(), *x.shape]
        head[:len(meta)] = torch.tensor(meta, dtype=torch.int64)
    return head


def head_spec(head):
    """(shape, dtype) a `tensor_head` names (read to the host)."""
    h = head.tolist()
    return tuple(h[2:2 + h[1]]), _DTYPES[h[0]]


def _empty(spec, device):
    shape, dtype = spec
    return torch.empty(shape, dtype=dtype, device=device)


def send_tensor(x, dst, group):
    """``x`` to global rank ``dst``: its head, then its data
    (`recv_tensor` takes both)."""
    C.send(tensor_head(x, x.device), dst=dst, group=group)
    C.send(x.contiguous(), dst=dst, group=group)


def recv_tensor(src, group, device):
    """A tensor `send_tensor` sent from global rank ``src``."""
    head = C.recv(tensor_head(None, device), src=src, group=group)
    return C.recv(_empty(head_spec(head), device), src=src, group=group)


def broadcast_tensor(x, src, group, device):
    """``x`` of global rank ``src`` on every rank of ``group`` (the
    others pass None): its head, then its data."""
    head = C.broadcast(tensor_head(x, device), src=src, group=group)
    x = _empty(head_spec(head), device) if x is None else x.contiguous()
    return C.broadcast(x, src=src, group=group)


class PipelineLayer(nn.Module):
    """reference: pp_layers.py:237.

    layers      — list of LayerDesc / modules / callables
    num_stages  — pipeline depth (defaults to the topology's pp degree)
    seg_method  — "uniform" or "layer:ClassNamePattern"
    num_virtual_pipeline_stages — chunks per stage for interleaved 1F1B

    A ``num_stages`` above 1 without a pp axis builds every stage in this
    process (JAX's host-sequential case); with one it must equal the pp
    degree."""

    def __init__(self, layers, num_stages=None, topology=None,
                 seg_method="uniform", loss_fn=None,
                 num_virtual_pipeline_stages=1, recompute_interval=0):
        super().__init__()
        from ... import topology as _topo
        hcg = _topo.get_hybrid_communicate_group()
        pp = 1 if hcg is None else hcg.get_pipe_parallel_world_size()
        if num_stages is None:
            num_stages = pp
        if pp > 1 and num_stages != pp:
            raise ValueError(f"PipelineLayer: num_stages {num_stages} != "
                             f"the topology's pp degree {pp}")
        self._num_stages = num_stages
        self._num_chunks = num_virtual_pipeline_stages
        self._loss_fn = loss_fn
        self._descs = list(layers)
        self._pp_group = None if pp <= 1 else hcg.get_pipe_parallel_group()
        #: the stages this process holds
        self._local_stages = list(range(num_stages)) if pp <= 1 else \
            [hcg.get_pipe_parallel_rank()]

        n_parts = num_stages * self._num_chunks
        if seg_method.startswith("layer:"):
            bounds = segment_by_layer(self._descs, n_parts,
                                      seg_method.split("layer:", 1)[1])
        else:
            bounds = segment_uniform(len(self._descs), n_parts)
        self._segment_bounds = bounds

        # JAX's run_function index of each descriptor (a repeated shared
        # key: its first appearance's)
        index, first, n = [], {}, 0
        for d in self._descs:
            if isinstance(d, SharedLayerDesc) and d.layer_name in first:
                index.append(first[d.layer_name])
                continue
            if isinstance(d, SharedLayerDesc):
                first[d.layer_name] = n
            index.append(n if _is_layer(d) else None)
            n += _is_layer(d)

        self._shared_layers = {}
        self.run_function = nn.ModuleDict()
        self._parts = []
        self._part_keys = []        # each item's shared key, or None
        for part_id in range(n_parts):
            local = part_id % num_stages in self._local_stages
            part, keys = [], []
            for j in range(bounds[part_id], bounds[part_id + 1]):
                d = self._descs[j]
                shared = isinstance(d, SharedLayerDesc)
                item = self._build(d, index[j]) if local else d
                part.append((item, d.forward_func if shared else None,
                             shared))
                keys.append(d.layer_name if shared else None)
            self._parts.append(part)
            self._part_keys.append(keys)

    def _build(self, d, idx):
        if isinstance(d, SharedLayerDesc):
            layer = self._shared_layers.get(d.layer_name)
            if layer is None:
                layer = self._shared_layers[d.layer_name] = d.build_layer()
        elif isinstance(d, LayerDesc):
            layer = d.build_layer()
        elif isinstance(d, nn.Module) or callable(d):
            layer = d
        else:
            raise TypeError(f"cannot build pipeline item {d!r}")
        if idx is not None and str(idx) not in self.run_function:
            self.run_function[str(idx)] = layer
        return layer

    # ---- stage/partition introspection (JAX's) ----
    def get_num_stages(self):
        return self._num_stages

    def get_stage_from_index(self, idx):
        for part_id in range(len(self._parts)):
            lo, hi = self._segment_bounds[part_id], \
                self._segment_bounds[part_id + 1]
            if lo <= idx < hi:
                return part_id % self._num_stages
        raise IndexError(idx)

    def stage_layers(self, stage, chunk=0):
        return self._parts[chunk * self._num_stages + stage]

    def shared_stages(self, key):
        """The stages whose parts use shared layer ``key``, in order."""
        return sorted({part_id % self._num_stages
                       for part_id, keys in enumerate(self._part_keys)
                       if key in keys})

    def run_part(self, part_id, x):
        """Part ``part_id``'s items on ``x`` (a part this rank holds)."""
        for item, fwd, _ in self._parts[part_id]:
            x = fwd(item, x) if fwd is not None else item(x)
        return x

    def global_output(self, out):
        """The global-view forward's output from the last part's (a model
        whose last part leaves an mp-split output gathers it here)."""
        return out

    def _stage_rank(self, stage):
        return self._pp_group.ranks[stage]

    def forward(self, x, chunk_id=None):
        """Global-view forward: every part in order (``chunk_id``: that
        chunk's parts only), the activation handed from stage to stage
        over the pp group; every rank returns the last stage's output."""
        n_parts = self._num_stages * self._num_chunks
        parts = list(range(n_parts)) if chunk_id is None else \
            [chunk_id * self._num_stages + s
             for s in range(self._num_stages)]
        if self._pp_group is None:
            for part_id in parts:
                x = self.run_part(part_id, x)
            return self.global_output(x)
        me = self._local_stages[0]
        dev = _env.current_device()
        for i, part_id in enumerate(parts):
            stage = part_id % self._num_stages
            prev = parts[i - 1] % self._num_stages if i else None
            if stage == me:
                if prev is not None and prev != me:
                    x = recv_tensor(self._stage_rank(prev), self._pp_group,
                                    dev)
                x = self.run_part(part_id, x)
                nxt = parts[i + 1] % self._num_stages \
                    if i + 1 < len(parts) else None
                if nxt is not None and nxt != me:
                    send_tensor(x, self._stage_rank(nxt), self._pp_group)
        last = parts[-1] % self._num_stages
        out = self.global_output(x) if last == me else None
        return broadcast_tensor(out, self._stage_rank(last),
                                self._pp_group, dev)

