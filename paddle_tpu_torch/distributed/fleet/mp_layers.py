"""Tensor-parallel (Megatron) layers (port of
paddle_tpu/distributed/fleet/mp_layers.py): `ColumnParallelLinear`,
`RowParallelLinear`, `VocabParallelEmbedding`, `ParallelCrossEntropy`,
the sequence-parallel linears and the sequence split/gather ops.

Each rank of the model-parallel group holds only its shard: weight
``[in, out / mp]`` for a column layer (its bias ``[out / mp]``), ``[in /
mp, out]`` for a row layer (its bias whole), ``[V / mp, H]`` for the
vocab embedding, with the JAX package's names and ``[in, out]`` layout.
Each parameter records its placement as JAX's do (``mp_placement``,
``("mp", Shard(d))``), ``mp_split`` (True when it is split) and
``mp_group`` (the group it is split over; the global-norm clip sums its
gradient's square over that group); a column
layer over a fused projection (``chunks=3``: GPT's q, k, v) splits each
chunk, so a rank's columns are its heads' q, k and v.

JAX leaves the collectives to GSPMD; here they are explicit autograd
functions over the group (`distributed.collective`):

- copy to the mp region: identity forward, all-reduce backward;
- reduce from it: all-reduce forward, identity backward;
- gather: all-gather forward, this rank's part backward (or a
  reduce-scatter, at a sequence-parallel column layer's input);
- split: this rank's part forward, all-gather backward;
- reduce-scatter (a sequence-parallel row layer's output): all-gather
  backward;
- the vocab-parallel cross entropy: the max and the sum of exponentials
  all-reduced over mp, the target's logit taken on the rank that owns
  it, and a backward of softmax − one-hot on the local slice.

The products stay ``torch.matmul`` (`nn.functional.linear`), as JAX
computes them outside any Pallas kernel.  A layer built without a model-
parallel group (no `fleet.init`, or mp 1) holds the global parameters;
`fleet.distributed_model` shards it later (`shard_`).
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ...device import resolve_device
from ...nn import functional as F
from ...nn.layers import _init, _no_param_attr
from .. import collective as C
from .. import topology
from ..placement import Replicate, Shard, shard_bounds


def _nranks(group):
    return 1 if group is None else group.nranks


def _rank(group):
    return 0 if group is None else max(group.rank, 0)


def _chunk_index(size, chunks, n, r):
    """Indices of rank ``r``'s part of a dim of ``size`` made of
    ``chunks`` equal chunks, each split into ``n`` parts."""
    per = size // chunks
    lo, hi = shard_bounds(per, n, r)
    return torch.cat([torch.arange(c * per + lo, c * per + hi)
                      for c in range(chunks)])


def shard_of(tensor, dim, n, r, chunks=1):
    """Rank ``r``'s part of global ``tensor`` along ``dim`` (``chunks``
    equal chunks, each split into ``n`` parts), a new tensor."""
    if n <= 1:
        return tensor.clone()
    if chunks == 1:
        lo, hi = shard_bounds(tensor.shape[dim], n, r)
        return tensor.narrow(dim, lo, hi - lo).clone()
    idx = _chunk_index(tensor.shape[dim], chunks, n, r).to(tensor.device)
    return tensor.index_select(dim, idx)


def unshard(parts, dim, chunks=1):
    """The global tensor from every rank's part (`shard_of`'s inverse)."""
    if len(parts) == 1:
        return parts[0]
    if chunks == 1:
        return torch.cat(parts, dim=dim)
    pieces = [p.chunk(chunks, dim=dim) for p in parts]
    return torch.cat([pieces[r][c] for c in range(chunks)
                      for r in range(len(parts))], dim=dim)


# ---------------------------------------------------------------------------
# the region functions
# ---------------------------------------------------------------------------

class _CopyToMP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        C.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromMP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        C.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    """All-gather along ``dim`` (chunk-aware); backward: this rank's part,
    or with ``reduce_back`` the reduce-scatter of the gradients."""

    @staticmethod
    def forward(ctx, x, group, dim, chunks, reduce_back):
        ctx.cfg = (group, dim, chunks, reduce_back)
        if chunks == 1:
            return C.all_gather_concat(x, axis=dim, group=group)
        parts = list(C.all_gather_concat(x, axis=dim, group=group).chunk(
            group.nranks, dim=dim))
        return unshard(parts, dim, chunks)

    @staticmethod
    def backward(ctx, g):
        group, dim, chunks, reduce_back = ctx.cfg
        if reduce_back:
            return C.reduce_scatter_concat(g, axis=dim, group=group), \
                None, None, None, None
        return shard_of(g, dim, group.nranks, group.rank, chunks), \
            None, None, None, None


class _Split(torch.autograd.Function):
    """This rank's part along ``dim``; backward: all-gather."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.cfg = (group, dim)
        return shard_of(x, dim, group.nranks, group.rank)

    @staticmethod
    def backward(ctx, g):
        group, dim = ctx.cfg
        return C.all_gather_concat(g, axis=dim, group=group), None, None


class _ReduceScatter(torch.autograd.Function):
    """Sum over the group, this rank's part along ``dim``; backward:
    all-gather."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.cfg = (group, dim)
        return C.reduce_scatter_concat(x, axis=dim, group=group)

    @staticmethod
    def backward(ctx, g):
        group, dim = ctx.cfg
        return C.all_gather_concat(g, axis=dim, group=group), None, None


def copy_to_mp(x, group):
    return x if _nranks(group) <= 1 else _CopyToMP.apply(x, group)


def reduce_from_mp(x, group):
    return x if _nranks(group) <= 1 else _ReduceFromMP.apply(x, group)


def gather_from_mp(x, group, dim=-1, chunks=1, reduce_back=False):
    if _nranks(group) <= 1:
        return x
    return _Gather.apply(x, group, dim % x.dim(), chunks, reduce_back)


def split_to_mp(x, group, dim=-1):
    return x if _nranks(group) <= 1 else _Split.apply(x, group,
                                                      dim % x.dim())


def reduce_scatter_to_mp(x, group, dim=1):
    if _nranks(group) <= 1:
        return x
    return _ReduceScatter.apply(x, group, dim % x.dim())


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

class _MPLayer(nn.Module):
    """A layer whose parameters split over the mp group: ``_split`` maps
    a parameter's name to ``(dim or None, chunks)``."""

    _split: dict = {}

    def _bind(self, mp_group):
        self.mp_group = mp_group if mp_group is not None else \
            topology.mp_group()
        self.world_size = _nranks(self.mp_group)
        self.rank = _rank(self.mp_group)

    def _new(self, name, shape, device, dtype):
        dim, chunks = self._split[name]
        local = list(shape)
        if dim is not None and self.world_size > 1:
            if shape[dim] % (chunks * self.world_size):
                raise ValueError(
                    f"{type(self).__name__}.{name}: dim {dim} of "
                    f"{tuple(shape)} does not split into {chunks} x "
                    f"{self.world_size} equal parts")
            local[dim] //= self.world_size
        p = nn.Parameter(torch.empty(local, device=device, dtype=dtype))
        self._mark(p, dim)
        return p

    def _mark(self, p, dim):
        p.mp_placement = ("mp", Shard(dim) if dim is not None
                          else Replicate())
        p.mp_split = dim is not None and self.world_size > 1
        p.mp_group = self.mp_group if p.mp_split else None

    def _fill(self, name, global_value):
        """Copy this rank's part of ``global_value`` into parameter
        ``name``."""
        dim, chunks = self._split[name]
        p = getattr(self, name)
        if dim is not None:
            global_value = shard_of(global_value, dim, self.world_size,
                                    self.rank, chunks)
        p.copy_(global_value)

    def shard_(self, mp_group):
        """Split parameters that hold global values onto this rank of
        ``mp_group`` (in place), or check that they are split already."""
        group = mp_group if mp_group is not None else topology.mp_group()
        n, r = _nranks(group), _rank(group)
        held = self.world_size
        for name, (dim, chunks) in self._split.items():
            p = self._parameters.get(name)
            if p is None or dim is None:
                continue
            if held == n and (n == 1 or group is self.mp_group):
                continue
            if held != 1:
                raise ValueError(
                    f"{type(self).__name__}.{name} is split over "
                    f"{held} ranks, not the {n} of {group}")
            with torch.no_grad():
                p.data = shard_of(p.data, dim, n, r, chunks)
        self.mp_group, self.world_size, self.rank = group, n, r
        for name, (dim, _) in self._split.items():
            p = self._parameters.get(name)
            if p is not None:
                self._mark(p, dim)
        return self


class ColumnParallelLinear(_MPLayer):
    """y = x W + b with the output features split over mp
    (reference: fleet/layers/mpu/mp_layers.py:325).  ``gather_output``
    joins the parts (all-gather); otherwise each rank keeps its
    ``out / mp`` features.  ``chunks`` (the port's): the output is made
    of that many equal chunks, each split over mp."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, gather_output=True, fuse_matmul_bias=False,
                 mp_group=None, name=None, *, std=None, chunks=1,
                 device=None, dtype=torch.float32):
        super().__init__()
        _no_param_attr("ColumnParallelLinear", weight_attr=weight_attr)
        device = resolve_device(device)
        self._bind(mp_group)
        self._split = {"weight": (1, chunks), "bias": (0, chunks)}
        self.in_features = in_features
        self.out_features = out_features
        self.gather_output = gather_output
        self.chunks = chunks
        self.std = std
        self.weight = self._new("weight", (in_features, out_features),
                                device, dtype)
        self.bias = self._new("bias", (out_features,), device, dtype) \
            if has_bias else None
        _init(self)

    @property
    def output_size_per_partition(self):
        return self.weight.shape[1]

    def reset_parameters(self, generator):
        std = self.std if self.std is not None else \
            math.sqrt(2.0 / (self.in_features + self.out_features))
        w = torch.empty(self.in_features, self.out_features,
                        device=self.weight.device, dtype=self.weight.dtype)
        self._fill("weight", w.normal_(0.0, std, generator=generator))
        if self.bias is not None:
            self.bias.zero_()

    def region_input(self, x):
        """``x`` entering the mp region: the identity whose backward
        all-reduces the input's gradient.  Layers that read one input
        share it (one all-reduce for all of them, as Megatron's fused
        q, k, v): ``local_forward(region_input(x))`` each."""
        return copy_to_mp(x, self.mp_group)

    def local_forward(self, x):
        """The product on an input already in the mp region."""
        y = F.linear(x, self.weight, self.bias)
        if self.gather_output:
            y = gather_from_mp(y, self.mp_group, -1, self.chunks)
        return y

    def forward(self, x):
        return self.local_forward(self.region_input(x))


class RowParallelLinear(_MPLayer):
    """y = x W + b with the input features split over mp; the partial
    products are all-reduced, then the (whole) bias is added (reference:
    fleet/layers/mpu/mp_layers.py:532).  Without ``input_is_parallel``
    the input is split first."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=False,
                 fuse_matmul_bias=False, mp_group=None, name=None, *,
                 std=None, device=None, dtype=torch.float32):
        super().__init__()
        _no_param_attr("RowParallelLinear", weight_attr=weight_attr)
        device = resolve_device(device)
        self._bind(mp_group)
        self._split = {"weight": (0, 1), "bias": (None, 1)}
        self.in_features = in_features
        self.out_features = out_features
        self.input_is_parallel = input_is_parallel
        self.std = std
        self.weight = self._new("weight", (in_features, out_features),
                                device, dtype)
        self.bias = self._new("bias", (out_features,), device, dtype) \
            if has_bias else None
        _init(self)

    @property
    def input_size_per_partition(self):
        return self.weight.shape[0]

    def reset_parameters(self, generator):
        std = self.std if self.std is not None else \
            math.sqrt(2.0 / (self.in_features + self.out_features))
        w = torch.empty(self.in_features, self.out_features,
                        device=self.weight.device, dtype=self.weight.dtype)
        self._fill("weight", w.normal_(0.0, std, generator=generator))
        if self.bias is not None:
            self.bias.zero_()

    def _partial(self, x):
        if not self.input_is_parallel:
            x = split_to_mp(x, self.mp_group, -1)
        return torch.matmul(x, self.weight)

    def forward(self, x):
        y = reduce_from_mp(self._partial(x), self.mp_group)
        return y + self.bias if self.bias is not None else y


class VocabParallelEmbedding(_MPLayer):
    """Embedding with the vocabulary split over mp (reference:
    fleet/layers/mpu/mp_layers.py:47): each rank looks up the ids it owns,
    zeros the others, and the rows are all-reduced.  N(0, ``std``²) at
    init (JAX's default 0.02)."""

    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 mp_group=None, name=None, *, std=0.02, device=None,
                 dtype=torch.float32):
        super().__init__()
        _no_param_attr("VocabParallelEmbedding", weight_attr=weight_attr)
        device = resolve_device(device)
        self._bind(mp_group)
        self._split = {"weight": (0, 1)}
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.std = std
        self.weight = self._new("weight", (num_embeddings, embedding_dim),
                                device, dtype)
        _init(self)

    def reset_parameters(self, generator):
        w = torch.empty(self.num_embeddings, self.embedding_dim,
                        device=self.weight.device, dtype=self.weight.dtype)
        self._fill("weight", w.normal_(0.0, self.std, generator=generator))

    def forward(self, x):
        if self.world_size <= 1:
            return F.embedding(x, self.weight)
        if x.is_floating_point() or x.is_complex():
            raise ValueError("indices must have an integer type")
        rows = self.weight.shape[0]
        start = self.rank * rows
        local = x.long() - start
        outside = (local < 0) | (local >= rows)
        out = F.embedding(local.masked_fill(outside, 0), self.weight)
        out = out * (~outside)[..., None].to(out.dtype)
        return reduce_from_mp(out, self.mp_group)


class _VocabParallelXent(torch.autograd.Function):
    """Per-row softmax cross entropy over vocab-split logits (fp32), the
    reference's c_softmax_with_cross_entropy."""

    @staticmethod
    def forward(ctx, logits, label, group, ignore_index):
        x = logits.float()
        n_local = x.shape[-1]
        m = x.max(dim=-1, keepdim=True).values
        C.all_reduce(m, op=C.ReduceOp.MAX, group=group)
        se = torch.exp(x - m).sum(dim=-1, keepdim=True)
        C.all_reduce(se, group=group)
        lse = m + torch.log(se)
        local = label.long() - group.rank * n_local
        own = (local >= 0) & (local < n_local)
        idx = local.clamp(0, n_local - 1)
        picked = x.gather(-1, idx[..., None])[..., 0] * own.to(x.dtype)
        C.all_reduce(picked, group=group)
        valid = label != ignore_index
        loss = torch.where(valid, lse[..., 0] - picked,
                           torch.zeros((), device=x.device))
        ctx.save_for_backward(logits, lse, idx, own, valid)
        return loss

    @staticmethod
    def backward(ctx, g):
        logits, lse, idx, own, valid = ctx.saved_tensors
        d = torch.exp(logits.float() - lse)
        d.scatter_add_(-1, idx[..., None], -own.to(d.dtype)[..., None])
        gm = torch.where(valid, g, torch.zeros((), device=g.device)).float()
        d.mul_(gm[..., None])
        return d.to(logits.dtype), None, None, None


class ParallelCrossEntropy(nn.Module):
    """Per-token cross entropy (``reduction="none"``; 0 at
    ``ignore_index``) over logits split on the class dim over mp
    (reference: fleet/layers/mpu/mp_layers.py:733).  With mp 1 it is
    `nn.functional.cross_entropy`, as JAX's."""

    def __init__(self, mp_group=None, name=None, ignore_index=-100):
        super().__init__()
        self.mp_group = mp_group if mp_group is not None else \
            topology.mp_group()
        self.ignore_index = ignore_index

    def forward(self, input, label):  # noqa: A002
        if _nranks(self.mp_group) <= 1:
            return F.cross_entropy(input, label, reduction="none",
                                   ignore_index=self.ignore_index)
        if label.dim() == input.dim():
            label = label.squeeze(-1)
        return _VocabParallelXent.apply(input, label, self.mp_group,
                                        self.ignore_index)


# ---------------------------------------------------------------------------
# sequence parallel (reference: fleet/utils/sequence_parallel_utils.py)
# ---------------------------------------------------------------------------

class ColumnSequenceParallelLinear(ColumnParallelLinear):
    """Input arrives split on the sequence ``[b, s / mp, h]``: all-gathered
    (reduce-scatter backward), then the column product; the output
    leaves feature-split."""

    def __init__(self, *args, **kwargs):
        kwargs.setdefault("gather_output", False)
        super().__init__(*args, **kwargs)

    def region_input(self, x):
        """The whole sequence from every rank's part (the gradient
        reduce-scattered back)."""
        return gather_from_mp(x, self.mp_group, 1, reduce_back=True)


class RowSequenceParallelLinear(RowParallelLinear):
    """The row product's partial sums reduce-scattered over the sequence:
    the output leaves ``[b, s / mp, h]`` (all-gather backward).  The bias
    is added on the split sequence, so it is marked sequence-parallel
    (its gradient is summed over mp)."""

    def __init__(self, *args, **kwargs):
        kwargs.setdefault("input_is_parallel", True)
        super().__init__(*args, **kwargs)
        if self.bias is not None:
            mark_as_sequence_parallel_parameter(self.bias)

    def forward(self, x):
        y = reduce_scatter_to_mp(self._partial(x), self.mp_group, 1)
        return y + self.bias if self.bias is not None else y


def scatter(x, axis="mp"):
    """This rank's part of the sequence (dim 1) of ``x``; all-gather
    backward (reference: sequence_parallel_utils.py ScatterOp)."""
    return split_to_mp(x, topology.mp_group(), 1)


def all_gather_seq(x):
    """The whole sequence (dim 1) from every rank's part; this rank's
    part backward (GatherOp)."""
    return gather_from_mp(x, topology.mp_group(), 1)


GatherOp = all_gather_seq
ScatterOp = scatter


def mark_as_sequence_parallel_parameter(param):
    """The parameter is used on a sequence split over mp: its gradient is
    summed over the mp group before the update
    (`distributed.parallel.allreduce_gradients`)."""
    param.is_sequence_parallel = True
