"""The Mixture-of-Experts layer with expert parallelism (port of
paddle_tpu/incubate/distributed/models/moe/moe_layer.py).

JAX routes by dense one-hot tensors (``combine [N, E, C]``) and lets
GSPMD turn the dispatch einsum into the expert all-to-all.  At a real
size that tensor does not fit (GPT-2 124M's recipe: N 8192 tokens a
rank, E 4, C 9830: 1.29 GB a layer in fp32), so the port routes by
index (`gate.Route`): each token carries its experts, queue places and
weights; dispatch scatters the rank's kept tokens into a buffer ``[E_r,
N, d]`` of its experts (a token meets an expert at most once), the
experts run on it (``torch.bmm``, as JAX's ``LA.bmm``), and combine
gathers each choice back and weights it, JAX's two terms in order.  The
gates' ``dispatch_info`` still gives JAX's dense triple.

``last_dropped`` holds the choices each expert's capacity dropped in the
last forward, over the global batch.

Over the topology:

- **mp.** The stacked experts (`ExpertFFN`, ``[E, d, h]`` stacks,
  ``Shard(0)`` over mp as in JAX) split over the mp group: a rank holds
  E / mp experts.  The tokens are copies on every mp rank: the layer's
  input enters through ``copy_to_mp`` (its backward all-reduces over
  mp), and so do the gate's logits (each rank's combine covers only its
  experts, so the logits' gradient is partial until that all-reduce);
  the rank's partial output leaves through an all-reduce over mp.  The
  experts' gradients are synchronised over dp only (the step's dp sync).
  Experts given as a list (``experts=[...]``) are copies, as in JAX.
- **dp.** The routing is JAX's over the global batch (the gates'
  `DataRows`): capacity from the global count, queue places after the
  lower ranks' tokens, global means in the aux loss.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from .....distributed.fleet.mp_layers import (_MPLayer, copy_to_mp,
                                              reduce_from_mp)
from .....device import resolve_device
from .....nn import functional as F
from .....nn.layers import _defer, init_generator
from .gate import BaseGate, GShardGate, NaiveGate, SwitchGate
from .gate.base_gate import queue_positions


class ExpertFFN(_MPLayer):
    """Stacked expert FFN: weights ``[E, d, h]`` / ``[E, h, d]``, one
    batched matmul over the expert dim, split ``Shard(0)`` over mp (a
    rank holds E / mp experts)."""

    def __init__(self, num_expert, d_model, d_hidden, activation=F.gelu, *,
                 device=None, dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        self._bind(None)
        self._split = {"w1": (0, 1), "b1": (0, 1), "w2": (0, 1),
                       "b2": (0, 1)}
        self.num_expert = num_expert
        self.d_model, self.d_hidden = d_model, d_hidden
        self.w1 = self._new("w1", (num_expert, d_model, d_hidden), device,
                            dtype)
        self.b1 = self._new("b1", (num_expert, 1, d_hidden), device, dtype)
        self.w2 = self._new("w2", (num_expert, d_hidden, d_model), device,
                            dtype)
        self.b2 = self._new("b2", (num_expert, 1, d_model), device, dtype)
        self.act = activation
        if not getattr(_defer, "depth", 0):
            with torch.no_grad():
                self.reset_parameters(init_generator(self.w1.device))

    def reset_parameters(self, generator):
        """Xavier normal weights (fan in and out of one expert's matrix,
        the JAX layer's default), zero biases."""
        for name in ("w1", "w2"):
            p = getattr(self, name)
            shape = (self.num_expert, *p.shape[1:])
            std = math.sqrt(2.0 / (shape[1] + shape[2]))
            w = torch.empty(shape, device=p.device, dtype=p.dtype)
            self._fill(name, w.normal_(0.0, std, generator=generator))
        self.b1.zero_()
        self.b2.zero_()

    @property
    def local_experts(self):
        """``(first, count)`` of this rank's experts."""
        n = self.w1.shape[0]
        return self.rank * n if self.world_size > 1 else 0, n

    def forward(self, x):
        """x: ``[E_r, C, d_model]`` → ``[E_r, C, d_model]``"""
        h = self.act(torch.bmm(x, self.w1) + self.b1)
        return torch.bmm(h, self.w2) + self.b2


def _gate_from_dict(gate, d_model, num_expert, device, dtype):
    gtype = gate.get("type", "gshard")
    topk = gate.get("top_k", 2 if gtype == "gshard" else 1)
    cls = {"gshard": GShardGate, "switch": SwitchGate,
           "naive": NaiveGate}[gtype]
    kwargs = {}
    if gtype != "naive" and "capacity" in gate:
        # (train_factor, eval_factor): lower it to force token dropping
        kwargs["capacity"] = gate["capacity"]
    return cls(d_model, num_expert, 1, topk=topk, device=device,
               dtype=dtype, **kwargs)


class MoELayer(nn.Module):
    """reference: moe/moe_layer.py MoELayer.

    ``d_model``; ``experts``: a list of per-expert layers, or an
    `ExpertFFN` (None: an `ExpertFFN` of ``num_expert`` experts, hidden
    ``d_hidden`` or 4 × ``d_model``); ``gate``: a dict (``type`` gshard,
    switch or naive, ``top_k``, ``capacity``) or a `BaseGate`;
    ``moe_group``: the axis the experts split over (mp, the only one
    here); the others are accepted for parity."""

    def __init__(self, d_model, experts=None, gate=None, moe_group=None,
                 mp_group=None, recompute_interval=0, recompute_ctx=None,
                 num_expert=None, d_hidden=None, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        if moe_group not in (None, "mp"):
            raise NotImplementedError(
                f"MoELayer(moe_group={moe_group!r}): the experts split over "
                "the mp axis only (ROADMAP A8)")
        self.d_model = d_model
        self.axis = "mp"
        if isinstance(experts, (list, nn.ModuleList)):
            self.experts = nn.ModuleList(list(experts))
            self.num_expert = len(self.experts)
            self._stacked = None
        else:
            self.num_expert = num_expert or (len(experts) if experts
                                             else 8)
            self._stacked = experts if isinstance(experts, ExpertFFN) else \
                ExpertFFN(self.num_expert, d_model, d_hidden or 4 * d_model,
                          device=device, dtype=dtype)
            # the same module under a second name, unregistered: its
            # state is JAX's "_stacked.*" only
            object.__setattr__(self, "experts", self._stacked)
        if gate is None:
            gate = {"type": "gshard", "top_k": 2}
        if isinstance(gate, dict):
            self.gate = _gate_from_dict(gate, d_model, self.num_expert,
                                        resolve_device(device), dtype)
        elif isinstance(gate, BaseGate):
            self.gate = gate
        else:
            raise TypeError(f"gate {gate!r} is neither dict nor BaseGate")

    @property
    def world_size(self):
        """The ranks the experts split over (1: copies)."""
        return self._stacked.world_size if self._stacked is not None else 1

    def _expert_forward(self, xe):
        """xe: ``[E_r, C, d]`` → ``[E_r, C, d]``"""
        if self._stacked is not None:
            return self._stacked(xe)
        return torch.stack([exp(xe[i]) for i, exp in
                            enumerate(self.experts)])

    def forward(self, inp):
        """inp: ``[..., d_model]``; routing over the flattened tokens."""
        shape = inp.shape
        x = inp.reshape(-1, self.d_model)
        if not hasattr(self.gate, "route"):
            if not hasattr(self.gate, "dispatch_info"):
                raise TypeError(
                    "MoELayer needs a capacity gate (gshard/switch); "
                    "NaiveGate has no dispatch_info (reference pairs it "
                    "with fastmoe-style count_by_gate, whose dynamic "
                    "shapes do not compile on TPU)")
            raise NotImplementedError(
                f"MoELayer: {type(self.gate).__name__} has no route(): the "
                "port routes by index, from a gate's Route (GShardGate, "
                "SwitchGate)")
        mp = self._stacked.mp_group if self.world_size > 1 else None
        logits = copy_to_mp(self.gate._logits(x, self.training), mp)
        route = self.gate.route(logits, self.training)
        #: [E] the choices of the global batch each expert's capacity
        #: dropped in the last forward (a device tensor; no host read)
        self.last_dropped = route.dropped()
        x = copy_to_mp(x, mp)
        first, count = (self._stacked.local_experts
                        if self._stacked is not None
                        else (0, self.num_expert))
        n, k = route.expert.shape
        # a choice's row in the buffer [E_r * n (+ 1 spare), d]: its
        # expert's block, then its place among this rank's tokens of that
        # expert (choice 0's first, as the queues hold them); choices
        # dropped or of another rank's experts go to the spare row
        local = route.keep & (route.expert >= first) & \
            (route.expert < first + count)
        onehot = torch.nn.functional.one_hot(
            (route.expert - first).clamp(0, count - 1), count) * \
            local[..., None]
        place = queue_positions(onehot.transpose(0, 1).reshape(k * n, count),
                                0).view(k, n).t()
        spare = count * n
        row = torch.where(local, (route.expert - first) * n + place, spare)
        buf = x.new_zeros(spare + 1, self.d_model)
        buf = buf.index_add(0, row.t().reshape(-1), x.repeat(k, 1))
        ye = self._expert_forward(buf[:spare].view(count, n, self.d_model))
        ye = torch.cat([ye.reshape(spare, self.d_model),
                        ye.new_zeros(1, self.d_model)])
        w = torch.where(local, route.weight,
                        torch.zeros_like(route.weight)).to(x.dtype)
        y = ye[row[:, 0]] * w[:, :1]
        for j in range(1, k):
            y = y + ye[row[:, j]] * w[:, j:j + 1]
        return reduce_from_mp(y, mp).reshape(shape)
