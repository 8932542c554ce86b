"""GShard top-2 gate with capacity and the load-balance auxiliary loss
(port of paddle_tpu/incubate/distributed/models/moe/gate/gshard_gate.py).

`_gshard_route` is JAX's ``_gshard_dispatch`` in index form: the softmax
and the two argmaxes in the logits' dtype, the second expert dropped at
random in proportion to its weight (the uniform draw from the key, over
the global batch), each token's place in its expert's queue, capacity
``int(max(1, factor · N / E · top_k))``, the weights renormalised over
the kept choices.  Over data-parallel ranks the routing is JAX's over the
global batch: the queue places count the lower ranks' tokens first and
the aux loss takes global means (`DataRows`, one all-gather of ``[3,
E]``).  The queue places are counted in integers: JAX counts them in
the logits' dtype, which in bf16 holds integers exactly only up to 256
(a deliberate divergence; the exact checks run in fp32).
`_gshard_dispatch` gives JAX's dense ``(combine, dispatch, aux)``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from ......framework import prng
from .base_gate import DataRows, Route, queue_positions
from .naive_gate import NaiveGate


def _gshard_route(logits, capacity, key=None, random_routing=True):
    """`Route` of top-2 GShard routing of this rank's ``logits`` ``[N,
    E]``."""
    n, e = logits.shape
    rows = DataRows(n)
    probs = torch.softmax(logits, dim=-1)
    idx1 = probs.argmax(dim=-1)
    mask1 = TF.one_hot(idx1, e).to(logits.dtype)
    p1 = (probs * mask1).sum(-1)
    idx2 = (probs * (1.0 - mask1)).argmax(dim=-1)
    mask2 = TF.one_hot(idx2, e).to(logits.dtype)
    p2 = (probs * mask2).sum(-1)
    if random_routing and key is not None:
        # drop the second expert at random, in proportion to its weight
        u = rows.rows(prng.uniform(key.to(logits.device), (rows.total,)))
        keep2 = u < (2.0 * p2 / (p1 + p2 + 1e-9))
        mask2 = mask2 * keep2[:, None].to(mask2.dtype)
    lower, total = rows.stats(torch.stack(
        [probs.sum(0), mask1.sum(0), mask2.sum(0)]).float())
    # aux load-balance loss (GShard eq. 4): mean frac * mean prob * E
    aux = ((total[0] / rows.total) * (total[1] / rows.total)).sum() * e
    c1, c2 = mask1.long(), mask2.long()
    lower = lower.detach().round().long()
    kept1 = total[1].detach().round().long().clamp(max=capacity)
    pos1 = queue_positions(c1, lower[1])
    pos2 = queue_positions(c2, lower[2] + kept1)
    keep1 = pos1 < capacity
    keep2 = (c2.sum(-1) > 0) & (pos2 < capacity)
    m1, m2 = keep1.to(logits.dtype), keep2.to(logits.dtype)
    denom = p1 * m1 + p2 * m2 + 1e-9
    weight = torch.stack([p1 * m1 / denom, p2 * m2 / denom], dim=1)
    demand = total[1:].detach().round().long()
    return Route(torch.stack([idx1, idx2], dim=1),
                 torch.stack([pos1, pos2], dim=1),
                 torch.stack([keep1, keep2], dim=1), weight, capacity,
                 aux.to(logits.dtype), demand)


def _gshard_dispatch(logits, capacity, key=None, random_routing=True):
    """JAX's ``_gshard_dispatch``: ``(combine [N, E, C], dispatch bool [N,
    E, C], aux)``."""
    route = _gshard_route(logits, capacity, key, random_routing)
    return (*route.dense(logits.shape[1]), route.aux)


class GShardGate(NaiveGate):
    def __init__(self, d_model, num_expert, world_size,
                 topk=2, capacity=(1.2, 2.4), random_routing=True,
                 group=None, *, device=None, dtype=torch.float32):
        if topk != 2:
            raise ValueError("GShard gate is top-2 (reference asserts topk==2)")
        super().__init__(d_model, num_expert, world_size, topk=2,
                         device=device, dtype=dtype)
        self.capacity_factor = capacity
        self.random_routing = random_routing

    def _logits(self, inp, train=True):
        return self.gate(inp)

    def route(self, logits, train=True):
        """`Route` of ``logits`` (this rank's tokens; the global batch over
        the topology's dp group): the capacity from the global count, the
        random routing's key the process stream's next
        (`framework.prng.next_rng_key`) in training."""
        n = DataRows(logits.shape[0]).total
        factor = self.capacity_factor[0 if train else 1]
        cap = int(max(1, factor * n / self.tot_expert * self.top_k))
        use_rr = self.random_routing and train
        key = prng.next_rng_key(logits.device) if use_rr else None
        route = _gshard_route(logits, cap, key=key, random_routing=use_rr)
        self.set_loss(route.aux)
        return route

    def dispatch_info(self, inp, train=True):
        """JAX's dense ``(combine [N, E, C], dispatch [N, E, C], aux)``."""
        route = self.route(self._logits(inp, train), train)
        return (*route.dense(self.tot_expert), route.aux)
