"""Switch (top-1) gate with capacity and the load-balance loss (port of
paddle_tpu/incubate/distributed/models/moe/gate/switch_gate.py): top-1
routing, the capacity factor of training or evaluation, in training the
logits jittered by a uniform in ``[1 - eps, 1 + eps)`` from the process
key stream (over the global batch).  `_switch_route` is JAX's
``_switch_dispatch`` in index form (see `gshard_gate`)."""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from ......framework import prng
from .base_gate import DataRows, Route, queue_positions
from .naive_gate import NaiveGate


def _switch_route(logits, capacity):
    n, e = logits.shape
    rows = DataRows(n)
    probs = torch.softmax(logits, dim=-1)
    idx = probs.argmax(dim=-1)
    mask = TF.one_hot(idx, e).to(logits.dtype)
    p = (probs * mask).sum(-1)
    lower, total = rows.stats(torch.stack([probs.sum(0),
                                           mask.sum(0)]).float())
    aux = ((total[0] / rows.total) * (total[1] / rows.total)).sum() * e
    pos = queue_positions(mask.long(), lower[1].detach().round().long())
    keep = pos < capacity
    return Route(idx[:, None], pos[:, None], keep[:, None],
                 (p * keep.to(p.dtype))[:, None], capacity,
                 aux.to(logits.dtype), total[1:].detach().round().long())


def _switch_dispatch(logits, capacity):
    """JAX's ``_switch_dispatch``: ``(combine, dispatch, aux)``."""
    route = _switch_route(logits, capacity)
    return (*route.dense(logits.shape[1]), route.aux)


class SwitchGate(NaiveGate):
    def __init__(self, d_model, num_expert, world_size, topk=1,
                 switch_eps=0.1, capacity=(1.2, 2.4), group=None, *,
                 device=None, dtype=torch.float32):
        if topk != 1:
            raise ValueError("Switch gate is top-1 (reference asserts topk==1)")
        super().__init__(d_model, num_expert, world_size, topk=1,
                         device=device, dtype=dtype)
        self.switch_eps = switch_eps
        self.capacity_factor = capacity

    def _logits(self, inp, train=True):
        logits = self.gate(inp)
        if train and self.switch_eps > 0:
            rows = DataRows(logits.shape[0])
            key = prng.next_rng_key(logits.device)
            noise = rows.rows(prng.uniform(
                key, (rows.total, logits.shape[1]),
                minval=1.0 - self.switch_eps, maxval=1.0 + self.switch_eps))
            logits = logits * noise
        return logits

    def route(self, logits, train=True):
        n = DataRows(logits.shape[0]).total
        factor = self.capacity_factor[0 if train else 1]
        route = _switch_route(logits, int(max(1, factor * n /
                                              self.tot_expert)))
        self.set_loss(route.aux)
        return route

    def dispatch_info(self, inp, train=True):
        route = self.route(self._logits(inp, train), train)
        return (*route.dense(self.tot_expert), route.aux)
