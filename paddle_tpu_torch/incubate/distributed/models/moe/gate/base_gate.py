"""Gate base class (port of paddle_tpu/incubate/distributed/models/moe/
gate/base_gate.py): ``num_expert`` experts a rank × ``world_size``
ranks."""
from __future__ import annotations

import torch
from torch import nn


class BaseGate(nn.Module):
    def __init__(self, num_expert, world_size):
        super().__init__()
        self.world_size = world_size
        self.num_expert = num_expert
        self.tot_expert = world_size * num_expert
        self.loss = None

    def forward(self, x):
        raise NotImplementedError("Base gate cannot be directly used")

    def set_loss(self, loss):
        self.loss = loss

    def get_loss(self, clear=True):
        loss = self.loss
        if clear:
            self.loss = None
        return loss


class Route:
    """A gate's routing in index form, ``k`` choices a token (JAX's dense
    ``combine [N, E, C]`` holds the same): ``expert`` ``[N, k]`` (long),
    ``pos`` ``[N, k]`` the token's place in its expert's queue over the
    global batch (long), ``keep`` ``[N, k]`` (bool: routed and within
    ``capacity``), ``weight`` ``[N, k]`` (the combine weight, zero where
    not kept), ``aux`` the load-balance loss, ``demand`` ``[k, E]`` the
    global batch's tokens routed to each expert by each choice (before
    the capacity)."""

    def __init__(self, expert, pos, keep, weight, capacity, aux, demand):
        self.expert, self.pos, self.keep = expert, pos, keep
        self.weight, self.capacity, self.aux = weight, capacity, aux
        self.demand = demand

    def dropped(self):
        """``[E]``: the global batch's choices each expert's capacity
        dropped (a queue holds choice 0's tokens, then choice 1's)."""
        kept = torch.zeros_like(self.demand[0])
        out = torch.zeros_like(kept)
        for want in self.demand:
            take = torch.minimum(want, self.capacity - kept)
            out += want - take
            kept += take
        return out

    def dense(self, num_expert):
        """JAX's ``(combine [N, E, C], dispatch bool [N, E, C])``: each kept
        choice's weight at (expert, position), a dropped one nowhere."""
        n, k = self.expert.shape
        c = self.capacity
        slot = self.expert * c + torch.where(self.keep, self.pos, 0)
        w = torch.where(self.keep, self.weight, torch.zeros_like(
            self.weight))
        combine = w.new_zeros(n, num_expert * c).scatter_add(1, slot, w)
        combine = combine.view(n, num_expert, c)
        return combine, combine > 0.0


class DataRows:
    """Where this rank's ``n`` tokens sit in the global batch the gate
    routes over: the data-parallel group (the topology's; None alone)
    holds ``size`` ranks of ``n`` tokens each, rank-major (rank 0's rows
    first, as JAX flattens the global batch).  With sharding or sep
    ranks above 1 the batch the gate sees is not the dp ranks' alone
    (ZeRO's ranks may split the rows, sep's ranks a sequence's chunks):
    `NotImplementedError` (ROADMAP A8)."""

    def __init__(self, n):
        from ......distributed import topology
        for axis, split in (("sharding", topology.sharding_group()),
                            ("sep", topology.sep_group())):
            if split is not None and split.nranks > 1:
                raise NotImplementedError(
                    f"MoE gates at {axis} > 1: they route over the dp "
                    f"ranks' batch, not the rows the {axis} ranks split "
                    "(ROADMAP A8)")
        g = topology.dp_group()
        self.group = g if g is not None and g.nranks > 1 else None
        self.size = 1 if self.group is None else self.group.nranks
        self.rank = 0 if self.group is None else self.group.rank
        self.n, self.total = n, n * self.size
        self.offset = self.rank * n

    def rows(self, t):
        """This rank's rows of a tensor over the global batch."""
        return t[self.offset:self.offset + self.n]

    def stats(self, local):
        """``(lower, total)``: the sums of ``local`` ``[..]`` (fp32) over
        the lower ranks and over all (one all-gather; differentiable)."""
        if self.group is None:
            return torch.zeros_like(local), local
        from ......distributed import functional as Fn
        every = Fn.all_gather(local, self.group, axis=0, tiled=False)
        return every[:self.rank].sum(0), every.sum(0)


def queue_positions(mask, lower):
    """Each token's place in its expert's queue: ``mask`` ``[N, E]``
    (long one-hot rows, or zero rows), ``lower`` ``[E]`` the tokens ahead
    of this rank's; → ``[N]`` (0 for an empty row)."""
    return ((mask.cumsum(0) - mask + lower) * mask).sum(-1)
