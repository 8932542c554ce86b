"""Data parallelism (port of paddle_tpu/distributed/parallel.py): each
dp rank runs the model on its rows of the batch, and the gradients are
averaged over the dp group before the update.

The JAX package gets the gradient all-reduce from GSPMD inside its
compiled step.  Here it is explicit (`allreduce_gradients`): the
gradients are packed by dtype into buckets of at most
``comm_buffer_size`` MB, one all-reduce a bucket (sum, then divided by
the group's size, as JAX hapi's ``_sync_grads``), and copied back.  The
gradients of parameters marked sequence-parallel
(`fleet.mp_layers.mark_as_sequence_parallel_parameter`) are summed over
the mp group too: each mp rank saw only its part of the sequence.

`mesh_update` is the eager step tail of the dp x mp lanes, in JAX hapi's
order; `framework.train_step.CompiledTrainStep` (eager lane) and
`hapi.Model` over several ranks both call it.

`DataParallel` syncs after ``backward`` by itself: its forward ties the
outputs to an identity whose backward queues the sync at the end of the
backward pass, so no gradient hook is installed (a captured train step
stays eligible).  The mesh steps sync in their own tails, so they refuse
a `DataParallel` network: they take the bare model.
"""
from __future__ import annotations

import torch
from torch import nn

from . import collective as C
from . import env as _env


def _buckets(tensors, limit_bytes):
    """Consecutive runs of same-dtype tensors of at most ``limit_bytes``
    each (a tensor larger than the limit is a bucket of its own)."""
    out, cur, size = [], [], 0
    for t in tensors:
        nbytes = t.numel() * t.element_size()
        if cur and (t.dtype != cur[0].dtype or size + nbytes > limit_bytes):
            out.append(cur)
            cur, size = [], 0
        cur.append(t)
        size += nbytes
    if cur:
        out.append(cur)
    return out


@torch.no_grad()
def allreduce_tensors(tensors, group, comm_buffer_size=25, average=True):
    """All-reduce ``tensors`` in place over ``group``, packed into
    buckets of ``comm_buffer_size`` MB; ``average`` divides each sum by
    the group's size."""
    if group is None or group.nranks <= 1 or not tensors:
        return
    limit = max(int(comm_buffer_size * (1 << 20)), 1)
    for bucket in _buckets(tensors, limit):
        if len(bucket) == 1:
            flat = bucket[0]
            C.all_reduce(flat, group=group)
            if average:
                flat.div_(group.nranks)
            continue
        flat = torch.cat([t.reshape(-1) for t in bucket])
        C.all_reduce(flat, group=group)
        if average:
            flat.div_(group.nranks)
        parts = flat.split([t.numel() for t in bucket])
        torch._foreach_copy_(bucket, [part.view_as(t)
                                      for part, t in zip(parts, bucket)])


def allreduce_gradients(params, dp_group=None, mp_group=None,
                        comm_buffer_size=25):
    """The data-parallel gradient sync: every gradient of ``params``
    averaged over ``dp_group``; the sequence-parallel ones summed over
    ``mp_group`` first."""
    grads = [p.grad for p in params if p.grad is not None]
    sp = [p.grad for p in params if p.grad is not None
          and getattr(p, "is_sequence_parallel", False)]
    if sp and mp_group is not None:
        allreduce_tensors(sp, mp_group, comm_buffer_size, average=False)
    allreduce_tensors(grads, dp_group, comm_buffer_size)


def all_ranks_found_inf(found, device):
    """A rank's found-inf flag (a 0-dim bool or fp32 ``[1]`` tensor, or a
    bool) made the world's: one fp32 all-reduce (sum > 0), as JAX hapi's
    ``_sync_grads`` rides it; returns a 0-dim bool on ``device``."""
    flag = torch.as_tensor(found).to(device=device,
                                     dtype=torch.float32).reshape(1)
    C.all_reduce(flag)
    return flag[0] > 0


def mesh_update(opt, scaler, dp_group, mp_group, device):
    """The eager update of a dp x mp step after ``backward``, JAX hapi's
    order (``_sync_grads``): unscale with the found-inf kept on the
    device, the dp gradient sync (`allreduce_gradients`), the found-inf
    made the world's (`all_ranks_found_inf`), then the update (the
    scaler's, which skips it on an inf; the global-norm clip sums over mp
    inside it)."""
    scaling = scaler is not None and scaler._enable
    if scaling:
        scaler.unscale_(opt, defer_found_inf=True)
    allreduce_gradients(opt._parameter_list, dp_group, mp_group)
    if scaling:
        scaler._found_inf = bool(all_ranks_found_inf(
            scaler._found_inf_tensor(), device))
    if scaler is not None:
        scaler.step(opt)
    else:
        opt.step()


def refuse_data_parallel(network, who):
    """Raise when a mesh step is handed a `DataParallel` (it would
    average the gradients over dp twice)."""
    if isinstance(network, DataParallel):
        raise ValueError(
            f"{who}: pass the bare model, not a DataParallel: the step "
            "averages the gradients over dp itself")


class _SyncAfterBackward(torch.autograd.Function):
    """Identity whose backward queues ``owner._sync`` to run when the
    backward pass ends (once per pass)."""

    @staticmethod
    def forward(ctx, owner, *outs):
        ctx.owner = owner
        outs = tuple(o.view_as(o) for o in outs)
        return outs if len(outs) > 1 else outs[0]

    @staticmethod
    def backward(ctx, *grads):
        ctx.owner._queue_sync()
        return (None,) + grads


class DataParallel(nn.Module):
    """reference: python/paddle/distributed/parallel.py:200.  Wraps
    ``layers`` (its parameters are taken as they are: the caller makes
    them equal on every rank, e.g. from one seed); each rank feeds its
    rows.  After each backward the gradients are averaged over
    ``group`` (None: the hybrid topology's dp group, else the world) in
    buckets of ``comm_buffer_size`` MB.  ``last_comm_buffer_size`` and
    ``find_unused_parameters`` are accepted, as in JAX, and change
    nothing."""

    def __init__(self, layers, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, find_unused_parameters=False,
                 group=None):
        super().__init__()
        from . import topology
        self._layers = layers
        self.comm_buffer_size = comm_buffer_size
        self.find_unused_parameters = find_unused_parameters
        if group is None:
            group = topology.dp_group() or C.get_group()
        self.group = group
        self._queued = False

    def forward(self, *inputs, **kwargs):
        out = self._layers(*inputs, **kwargs)
        if not torch.is_grad_enabled() or self.group.nranks <= 1:
            return out
        outs = out if isinstance(out, tuple) else (out,)
        live = [i for i, o in enumerate(outs) if torch.is_tensor(o)
                and o.requires_grad]
        if not live:
            return out
        tied = _SyncAfterBackward.apply(self, *[outs[i] for i in live])
        tied = tied if isinstance(tied, tuple) else (tied,)
        outs = list(outs)
        for i, t in zip(live, tied):
            outs[i] = t
        return tuple(outs) if isinstance(out, tuple) else outs[0]

    def _queue_sync(self):
        if self._queued:
            return
        self._queued = True
        torch.autograd.Variable._execution_engine.queue_callback(self._sync)

    def _sync(self):
        self._queued = False
        self.apply_collective_grads()

    def apply_collective_grads(self):
        """Average the gradients over the dp group now."""
        from . import topology
        allreduce_gradients(list(self._layers.parameters()), self.group,
                            topology.mp_group(), self.comm_buffer_size)

    def scale_loss(self, loss):
        return loss

    def state_dict(self, *a, **k):
        return self._layers.state_dict(*a, **k)

    def set_state_dict(self, *a, **k):
        return self._layers.load_state_dict(*a, **k)

    load_state_dict = set_state_dict


def init_parallel_env(*, backend=None, device=None):
    """`env.init_parallel_env`, returning its `ParallelEnv`."""
    return _env.init_parallel_env(backend=backend, device=device)
