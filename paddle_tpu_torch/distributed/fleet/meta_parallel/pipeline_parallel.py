"""Pipeline-parallel runtime (port of paddle_tpu/distributed/fleet/
meta_parallel/pipeline_parallel.py): `PipelineParallel`, `Host1F1B` and
`PipelineParallelWithInterleave`.

JAX's single controller orders per-stage programs (or compiles one SPMD
program).  Here each rank is a process holding one stage, and **each
rank runs its own action list**: JAX's `Host1F1B._plan`, ``[F]*W +
[F,B]*(M-W) + [B]*W`` with ``W = min(M, S-1-s)`` for stage s.  A
forward's output goes to the next stage's rank of the same dp/sharding/
mp place and the backward's input gradient comes back, point to point
over the pp group.

**The timetable.**  Every rank derives the same global timetable from
the stages' action lists: at each tick a stage runs its next action if
its input arrived in an earlier tick, then every transfer the tick made
is exchanged in one `collective.batch_isend_irecv` per rank (a rank's
sends and receives together).  Both ends of each link post their halves
in the same tick, in the same order, so no send waits behind a receive
(the ordering deadlock of blocking send/recv, or of NCCL's one stream a
pair).  An activation's shape travels once per boundary and input shape
(an int64 head before the data); a gradient's is the activation's.
``last_schedule`` records each stage's actions in the order this rank
ran them (every stage's list equals its `_plan` row).

**The orders.**  ``num_virtual_pipeline_stages`` C ≥ 2 (virtual stage
v = c·S + s, part v of `PipelineLayer`): each rank runs every forward
chunk by chunk, micro-batch by micro-batch, then every backward in the
reverse order (GPipe over the virtual stages: it respects every
dependency and is deadlock-free under the timetable); ``schedule="host"``
(and JAX's sequential fallback): forward then backward of one
micro-batch at a time.  All compute the same function.

**Loss and gradients** are JAX's accumulation: each micro-batch's loss
is divided by M (``accumulate_steps``), gradients accumulate over the
micro-batches, and the total loss (on the last stage) is broadcast over
the pp group, then averaged over dp.  With dp above 1 each dp rank takes
its rows of the global batch.  **Tied weights** (a `SharedLayerDesc`
used by several stages): after the backward each copy's gradient (zeros
where the copy is not used) is summed over the ranks that hold the
copies, per dp/mp place, before the update.  The update is the dp x mp
step's (`distributed.parallel.mesh_update`: the dp average, the scaler's
found-inf over the world); the global-norm clip sums over pp too, the
tied copies counted once (`nn.clip.global_norm`).
"""
from __future__ import annotations

import warnings

import torch
from torch import nn

from ... import collective as C
from ... import env as _env
from ...parallel import allreduce_tensors, mesh_update
from .pp_layers import (PipelineLayer, broadcast_tensor, head_spec,
                        tensor_head)

_SHARDED = ("pipeline parallelism with sharding_degree > 1 (or a stage-3 "
            "sharding strategy) is not ported (ROADMAP A8)")


def _split_micro(tensor, n):
    """Split the global batch into n micro-batches along dim 0."""
    if isinstance(tensor, (tuple, list)):
        parts = [_split_micro(t, n) for t in tensor]
        return list(zip(*parts))
    b = tensor.shape[0]
    if b % n != 0:
        raise ValueError(f"batch {b} not divisible by micro-batches {n}")
    return list(torch.chunk(tensor, n, dim=0))


def _unpack(data):
    return data if isinstance(data, tuple) and len(data) == 2 \
        else (data, None)


def _shape_key(x):
    if isinstance(x, (tuple, list)):
        return tuple(_shape_key(t) for t in x)
    return tuple(x.shape), str(x.dtype)


def timetable(plans, num_virtual):
    """The global timetable of per-stage action lists ``plans`` (each a
    list of ``(op, v, m)``): a list of ticks, each ``{stage: action}``.
    A forward of virtual stage v > 0 waits for v - 1's output, a backward
    of v < V - 1 for v + 1's input gradient, each made in an earlier
    tick."""
    ptr = [0] * len(plans)
    avail, ticks = set(), []
    total = sum(len(p) for p in plans)
    done = 0
    while done < total:
        tick, made = {}, set()
        for s, plan in enumerate(plans):
            if ptr[s] >= len(plan):
                continue
            op, v, m = plan[ptr[s]]
            need = ("act", v, m) if op == "F" and v > 0 else \
                ("grad", v, m) if op == "B" and v < num_virtual - 1 \
                else None
            if need is not None and need not in avail:
                continue
            tick[s] = (op, v, m)
            ptr[s] += 1
            done += 1
            if op == "F" and v < num_virtual - 1:
                made.add(("act", v + 1, m))
            elif op == "B" and v > 0:
                made.add(("grad", v - 1, m))
        if not tick:
            raise RuntimeError(f"pipeline schedule deadlocked (ptr={ptr}, "
                               f"plans={plans})")
        ticks.append(tick)
        avail |= made
    return ticks


class Host1F1B:
    """The cross-rank schedule over `PipelineLayer` ``pipeline_layer``'s
    stages (this rank's stages run here; see the module docstring):
    ``n_micro`` micro-batches, the loss of the last stage's output by
    ``loss_fn``.  ``order``: ``"1f1b"`` (JAX's `_plan`), ``"interleave"``
    or ``"sequential"``; ``remat`` runs each stage's body under
    `recompute`."""

    def __init__(self, pipeline_layer, n_micro, loss_fn, *, order="1f1b",
                 remat=False):
        self._layers = pipeline_layer
        self._n_micro = n_micro
        self._loss_fn = loss_fn
        self._num_stages = pipeline_layer.get_num_stages()
        self._order = order
        self._remat = remat
        self._heads = set()       # (virtual stage, input key) sent once
        self._shapes = {}         # the same: (shape, dtype) received
        self.last_schedule = []

    def _plan(self):
        S, M = self._num_stages, self._n_micro
        plans = []
        for s in range(S):
            w = min(M, S - 1 - s)
            plans.append([("F", m) for m in range(w)]
                         + [op for m in range(w, M)
                            for op in (("F", m), ("B", m - w))]
                         + [("B", m) for m in range(M - w, M)])
        return plans

    def _plans(self):
        """Each stage's actions ``(op, virtual stage, micro)``."""
        S, M = self._num_stages, self._n_micro
        C_ = self._layers._num_chunks
        if self._order == "1f1b":
            return [[(op, s, m) for op, m in plan]
                    for s, plan in enumerate(self._plan())]
        plans = []
        for s in range(S):
            vs = [c * S + s for c in range(C_)]
            if self._order == "sequential":
                plans.append([a for m in range(M)
                              for a in [("F", v, m) for v in vs]
                              + [("B", v, m) for v in reversed(vs)]])
            else:
                plans.append([("F", v, m) for v in vs for m in range(M)]
                             + [("B", v, m) for v in reversed(vs)
                                for m in range(M)])
        return plans

    def _stage(self, v, x):
        pl = self._layers
        if not self._remat:
            return pl.run_part(v, x)
        from ..utils import recompute
        return recompute(lambda t: pl.run_part(v, t), x)

    def run(self, data, scaler=None, *, forward_only=False):
        """One schedule over ``data`` (``(inputs, labels)`` or inputs):
        the micro-batches' forwards and backwards (``forward_only``: the
        forwards), gradients accumulated; returns the total loss (the sum
        of each micro-batch's loss / M), the same on every rank of the pp
        group."""
        pl = self._layers
        inputs, labels = _unpack(data)
        M, S = self._n_micro, self._num_stages
        V = S * pl._num_chunks
        micros_x = _split_micro(inputs, M)
        micros_y = _split_micro(labels, M) if labels is not None \
            else [None] * M
        key = _shape_key(micros_x[0])
        group = pl._pp_group
        local = set(pl._local_stages)
        dev = _env.current_device()
        acts_in, outs, inbox, losses = {}, {}, {}, []
        self.last_schedule = []
        plans = self._plans()
        if forward_only:
            plans = [[a for a in plan if a[0] == "F"] for plan in plans]
        for tick in timetable(plans, V):
            sends, recvs = [], []
            for s in sorted(tick):
                op, v, m = tick[s]
                if s not in local:
                    self._expect(op, v, m, local, outs, recvs, key, dev)
                    continue
                if op == "F":
                    x = micros_x[m] if v == 0 else inbox.pop(("act", v, m))
                    if v > 0 and x.is_floating_point():
                        x = x.detach().requires_grad_()
                    if not forward_only:
                        acts_in[(v, m)] = x
                    out = self._stage(v, x)
                    if v == V - 1:
                        if self._loss_fn is not None and \
                                micros_y[m] is not None:
                            out = self._loss_fn(out, micros_y[m])
                        out = out / float(M)
                        losses.append(out.detach())
                    if not forward_only:
                        outs[(v, m)] = out
                    if v < V - 1:
                        self._deliver(("act", v + 1, m), out.detach(),
                                      (v + 1) % S, local, inbox, sends, key)
                else:
                    out = outs.pop((v, m))
                    if v == V - 1:
                        (scaler.scale(out) if scaler is not None
                         else out).backward()
                    elif out.requires_grad:
                        torch.autograd.backward(
                            out, grad_tensors=inbox.pop(("grad", v, m)))
                    else:
                        inbox.pop(("grad", v, m), None)
                    x = acts_in.pop((v, m))
                    if v > 0 and x.is_floating_point():
                        g = x.grad if x.grad is not None else \
                            torch.zeros_like(x)
                        self._deliver(("grad", v - 1, m), g, (v - 1) % S,
                                      local, inbox, sends, key)
                self.last_schedule.append((s, op, m))
            self._exchange(sends, recvs, inbox, group, dev)
        total = None
        for lo in losses:
            total = lo if total is None else total + lo
        last = S - 1
        if group is None:
            return total
        return broadcast_tensor(total if last in local else None,
                                group.ranks[last], group, dev)

    # ---- point to point ----
    def _deliver(self, what, t, stage, local, inbox, sends, key):
        if stage in local:
            inbox[what] = t
            return
        sends.append((what, t.contiguous(), stage, key))

    def _expect(self, op, v, m, local, outs, recvs, key, dev):
        """The receive a remote stage's action makes this rank post."""
        S = self._num_stages
        V = S * self._layers._num_chunks
        if op == "F" and v < V - 1 and (v + 1) % S in local:
            recvs.append((("act", v + 1, m), (v + 1, key), v % S))
        elif op == "B" and v > 0 and (v - 1) % S in local:
            sent = outs.get((v - 1, m))
            if sent is not None and sent.is_floating_point():
                recvs.append((("grad", v - 1, m),
                              (tuple(sent.shape), sent.dtype), v % S))

    def _exchange(self, sends, recvs, inbox, group, dev):
        """This tick's transfers: the heads of activations whose shape the
        peer has not seen, then the data, each as one batch."""
        if not sends and not recvs:
            return
        ranks = group.ranks
        heads, head_recvs = [], []
        for what, t, stage, key in sends:
            hk = (what[1], key)
            if what[0] == "act" and hk not in self._heads:
                self._heads.add(hk)
                heads.append(C.P2POp(C.isend, tensor_head(t, t.device),
                                     ranks[stage], group))
        for what, spec, stage in recvs:
            if what[0] == "act" and spec not in self._shapes:
                h = tensor_head(None, dev)
                head_recvs.append((spec, h))
                heads.append(C.P2POp(C.irecv, h, ranks[stage], group))
        if heads:
            C.batch_isend_irecv(heads)
            for spec, h in head_recvs:
                self._shapes[spec] = head_spec(h)
        ops, bufs = [], []
        for what, t, stage, key in sends:
            ops.append(C.P2POp(C.isend, t, ranks[stage], group))
        for what, spec, stage in recvs:
            shape, dtype = self._shapes[spec] if what[0] == "act" else spec
            buf = torch.empty(shape, dtype=dtype, device=dev)
            bufs.append((what, buf))
            ops.append(C.P2POp(C.irecv, buf, ranks[stage], group))
        C.batch_isend_irecv(ops)
        for what, buf in bufs:
            inbox[what] = buf


def _strategy_cfg(strategy):
    return getattr(strategy, "pipeline_configs", {}) if strategy else {}


class PipelineParallel(nn.Module):
    """reference: fleet/meta_parallel/pipeline_parallel.py:133.

    ``strategy.pipeline_configs``: ``accumulate_steps`` (M, the
    micro-batches of a `train_batch`), ``schedule`` (``"auto"``,
    ``"spmd"``, ``"host"``: JAX's lanes; ``"spmd"`` refuses the stage
    structures JAX's SPMD schedule refuses, `pipeline_spmd.homogenize`)
    and ``remat`` (recompute each stage's body; the port's default is
    off: 1F1B already keeps at most S micro-batches' activations a stage,
    the bound JAX's per-tick remat exists to give its scan).  Unlike
    JAX's SPMD lane, `parameters` is this rank's stage parameters, never
    stacked ``[S, C, ...]`` tensors."""

    def __init__(self, layers, hcg=None, strategy=None):
        super().__init__()
        if not isinstance(layers, PipelineLayer):
            raise TypeError(
                "PipelineParallel expects a PipelineLayer (reference "
                "requires the same, pipeline_parallel.py:146)")
        from ... import topology
        self._layers = layers
        self._hcg = hcg if hcg is not None else \
            topology.get_hybrid_communicate_group()
        self._strategy = strategy
        self._num_stages = layers.get_num_stages()
        cfg = _strategy_cfg(strategy)
        self._n_micro = int(cfg.get("accumulate_steps", 1))
        self._loss_fn = layers._loss_fn
        self.total_loss = None
        self._host1f1b = None
        if self._hcg is not None and (
                self._hcg.get_sharding_parallel_world_size() > 1 or (
                    strategy is not None and getattr(strategy, "sharding",
                                                     False))):
            raise NotImplementedError(_SHARDED)
        schedule = cfg.get("schedule", "auto")
        remat = bool(cfg.get("remat", False))
        self._spmd = None
        chunks = layers._num_chunks
        order = "1f1b" if chunks == 1 else "interleave"
        if schedule == "host":
            order = "sequential"
        elif self._num_stages > 1:
            from .pipeline_spmd import NotHomogeneous, SPMDPipeline
            try:
                self._spmd = SPMDPipeline(layers, n_micro=self._n_micro,
                                          remat=remat)
            except NotHomogeneous as e:
                if schedule == "spmd":
                    raise
                from ....utils import monitor as _monitor
                if self._n_micro > 1 and chunks == 1:
                    _monitor.incr("pp.schedule.fallback_host_1f1b")
                    warnings.warn(
                        f"pipeline stages not stackable ({e}); using "
                        f"host-scheduled 1F1B over per-stage programs "
                        f"(single-program SPMD schedule unavailable)")
                else:
                    order = "sequential"
                    _monitor.incr("pp.schedule.fallback_sequential")
                    warnings.warn(
                        f"pipeline schedule falling back to host-sequential"
                        f" accumulation (stages not stackable: {e})")
        self._runner = Host1F1B(layers, self._n_micro, self._loss_fn,
                                order=order, remat=remat)
        if self._spmd is None and order == "1f1b":
            self._host1f1b = self._runner
        self._bind_stages()

    # ---- the stages' parameters ----
    def _bind_stages(self):
        """Mark each parameter with the pp group (the clip sums over it)
        and the tied copies after the first (counted once); build the
        groups that sum the tied copies' gradients (every rank builds
        them alike)."""
        layers, hcg = self._layers, self._hcg
        group = layers._pp_group
        self._ties = []
        if group is None:
            return
        for p in layers.parameters():
            p.pp_group = group
        me = layers._local_stages[0]
        for key in sorted(layers._shared_layers):
            stages = layers.shared_stages(key)
            if len(stages) < 2:
                continue
            if len(stages) == layers.get_num_stages():
                tie = group
            else:
                tie = None
                for line in hcg.mesh.lines("pp"):
                    g = C.new_group([line[s] for s in stages])
                    if _env.get_rank() in g.ranks:
                        tie = g
            layer = layers._shared_layers.get(key)
            if layer is None or me not in stages:
                continue
            params = list(layer.parameters())
            if me != stages[0]:
                for p in params:
                    p.pp_tied_copy = True
            self._ties.append((tie, params))

    def _sync_ties(self):
        """Each tied copy's gradient summed over the ranks that hold the
        copies (zeros for a copy the stage does not use)."""
        for tie, params in self._ties:
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            allreduce_tensors([p.grad for p in params], tie, average=False)

    def parameters(self, include_sublayers=True):
        """This rank's stage parameters (the optimizer's list)."""
        return self._layers.parameters(include_sublayers)

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def set_state_dict(self, state_dict, *args, **kwargs):
        return self._layers.load_state_dict(state_dict, *args, **kwargs)

    def forward(self, x):
        return self._layers(x)

    def _rows(self, t):
        """This dp rank's rows of a global batch."""
        hcg = self._hcg
        dp = 1 if hcg is None else hcg.get_data_parallel_world_size()
        if t is None or dp <= 1:
            return t
        if isinstance(t, (tuple, list)):
            return type(t)(self._rows(x) for x in t)
        n = t.shape[0]
        if n % dp:
            raise ValueError(f"train_batch: a batch of {n} rows does not "
                             f"split over the {dp} dp ranks")
        per, r = n // dp, hcg.get_data_parallel_rank()
        return t[r * per:(r + 1) * per]

    def _dp_mean(self, loss):
        hcg = self._hcg
        if hcg is None or hcg.get_data_parallel_world_size() <= 1:
            return loss
        loss = loss.detach().clone()
        C.all_reduce(loss, op=C.ReduceOp.AVG,
                     group=hcg.get_data_parallel_group())
        return loss

    def train_batch(self, data, optimizer, lr_scheduler=None, scaler=None):
        """One pipeline-scheduled optimizer step over the global batch
        ``data`` (reference: pipeline_parallel.py:600); returns the total
        loss, the same on every rank."""
        inputs, labels = _unpack(data)
        data = (self._rows(inputs), self._rows(labels)) \
            if labels is not None else self._rows(inputs)
        total = self._runner.run(data, scaler=scaler)
        self.total_loss = self._dp_mean(total)
        self._sync_ties()
        hcg = self._hcg
        mesh_update(optimizer, scaler,
                    None if hcg is None else hcg.get_data_parallel_group(),
                    None if hcg is None else hcg.get_model_parallel_group(),
                    _env.current_device())
        optimizer.clear_grad()
        if lr_scheduler is not None:
            lr_scheduler.step()
        return self.total_loss

    def eval_batch(self, data, compute_loss=True):
        """The forward of ``data`` without gradients: the loss of the
        whole batch with ``compute_loss`` and labels (taken on the last
        stage, broadcast), else the global-view output."""
        inputs, labels = _unpack(data)
        layers = self._layers
        with torch.no_grad():
            if not (compute_loss and self._loss_fn is not None
                    and labels is not None):
                return layers(inputs)
            inputs, labels = self._rows(inputs), self._rows(labels)
            runner = Host1F1B(layers, 1, self._loss_fn, order="sequential")
            return self._dp_mean(runner.run((inputs, labels),
                                            forward_only=True))


class PipelineParallelWithInterleave(PipelineParallel):
    """Virtual-pipeline scheduling (reference: pipeline_parallel.py:832):
    each stage owns ``num_chunks`` non-contiguous model chunks; this
    rank's chunks run in the interleaved lane's order (the module
    docstring)."""

    def __init__(self, layers, hcg=None, strategy=None):
        super().__init__(layers, hcg=hcg, strategy=strategy)
        self._num_chunks = layers._num_chunks
        if self._num_chunks < 2:
            raise ValueError(
                "interleaved schedule needs num_virtual_pipeline_stages>=2")
