"""Keras-like high-level Model API (port of paddle_tpu/hapi/model.py):
``Model(network).prepare(optimizer, loss, metrics, amp_configs)``, then
``fit`` / ``evaluate`` / ``predict`` (or ``train_batch`` / ``eval_batch``
/ ``predict_batch``) and ``save`` / ``load``.

Every training step goes through `framework.train_step.
CompiledTrainStep` (one CUDA graph replay a step on the card after the
eager first step) unless ``FLAGS_compiled_train_step`` is off or a
subclass overrides the step; the loss stays on the device between log
points.  A batch is moved to the network's device, unless it is there
already (``data.Pipeline.device_prefetch`` puts it there ahead of the
step).

Checkpointing: with ``save_dir`` (or a `hapi.callbacks.ModelCheckpoint`)
fit saves through `framework.checkpoint_manager.CheckpointManager`
(model, optimizer, the next epoch and a ``data.Pipeline``'s position),
installs a `distributed.fleet.elastic.PreemptionHandler` (SIGTERM saves
at the next step boundary and exits with ``ELASTIC_EXIT_CODE``), and
``fit(resume=True)`` continues from the newest valid checkpoint, one the
JAX package wrote too.

Telemetry: fit runs under `observability.StepMetrics` (``step_metrics``,
prefix ``train.``: step time from CUDA events on the card, examples and
tokens per second, MFU, memory watermarks), with the step's FLOPs
counted once on the first batch (`ops.flops.FlopsCounter`, one extra
forward under ``no_grad`` that leaves every generator as it found it),
a ``data.Pipeline``'s goodput attached, and the metrics exporter started
when ``FLAGS_metrics_export_path`` is set.

The training sentinel (``FLAGS_sentinel``, `framework.sentinel`): fit
wraps a run without loss scaling in a unit-scale ``GradScaler`` that
always checks found-inf, builds the compiled step with its health
output, pins anchors (`_sentinel_snapshot`: the model, the optimizer,
the scaler, the generators' states and a pipeline's position; in host
memory, or in the ``ModelCheckpoint``'s ``CheckpointManager``), and after
a rollback (`_sentinel_restore`, which copies into the tensors the
captured graphs read) replays the anchor's epoch without the quarantined
iterations.  The fault points ``bad_batch`` (the batch before the step),
``loss_spike`` and ``grad_bitflip`` (the eager step) are its drills.

Data parallelism (a world size above 1, JAX's ``_sync_grads``): each
rank trains on its rows, its dp share of a dataset through a
`io.DistributedBatchSampler` over the dp ranks (a ``data.Pipeline`` or
a ``DataLoader`` is taken as it is: it yields the rank's rows).  The dp
group is the hybrid topology's when `fleet.init` built one (the mp ranks
of a dp rank read the same rows), else the world.  The eager step
unscales with the found-inf kept on the device, averages the gradients
over dp in buckets, makes the found-inf the world's (one scalar
all-reduce) and updates (`distributed.parallel.mesh_update`); the
compiled step runs the same tail (`CompiledTrainStep` with the mesh,
``local_batch=True``).  The network is the bare model: a `DataParallel`
raises (the step averages over dp itself).

With more than one rank the sentinel runs on every rank with the world
and the rank (JAX's): each check publishes the rank's health on the
guardian store and the blame follows (`framework.sentinel`); it gets no
``CheckpointManager`` (no rollback anchor crosses ranks), so a
persistent anomaly skips, blames and raises `SentinelError` for the
launch controller's quarantine relaunch.

Sharded checkpoints and the elastic reshard: with more than one rank the
``ModelCheckpoint`` writes a shard file a rank (`distributed.reshard`)
over `_checkpoint_mesh_spec` (the mesh's axes above size 1, else dp over
the world), and ``fit(resume=...)`` restores the newest valid one
resharded onto `_resume_target_mesh` (``PADDLE_RESHARD_MESH`` first):
the same layout takes the fast path, a resized world or another dp×mp
factorisation assembles each tensor, and a layout that cannot map raises
`LayoutMismatchError`; a checkpoint without a layout loads whole.  Values
are copied into the existing tensors, so a captured step still reads
them; ``last_resume`` records the source, the report and the seconds.

Hot-spare recovery (``FLAGS_hot_spare``, `framework.hot_spare`): fit arms
the process's agent, snapshots ``_hot_spare_state`` every
``FLAGS_hot_spare_every`` updates at the step boundary (streamed to the
ring buddy), parks on a preemption or a peer's failure (not at a
finished fit's end, unlike JAX: nothing relaunches, and the snapshot is
older than the last checkpoint), and a resume climbs the ladder: the
peer's copy (every rank must restore the same iteration, else all of
them go to the disk, loudly), then the disk.

Not ported, each raising `NotImplementedError` with its ROADMAP label:
``prepare(jit=True)`` (A9), ``summary`` (A9).
"""
from __future__ import annotations

import os
import weakref

import numpy as np
import torch

from .. import distributed as dist_env
from ..io import DataLoader
from ..metric import Metric
from ..nn import functional as F
from ..utils import fault_injection as _fault_injection
from ..utils.flags import flag as _flag
from .callbacks import config_callbacks

_JIT = "prepare(jit=True): to_static is not ported (ROADMAP A9, jit)"
_SUMMARY = "Model.summary is not ported (ROADMAP A9)"


def _to(t, device):
    return t.to(device) if torch.is_tensor(t) and t.device != device else t


def _batch_counts(x):
    """(examples, tokens) of a batch: examples its leading dimension,
    tokens its element count when it holds integers (token ids), else
    None."""
    shape = tuple(getattr(x, "shape", ()) or ())
    if not shape:
        return 0, None
    integer = torch.is_tensor(x) and not x.is_floating_point() and \
        not x.is_complex()
    return int(shape[0]), (int(np.prod(shape)) if integer else None)


def _generators(network):
    """The torch generators ``network``'s forward draws from (each module's
    attributes, then the package's default dropout generators), in a
    fixed order."""
    seen, out = set(), []
    for mod in network.modules():
        for v in vars(mod).values():
            if isinstance(v, torch.Generator) and id(v) not in seen:
                seen.add(id(v))
                out.append(v)
    for _, gen in sorted(F._generators.items(), key=lambda kv: str(kv[0])):
        if id(gen) not in seen:
            seen.add(id(gen))
            out.append(gen)
    return out


class Model:
    def __init__(self, network, inputs=None, labels=None):
        self.network = network
        self._optimizer = None
        self._loss = None
        self._metrics = []
        self.stop_training = False
        self._amp_level = "O0"
        self._amp_dtype = "bfloat16"
        self._amp_lists = (None, None)
        self._scaler = None
        self._nranks = 1
        self._rank = 0
        # the dp lane's (world > 1): the mesh, the dp and mp groups, this
        # rank's dp index and the dp size
        self._mesh = None
        self._dp_group = self._mp_group = None
        self._dp_rank, self._dp_size = 0, 1
        # the data.Pipeline fit trains on: its position rides checkpoints
        self._data_pipeline = None
        self._compiled_step = None
        self._accum_steps = 1
        # the training sentinel fit installs under FLAGS_sentinel (None:
        # every seam is one attribute read)
        self._sentinel = None
        # the global iteration the sentinel's fault points read (fit sets it)
        self._fi_step = None
        self.step_metrics = None
        # the last resume: {"source", "report", "seconds", "step"}
        self.last_resume = None
        # (epoch, batches to pass over) after a resume mid-epoch
        self._resume_skip = None

    def _device(self):
        for p in self.network.parameters():
            return p.device
        return torch.device("cpu")

    # ---- configuration ----
    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None, jit=False):
        if jit:
            raise NotImplementedError(_JIT)
        self._nranks = dist_env.get_world_size()
        self._rank = dist_env.get_rank()
        if self._nranks > 1:
            self._bind_world()
        self._loss = loss
        metrics = metrics or []
        if isinstance(metrics, Metric):
            metrics = [metrics]
        self._metrics = metrics

        # "O1"/"O2", or a dict of auto_cast and GradScaler knobs
        scaler_kw = {}
        if amp_configs:
            if isinstance(amp_configs, str):
                self._amp_level = amp_configs
            else:
                cfg = dict(amp_configs)
                self._amp_level = cfg.pop("level", "O1")
                self._amp_dtype = cfg.pop("dtype", "bfloat16")
                self._amp_lists = (cfg.pop("custom_white_list", None),
                                   cfg.pop("custom_black_list", None))
                scaler_kw = cfg
            if self._amp_level not in ("O0", "O1", "O2"):
                raise ValueError(
                    f"amp level must be O0/O1/O2, got {self._amp_level!r}")
        from .. import amp as amp_pkg
        if self._amp_level == "O2" and optimizer is not None:
            # parameters in the amp type; the optimizer keeps fp32 masters
            self.network, optimizer = amp_pkg.decorate(
                self.network, optimizer, level="O2", dtype=self._amp_dtype)
        if self._amp_level != "O0" and (
                self._amp_dtype in ("float16", "fp16") or scaler_kw):
            # bf16 needs no loss scaling: a scaler only for fp16 or when
            # scaling knobs are passed
            self._scaler = amp_pkg.GradScaler(**scaler_kw)
        self._optimizer = optimizer
        # the compiled train step is built at the first train batch;
        # None = not yet decided, False = ruled out
        self._compiled_step = None
        self._accum_steps = 1
        return self

    def _bind_world(self):
        """The dp lane's groups: the hybrid topology's, else dp over the
        world."""
        from ..distributed import parallel, topology
        from ..distributed.mesh import init_mesh
        parallel.refuse_data_parallel(self.network, "hapi.Model")
        hcg = topology.get_hybrid_communicate_group()
        if hcg is not None:
            self._mesh = hcg.mesh
            self._dp_group = hcg.get_data_parallel_group()
            self._mp_group = hcg.get_model_parallel_group()
            self._dp_rank = hcg.get_data_parallel_rank()
            self._dp_size = hcg.get_data_parallel_world_size()
        else:
            self._mesh = init_mesh([self._nranks], ["dp"])
            self._dp_group = self._mesh.get_group("dp")
            self._dp_rank, self._dp_size = self._rank, self._nranks

    # ---- steps ----
    def _compute_loss(self, outputs, labels):
        if self._loss is None:
            raise RuntimeError("prepare(loss=...) before fit/evaluate")
        return self._loss(outputs, labels)

    def _autocast(self):
        from .. import amp as amp_pkg
        return amp_pkg.auto_cast(enable=self._amp_level != "O0",
                                 level=self._amp_level,
                                 dtype=self._amp_dtype,
                                 custom_white_list=self._amp_lists[0],
                                 custom_black_list=self._amp_lists[1])

    def _forward_loss(self, x, y):
        """Forward and loss under autocast: the only user code the
        compiled train step captures."""
        with self._autocast():
            out = self.network(x)
            return self._compute_loss(out, y)

    def _train_step(self, x, y, update=True):
        with self._autocast():
            out = self.network(x)
            loss = self._compute_loss(out, y)
        if self._fi_step is not None:
            loss = _fault_injection.spike_loss(loss, self._fi_step)
        bwd = loss
        if self._scaler is not None:
            bwd = self._scaler.scale(bwd)
        if self._accum_steps > 1:
            # each micro-batch scaled so the accumulated gradient is the
            # mean over the window
            bwd = bwd * (1.0 / self._accum_steps)
        bwd.backward()
        if self._fi_step is not None:
            _fault_injection.corrupt_grads(self._optimizer, self._fi_step)
        if not update:
            return loss, out
        if self._sentinel is not None:
            found = self._sentinel.note_eager(self._optimizer)
            sc = self._scaler
            if found is not None and sc is not None and sc._scale == 1.0 \
                    and sc._always_check:
                # the unit-scale wrapper takes the health pass's flag
                # instead of reducing every gradient again
                sc._planted_found_inf = found
        if self._nranks > 1:
            from ..distributed import parallel
            parallel.mesh_update(self._optimizer, self._scaler,
                                 self._dp_group, self._mp_group,
                                 self._device())
        elif self._scaler is not None:
            self._scaler.step(self._optimizer)
        else:
            self._optimizer.step()
        if self._sentinel is not None and self._scaler is not None:
            self._sentinel.note_eager_skip(self._scaler._found_inf)
        self._optimizer.clear_grad()
        return loss, out

    def _ensure_compiled_step(self):
        """The CompiledTrainStep of this model, or None for the eager
        lane.  None stays undecided while the flag is off; False latches
        ineligibility."""
        if self._compiled_step is False:
            return None
        if self._compiled_step is not None:
            if self._compiled_step._sentinel == (self._sentinel is not None):
                return self._compiled_step
            # the sentinel was turned on or off: rebuilt with or without
            # the health output
            self._compiled_step = None
        if not _flag("FLAGS_compiled_train_step", True):
            return None
        if (self._loss is None or self._optimizer is None
                or type(self).train_batch is not Model.train_batch
                or type(self)._train_step is not Model._train_step
                or type(self)._forward_loss is not Model._forward_loss):
            self._compiled_step = False
            return None
        from ..framework.train_step import CompiledTrainStep
        # the step holds this model weakly: no reference cycle keeps a
        # dropped model, its step and the graph's memory pool alive
        ref = weakref.ref(self)
        cs = CompiledTrainStep(
            lambda x, y: ref()._forward_loss(x, y), self._optimizer,
            scaler=self._scaler, network=self.network,
            accumulate_grad_batches=self._accum_steps,
            sentinel=self._sentinel is not None, mesh=self._mesh,
            local_batch=True,
            eager_step=lambda x, y, update:
                ref()._train_step(x, y, update)[0])
        if cs.fallback_reason is not None:
            self._compiled_step = False   # structurally eager
            return None
        self._compiled_step = cs
        return cs

    def _inputs(self, inputs, labels):
        dev = self._device()
        x = inputs[0] if isinstance(inputs, (list, tuple)) else inputs
        y = labels[0] if isinstance(labels, (list, tuple)) else labels
        return _to(x, dev), _to(y, dev)

    def _train_batch_device(self, inputs, labels=None, update=True):
        """One train step; the loss stays on the device (no host read)."""
        self.network.train()
        x, y = self._inputs(inputs, labels)
        cs = self._ensure_compiled_step()
        if cs is not None:
            return cs(x, y, update=update)
        loss, _ = self._train_step(x, y, update)
        return loss

    def train_batch(self, inputs, labels=None, update=True):
        return [float(self._train_batch_device(inputs, labels,
                                               update).detach())]

    def eval_batch(self, inputs, labels=None):
        self.network.eval()
        x, y = self._inputs(inputs, labels)
        with torch.no_grad(), self._autocast():
            out = self.network(x)
            loss = self._compute_loss(out, y)
        return [float(loss)], out

    def predict_batch(self, inputs):
        self.network.eval()
        x, _ = self._inputs(inputs, None)
        with torch.no_grad(), self._autocast():
            return self.network(x)

    # ---- loops ----
    def _as_loader(self, data, batch_size, shuffle):
        from ..data import Pipeline
        if data is None or isinstance(data, (DataLoader, Pipeline)):
            # a data.Pipeline carries its own shard, shuffle and batch
            # stages and a checkpointable position
            return data
        if self._nranks > 1:
            # each dp rank reads its share (JAX hapi's
            # DistributedBatchSampler); the mp ranks of a dp rank alike
            from ..io import DistributedBatchSampler
            sampler = DistributedBatchSampler(
                data, batch_size=batch_size, num_replicas=self._dp_size,
                rank=self._dp_rank, shuffle=shuffle)
            return DataLoader(data, batch_sampler=sampler)
        return DataLoader(data, batch_size=batch_size, shuffle=shuffle)

    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1,
            verbose=2, drop_last=False, shuffle=True, num_workers=0,
            callbacks=None, accumulate_grad_batches=1, num_iters=None,
            resume=None, max_to_keep=None):
        """Train; returns ``{"loss": [each epoch's last logged loss]}``.
        ``resume=True`` (with ``save_dir``) or ``resume=<dir>`` restores
        the model, optimizer, epoch and a data.Pipeline's position from
        the newest valid checkpoint; torn checkpoints are skipped.  While
        checkpointing, SIGTERM saves at the next step boundary and exits
        with ``ELASTIC_EXIT_CODE``."""
        from ..data import Pipeline
        from ..observability import StepMetrics, maybe_start_exporter
        from .callbacks import ModelCheckpoint
        loader = self._as_loader(train_data, batch_size, shuffle)
        eval_loader = self._as_loader(eval_data, batch_size, False)
        self._data_pipeline = loader if isinstance(loader, Pipeline) \
            else None
        try:
            steps = len(loader)
        except TypeError:
            steps = None
        accumulate_grad_batches = max(int(accumulate_grad_batches or 1), 1)
        if accumulate_grad_batches != self._accum_steps:
            self._accum_steps = accumulate_grad_batches
            self._compiled_step = None   # rebuilt for the new window
        cbs = config_callbacks(callbacks, self, epochs=epochs, steps=steps,
                               verbose=verbose, save_freq=save_freq,
                               save_dir=save_dir,
                               metrics=[m.name() for m in self._metrics],
                               max_to_keep=max_to_keep, log_freq=log_freq)
        ckpt_cb = next((c for c in cbs.callbacks
                        if isinstance(c, ModelCheckpoint)), None)

        initial_epoch = 0
        self._resume_skip = None
        if resume:
            initial_epoch = self._resume_from(resume, save_dir, ckpt_cb,
                                              steps=steps)

        handler = None
        if ckpt_cb is not None and ckpt_cb.save_dir:
            from ..distributed.fleet.elastic import PreemptionHandler
            handler = PreemptionHandler().install()

        sentinel = self._install_sentinel(ckpt_cb)
        # hot-spare recovery: None with the flag off (one attribute read
        # a step)
        hot_spare_agent = self._install_hot_spare()

        # telemetry: the step metrics, the exporter thread when its flag
        # names a path; the step's FLOPs counted once, on the first batch
        maybe_start_exporter()
        self.step_metrics = StepMetrics(prefix="train.",
                                        device=self._device())
        if self._data_pipeline is not None:
            self.step_metrics.attach_data(self._data_pipeline.goodput)
        flops_pending = True

        self.stop_training = False
        cbs.call("on_train_begin")
        history = {"loss": []}
        it = 0
        logs = {}
        if sentinel is not None:
            sentinel.begin(it=0, epoch=initial_epoch)
        finished = False
        try:
            epoch = initial_epoch
            # after a rollback: redo the anchor's epoch, passing over (not
            # training on) the batches before the anchor; the loader's
            # fixed order maps an iteration to the same batch on a replay.
            # A peer resume mid-epoch passes over the epoch's batches the
            # snapshot had trained on the same way.
            replay_epoch, replay_from = self._resume_skip or (None, -1)
            while epoch < epochs:
                cbs.call("on_epoch_begin", epoch)
                sampler = getattr(loader, "batch_sampler", None)
                if sampler is not None and hasattr(sampler, "set_epoch"):
                    # a resumed fit shuffles epoch N as the uninterrupted
                    # run did
                    sampler.set_epoch(epoch)
                for m in self._metrics:
                    m.reset()
                logs = {}
                loss_t = None
                rollback = None
                for step, batch in enumerate(loader):
                    if replay_epoch == epoch and step < replay_from:
                        continue       # fast-forward to the anchor
                    x, y = self._split_batch(batch)
                    if sentinel is not None and sentinel.quarantined(it):
                        it += 1        # a quarantined batch is never fed
                        continue       # again
                    if _fault_injection.active("bad_batch") is not None:
                        x = _fault_injection.corrupt_batch(x, it)
                    self._fi_step = it
                    cbs.call("on_train_batch_begin", step)
                    if flops_pending:
                        flops_pending = False
                        self._measure_step_flops(x)
                    examples, tokens = _batch_counts(x)
                    update = (accumulate_grad_batches <= 1
                              or (it + 1) % accumulate_grad_batches == 0)
                    self.step_metrics.begin_step()
                    loss_t = self._train_batch_device(x, y, update=update)
                    self.step_metrics.end_step(examples, tokens)
                    # the loss stays on the device between log points
                    if step % log_freq == 0 or self._metrics:
                        logs["loss"] = float(loss_t.detach())
                    for m in self._metrics:
                        out = self.predict_batch(x)
                        m.update(*m.compute(out, y))
                        logs[m.name()] = m.accumulate()
                    cbs.call("on_train_batch_end", step, logs)
                    if handler is not None and handler.preempted():
                        # save at the step boundary, then ask for a
                        # relaunch; a data.Pipeline resumes mid-epoch
                        self._sync_compiled_state()
                        ckpt_cb.save_now(next_epoch=epoch)
                        ckpt_cb.manager.wait()
                        if hot_spare_agent is not None:
                            # memory dies with the relaunch: park every
                            # snapshot held in the guardian store
                            hot_spare_agent.park()
                        handler.uninstall()
                        handler.exit_for_relaunch()
                    if sentinel is not None:
                        rollback = sentinel.after_step(it, epoch, step,
                                                       loss_t, update)
                    it += 1
                    if rollback is not None:
                        break
                    if hot_spare_agent is not None:
                        # the step just completed is inside the snapshot:
                        # a peer restore resumes at `it`
                        hot_spare_agent.maybe_snapshot(
                            it, self._hot_spare_state,
                            {"it": it, "epoch": epoch,
                             "next_step": step + 1, "next_epoch": epoch})
                    if num_iters and it >= num_iters:
                        break
                if rollback is None and sentinel is not None:
                    rollback = sentinel.flush()
                if rollback is not None:
                    it = rollback.it
                    epoch = rollback.epoch
                    replay_epoch = rollback.epoch
                    # a data.Pipeline was rewound onto the anchor's position
                    # by the restore: nothing to pass over
                    replay_from = (0 if self._data_pipeline is not None
                                   else rollback.next_step)
                    continue           # redo from the anchor
                replay_epoch, replay_from = None, -1
                if loss_t is not None:
                    logs["loss"] = float(loss_t.detach())
                self._sync_compiled_state()
                history["loss"].append(logs.get("loss"))
                if eval_loader is not None and (epoch + 1) % eval_freq == 0:
                    eval_logs = self.evaluate(eval_loader, verbose=0,
                                              _callbacks=cbs)
                    logs.update({f"eval_{k}": v
                                 for k, v in eval_logs.items()})
                cbs.call("on_epoch_end", epoch, logs)
                epoch += 1
                if self.stop_training or (num_iters and it >= num_iters):
                    break
            finished = True
        finally:
            if handler is not None:
                handler.uninstall()
            if hot_spare_agent is not None:
                # an exit into a relaunch (an exception, a preemption)
                # parks what the agent holds; a finished fit has nothing
                # to relaunch into, and its snapshot is older than its
                # last checkpoint
                hot_spare_agent.close(park=not finished)
            self.step_metrics.flush()
            self._sentinel = None
            self._fi_step = None
        cbs.call("on_train_end", logs)
        return history

    def _sync_compiled_state(self):
        """Write the compiled step's device-held loss-scaling state back
        into the GradScaler before a save or at an epoch's end."""
        cs = self._compiled_step
        if cs is not None and cs is not False:
            cs.sync_scaler()

    # ---- the training sentinel (framework/sentinel.py) ----
    def _install_sentinel(self, ckpt_cb):
        """The fit's `TrainingSentinel` when ``FLAGS_sentinel`` is on, else
        None.  A run without loss scaling gets a unit-scale GradScaler
        that always checks found-inf, so a non-finite step is skipped (in
        the compiled lane as the update's skip flag, no host read)."""
        from ..framework.sentinel import TrainingSentinel, sentinel_enabled
        if not sentinel_enabled():
            if getattr(self._scaler, "_sentinel_wrapper", False):
                self._scaler = None     # the sentinel was turned off since
            self._sentinel = None       # the last fit installed its wrapper
            return None
        from .. import amp as amp_pkg
        if self._scaler is None:
            self._scaler = amp_pkg.GradScaler(
                enable=True, init_loss_scaling=1.0,
                use_dynamic_loss_scaling=False, always_check_found_inf=True)
            self._scaler._sentinel_wrapper = True
        manager = None
        if ckpt_cb is not None and ckpt_cb.save_dir and self._nranks == 1:
            manager = ckpt_cb.manager
        self._sentinel = TrainingSentinel(self, manager=manager,
                                          nranks=self._nranks,
                                          rank=self._rank)
        return self._sentinel

    def _install_hot_spare(self):
        """The fit's armed hot-spare agent when ``FLAGS_hot_spare`` is on,
        else None."""
        if not _flag("FLAGS_hot_spare", False):
            return None
        from ..framework import hot_spare
        return hot_spare.arm(rank=self._rank, world=self._nranks)

    def _rng_states(self):
        return [g.get_state() for g in _generators(self.network)]

    def _set_rng_states(self, states):
        for g, st in zip(_generators(self.network), states):
            g.set_state(torch.as_tensor(np.asarray(st), dtype=torch.uint8))

    def _sentinel_snapshot(self):
        """Host copies of the model, the optimizer, the scaler, the
        generators' states and a pipeline's position: the sentinel's
        anchor (the compiled step rewrites the device tensors in place)."""
        self._sync_compiled_state()

        def host(sd):
            return {k: (v.detach().to("cpu", copy=True)
                        if torch.is_tensor(v) else v)
                    for k, v in sd.items()}

        state = {"model": host(self.network.state_dict()),
                 "rng": [st.numpy() for st in self._rng_states()]}
        if self._optimizer is not None:
            state["optimizer"] = host(self._optimizer.state_dict())
        if self._scaler is not None:
            state["scaler"] = dict(self._scaler.state_dict())
        if self._data_pipeline is not None:
            state["data_pipeline"] = self._data_pipeline.state_dict()
        return state

    def _hot_spare_state(self):
        """The sentinel anchor's state with the live tensors (the
        hot-spare agent copies them to its host buffers itself)."""
        self._sync_compiled_state()
        state = {"model": dict(self.network.state_dict()),
                 "rng": [st.numpy() for st in self._rng_states()]}
        if self._optimizer is not None:
            state["optimizer"] = self._optimizer.state_dict()
        if self._scaler is not None:
            state["scaler"] = dict(self._scaler.state_dict())
        if self._data_pipeline is not None:
            state["data_pipeline"] = self._data_pipeline.state_dict()
        return state

    def _sentinel_restore(self, state):
        """Roll the live model back onto an anchor: every value is copied
        into the existing tensor (the parameters, the optimizer's moments,
        masters and step, the scaler's device vector), whose address the
        captured graphs read, and the generators take the anchor's
        states, so a replay draws the masks the clean run draws."""
        self.network.load_state_dict(state["model"])
        if self._optimizer is not None and state.get("optimizer"):
            self._optimizer.set_state_dict(state["optimizer"])
        if self._scaler is not None and state.get("scaler"):
            self._scaler.load_state_dict(dict(state["scaler"]))
            self._scaler._found_inf = False
            self._scaler._unscaled = False
        cs = self._compiled_step
        if cs is not None and cs is not False:
            cs.load_scaler()
            cs.last_health = None
        if "rng" in state:
            self._set_rng_states(state["rng"])
        if self._data_pipeline is not None and state.get("data_pipeline"):
            self._data_pipeline.load_state_dict(state["data_pipeline"])

    def _measure_step_flops(self, x):
        """The analytic FLOPs of one train step (`ops.flops.FlopsCounter`,
        3 × one forward under ``no_grad``), once a fit, for ``train.mfu``.
        The generators the forward draws from are put back, so the fit's
        trajectory is the one without the measurement."""
        from ..ops.flops import FlopsCounter
        states = self._rng_states()
        x = _to(x, self._device())
        try:
            with torch.no_grad(), self._autocast(), FlopsCounter() as fc:
                self.network(x)
        finally:
            self._set_rng_states(states)
        if fc.forward_flops:
            self.step_metrics.set_flops_per_step(fc.train_step_flops)

    # ---- sharded checkpoints and the elastic reshard ----
    def _mp_size(self):
        return 1 if self._mp_group is None else int(self._mp_group.nranks)

    def _checkpoint_mesh_spec(self):
        """The rank factorisation sharded checkpoints use to save and to
        resume: the mesh's axes of size above 1 when one besides dp is
        (the hybrid topology's), else pure dp over the world.  Ranks are
        row-major over those axes (the topology's order)."""
        from ..distributed.mesh import get_mesh
        from ..distributed.reshard import LayoutError, MeshSpec
        mesh = self._mesh if self._mesh is not None else get_mesh()
        if mesh is not None and any(
                mesh.get_dim_size(n) > 1 for n in mesh.dim_names
                if n != "dp"):
            axes = [n for n in mesh.dim_names if mesh.get_dim_size(n) > 1]
            spec = MeshSpec(tuple(axes),
                            tuple(mesh.get_dim_size(n) for n in axes))
            coords = mesh.coord(self._rank)
            mine = {n: c for n, c in zip(mesh.dim_names, coords)
                    if n in axes}
            if spec.world != self._nranks or spec.coords(self._rank) != mine:
                raise LayoutError(
                    f"the mesh {mesh} does not lay its ranks out row-major "
                    f"over {spec!r}: rank {self._rank} sits at {mine}")
            return spec
        return MeshSpec(("dp",), (max(self._nranks, 1),))

    def _resume_target_mesh(self):
        """The mesh this incarnation reshards a checkpoint onto:
        ``PADDLE_RESHARD_MESH`` (JSON ``{"axes", "shape"}``) first, then
        `_checkpoint_mesh_spec`, which is what ModelCheckpoint saves (a
        resume on the same topology takes the fast path)."""
        import json
        from ..distributed.reshard import MeshSpec
        raw = os.environ.get("PADDLE_RESHARD_MESH")
        if raw:
            obj = json.loads(raw)
            return MeshSpec(obj["axes"], obj["shape"])
        return self._checkpoint_mesh_spec()

    def _checkpoint_splits(self):
        """``{checkpoint key: (dim, chunks)}`` of the model's and the
        optimizer's tensors a tensor-parallel layer splits over mp (keys
        as `distributed.reshard.flatten_state` names them); empty at mp
        1."""
        if self._mp_size() <= 1:
            return {}
        from ..convert import _param_splits, _splits
        out = {f"model.{k}": v for k, v in _splits(self.network).items()}
        opt = self._optimizer
        if opt is not None:
            params = opt._all_params()
            splits = _param_splits(self.network, opt)
            for key, val in opt.state_dict().items():
                name, _, idx = key.rpartition(".")
                if torch.is_tensor(val) and idx.isdigit() and \
                        int(idx) < len(params) and \
                        splits[int(idx)] is not None and \
                        tuple(val.shape) == tuple(params[int(idx)].shape):
                    out[f"optimizer.{key}"] = splits[int(idx)]
        return out

    @staticmethod
    def _mp_partition(splits, key, ndim):
        """"mp" on the split dim of a tensor a tensor-parallel layer
        splits in one piece, else whole (a fused projection's are
        gathered whole by `_gather_fused`)."""
        p = [None] * ndim
        sp = splits.get(key)
        if sp is not None and sp[1] == 1:
            p[sp[0] % ndim] = "mp"
        return tuple(p)

    def _checkpoint_partition(self, spec):
        """The partition of each saved (local) tensor over ``spec``."""
        splits = self._checkpoint_splits() if "mp" in spec.axes else {}
        return lambda key, arr: self._mp_partition(splits, key, arr.ndim)

    def _gather_fused(self, state):
        """``state`` with each fused projection's part (``chunks`` above
        1: this rank's q, k and v) replaced by the whole tensor, gathered
        over mp (every mp rank calls it)."""
        fused = {k: v for k, v in self._checkpoint_splits().items()
                 if v[1] > 1}
        if not fused:
            return state
        from ..convert import _gather_part
        for group in ("model", "optimizer"):
            sd = state.get(group) or {}
            for k in list(sd):
                sp = fused.get(f"{group}.{k}")
                if sp is not None:
                    sd[k] = _gather_part(sd[k].detach(), sp)
        return state

    def _reshard_to_parts(self, state):
        """A restored state's whole fused tensors cut to this rank's part
        (`distributed.fleet.mp_layers.shard_of`)."""
        fused = {k: v for k, v in self._checkpoint_splits().items()
                 if v[1] > 1}
        if not fused:
            return state
        from ..distributed.fleet.mp_layers import shard_of
        g = self._mp_group
        for group in ("model", "optimizer"):
            sd = state.get(group) or {}
            for k in list(sd):
                sp = fused.get(f"{group}.{k}")
                if sp is not None:
                    sd[k] = shard_of(sd[k], sp[0], g.nranks, g.rank, sp[1])
        return state

    def _target_partition(self):
        """The partition a resume restores each tensor in: this rank's mp
        part of a tensor split in one piece, else whole (None at mp 1)."""
        splits = self._checkpoint_splits()
        if not splits:
            return None
        return lambda key, meta: self._mp_partition(
            splits, key, len(meta["global_shape"]))

    def _agree_on_peer(self, got):
        """With more than one rank, every rank must restore the same
        iteration from the peer rung; otherwise every rank falls to the
        disk (a `PeerRestoreWarning`).  One all-reduce of ``(it, -it)``."""
        if self._nranks <= 1:
            return got
        import warnings
        from ..distributed import collective
        from ..framework.hot_spare import PeerRestoreWarning
        it = int(got[1].get("it", -1)) if got is not None else -1
        t = torch.tensor([it, -it], dtype=torch.int64,
                         device=self._device())
        collective.all_reduce(t, op=collective.ReduceOp.MAX)
        hi, lo = int(t[0]), -int(t[1])
        if hi == lo and (got is not None or hi < 0):
            return got          # the same iteration everywhere, or none
        msg = (f"hot-spare: the ranks' peer snapshots disagree (iterations "
               f"{lo}..{hi}, this rank {it}); every rank falls back to "
               "disk")
        warnings.warn(msg, PeerRestoreWarning, stacklevel=2)
        import sys
        print(f"PeerRestoreWarning: {msg}", file=sys.stderr, flush=True)
        return None

    def _resume_position(self, book, steps):
        """The epoch a peer snapshot resumes at, and the batches of it to
        pass over (a snapshot at an epoch's last batch resumes at the
        next epoch's start)."""
        epoch = int(book.get("epoch", book.get("next_epoch", 0)))
        nxt = int(book.get("next_step", 0))
        if steps is not None and nxt >= steps:
            return epoch + 1, None
        if nxt > 0 and self._data_pipeline is None:
            return epoch, (epoch, nxt)
        return epoch, None

    def _resume_from(self, resume, save_dir, ckpt_cb, steps=None):
        """Restore the model, the optimizer and a data.Pipeline's position
        and return the epoch to continue from (0 when there is nothing
        to restore).  With ``FLAGS_hot_spare`` the peer rung comes first;
        then the newest valid checkpoint, resharded onto
        `_resume_target_mesh`.  Values are copied into the existing
        tensors, whose addresses a captured train step reads."""
        import time
        resume_dir = resume if isinstance(resume, (str, os.PathLike)) \
            else (save_dir or (ckpt_cb.save_dir if ckpt_cb else None))
        if not resume_dir:
            raise ValueError(
                "fit(resume=True) needs save_dir (or resume=<dir>)")
        t0 = time.perf_counter()
        if _flag("FLAGS_hot_spare", False):
            from ..framework import hot_spare
            got = self._agree_on_peer(hot_spare.restore_with_ladder(
                os.environ.get("PADDLE_JOB_ID", "default"), self._rank,
                disk_fn=None))
            if got is not None:
                state, book, source = got
                self._sentinel_restore(state)
                epoch, self._resume_skip = self._resume_position(book,
                                                                 steps)
                self.last_resume = {
                    "source": source, "report": None, "step": None,
                    "it": int(book.get("it", 0)),
                    "seconds": time.perf_counter() - t0}
                return epoch
        from ..distributed.reshard import restore_latest_resharded
        restored = restore_latest_resharded(
            str(resume_dir), self._resume_target_mesh(), self._rank,
            target_partition_fn=self._target_partition(),
            map_location="cpu", gc_invalid=self._rank == 0)
        if restored is None:
            self.last_resume = {"source": None, "report": None,
                                "step": None,
                                "seconds": time.perf_counter() - t0}
            return 0
        state, step, report = restored
        state = self._reshard_to_parts(state)
        self.network.load_state_dict(state["model"])
        if self._optimizer is not None and state.get("optimizer"):
            self._optimizer.set_state_dict(state["optimizer"])
        pipe = self._data_pipeline
        if pipe is not None and state.get("data_pipeline"):
            pipe.load_state_dict(state["data_pipeline"])
        self.last_resume = {"source": "disk", "report": report,
                            "step": step,
                            "seconds": time.perf_counter() - t0}
        return int(state.get("next_epoch", 0))

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, num_samples=None,
                 _callbacks=None):
        loader = self._as_loader(eval_data, batch_size, False)
        cbs = _callbacks or config_callbacks(callbacks, self,
                                             verbose=verbose)
        cbs.call("on_eval_begin")
        for m in self._metrics:
            m.reset()
        losses = []
        for step, batch in enumerate(loader):
            x, y = self._split_batch(batch)
            loss, out = self.eval_batch(x, y)
            losses.append(loss[0])
            for m in self._metrics:
                m.update(*m.compute(out, y))
            cbs.call("on_eval_batch_end", step, {"loss": loss[0]})
        logs = {"loss": float(np.mean(losses)) if losses else 0.0}
        for m in self._metrics:
            logs[m.name()] = m.accumulate()
        cbs.call("on_eval_end", logs)
        return logs

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, verbose=1, callbacks=None):
        loader = self._as_loader(test_data, batch_size, False)
        outs = []
        for batch in loader:
            x, _ = self._split_batch(batch, allow_no_label=True)
            outs.append(self.predict_batch(x))
        if stack_outputs:
            return torch.cat(outs)
        return outs

    @staticmethod
    def _split_batch(batch, allow_no_label=False):
        if isinstance(batch, (list, tuple)):
            if len(batch) >= 2:
                return batch[0], batch[1]
            if allow_no_label:
                return batch[0], None
        return batch, None

    # ---- persistence ----
    def save(self, path, training=True):
        from ..framework.io import save
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        save(self.network.state_dict(), path + ".pdparams")
        if training and self._optimizer is not None:
            save(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        """Copy a `save`d state (either package's) into the network and
        optimizer in place, on the network's device."""
        from ..framework.io import load
        dev = self._device()
        self.network.load_state_dict(load(path + ".pdparams",
                                          map_location=dev))
        opt_path = path + ".pdopt"
        if not reset_optimizer and self._optimizer is not None \
                and os.path.exists(opt_path):
            self._optimizer.set_state_dict(load(opt_path, map_location=dev))

    def parameters(self, *args, **kwargs):
        return self.network.parameters(*args, **kwargs)

    def summary(self, input_size=None, dtype=None):
        raise NotImplementedError(_SUMMARY)
