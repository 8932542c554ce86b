"""hapi callbacks (port of paddle_tpu/hapi/callbacks.py): ``Callback``,
``CallbackList``, ``ProgBarLogger``, ``ModelCheckpoint``,
``EarlyStopping``, ``LRScheduler``, ``ReduceLROnPlateau`` and
``config_callbacks``.  ``VisualDL`` and ``WandbCallback`` are not ported
(ROADMAP A9)."""
from __future__ import annotations

import os
import time

import torch


class Callback:
    def __init__(self):
        self.model = None
        self.params = {}

    def set_model(self, model):
        self.model = model

    def set_params(self, params):
        self.params = params or {}

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_train_batch_begin(self, step, logs=None):
        pass

    def on_train_batch_end(self, step, logs=None):
        pass

    def on_eval_begin(self, logs=None):
        pass

    def on_eval_end(self, logs=None):
        pass

    def on_eval_batch_end(self, step, logs=None):
        pass


class CallbackList:
    def __init__(self, callbacks, model=None, params=None):
        self.callbacks = list(callbacks)
        for cb in self.callbacks:
            cb.set_model(model)
            cb.set_params(params)

    def call(self, hook, *args, **kwargs):
        for cb in self.callbacks:
            getattr(cb, hook)(*args, **kwargs)


def _fmt(logs):
    return " - ".join(f"{k}: {v:.4f}" if isinstance(v, float)
                      else f"{k}: {v}" for k, v in (logs or {}).items())


class ProgBarLogger(Callback):
    """A line per epoch (and per ``log_freq`` steps at ``verbose`` 2)."""

    def __init__(self, log_freq=1, verbose=2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch
        self.steps = self.params.get("steps")
        self._t0 = time.time()
        if self.verbose:
            print(f"Epoch {epoch + 1}/{self.params.get('epochs', '?')}")

    def on_train_batch_end(self, step, logs=None):
        if self.verbose > 1 and step % self.log_freq == 0:
            print(f"step {step + 1}/{self.steps or '?'} - {_fmt(logs)}")

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            dt = time.time() - self._t0
            print(f"epoch {epoch + 1} done in {dt:.1f}s - {_fmt(logs)}")


def _clone_tensors(obj):
    if torch.is_tensor(obj):
        return obj.detach().clone()
    if isinstance(obj, dict):
        return {k: _clone_tensors(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_clone_tensors(v) for v in obj)
    return obj


class ModelCheckpoint(Callback):
    """Epoch checkpoints through `framework.checkpoint_manager.
    CheckpointManager` (``save_dir/ckpt-N/`` committed by its manifest),
    so ``Model.fit(resume=...)`` restores the latest valid one after a
    crash or preemption; ``max_to_keep`` bounds the directory.
    ``final.pdparams`` is written at the end of training.

    With more than one rank every rank writes its own shard file into one
    ``ckpt-N`` directory and rank 0 commits the manifest with its layout
    section (`distributed.reshard.ShardedCheckpointer` over the model's
    `Model._checkpoint_mesh_spec`), so a resized relaunch reshards on
    resume.  At mp 1 every rank writes the full state (JAX's layout); at
    mp above 1 a rank writes its own part of each tensor a
    tensor-parallel layer splits (``local``), with the split as its
    partition, and a fused projection's tensors (q, k and v in each part)
    gathered whole.  A sharded save is synchronous; ``final.pdparams`` is
    rank 0's, at mp 1 only.

    With ``async_save`` the manager writes on a background thread while
    training goes on.  The compiled train step updates the parameters,
    masters and moments in place, so `_state` clones every tensor of the
    state on the card on the calling thread and records an event after
    the clones; the save thread waits on that event before it copies the
    clones to the host and pickles them.  The checkpoint is then the
    state of the step it was taken at, whatever replays follow."""

    def __init__(self, save_freq=1, save_dir=None, max_to_keep=None,
                 async_save=False):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir
        self.max_to_keep = max_to_keep
        self.async_save = async_save
        self._manager = None

    @property
    def manager(self):
        if self._manager is None and self.save_dir:
            if self._sharded():
                from ..distributed.reshard import ShardedCheckpointer
                spec = self.model._checkpoint_mesh_spec()
                self._manager = ShardedCheckpointer(
                    self.save_dir, spec, rank=self.model._rank,
                    partition_fn=self.model._checkpoint_partition(spec),
                    local=True, max_to_keep=self.max_to_keep,
                    map_location=self.model._device())
                return self._manager
            from ..framework.checkpoint_manager import CheckpointManager
            self._manager = CheckpointManager(
                self.save_dir, max_to_keep=self.max_to_keep,
                async_save=self.async_save,
                map_location=self.model._device())
        return self._manager

    def _sharded(self):
        return getattr(self.model, "_nranks", 1) > 1

    def _state(self, next_epoch):
        """``(state, ready)``: the checkpoint's state and, for an async
        save of tensors on the card, the event the save thread waits on
        (else None)."""
        state = {"model": self.model.network.state_dict(),
                 "next_epoch": int(next_epoch)}
        opt = getattr(self.model, "_optimizer", None)
        if opt is not None:
            state["optimizer"] = opt.state_dict()
        pipe = getattr(self.model, "_data_pipeline", None)
        if pipe is not None:
            # a few ints: the input resumes mid-epoch from these
            state["data_pipeline"] = pipe.state_dict()
        ready = None
        if self._sharded():
            return self.model._gather_fused(state), None
        if self.async_save:
            state = _clone_tensors(state)
            dev = self.model._device()
            if dev.type == "cuda":
                ready = torch.cuda.Event()
                ready.record(torch.cuda.current_stream(dev))
        return state, ready

    def save_now(self, next_epoch):
        """Checkpoint now (fit's preemption path calls this at the step
        boundary after SIGTERM)."""
        if self.manager is not None:
            state, ready = self._state(next_epoch)
            if self.async_save and not self._sharded():
                self.manager.save(
                    state, before_write=None if ready is None
                    else ready.synchronize)
            else:
                self.manager.save(state)

    def on_epoch_end(self, epoch, logs=None):
        if self.save_dir and (epoch + 1) % self.save_freq == 0:
            self.save_now(next_epoch=epoch + 1)

    def on_train_end(self, logs=None):
        if self.save_dir:
            if self._manager is not None:
                self._manager.wait()
            if not self._sharded() or (self.model._rank == 0 and
                                       not self.model._checkpoint_splits()):
                self.model.save(os.path.join(self.save_dir, "final"))


class EarlyStopping(Callback):
    def __init__(self, monitor="loss", mode="auto", patience=0,
                 verbose=1, min_delta=0, baseline=None,
                 save_best_model=True):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        self.stopped = False
        if mode == "max" or (mode == "auto" and "acc" in monitor):
            self.better = lambda a, b: a > b + self.min_delta
            self.best = float("-inf")
        else:
            self.better = lambda a, b: a < b - self.min_delta
            self.best = float("inf")
        self.wait = 0

    def on_eval_end(self, logs=None):
        val = (logs or {}).get(self.monitor)
        if val is None:
            return
        if isinstance(val, (list, tuple)):
            val = val[0]
        if self.better(val, self.best):
            self.best = val
            self.wait = 0
        else:
            self.wait += 1
            if self.wait > self.patience:
                self.stopped = True
                self.model.stop_training = True


class LRScheduler(Callback):
    """Steps the optimizer's LRScheduler each epoch (or batch)."""

    def __init__(self, by_step=False, by_epoch=True):
        super().__init__()
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        from ..optimizer.lr import LRScheduler as Sched
        opt = getattr(self.model, "_optimizer", None)
        lr = getattr(opt, "_learning_rate", None)
        return lr if isinstance(lr, Sched) else None

    def on_train_batch_end(self, step, logs=None):
        s = self._sched()
        if self.by_step and s:
            s.step()

    def on_epoch_end(self, epoch, logs=None):
        s = self._sched()
        if self.by_epoch and s:
            s.step()


def config_callbacks(callbacks, model, epochs=None, steps=None,
                     verbose=2, save_freq=1, save_dir=None, metrics=None,
                     max_to_keep=None, log_freq=1):
    cbs = list(callbacks or [])
    if not any(isinstance(c, ProgBarLogger) for c in cbs):
        # the logger's cadence is fit's log_freq: the steps at which fit
        # reads the loss back from the device
        cbs.insert(0, ProgBarLogger(log_freq=max(int(log_freq), 1),
                                    verbose=verbose))
    if save_dir and not any(isinstance(c, ModelCheckpoint) for c in cbs):
        cbs.append(ModelCheckpoint(save_freq, save_dir,
                                   max_to_keep=max_to_keep))
    return CallbackList(cbs, model=model,
                        params={"epochs": epochs, "steps": steps,
                                "verbose": verbose,
                                "metrics": metrics or []})


class ReduceLROnPlateau(Callback):
    """Reduce the rate when a monitored metric stops improving."""

    def __init__(self, monitor="loss", factor=0.1, patience=10,
                 verbose=1, mode="auto", min_delta=1e-4, cooldown=0,
                 min_lr=0.0):
        super().__init__()
        self.monitor = monitor
        self.factor = factor
        self.patience = patience
        self.verbose = verbose
        self.min_delta = min_delta
        self.cooldown = cooldown
        self.min_lr = min_lr
        self._best = None
        self._wait = 0
        self._cooldown_left = 0
        lower_better = mode == "min" or (mode == "auto"
                                         and "acc" not in monitor)
        self._better = ((lambda a, b: a < b - min_delta) if lower_better
                        else (lambda a, b: a > b + min_delta))

    def on_epoch_end(self, epoch, logs=None):
        logs = logs or {}
        cur = logs.get(self.monitor)
        if cur is None:
            return
        cur = float(cur[0] if isinstance(cur, (list, tuple)) else cur)
        if self._cooldown_left > 0:
            self._cooldown_left -= 1
            self._wait = 0
        if self._best is None or self._better(cur, self._best):
            self._best = cur
            self._wait = 0
            return
        self._wait += 1
        if self._wait >= self.patience:
            opt = getattr(self.model, "_optimizer", None)
            if opt is not None:
                lr = opt.get_lr()
                new_lr = max(lr * self.factor, self.min_lr)
                if new_lr < lr:
                    opt.set_lr(new_lr)
                    if self.verbose:
                        print(f"ReduceLROnPlateau: lr -> {new_lr:.3e}")
            self._cooldown_left = self.cooldown
            self._wait = 0
