"""Optimizers (port of paddle_tpu/optimizer/optimizer.py: ``Optimizer``,
``Adam``, ``AdamW``).

State mirrors the JAX package: per parameter ``moment1``/``moment2`` (fp32)
and, for bf16/fp16 parameters under ``multi_precision``, an fp32 ``master``
copy that the update runs on; the parameter gets the master rounded to its
own dtype; and ``_step_tensor``, the fp32 count of applied updates, a 0-dim
tensor on the parameters' device (saved as ``step_tensor``).  The learning
rate is a float or an `lr.LRScheduler` (``get_lr`` reads its ``last_lr``).

One update entry serves both lanes: `Optimizer._apply_update` takes the
learning rate and the step counter as device scalars and an optional
device skip flag.  The eager `step` writes the rate into the optimizer's
device scalar, counts the step on the device and calls it; the compiled
train step (`framework.train_step`) calls it inside its captured body.
Each parameter's update is one call of `kernels.adam.adam_update`: on the
card the fused Adam kernel (``csrc/adam.cu``, the port of the Pallas
``adam_update_pallas`` that the JAX package takes by default), on the CPU
its plain version; both are the JAX package's fp32 op sequence, bitwise.
Moments, masters and the step counter are updated in place (JAX rebinds
new arrays), so their addresses hold across steps and a captured graph
keeps reading them.
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels.adam import adam_scalars, adam_update
from .lr import LRScheduler


def lr_scale(p):
    """A parameter's learning-rate multiplier: its ``optimize_attr
    ["learning_rate"]`` as in the JAX package (torch parameters carry an
    ``optimize_attr`` only if the caller set one), else 1."""
    return float(getattr(p, "optimize_attr", {}).get("learning_rate", 1.0))


class Optimizer:
    """Base class: ``step()``, ``clear_grad()``, ``state_dict()`` /
    ``set_state_dict()``, ``get_lr()`` / ``set_lr()`` /
    ``set_lr_scheduler()``; subclasses name their state and update one
    parameter in `_update`."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=True):
        if parameters is None:
            raise ValueError("parameters must be provided")
        self._parameter_list = list(parameters)
        self._learning_rate = learning_rate
        self._grad_clip = grad_clip
        self._use_master_weights = multi_precision
        self._weight_decay = weight_decay          # a float or None
        self._state = {}
        self._step_count = 0         # step() calls
        self._step_tensor = None     # device fp32: updates applied
        self._lr_tensor = None       # device fp32: the rate of this step

    # ---------------- lr ----------------
    def get_lr(self):
        if isinstance(self._learning_rate, LRScheduler):
            return self._learning_rate.last_lr
        return float(self._learning_rate)

    def set_lr(self, value):
        self._learning_rate = float(value)

    def set_lr_scheduler(self, scheduler):
        self._learning_rate = scheduler

    def _device(self):
        return self._parameter_list[0].device if self._parameter_list \
            else torch.device("cpu")

    def _write_lr(self):
        """``get_lr()`` into the device scalar the update reads: a fill in
        stream order (no host buffer a queued kernel could still read)."""
        self._lr_tensor.fill_(self.get_lr())
        return self._lr_tensor

    # ---------------- state ----------------
    def _all_params(self):
        return self._parameter_list

    def _master_weight_needed(self, p):
        return self._use_master_weights and \
            p.dtype in (torch.bfloat16, torch.float16)

    def _state_spec(self):
        """Subclass returns ``[(name, init_fn(param) -> tensor or None)]``."""
        return []

    def _ensure_state(self):
        if self._step_tensor is None:
            dev = self._device()
            self._step_tensor = torch.zeros((), dtype=torch.float32,
                                            device=dev)
            self._lr_tensor = torch.zeros((), dtype=torch.float32,
                                          device=dev)
        if self._state:
            return
        with torch.no_grad():
            for name, init in self._state_spec():
                self._state[name] = [init(p) for p in self._parameter_list]

    def _wd_applies(self, p):
        """Whether weight decay applies to this parameter: with an
        ``apply_decay_param_fun``, its verdict on the parameter's ``name``
        attribute (torch parameters carry one only if the caller set it)."""
        if not self._weight_decay:
            return False
        fn = getattr(self, "_apply_decay_param_fun", None)
        if fn is not None:
            return bool(fn(getattr(p, "name", "")))
        return True

    # ---------------- update ----------------
    @torch.no_grad()
    def step(self):
        """The eager step: clip, count the update on the device, write the
        rate, `_apply_update`."""
        self._ensure_state()
        self._step_count += 1
        params_grads = [(p, p.grad) for p in self._parameter_list
                        if p.grad is not None and p.requires_grad]
        if not params_grads:
            return
        if self._grad_clip is not None:
            params_grads = self._grad_clip(params_grads)
        self._step_tensor.add_(1.0)
        self._apply_update(params_grads, self._write_lr(), self._step_tensor)

    @torch.no_grad()
    def _apply_update(self, params_grads, lr, step, skip=None):
        """Update every ``(param, grad)`` in place with the device scalars
        ``lr`` and ``step`` (the counter after this update, fp32 0-dim);
        with ``skip`` (a 0-dim bool on the device) set, nothing changes.
        Returns nothing and reads nothing back."""
        self._ensure_state()
        grads = {id(p): g for p, g in params_grads if g is not None}
        scalars = {}
        for i, p in enumerate(self._parameter_list):
            g = grads.get(id(p))
            if g is None:
                continue
            s = lr_scale(p)
            if s not in scalars:
                scalars[s] = self._scalars(lr, step, s)
            state = {name: vals[i] for name, vals in self._state.items()}
            self._update(p, g, state, scalars[s], self._wd_applies(p), skip)

    def _scalars(self, lr, step, scale):
        """The device scalars `_update` takes for one ``lr_scale``."""
        raise NotImplementedError

    def _update(self, p, g, state, scal, use_wd, skip=None):
        raise NotImplementedError

    def clear_grad(self, set_to_zero=True):
        """Zero every gradient in place (the JAX package's default), or
        drop it with ``set_to_zero=False``."""
        for p in self._parameter_list:
            if p.grad is None:
                continue
            if set_to_zero:
                p.grad.zero_()
            else:
                p.grad = None

    # ---------------- checkpoint ----------------
    def state_dict(self):
        """``{"step_count": int, "step_tensor": 0-dim tensor, "<name>.<i>":
        tensor, "LR_Scheduler": dict}``: the JAX package's keys, ``i`` the
        parameter's index, the scheduler's state when there is one."""
        self._ensure_state()
        sd = {"step_count": self._step_count,
              "step_tensor": self._step_tensor.clone()}
        for name, vals in self._state.items():
            for i, v in enumerate(vals):
                if v is not None:
                    sd[f"{name}.{i}"] = v
        if isinstance(self._learning_rate, LRScheduler):
            sd["LR_Scheduler"] = self._learning_rate.state_dict()
        return sd

    @torch.no_grad()
    def set_state_dict(self, state):
        """Adopt a state dict of this class or of the JAX package (values
        may be tensors, numpy arrays or Python numbers).  Values are copied
        into the existing tensors, whose addresses a captured step reads;
        a state slot that does not exist yet is made on its parameter's
        device."""
        self._ensure_state()
        self._step_count = int(state.get("step_count", 0))
        step_t = state.get("step_tensor", self._step_count)
        self._step_tensor.copy_(torch.from_numpy(
            np.array(step_t.cpu() if torch.is_tensor(step_t) else step_t,
                     dtype=np.float32)))
        for name, vals in self._state.items():
            for i, p in enumerate(self._parameter_list):
                key = f"{name}.{i}"
                if key not in state:
                    continue
                v = state[key]
                t = v if torch.is_tensor(v) else torch.from_numpy(
                    np.array(v, dtype=np.float32))
                if tuple(t.shape) != tuple(p.shape):
                    raise ValueError(f"{key}: shape {tuple(t.shape)} != "
                                     f"parameter {tuple(p.shape)}")
                if vals[i] is None:
                    vals[i] = t.to(device=p.device, dtype=torch.float32,
                                   copy=True)
                else:
                    vals[i].copy_(t)
        if "LR_Scheduler" in state and isinstance(self._learning_rate,
                                                  LRScheduler):
            self._learning_rate.set_state_dict(state["LR_Scheduler"])


class Adam(Optimizer):
    _decoupled = False

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=True,
                 apply_decay_param_fun=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        self._apply_decay_param_fun = apply_decay_param_fun

    def _state_spec(self):
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return [("moment1", zeros), ("moment2", zeros),
                ("master", lambda p: (p.detach().float().clone()
                                      if self._master_weight_needed(p)
                                      else None))]

    def _scalars(self, lr, step, scale):
        return adam_scalars(lr, step, self._beta1, self._beta2, scale)

    def _update(self, p, g, state, scal, use_wd, skip=None):
        """One parameter: the JAX package's update (optimizer.py
        ``Adam._fused_update``) through `adam_update`, on the fp32 master
        when there is one."""
        mw = state["master"]
        if mw is not None:
            w, out = mw, p
        elif p.dtype == torch.float32:
            w, out = p, None
        else:                        # a 16-bit parameter without a master
            w, out = p.detach().float(), p
        adam_update(w, g, state["moment1"], state["moment2"], out, scal,
                    b1=self._beta1, b2=self._beta2, eps=self._epsilon,
                    wd=float(self._weight_decay) if use_wd else 0.0,
                    decoupled=self._decoupled, skip=skip)


class AdamW(Adam):
    """Decoupled weight decay (port of paddle_tpu/optimizer/optimizer.py
    ``AdamW``; default ``weight_decay=0.01``)."""
    _decoupled = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 apply_decay_param_fun=None, grad_clip=None,
                 multi_precision=True):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, multi_precision,
                         apply_decay_param_fun)
