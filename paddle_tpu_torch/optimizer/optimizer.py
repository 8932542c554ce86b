"""Optimizers (port of paddle_tpu/optimizer/optimizer.py: ``Optimizer``,
``Adam``, ``AdamW``).

State mirrors the JAX package: per parameter ``moment1``/``moment2`` (fp32)
and, for bf16/fp16 parameters under ``multi_precision``, an fp32 ``master``
copy that the update runs on; the parameter gets the master rounded to its
own dtype.  The update of each parameter is one call of
`kernels.adam.adam_update`: on the card the fused Adam kernel
(``csrc/adam.cu``, the port of the Pallas ``adam_update_pallas`` that the
JAX package takes by default), on the CPU its plain version; both are the
JAX package's fp32 op sequence, bitwise.  Moments and masters are updated
in place (JAX rebinds new arrays).
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels.adam import adam_update


class Optimizer:
    """Base class: ``step()``, ``clear_grad()``, ``state_dict()`` /
    ``set_state_dict()``; subclasses name their state and update one
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
        self._step_count = 0     # step() calls
        self._step_t = 0.0       # updates applied (bias correction)

    def get_lr(self):
        return float(self._learning_rate)

    def _all_params(self):
        return self._parameter_list

    def _master_weight_needed(self, p):
        return self._use_master_weights and \
            p.dtype in (torch.bfloat16, torch.float16)

    def _state_spec(self):
        """Subclass returns ``[(name, init_fn(param) -> tensor or None)]``."""
        return []

    def _ensure_state(self):
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

    @torch.no_grad()
    def step(self):
        self._ensure_state()
        self._step_count += 1
        params_grads = [(p, p.grad) for p in self._parameter_list
                        if p.grad is not None and p.requires_grad]
        if not params_grads:
            return
        if self._grad_clip is not None:
            params_grads = self._grad_clip(params_grads)
        grads = {id(p): g for p, g in params_grads}
        self._step_t += 1.0
        lr = self.get_lr()
        for i, p in enumerate(self._parameter_list):
            g = grads.get(id(p))
            if g is None:
                continue
            state = {name: vals[i] for name, vals in self._state.items()}
            self._update(p, g, state, lr, self._wd_applies(p))

    def _update(self, p, g, state, lr, use_wd):
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

    def state_dict(self):
        """``{"step_count": int, "step_tensor": float, "<name>.<i>":
        tensor}``: the JAX package's keys, ``i`` the parameter's index."""
        self._ensure_state()
        sd = {"step_count": self._step_count, "step_tensor": self._step_t}
        for name, vals in self._state.items():
            for i, v in enumerate(vals):
                if v is not None:
                    sd[f"{name}.{i}"] = v
        return sd

    @torch.no_grad()
    def set_state_dict(self, state):
        """Adopt a state dict of this class or of the JAX package (values
        may be tensors, numpy arrays or the JAX package's Tensors taken to
        numpy); copied onto each parameter's device."""
        self._ensure_state()
        self._step_count = int(state.get("step_count", 0))
        step_t = state.get("step_tensor", self._step_count)
        self._step_t = float(np.asarray(
            step_t.cpu() if torch.is_tensor(step_t) else step_t))
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
                vals[i] = t.to(device=p.device, dtype=torch.float32,
                               copy=True)


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

    def _bias_corrections(self):
        """``1 - beta ** step`` in fp32, as the JAX update computes them
        from its fp32 step counter."""
        t = np.float32(self._step_t)
        return (float(np.float32(1.0) - np.float32(self._beta1) ** t),
                float(np.float32(1.0) - np.float32(self._beta2) ** t))

    def _update(self, p, g, state, lr, use_wd):
        """One parameter: the JAX package's update (optimizer.py
        ``Adam._fused_update``) through `adam_update`, on the fp32 master
        when there is one."""
        bc1, bc2 = self._bias_corrections()
        mw = state["master"]
        if mw is not None:
            w, out = mw, p
        elif p.dtype == torch.float32:
            w, out = p, None
        else:                        # a 16-bit parameter without a master
            w, out = p.detach().float(), p
        adam_update(w, g, state["moment1"], state["moment2"], out, lr, bc1,
                    bc2, b1=self._beta1, b2=self._beta2, eps=self._epsilon,
                    wd=float(self._weight_decay) if use_wd else 0.0,
                    decoupled=self._decoupled)


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
