"""Optimizers (port of paddle_tpu/optimizer/optimizer.py: ``Optimizer``,
``SGD``, ``Momentum``, ``Adam``, ``AdamW``, ``Adagrad``, ``RMSProp``,
``Lamb``, ``Adadelta``, ``Adamax``, ``LBFGS``, ``L1Decay``, ``L2Decay``).

State mirrors the JAX package, under its names (``moment1``,
``velocity``, ``mean_square``, ...): fp32 tensors per parameter and, for
bf16/fp16 parameters under ``multi_precision``, an fp32 ``master`` copy
that the update runs on; the parameter gets the master rounded to its
own dtype; and ``_step_tensor``, the fp32 count of applied updates, a
0-dim tensor on the parameters' device (saved as ``step_tensor``).  The
learning rate is a float or an `lr.LRScheduler` (``get_lr`` reads its
``last_lr``).

One update entry serves both lanes: `Optimizer._apply_update` takes the
learning rate and the step counter as device scalars, an optional device
skip flag and an optional device gradient scale (the global-norm clip's,
`Optimizer._clip`).  The eager `step` writes the rate into the
optimizer's device scalar, counts the step on the device and calls it;
the compiled train step (`framework.train_step`) calls it inside its
captured body.  Adam/AdamW update each parameter with one call of
`kernels.adam.adam_update` (on the card the fused Adam kernel,
``csrc/adam.cu``, the port of the Pallas ``adam_update_pallas``; on the
CPU its plain version).  The other optimizers' updates are XLA code in
the JAX package, outside any Pallas kernel; here they are the same
expressions in torch ops, in the same order, each rounded in fp32 as
XLA rounds it.  Every state tensor is updated in place (JAX rebinds new
arrays), so addresses hold across steps and a captured graph keeps
reading them.  `LBFGS` reads the host and runs eagerly only.

Under ZeRO (``distributed.fleet.sharding``) the optimizer carries the
plan as ``_zero``: its state covers the rank's rows of each parameter
(`_state_view`), `step` syncs the gradients over the sharding, dp and
mp groups before the clip, and `_apply_update` runs each update on a
contiguous tensor of the rows (the Adam kernel's vector path), then
all-gathers the parameters that stay whole.
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels.adam import adam_scalars, adam_update, bias_correction
from ..nn.clip import ClipGradByGlobalNorm
from .lr import LRScheduler


class L2Decay:
    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)


class L1Decay:
    """Read by the optimizers exactly as `L2Decay` (``coeff * w`` added to
    the gradient), as the JAX package reads it."""

    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)


def _wd_coeff(wd):
    if wd is None:
        return 0.0
    if isinstance(wd, (L1Decay, L2Decay)):
        return wd.coeff
    return float(wd)


def lr_scale(p):
    """A parameter's learning-rate multiplier: its ``optimize_attr
    ["learning_rate"]`` as in the JAX package (torch parameters carry an
    ``optimize_attr`` only if the caller set one), else 1."""
    return float(getattr(p, "optimize_attr", {}).get("learning_rate", 1.0))


def param_name(p):
    """A parameter's name as the JAX package's ``p.name``: torch reserves
    ``Tensor.name`` (read-only, None), so a torch parameter carries its
    name, when the caller gave it one, as ``p.param_name``."""
    return getattr(p, "param_name", None)


def _scaled_lr(lr, scale):
    return lr * float(scale) if scale != 1.0 else lr


def _unit(gscale, like):
    """The gradient scale, or 1 (a fill on the device) without a clip."""
    return torch.ones_like(like) if gscale is None else gscale


def _grad(g, gs):
    """The gradient as the update reads it: JAX's clip output
    ``(g.astype(f32) * s).astype(g.dtype)``, then ``.astype(f32)``; one
    rounding to g's dtype (exact at ``s == 1``)."""
    gf = g.float() * gs
    return gf if g.dtype == torch.float32 else gf.to(g.dtype).float()


def _working(p, state):
    """(the fp32 value the update runs on, the master or None)."""
    mw = state.get("master")
    if mw is not None:
        return mw, mw
    return (p.detach() if p.dtype == torch.float32 else p.detach().float(),
            None)


def _commit(p, mw, w_new, pairs, skip):
    """Write the new values in place: each ``(state tensor, new value)``
    of ``pairs``, the master ``mw`` (when there is one) and the parameter
    (``w_new`` rounded to its dtype); with ``skip`` set every tensor
    keeps its value (a select on the device, no host read)."""
    pairs = list(pairs) + ([] if mw is None else [(mw, w_new)]) + \
        [(p, w_new)]
    for t, new in pairs:
        if skip is None:
            t.copy_(new)
        else:
            t.copy_(torch.where(skip, t, new.to(t.dtype)))


class Optimizer:
    """Base class: ``step()``, ``clear_grad()``, ``state_dict()`` /
    ``set_state_dict()``, ``get_lr()`` / ``set_lr()`` /
    ``set_lr_scheduler()``; subclasses name their state in `_state_spec`,
    make their device scalars in `_scalars` and update one parameter in
    `_update`."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=True):
        if parameters is None:
            raise ValueError("parameters must be provided")
        self._parameter_list = list(parameters)
        self._learning_rate = learning_rate
        self._grad_clip = grad_clip
        self._use_master_weights = multi_precision
        if isinstance(weight_decay, float):
            self._weight_decay = L2Decay(weight_decay)
        else:
            self._weight_decay = weight_decay
        self._state = {}
        self._step_count = 0         # step() calls
        self._step_tensor = None     # device fp32: updates applied
        self._lr_tensor = None       # device fp32: the rate of this step
        self._zero = None            # the ZeRO plan (fleet.sharding)

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

    def _master(self, p):
        return p.detach().float().clone() if self._master_weight_needed(p) \
            else None

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
                self._state[name] = [init(self._state_view(p))
                                     for p in self._parameter_list]

    def _state_view(self, p):
        """The part of ``p`` its state covers: all of it, or under ZeRO
        the rank's rows."""
        return p if self._zero is None else self._zero.state_view(p)

    def _wd_applies(self, p):
        """Whether weight decay applies to this parameter: always for one
        with a ``regularizer`` attribute; otherwise, with a decay set and
        an ``apply_decay_param_fun``, its verdict on the parameter's name
        (`param_name`).  The coefficient is the optimizer's either way."""
        if getattr(p, "regularizer", None) is not None:
            return True
        if self._weight_decay is None:
            return False
        fn = getattr(self, "_apply_decay_param_fun", None)
        if fn is not None:
            return bool(fn(param_name(p)))
        return True

    # ---------------- update ----------------
    def _clip(self, params_grads):
        """The clip of both lanes → ``(params_grads, gscale)``: a
        `ClipGradByGlobalNorm` only computes its device scale (the update
        applies it as it reads each gradient), any other clip returns new
        gradients and the scale is None."""
        clip = self._grad_clip
        if isinstance(clip, ClipGradByGlobalNorm):
            return params_grads, clip.scale(params_grads)
        if clip is not None:
            params_grads = clip(params_grads)
        return params_grads, None

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
        if self._zero is not None:
            params_grads = self._zero.sync_gradients(params_grads)
        params_grads, gscale = self._clip(params_grads)
        self._step_tensor.add_(1.0)
        self._apply_update(params_grads, self._write_lr(), self._step_tensor,
                           gscale=gscale)

    @torch.no_grad()
    def _apply_update(self, params_grads, lr, step, skip=None, gscale=None):
        """Update every ``(param, grad)`` in place with the device scalars
        ``lr`` and ``step`` (the counter after this update, fp32 0-dim)
        and ``gscale`` (the global-norm clip's fp32 0-dim scale, or None);
        with ``skip`` (a 0-dim bool on the device) set, nothing changes.
        Returns nothing and reads nothing back.  Under ZeRO ``grad`` is
        the rows' gradient and the update writes the rows."""
        self._ensure_state()
        grads = {id(p): g for p, g in params_grads if g is not None}
        scalars = {}
        updated = []
        for i, p in enumerate(self._parameter_list):
            g = grads.get(id(p))
            if g is None:
                continue
            s = lr_scale(p)
            if s not in scalars:
                scalars[s] = self._scalars(lr, step, s, gscale)
            state = {name: vals[i] for name, vals in self._state.items()}
            target = p if self._zero is None else self._zero.target(p)
            self._update(target, g, state, scalars[s], self._wd_applies(p),
                         skip)
            updated.append(p)
        if self._zero is not None:
            self._zero.gather_params(updated)

    def _scalars(self, lr, step, lr_scale, gscale=None):
        """The device scalars `_update` takes for one ``lr_scale``:
        ``[lr * lr_scale, gscale]`` (fp32 [2]); subclasses with bias
        corrections make their own."""
        return torch.stack([_scaled_lr(lr, lr_scale), _unit(gscale, lr)])

    def _update(self, p, g, state, scal, use_wd, skip=None):
        raise NotImplementedError

    def _decayed(self, gf, w, use_wd):
        """``gf + wd * w`` when a decay applies (L2-coupled)."""
        wd = _wd_coeff(self._weight_decay)
        return gf + wd * w if wd and use_wd else gf

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

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        """``loss.backward()``, `step` and `clear_grad`, as JAX's; the
        static-graph arguments are accepted and ignored, as there."""
        loss.backward()
        self.step()
        self.clear_grad()

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
                want = tuple(self._state_view(p).shape)
                if tuple(t.shape) != want:
                    raise ValueError(f"{key}: shape {tuple(t.shape)} != "
                                     f"parameter {want}")
                if vals[i] is None:
                    vals[i] = t.to(device=p.device, dtype=torch.float32,
                                   copy=True)
                else:
                    vals[i].copy_(t)
        if "LR_Scheduler" in state and isinstance(self._learning_rate,
                                                  LRScheduler):
            self._learning_rate.set_state_dict(state["LR_Scheduler"])

    load_state_dict = set_state_dict


def _zeros(p):
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


class SGD(Optimizer):
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=True):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)

    def _state_spec(self):
        return [("master", self._master)] if self._use_master_weights \
            else []

    def _update(self, p, g, state, scal, use_wd, skip=None):
        lr, gs = scal[0], scal[1]
        w, mw = _working(p, state)
        gf = self._decayed(_grad(g, gs), w, use_wd)
        w = w - lr * gf
        _commit(p, mw, w, [], skip)


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 name=None, multi_precision=True):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def _state_spec(self):
        return [("velocity", _zeros), ("master", self._master)]

    def _update(self, p, g, state, scal, use_wd, skip=None):
        lr, gs = scal[0], scal[1]
        mu = self._momentum
        w, mw = _working(p, state)
        gf = self._decayed(_grad(g, gs), w, use_wd)
        v = mu * state["velocity"] + gf
        upd = gf + mu * v if self._nesterov else v
        w = w - lr * upd
        _commit(p, mw, w, [(state["velocity"], v)], skip)


class Adam(Optimizer):
    _decoupled = False

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=True,
                 name=None, apply_decay_param_fun=None, **kwargs):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        self._apply_decay_param_fun = apply_decay_param_fun

    def _state_spec(self):
        return [("moment1", _zeros), ("moment2", _zeros),
                ("master", self._master)]

    def _scalars(self, lr, step, lr_scale, gscale=None):
        return adam_scalars(lr, step, self._beta1, self._beta2, lr_scale,
                            gscale)

    def _update(self, p, g, state, scal, use_wd, skip=None):
        """One parameter: the JAX package's update (optimizer.py
        ``Adam._fused_update``) through `adam_update`, on the fp32 master
        when there is one; the kernel applies the clip's scale ``scal[3]``
        as it loads g."""
        mw = state["master"]
        if mw is not None:
            w, out = mw, p
        elif p.dtype == torch.float32:
            w, out = p, None
        else:                        # a 16-bit parameter without a master
            w, out = p.detach().float(), p
        wd = _wd_coeff(self._weight_decay)
        adam_update(w, g, state["moment1"], state["moment2"], out, scal,
                    b1=self._beta1, b2=self._beta2, eps=self._epsilon,
                    wd=wd if use_wd else 0.0, decoupled=self._decoupled,
                    skip=skip)


class AdamW(Adam):
    """Decoupled weight decay (port of paddle_tpu/optimizer/optimizer.py
    ``AdamW``; default ``weight_decay=0.01``; ``lr_ratio`` and
    ``lazy_mode`` are accepted and ignored, as there)."""
    _decoupled = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=True, name=None, **kwargs):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, lazy_mode, multi_precision,
                         name, apply_decay_param_fun)


class Adagrad(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 initial_accumulator_value=0.0, multi_precision=True):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._epsilon = epsilon
        self._init_acc = initial_accumulator_value

    def _state_spec(self):
        return [("moment", lambda p: torch.full(
                    p.shape, self._init_acc, dtype=torch.float32,
                    device=p.device)),
                ("master", self._master)]

    def _update(self, p, g, state, scal, use_wd, skip=None):
        lr, gs = scal[0], scal[1]
        w, mw = _working(p, state)
        gf = self._decayed(_grad(g, gs), w, use_wd)
        m = state["moment"] + gf.square()
        w = w - lr * gf / (m.sqrt() + self._epsilon)
        _commit(p, mw, w, [(state["moment"], m)], skip)


class RMSProp(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None, multi_precision=True):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._rho = rho
        self._epsilon = epsilon
        self._momentum = momentum
        self._centered = centered

    def _state_spec(self):
        return [("mean_square", _zeros), ("mean_grad", _zeros),
                ("velocity", _zeros), ("master", self._master)]

    def _update(self, p, g, state, scal, use_wd, skip=None):
        lr, gs = scal[0], scal[1]
        rho, eps, mu = self._rho, self._epsilon, self._momentum
        w, mw = _working(p, state)
        gf = self._decayed(_grad(g, gs), w, use_wd)
        ms = rho * state["mean_square"] + (1 - rho) * gf.square()
        pairs = [(state["mean_square"], ms)]
        if self._centered:
            mg = rho * state["mean_grad"] + (1 - rho) * gf
            denom = (ms - mg.square() + eps).sqrt()
            pairs.append((state["mean_grad"], mg))
        else:
            denom = (ms + eps).sqrt()
        v = mu * state["velocity"] + lr * gf / denom
        w = w - v
        pairs.append((state["velocity"], v))
        _commit(p, mw, w, pairs, skip)


class Lamb(Optimizer):
    """Layer-wise adaptive Adam: the update ``r`` (Adam's, plus ``wd * w``
    unless ``exclude_from_weight_decay_fn(p)``) scaled by the trust ratio
    ``||w|| / ||r||`` (1 where either norm is 0), chosen on the device."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 name=None, multi_precision=True):
        super().__init__(learning_rate, parameters, lamb_weight_decay,
                         grad_clip, name, multi_precision)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._exclude_fn = exclude_from_weight_decay_fn

    def _state_spec(self):
        return [("moment1", _zeros), ("moment2", _zeros),
                ("master", self._master)]

    def _wd_applies(self, p):
        if self._exclude_fn is not None and self._exclude_fn(p):
            return False
        return True

    def _scalars(self, lr, step, lr_scale, gscale=None):
        return adam_scalars(lr, step, self._beta1, self._beta2, lr_scale,
                            gscale)

    def _update(self, p, g, state, scal, use_wd, skip=None):
        lr, bc1, bc2, gs = scal[0], scal[1], scal[2], scal[3]
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        wd = _wd_coeff(self._weight_decay)
        w, mw = _working(p, state)
        gf = _grad(g, gs)
        m1 = b1 * state["moment1"] + (1 - b1) * gf
        m2 = b2 * state["moment2"] + (1 - b2) * gf.square()
        r = (m1 / bc1) / ((m2 / bc2).sqrt() + eps)
        if wd and use_wd:
            r = r + wd * w
        w_norm = torch.linalg.vector_norm(w)
        r_norm = torch.linalg.vector_norm(r)
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            1.0)
        w = w - lr * trust * r
        pairs = [(state["moment1"], m1), (state["moment2"], m2)]
        _commit(p, mw, w, pairs, skip)


class Adadelta(Optimizer):
    """E[g²] and E[Δx²] accumulated; the step is ``sqrt(E[Δx²] + eps) /
    sqrt(E[g²] + eps) * g``, times the learning rate."""

    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None, multi_precision=True):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._epsilon = epsilon
        self._rho = rho

    def _state_spec(self):
        return [("avg_sq_grad", _zeros), ("avg_sq_update", _zeros),
                ("master", self._master)]

    def _update(self, p, g, state, scal, use_wd, skip=None):
        lr, gs = scal[0], scal[1]
        rho, eps = self._rho, self._epsilon
        w, mw = _working(p, state)
        gf = self._decayed(_grad(g, gs), w, use_wd)
        g2 = rho * state["avg_sq_grad"] + (1 - rho) * gf.square()
        upd = (state["avg_sq_update"] + eps).sqrt() / (g2 + eps).sqrt() * gf
        u2 = rho * state["avg_sq_update"] + (1 - rho) * upd.square()
        w = w - lr * upd
        pairs = [(state["avg_sq_grad"], g2), (state["avg_sq_update"], u2)]
        _commit(p, mw, w, pairs, skip)


class Adamax(Optimizer):
    """Adam with an infinity-norm second moment."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None, multi_precision=True):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _state_spec(self):
        return [("moment", _zeros), ("inf_norm", _zeros),
                ("master", self._master)]

    def _scalars(self, lr, step, lr_scale, gscale=None):
        """``[lr * lr_scale, gscale, 1 - b1^t]``."""
        return torch.stack([_scaled_lr(lr, lr_scale), _unit(gscale, lr),
                            bias_correction(self._beta1, step)])

    def _update(self, p, g, state, scal, use_wd, skip=None):
        lr, gs, bc1 = scal[0], scal[1], scal[2]
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        w, mw = _working(p, state)
        gf = self._decayed(_grad(g, gs), w, use_wd)
        m = b1 * state["moment"] + (1 - b1) * gf
        u = torch.maximum(b2 * state["inf_norm"], gf.abs())
        w = w - lr / bc1 * m / (u + eps)
        pairs = [(state["moment"], m), (state["inf_norm"], u)]
        _commit(p, mw, w, pairs, skip)


def _value(loss):
    return float(loss.detach()) if torch.is_tensor(loss) else float(loss)


class LBFGS(Optimizer):
    """Limited-memory BFGS with a ``step(closure)`` interface: the
    two-loop recursion over a bounded ``(s, y)`` history (pairs whose
    curvature ``s·y`` is not above 1e-10 are left out);
    ``line_search_fn`` set takes a backtracking Armijo search (up to 20
    halvings).  It reads the host (the tolerances, the line search), so
    it runs eagerly only: `framework.CompiledTrainStep` falls back for
    it."""

    def __init__(self, learning_rate=1.0, max_iter=20, max_eval=None,
                 tolerance_grad=1e-7, tolerance_change=1e-9,
                 history_size=100, line_search_fn=None, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision=False)
        self._max_iter = max_iter
        self._tol_grad = tolerance_grad
        self._tol_change = tolerance_change
        self._hist = history_size
        self._line_search = line_search_fn
        self._s, self._y = [], []
        self._prev_flat_g = None
        self._prev_flat_w = None

    @staticmethod
    def _flatten(tensors):
        return torch.cat([t.detach().reshape(-1).float() for t in tensors])

    def _flat_grads(self):
        # parameters the closure did not touch contribute zero gradient
        return self._flatten([
            p.grad if p.grad is not None else torch.zeros_like(p)
            for p in self._parameter_list])

    @torch.no_grad()
    def _unflatten_to_params(self, flat):
        off = 0
        for p in self._parameter_list:
            n = p.numel()
            p.copy_(flat[off:off + n].reshape(p.shape))
            off += n

    def _direction(self, g):
        q = g
        alphas = []
        for s, y in zip(reversed(self._s), reversed(self._y)):
            rho = 1.0 / torch.clamp_min(torch.dot(y, s), 1e-10)
            a = rho * torch.dot(s, q)
            q = q - a * y
            alphas.append((rho, a, s, y))
        if self._y:
            y_last, s_last = self._y[-1], self._s[-1]
            gamma = torch.dot(s_last, y_last) / torch.clamp_min(
                torch.dot(y_last, y_last), 1e-10)
            q = gamma * q
        for rho, a, s, y in reversed(alphas):
            b = rho * torch.dot(y, q)
            q = q + s * (a - b)
        return -q

    def step(self, closure=None):
        if closure is None:
            raise RuntimeError("LBFGS.step requires a closure that "
                               "re-evaluates the loss")
        loss = closure()
        flat_g = self._flat_grads()
        flat_w = self._flatten(self._parameter_list)
        for _ in range(self._max_iter):
            if float(flat_g.abs().max()) <= self._tol_grad:
                break
            if self._prev_flat_g is not None:
                s = flat_w - self._prev_flat_w
                y = flat_g - self._prev_flat_g
                if float(torch.dot(s, y)) > 1e-10:   # curvature condition
                    self._s.append(s)
                    self._y.append(y)
                    if len(self._s) > self._hist:
                        self._s.pop(0)
                        self._y.pop(0)
            d = self._direction(flat_g)
            self._prev_flat_w, self._prev_flat_g = flat_w, flat_g
            t = float(self._current_lr())
            g_dot_d = float(torch.dot(flat_g, d))
            f0 = _value(loss)
            for _ls in range(20 if self._line_search else 1):
                self._unflatten_to_params(flat_w + t * d)
                self.clear_grad()
                loss = closure()
                if not self._line_search or \
                        _value(loss) <= f0 + 1e-4 * t * g_dot_d:
                    break
                t *= 0.5
            flat_w = self._flatten(self._parameter_list)
            flat_g = self._flat_grads()
            if float((t * d).abs().max()) <= self._tol_change:
                break
        return loss

    def _current_lr(self):
        lr = self._learning_rate
        return lr() if isinstance(lr, LRScheduler) else lr
