"""Automatic mixed precision (port of paddle_tpu/amp/__init__.py:
``auto_cast``, ``decorate``, ``GradScaler``).

O2 is the training path: `decorate` casts the model's floating parameters
to bf16 (or fp16) and the optimizer keeps fp32 master weights, so the whole
forward and backward run in the low-precision type except where an op keeps
fp32 itself (RMS-norm statistics, the attention softmax, the cross-entropy).
`auto_cast` with ``level="O1"`` casts matrix products through
``torch.autocast``; under O2 it changes nothing (the parameters already
carry the type).  `GradScaler` is dynamic loss scaling for fp16; with
``init_loss_scaling=1.0`` (bf16) it passes everything through.
"""
from __future__ import annotations

import contextlib

import torch

from ..device import to_torch_dtype


@contextlib.contextmanager
def auto_cast(enable=True, level="O1", dtype="bfloat16"):
    if not enable or level != "O1":
        yield
        return
    dt = to_torch_dtype(dtype)
    with contextlib.ExitStack() as stack:
        stack.enter_context(torch.autocast("cpu", dtype=dt))
        if torch.cuda.is_available():
            stack.enter_context(torch.autocast("cuda", dtype=dt))
        yield


def decorate(models, optimizers=None, level="O2", dtype="bfloat16",
             master_weight=None):
    """O2: cast every floating parameter of ``models`` to ``dtype`` in
    place; the optimizers keep fp32 master weights unless
    ``master_weight=False``.  Returns ``models`` (and ``optimizers``)."""
    target = to_torch_dtype(dtype)
    single = not isinstance(models, (list, tuple))
    model_list = [models] if single else list(models)
    if level == "O2":
        with torch.no_grad():
            for m in model_list:
                for p in m.parameters():
                    if p.is_floating_point() and p.dtype != target:
                        p.data = p.data.to(target)
    if optimizers is None:
        return models if single else model_list
    for opt in (optimizers if isinstance(optimizers, (list, tuple))
                else [optimizers]):
        opt._use_master_weights = master_weight is not False
    return (models if single else model_list), optimizers


class GradScaler:
    """Dynamic loss scaling (port of paddle_tpu/amp GradScaler): ``scale``
    the loss, then ``step(opt)`` unscales the gradients, skips the update
    when any gradient is not finite, and ``update`` grows the scale after
    ``incr_every_n_steps`` good steps or shrinks it after
    ``decr_every_n_nan_or_inf`` bad ones.  At scale 1.0 (bf16 training)
    nothing is multiplied or checked, unless ``always_check_found_inf``
    (then a non-finite step is still skipped).

    This is the eager surface: ``unscale_`` reads the found-inf decision
    back to the host, unless ``defer_found_inf`` keeps it on the device
    (`_found_inf_tensor`).  The compiled train step keeps ``[scale, good,
    bad]`` on the device instead and updates it with `scaler_update`;
    its ``sync_scaler()`` writes the vector back here."""

    def __init__(self, enable=True, init_loss_scaling=2.0 ** 15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=2000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True,
                 min_loss_scale=1.0, always_check_found_inf=False):
        self._enable = enable
        self._scale = float(init_loss_scaling) if enable else 1.0
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._min_scale = max(float(min_loss_scale), 1.0)
        self._always_check = bool(always_check_found_inf)
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        self._found_inf_dev = None
        self._found_inf_streak = 0
        self._unscaled = False

    def scale(self, loss):
        if not self._enable or self._scale == 1.0:
            return loss
        return loss * self._scale

    @torch.no_grad()
    def unscale_(self, optimizer, defer_found_inf=False):
        """Divide every gradient by the scale (once per step) and record
        whether any is not finite: one device reduction and one host read,
        or, with ``defer_found_inf``, none (`_found_inf_tensor`)."""
        if not self._enable or self._unscaled:
            return
        self._unscaled = True
        self._found_inf_dev = None
        grads = [p.grad for p in optimizer._all_params()
                 if p.grad is not None]
        if self._scale != 1.0:
            inv = 1.0 / self._scale
            for g in grads:
                g.mul_(inv)
        found = False
        if grads and (self._scale != 1.0 or self._always_check):
            bad = found_inf(grads)
            if defer_found_inf:
                self._found_inf_dev = bad
            else:
                found = bool(bad)
        self._found_inf = found

    def _found_inf_tensor(self):
        """The deferred found-inf decision as an fp32 ``[1]`` tensor (0.0:
        every gradient finite), ready to ride a gradient all-reduce."""
        bad = self._found_inf_dev
        self._found_inf_dev = None
        if bad is None:
            return torch.tensor([float(self._found_inf)])
        return bad.reshape(1).float()

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()
        self.update()
        self._unscaled = False

    def update(self):
        if not self._enable:
            return
        if self._found_inf:
            self._found_inf_streak += 1
        else:
            self._found_inf_streak = 0
        if not self._dynamic or self._scale == 1.0:
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every:
                self._scale = max(self._scale * self._decr_ratio,
                                  self._min_scale)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every:
                self._scale *= self._incr_ratio
                self._good_steps = 0

    @property
    def found_inf_streak(self):
        """Consecutive steps skipped for non-finite gradients (reset by
        the first healthy step)."""
        return self._found_inf_streak

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_loss_scaling(self):
        return self._scale

    def state_dict(self):
        return {"scale": self._scale, "good_steps": self._good_steps,
                "bad_steps": self._bad_steps}

    def load_state_dict(self, state):
        self._scale = float(state["scale"])
        self._good_steps = int(state["good_steps"])
        self._bad_steps = int(state["bad_steps"])


def found_inf(grads):
    """0-dim bool on the gradients' device: any gradient not finite (one
    fp32 sum a gradient, stacked: the eager scaler's reduction)."""
    sums = torch.stack([g.float().sum() for g in grads])
    return ~torch.isfinite(sums).all()


def scaler_update(scaler, svec, found):
    """`GradScaler.update` as device math (JAX train_step.py
    ``_scaler_update``, op for op): ``svec`` the fp32 ``[scale, good, bad]``
    vector, ``found`` a 0-dim bool; returns the new vector, the old one
    when scaling is off or the scale is 1."""
    scale, good, bad = svec[0], svec[1], svec[2]
    active = (scale != 1.0) & bool(scaler._enable and scaler._dynamic)
    bad_n = torch.where(found, bad + 1.0, torch.zeros_like(bad))
    good_n = torch.where(found, torch.zeros_like(good), good + 1.0)
    dec = found & (bad_n >= scaler._decr_every)
    inc = ~found & (good_n >= scaler._incr_every)
    scale_n = torch.where(
        dec, torch.clamp_min(scale * scaler._decr_ratio, scaler._min_scale),
        torch.where(inc, scale * scaler._incr_ratio, scale))
    bad_n = torch.where(dec, torch.zeros_like(bad_n), bad_n)
    good_n = torch.where(inc, torch.zeros_like(good_n), good_n)
    out = torch.stack([scale_n, good_n, bad_n])
    return torch.where(active, out, svec)
