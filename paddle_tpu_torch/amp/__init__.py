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
    nothing is multiplied or checked."""

    def __init__(self, enable=True, init_loss_scaling=2.0 ** 15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=2000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True,
                 min_loss_scale=1.0):
        self._enable = enable
        self._scale = float(init_loss_scaling) if enable else 1.0
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._min_scale = max(float(min_loss_scale), 1.0)
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        self._unscaled = False

    def scale(self, loss):
        if not self._enable or self._scale == 1.0:
            return loss
        return loss * self._scale

    @torch.no_grad()
    def unscale_(self, optimizer):
        """Divide every gradient by the scale (once per step) and record
        whether any is not finite (one device reduction, one host read)."""
        if not self._enable or self._unscaled:
            return
        self._unscaled = True
        grads = [p.grad for p in optimizer._all_params()
                 if p.grad is not None]
        if self._scale != 1.0:
            inv = 1.0 / self._scale
            for g in grads:
                g.mul_(inv)
        found = False
        if grads and self._scale != 1.0:
            sums = torch.stack([g.float().sum() for g in grads])
            found = not bool(torch.isfinite(sums).all())
        self._found_inf = found

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
        if not self._enable or not self._dynamic or self._scale == 1.0:
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

    def get_loss_scaling(self):
        return self._scale
