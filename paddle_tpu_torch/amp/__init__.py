"""Automatic mixed precision (port of paddle_tpu/amp/__init__.py:
``auto_cast`` / ``amp_guard``, ``decorate``, ``GradScaler``,
``is_bfloat16_supported``, ``is_float16_supported``; `amp_lists` as it
is).

O2 is the training path: `decorate` casts the model's floating parameters
to bf16 (or fp16) and the optimizer keeps fp32 master weights, so the whole
forward and backward run in the low-precision type except where an op keeps
fp32 itself (RMS-norm statistics, the attention softmax, the cross-entropy).

`auto_cast` sets the level, the type and the custom lists that the port's
op entries read through `amp_op`, the counterpart of the JAX package's
``_amp_cast`` hook (core/dispatch.py): under O1 an op on the white list
(``amp_lists.WHITE_LIST`` or the custom white list) runs with its
floating inputs cast to the amp type, one on the black list in fp32;
under O2 every op not on a black list runs in the amp type.  The routed
entries, under the JAX op names, are `ROUTED_OPS`; inside one the hook
alone decides the types (``torch.autocast`` is held off).  Everything
else is torch's own: under O1 ``torch.autocast`` casts torch's matrix
products and convolutions, under O2 nothing (`decorate` cast the
parameters).  A custom list naming an op that is not routed raises.
`GradScaler` is dynamic loss scaling for fp16; with
``init_loss_scaling=1.0`` (bf16) it passes everything through.
"""
from __future__ import annotations

import contextlib
import functools

import torch

from ..device import to_torch_dtype
from ..utils import monitor as _monitor
from . import amp_lists

#: the port's op entries that apply the lists, under the JAX op names
#: (nn/functional.py: linear, rms_norm, layer_norm, cross_entropy;
#: flash_attention and scaled_dot_product_attention as "flash_attention")
ROUTED_OPS = frozenset({"linear", "rms_norm", "layer_norm", "cross_entropy",
                        "flash_attention"})
_NOT_ROUTED = ("auto_cast: the port has no op entry that applies a custom "
               "{} list to {!r}; the JAX package's other ops are ROADMAP "
               "A9")


class _AmpState:
    """What `auto_cast` set: level (None: off), type and custom lists."""
    level = None
    dtype = torch.bfloat16
    white = frozenset()
    black = frozenset()


_STATE = _AmpState()


def _check_lists(white, black, level):
    if level not in ("O1", "O2"):
        return
    for kind, names in (("white", white), ("black", black)):
        for name in sorted(names - ROUTED_OPS):
            raise NotImplementedError(_NOT_ROUTED.format(kind, name))


def _autocast_contexts(stack, dt, enabled):
    stack.enter_context(torch.autocast("cpu", dtype=dt, enabled=enabled))
    if torch.cuda.is_available():
        stack.enter_context(torch.autocast("cuda", dtype=dt,
                                           enabled=enabled))


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16", use_promote=True):
    """Mixed precision for the ops run inside: sets the level, type and
    custom lists `amp_op` reads (restored on exit) and, at O1, enters
    ``torch.autocast`` for torch's own products.  ``enable=False`` leaves
    whatever an outer context set, as JAX's does.  ``use_promote`` is
    accepted, as in JAX.  Raises `NotImplementedError` for a custom list
    entry the port cannot honour."""
    white = frozenset(custom_white_list or ())
    black = frozenset(custom_black_list or ())
    if not enable:
        yield
        return
    _check_lists(white, black, level)
    dt = to_torch_dtype(dtype)
    prev = (_STATE.level, _STATE.dtype, _STATE.white, _STATE.black)
    _STATE.level, _STATE.dtype, _STATE.white, _STATE.black = \
        level, dt, white, black
    try:
        with contextlib.ExitStack() as stack:
            if level == "O1":
                _autocast_contexts(stack, dt, True)
            yield
    finally:
        _STATE.level, _STATE.dtype, _STATE.white, _STATE.black = prev


amp_guard = auto_cast


def op_dtype(name):
    """The type the hook casts op ``name``'s floating inputs to: the amp
    type, fp32, or None (inputs left as they are).  JAX's ``_amp_cast``
    rule: white = on a white list, black = on a black list; O2 makes
    every op not black white; black wins."""
    st = _STATE
    white = name in amp_lists.WHITE_LIST or name in st.white
    black = name in amp_lists.BLACK_LIST or name in st.black
    if st.level == "O2":
        white = not black
    if black:
        return torch.float32
    return st.dtype if white else None


def _cast(x, dt):
    if torch.is_tensor(x) and x.dtype in (torch.float32, torch.float16,
                                          torch.bfloat16):
        return x.to(dt)
    return x


def amp_op(name):
    """Decorator of a port op entry: under an O1/O2 `auto_cast`, its
    floating tensor arguments are cast by `op_dtype` (``name`` the JAX
    op's) and its body runs with ``torch.autocast`` off, so the types are
    the hook's alone; with amp off it is a plain call."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if _STATE.level not in ("O1", "O2"):
                return fn(*args, **kwargs)
            dt = op_dtype(name)
            if dt is not None:
                args = [_cast(a, dt) for a in args]
                kwargs = {k: _cast(v, dt) for k, v in kwargs.items()}
            with contextlib.ExitStack() as stack:
                _autocast_contexts(stack, _STATE.dtype, False)
                return fn(*args, **kwargs)
        return wrapper
    return deco


def _on_card(device):
    """Whether ``device`` (None: the card when there is one, else the CPU)
    is a card that is there."""
    if device is None:
        return torch.cuda.is_available()
    return torch.device(device).type == "cuda" and torch.cuda.is_available()


def is_bfloat16_supported(device=None):
    """bf16 on ``device``: the CPU always, as the JAX package answers on
    every platform; a card when torch says so."""
    return torch.cuda.is_bf16_supported() if _on_card(device) else True


def is_float16_supported(device=None):
    """fp16 on ``device``: a card yes, the CPU no (the JAX package answers
    True on an accelerator, False on the CPU)."""
    return _on_card(device)


def decorate(models, optimizers=None, level="O2", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """O2: cast every floating parameter of ``models`` to ``dtype`` in
    place; the optimizers keep fp32 master weights unless
    ``master_weight=False``.  ``save_dtype`` is accepted, as in JAX.
    Returns ``models`` (and ``optimizers``)."""
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
    its ``sync_scaler()`` writes the vector back here.

    The training sentinel wraps a run without loss scaling in a unit-scale
    scaler (``init_loss_scaling=1.0``, ``always_check_found_inf=True``;
    ``_sentinel_wrapper`` marks it), so a non-finite step is skipped.  Its
    fused health pass plants its device found-inf flag in
    ``_planted_found_inf``, which the next ``unscale_`` takes instead of
    reducing every gradient again.  `update` keeps the consecutive
    found-inf count for every enabled scaler and publishes it
    (``amp.found_inf_streak`` gauge, ``amp.found_inf_total`` counter)."""

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
        self._planted_found_inf = None
        self._sentinel_wrapper = False

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
        bad, self._planted_found_inf = self._planted_found_inf, None
        if grads and (self._scale != 1.0 or self._always_check):
            if bad is None:
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

    def minimize(self, optimizer, scaled_loss):
        """Paddle's ``scaler.minimize(opt, scaled)``: the loss was scaled and
        its backward taken by the caller, so this is `step`."""
        self.step(optimizer)

    def update(self):
        if not self._enable:
            return
        if self._found_inf:
            self._found_inf_streak += 1
            _monitor.incr("amp.found_inf_total")
            _monitor.set_value("amp.found_inf_streak", self._found_inf_streak)
        elif self._found_inf_streak:
            self._found_inf_streak = 0
            _monitor.set_value("amp.found_inf_streak", 0)
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
