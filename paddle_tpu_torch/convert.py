"""Weights and optimizer state across the two packages.

The port keeps paddle_tpu's parameter names and layouts (``Linear`` is
``[in, out]``), so a paddle_tpu state dict, taken to numpy arrays, maps
name for name onto a port model with no transpose::

    np_state = {k: np.asarray(v._data_) for k, v in jax_model.state_dict().items()}
    load_paddle_tpu_state(torch_model, np_state)

An optimizer's state (``moment1.<i>``, ``moment2.<i>``, ``master.<i>``,
``step_count``, ``step_tensor``, and ``LR_Scheduler`` with a schedule) is
indexed by the position of the parameter in the optimizer's list;
`load_paddle_tpu_optimizer_state` carries it over when the port's
optimizer lists the port model's parameters in the JAX optimizer's order
(``model.parameters()`` on both sides: the port's modules register them in
the JAX package's order).  The step counter lands in the optimizer's
device tensor and the schedule's state in its `LRScheduler`;
`load_paddle_tpu_scaler_state` adopts a ``GradScaler.state_dict()``.  A
run resumed so continues as the JAX compiled step does.
"""
from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device, to_torch_dtype


def state_dict_from_paddle_tpu(np_state, device=None, dtype=None):
    """``{name: np.ndarray}`` → ``{name: torch.Tensor}`` on ``device``
    (None → the card), cast to ``dtype`` when given."""
    dev = resolve_device(device)
    dt = to_torch_dtype(dtype) if dtype is not None else None
    out = {}
    for name, arr in np_state.items():
        t = torch.tensor(np.asarray(arr))     # a copy the caller cannot alias
        out[name] = t.to(device=dev, dtype=dt if dt is not None else t.dtype)
    return out


def load_paddle_tpu_state(model, np_state):
    """Copy a paddle_tpu state dict (numpy arrays) into ``model`` in
    place, on the model's device and in its dtype.  Raises on a missing,
    unexpected or mis-shaped key."""
    own = model.state_dict()
    missing = sorted(set(own) - set(np_state))
    unexpected = sorted(set(np_state) - set(own))
    if missing or unexpected:
        raise KeyError(f"state dict mismatch: missing {missing}, "
                       f"unexpected {unexpected}")
    for name, arr in np_state.items():
        if tuple(arr.shape) != tuple(own[name].shape):
            raise ValueError(f"{name}: shape {tuple(arr.shape)} != model's "
                             f"{tuple(own[name].shape)}")
    ref = next(iter(own.values()))
    tensors = state_dict_from_paddle_tpu(np_state, device=ref.device,
                                         dtype=ref.dtype)
    with torch.no_grad():
        for name, t in tensors.items():
            own[name].copy_(t)
    return model


def load_paddle_tpu_optimizer_state(optimizer, np_state):
    """Adopt a paddle_tpu optimizer's ``state_dict()`` (values taken to
    numpy arrays or Python numbers) into a port optimizer of the same
    kind, copying each tensor onto its parameter's device.  Raises on a
    key the port optimizer has no slot for."""
    optimizer._ensure_state()
    n = len(optimizer._all_params())
    names = set(optimizer._state)
    for key in np_state:
        if key in ("step_count", "step_tensor", "LR_Scheduler"):
            continue
        name, _, idx = key.rpartition(".")
        if name not in names or not idx.isdigit() or int(idx) >= n:
            raise KeyError(f"optimizer state key {key!r} has no slot in "
                           f"{type(optimizer).__name__} (state "
                           f"{sorted(names)}, {n} parameters)")
    optimizer.set_state_dict(dict(np_state))
    return optimizer


def load_paddle_tpu_scaler_state(scaler, state):
    """Adopt a paddle_tpu ``GradScaler.state_dict()`` (``scale``,
    ``good_steps``, ``bad_steps``; numbers or 0-dim arrays) into a port
    `amp.GradScaler`."""
    scaler.load_state_dict({k: np.asarray(state[k]).item()
                            for k in ("scale", "good_steps", "bad_steps")})
    return scaler
