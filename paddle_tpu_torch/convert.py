"""Weights across the two packages.

The port keeps paddle_tpu's parameter names and layouts (``Linear`` is
``[in, out]``), so a paddle_tpu state dict, taken to numpy arrays, maps
name for name onto a port model with no transpose::

    np_state = {k: np.asarray(v._data_) for k, v in jax_model.state_dict().items()}
    load_paddle_tpu_state(torch_model, np_state)
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
