"""Functional ops of the serving path (port of paddle_tpu/nn/functional.py:
``rms_norm``, ``silu``, ``linear``)."""
from __future__ import annotations

import torch

from ..kernels import rms_norm as _rms


def rms_norm(x, weight, epsilon=1e-6):
    """x / rms(x) * weight: the RMS-norm kernel on the card, its plain
    version on the CPU."""
    return _rms.rms_norm(x, weight, epsilon)


def silu(x):
    return torch.nn.functional.silu(x)


def linear(x, weight, bias=None):
    """y = x @ W + b with W in Paddle's ``[in, out]`` layout."""
    y = torch.matmul(x, weight)
    if bias is not None:
        y = y + bias
    return y
