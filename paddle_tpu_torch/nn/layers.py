"""Layers of the serving and training paths (port of
paddle_tpu/nn/layers_common.py ``Linear``, ``Embedding``, ``RMSNorm``,
``LayerNorm``, ``Dropout``), with the same parameter names and layouts so
state dicts cross unchanged: ``Linear.weight`` is ``[in, out]``.

Parameters are allocated uninitialised on the requested device and filled
by `reset_parameters` (under ``torch.no_grad()``) from an explicit
``torch.Generator``.  ``device=None`` means the card (`resolve_device`):
without CUDA a layer raises unless it was asked for ``"cpu"``.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..device import resolve_device
from . import functional as F


class Linear(nn.Module):
    """y = x W + b, W: ``[in_features, out_features]``.  ``std`` is the
    normal init's deviation; None is Paddle's default Xavier normal."""

    def __init__(self, in_features, out_features, bias=True, std=None,
                 device=None, dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        self.in_features = in_features
        self.out_features = out_features
        self.std = std
        self.weight = nn.Parameter(torch.empty(
            in_features, out_features, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.empty(
            out_features, device=device, dtype=dtype)) if bias else None

    def reset_parameters(self, generator):
        std = self.std if self.std is not None else \
            math.sqrt(2.0 / (self.in_features + self.out_features))
        self.weight.normal_(0.0, std, generator=generator)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class Embedding(nn.Module):
    def __init__(self, num_embeddings, embedding_dim, std=1.0, device=None,
                 dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        self.std = std
        self.weight = nn.Parameter(torch.empty(
            num_embeddings, embedding_dim, device=device, dtype=dtype))

    def reset_parameters(self, generator):
        self.weight.normal_(0.0, self.std, generator=generator)

    def forward(self, ids):
        return F.embedding(ids, self.weight)


class RMSNorm(nn.Module):
    def __init__(self, hidden_size, epsilon=1e-6, device=None,
                 dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        self._epsilon = epsilon
        self.weight = nn.Parameter(torch.empty(
            hidden_size, device=device, dtype=dtype))

    def reset_parameters(self, generator=None):
        self.weight.fill_(1.0)

    def forward(self, x):
        return F.rms_norm(x, self.weight, self._epsilon)


class LayerNorm(nn.Module):
    """``weight`` (ones) and ``bias`` (zeros) over ``normalized_shape``."""

    def __init__(self, normalized_shape, epsilon=1e-5, device=None,
                 dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        self.weight = nn.Parameter(torch.empty(
            self._normalized_shape, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.empty(
            self._normalized_shape, device=device, dtype=dtype))

    def reset_parameters(self, generator=None):
        self.weight.fill_(1.0)
        self.bias.zero_()

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight,
                            self.bias, self._epsilon)


class Dropout(nn.Module):
    """``upscale_in_train`` dropout while training, the identity in
    ``eval()``; the mask is drawn from ``generator`` (a ``torch.Generator``
    on the input's device; None: the package's default for the device).
    Capturable in a CUDA graph (`functional.dropout`)."""

    def __init__(self, p=0.5, generator=None):
        super().__init__()
        self.p = p
        self.generator = generator

    def forward(self, x):
        return F.dropout(x, self.p, training=self.training,
                         generator=self.generator)
