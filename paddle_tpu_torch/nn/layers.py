"""Layers of the serving and training paths (port of
paddle_tpu/nn/layers_common.py ``Linear``, ``Embedding``, ``RMSNorm``,
``LayerNorm``, ``Dropout``), with the same parameter names and layouts so
state dicts cross unchanged: ``Linear.weight`` is ``[in, out]``.

The positional parameters are JAX's (``Linear(in, out, weight_attr,
bias_attr, name)``, ``Embedding(n, d, padding_idx, sparse, weight_attr,
name)``, ``Dropout(p, axis, mode, name)``); the port's own ones (``std``,
``device``, ``dtype``, ``generator``) are keyword-only.  A parameter
attribute other than ``bias_attr=False`` raises `NotImplementedError`:
``ParamAttr`` is not ported (ROADMAP A9).

A layer fills its parameters at construction, as JAX's do, by
`reset_parameters` (under ``torch.no_grad()``) from the package's init
generator for the device (`init_generator`, seeded 0; never torch's
global RNG).  A model that draws every parameter from a generator of its
own builds its layers under `deferred_init`, which leaves them for its
``reset_parameters`` pass.  ``device=None`` means the card
(`resolve_device`): without CUDA a layer raises unless it was asked for
``"cpu"``.
"""
from __future__ import annotations

import contextlib
import math
import threading

import torch
from torch import nn

from ..device import resolve_device
from . import functional as F


_init_generators = {}
_defer = threading.local()


def init_generator(device):
    """The package's generator for layer init on ``device`` (seed 0)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev not in _init_generators:
        _init_generators[dev] = torch.Generator(device=dev).manual_seed(0)
    return _init_generators[dev]


@contextlib.contextmanager
def deferred_init():
    """Layers built in this scope (on this thread) leave their parameters
    uninitialised: their owner fills them by ``reset_parameters``."""
    depth = getattr(_defer, "depth", 0)
    _defer.depth = depth + 1
    try:
        yield
    finally:
        _defer.depth = depth


def _init(layer):
    if not getattr(_defer, "depth", 0):
        with torch.no_grad():
            layer.reset_parameters(init_generator(layer.weight.device))


def _no_param_attr(layer, **attrs):
    for name, value in attrs.items():
        if value is not None:
            raise NotImplementedError(
                f"{layer}({name}={value!r}): ParamAttr is not ported yet "
                "(ROADMAP A9)")


class Linear(nn.Module):
    """y = x W + b, W: ``[in_features, out_features]``.  ``bias_attr=False``
    builds no bias.  ``std`` is the normal init's deviation; None is
    Paddle's default Xavier normal."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None, *, std=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        bias = bias_attr is not False
        _no_param_attr("Linear", weight_attr=weight_attr,
                       bias_attr=bias_attr if bias else None)
        device = resolve_device(device)
        self.in_features = in_features
        self.out_features = out_features
        self.std = std
        self.weight = nn.Parameter(torch.empty(
            in_features, out_features, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.empty(
            out_features, device=device, dtype=dtype)) if bias else None
        _init(self)

    def reset_parameters(self, generator):
        std = self.std if self.std is not None else \
            math.sqrt(2.0 / (self.in_features + self.out_features))
        self.weight.normal_(0.0, std, generator=generator)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class Embedding(nn.Module):
    """Rows of ``weight`` ``[num_embeddings, embedding_dim]``, N(0, std²)
    at init.  With ``padding_idx`` the row is zeroed at init and every
    lookup of that id reads 0 (`functional.embedding`), as in JAX; a
    negative ``padding_idx`` zeroes that row from the end, and, as in
    JAX, masks no id (an id is never negative).  ``sparse`` is accepted
    and ignored, as JAX does."""

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None, *, std=1.0,
                 device=None, dtype=torch.float32):
        super().__init__()
        _no_param_attr("Embedding", weight_attr=weight_attr)
        device = resolve_device(device)
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.padding_idx = padding_idx
        self.std = std
        self.weight = nn.Parameter(torch.empty(
            num_embeddings, embedding_dim, device=device, dtype=dtype))
        _init(self)

    def reset_parameters(self, generator):
        self.weight.normal_(0.0, self.std, generator=generator)
        if self.padding_idx is not None:
            self.weight[self.padding_idx] = 0.0

    def forward(self, x):
        return F.embedding(x, self.weight, padding_idx=self.padding_idx)


class RMSNorm(nn.Module):
    """``weight`` (ones) over the last axis.  ``weight_attr`` and ``name``
    sit in JAX's places; a ParamAttr other than None raises (ROADMAP
    A9)."""

    def __init__(self, hidden_size, epsilon=1e-6, weight_attr=None,
                 name=None, *, device=None, dtype=torch.float32):
        super().__init__()
        _no_param_attr("RMSNorm", weight_attr=weight_attr)
        device = resolve_device(device)
        self._epsilon = epsilon
        self.weight = nn.Parameter(torch.empty(
            hidden_size, device=device, dtype=dtype))
        _init(self)

    def reset_parameters(self, generator=None):
        self.weight.fill_(1.0)

    def forward(self, x):
        return F.rms_norm(x, self.weight, self._epsilon)


class LayerNorm(nn.Module):
    """``weight`` (ones) and ``bias`` (zeros) over ``normalized_shape``;
    ``weight_attr=False`` or ``bias_attr=False`` builds the norm without
    that parameter, as in JAX (another ParamAttr raises, ROADMAP A9)."""

    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        _no_param_attr("LayerNorm",
                       weight_attr=None if weight_attr is False
                       else weight_attr,
                       bias_attr=None if bias_attr is False else bias_attr)
        device = resolve_device(device)
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon

        def param():
            return nn.Parameter(torch.empty(
                self._normalized_shape, device=device, dtype=dtype))
        self.weight = param() if weight_attr is not False else None
        self.bias = param() if bias_attr is not False else None
        if not getattr(_defer, "depth", 0):
            with torch.no_grad():
                self.reset_parameters()

    def reset_parameters(self, generator=None):
        if self.weight is not None:
            self.weight.fill_(1.0)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight,
                            self.bias, self._epsilon)


class Dropout(nn.Module):
    """``upscale_in_train`` dropout while training, the identity in
    ``eval()``; the mask is drawn from ``generator`` (a ``torch.Generator``
    on the input's device; None: the package's default for the device).
    Capturable in a CUDA graph (`functional.dropout`).  An ``axis`` or
    another ``mode`` raises `NotImplementedError` (ROADMAP A9)."""

    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None,
                 *, generator=None):
        super().__init__()
        if axis is not None or mode != "upscale_in_train":
            raise NotImplementedError(
                f"Dropout(axis={axis!r}, mode={mode!r}): only "
                "upscale_in_train over every element is ported (ROADMAP A9)")
        self.p = p
        self.axis = axis
        self.mode = mode
        self.generator = generator

    def forward(self, x):
        return F.dropout(x, self.p, training=self.training,
                         generator=self.generator)
