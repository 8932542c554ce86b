"""Quantized KV-cache storage (port of the KV part of
paddle_tpu/quantization/__init__.py).

Each cached token position keeps one float32 scale covering its
``[H_kv, D]`` row, stored beside the page (``[P, page_size]`` scale
tensors): a write never re-quantizes older tokens, and the read
dequantizes inside the attention (the paged-decode kernel) or right
after the gather (a prefill chunk).  ``int8`` rounds half to even after
the scale; ``fp8`` (e4m3) clips and lets the cast round, as the JAX
package does, so both produce the same codes and scales.

A float8 tensor is gathered and stored through a ``uint8`` view of the
same bytes (`as_bytes`): PyTorch's CUDA indexing kernels do not all take
float8.
"""
from __future__ import annotations

import torch

#: cache_dtype name -> (storage dtype, symmetric quant range max)
KV_QUANT_DTYPES = {"int8": (torch.int8, 127.0),
                   "fp8": (torch.float8_e4m3fn, 448.0)}


def kv_quant_params(cache_dtype):
    """(storage dtype, qmax) for a quantized KV ``cache_dtype``, or None
    for an ordinary float type."""
    return KV_QUANT_DTYPES.get(cache_dtype)


def qmax_of(storage_dtype):
    return 127.0 if storage_dtype == torch.int8 else 448.0


def as_bytes(t):
    """``t`` itself, or a ``uint8`` view of it when it is float8."""
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


def quantize_kv_rows(x, qmax, storage_dtype):
    """Per-token-row symmetric quantization of new K/V values.

    x: float ``[..., H, D]``; the scale covers the trailing ``[H, D]``
    row.  Returns ``(q [..., H, D] storage_dtype, scale [...] float32)``
    with ``q * scale ≈ x``.  The divisions are tensor by tensor: on the
    card a division by a Python number becomes a multiplication by its
    reciprocal, which would round differently.  The divisor is filled on
    the device (no host copy), so a CUDA graph can capture the call."""
    xf = x.float()
    absmax = xf.abs().amax(dim=(-2, -1))
    scale = torch.clamp(absmax / torch.full((), qmax, device=x.device),
                        min=1e-12)
    scaled = xf / scale[..., None, None]
    if storage_dtype == torch.int8:
        q = torch.clamp(torch.round(scaled), -qmax, qmax).to(torch.int8)
    else:                           # fp8: the cast IS the rounding
        q = torch.clamp(scaled, -qmax, qmax).to(storage_dtype)
    return q, scale


def dequantize_kv(q, scale):
    """Inverse of `quantize_kv_rows`: ``q[..., H, D] × scale[...]`` →
    float32."""
    return q.float() * scale[..., None, None]
