"""RMS norm forward: the CUDA kernel ``csrc/rms_norm.cu`` and its plain
version (port of paddle_tpu/pallas/fused.py ``rms_norm_pallas`` forward).

Both compute ``y = (x * r * w)`` in fp32 with ``r = rsqrt(mean(x^2) +
eps)`` and round once to x's dtype, the op order of the TPU kernel.  (The
JAX package's jnp fallback rounds before ``* w``; in fp32 the two agree,
in bf16 they differ by rounding.)
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, check_cuda, dtype_code


def rms_norm_ref(x, weight, eps, return_rstd=False):
    """Plain PyTorch version, same op order as the kernel."""
    xf = x.float()
    r = torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + eps)
    y = (xf * r * weight.float()).to(x.dtype)
    return (y, r.squeeze(-1)) if return_rstd else y


def rms_norm(x, weight, eps, return_rstd=False):
    """x: [..., N], weight: [N] → y like x (and fp32 ``r`` [...] with
    ``return_rstd``).  CPU tensors take `rms_norm_ref`; CUDA tensors
    launch the kernel."""
    if x.device.type == "cpu":
        return rms_norm_ref(x, weight, eps, return_rstd)
    if x.device.type != "cuda":
        raise ValueError(f"rms_norm: unsupported device {x.device}")
    check_cuda("rms_norm", x, weight)
    n = x.shape[-1]
    if weight.dim() != 1 or weight.shape[0] != n:
        raise ValueError(f"rms_norm: weight {tuple(weight.shape)} does not "
                         f"match x's last dim {n}")
    rows = x.numel() // n if n else 0
    y = torch.empty_like(x)
    r = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device) \
        if return_rstd else None
    if rows:
        fn = _build.function("ptt_rms_norm_fwd", [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        with torch.cuda.device(x.device):
            err = fn(_build.ptr(x), _build.ptr(weight), _build.ptr(y),
                     _build.ptr(r) if r is not None else None, rows, n,
                     float(eps), dtype_code(x), dtype_code(weight),
                     _build.stream(x.device))
        _build.check(err, "ptt_rms_norm_fwd")
        rms_norm.launches += 1
    return (y, r) if return_rstd else y


rms_norm.launches = 0
