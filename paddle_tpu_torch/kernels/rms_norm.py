"""RMS norm: the CUDA kernels ``csrc/rms_norm.cu`` (forward and backward)
and their plain versions (port of paddle_tpu/pallas/fused.py
``rms_norm_pallas`` and its VJP).

The forward computes ``y = (x * r * w)`` in fp32 with ``r = rsqrt(mean(x^2)
+ eps)`` and rounds once to x's dtype, the op order of the TPU kernel.  (The
JAX package's jnp fallback rounds before ``* w``; in fp32 the two agree,
in bf16 they differ by rounding.)  The backward takes the forward's ``r``
and computes ``dx = r * (g*w - x^ * mean(g*w*x^))`` and ``dw = sum_rows
g*x^`` in fp32 with ``x^ = x*r``; `RMSNormFunction` ties the two together
for autograd.
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


def rms_norm_bwd_ref(x, weight, r, g):
    """Plain PyTorch backward, the TPU kernel's op order: x: [..., N],
    r: fp32 [...] from the forward, g like x → (dx like x, dw like w)."""
    n = x.shape[-1]
    xf = x.reshape(-1, n).float()
    gf = g.reshape(-1, n).float()
    rr = r.reshape(-1, 1)
    xhat = xf * rr
    gw = gf * weight.float()
    m = (gw * xhat).mean(dim=-1, keepdim=True)
    dx = (rr * (gw - xhat * m)).to(x.dtype).reshape(x.shape)
    dw = (gf * xhat).sum(dim=0).to(weight.dtype)
    return dx, dw


def rms_norm_bwd(x, weight, r, g):
    """x, g: [..., N]; weight: [N]; r: fp32 [...] (the forward's
    ``return_rstd``) → (dx like x, dw like weight).  CPU tensors take
    `rms_norm_bwd_ref`; CUDA tensors launch the two kernels (per-block
    partial sums of dw, then their sum in block order)."""
    if x.device.type == "cpu":
        return rms_norm_bwd_ref(x, weight, r, g)
    if x.device.type != "cuda":
        raise ValueError(f"rms_norm_bwd: unsupported device {x.device}")
    x, g, r = x.contiguous(), g.contiguous(), r.contiguous()
    check_cuda("rms_norm_bwd", x, weight, r, g)
    n = x.shape[-1]
    rows = x.numel() // n if n else 0
    if g.shape != x.shape or r.numel() != rows or r.dtype != torch.float32:
        raise ValueError(f"rms_norm_bwd: g {tuple(g.shape)} / r "
                         f"{tuple(r.shape)} {r.dtype} do not match x "
                         f"{tuple(x.shape)}")
    dx = torch.empty_like(x)
    dw = torch.empty_like(weight)
    if not rows:
        return dx, dw.zero_()
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    blocks = min(rows, 2 * sms)
    ws = torch.empty(blocks, n, dtype=torch.float32, device=x.device)
    fn = _build.function("ptt_rms_norm_bwd", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p])
    with torch.cuda.device(x.device):
        err = fn(_build.ptr(x), _build.ptr(weight), _build.ptr(r),
                 _build.ptr(g), _build.ptr(dx), _build.ptr(dw),
                 _build.ptr(ws), rows, n, blocks, dtype_code(x),
                 dtype_code(weight), _build.stream(x.device))
    _build.check(err, "ptt_rms_norm_bwd")
    rms_norm_bwd.launches += 1
    return dx, dw


rms_norm_bwd.launches = 0


class RMSNormFunction(torch.autograd.Function):
    """y = rms_norm(x, w, eps) under autograd: the forward kernel saves
    its fp32 ``r`` and the backward kernel consumes it (the custom VJP of
    paddle_tpu/pallas/fused.py ``rms_norm_pallas``)."""

    @staticmethod
    def forward(ctx, x, weight, eps):
        y, r = rms_norm(x, weight, eps, return_rstd=True)
        ctx.save_for_backward(x, weight, r)
        return y

    @staticmethod
    def backward(ctx, g):
        x, weight, r = ctx.saved_tensors
        dx, dw = rms_norm_bwd(x, weight, r, g)
        return dx, dw, None
