"""Rotary position embedding: the CUDA kernel ``csrc/rope.cu`` and its plain
version (port of paddle_tpu/pallas/fused.py ``rope_pallas``: ``_rope_call``
and its VJP).

``t`` is ``[B, S, H, D]``; ``cos``/``sin`` are fp32 ``[S, D]`` tables.  Both
versions compute in fp32 in the TPU kernel's order (neox: ``t*cos +
rot*sin`` with ``rot = [-t2, t1]``; interleaved: ``t1*c - t2*s``,
``t2*c + t1*s`` on the pairs) and round once to t's dtype.  The backward
is the same kernel rotating by the opposite angle (``inverse``), so no
``-sin`` table is built.  Unlike JAX's ``rope_supported`` (S % 8 == 0), any
S and any even D are taken.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, check_cuda, dtype_code


def rope_ref(t, cos, sin, neox=True, inverse=False):
    """Plain PyTorch version, the same op order as the kernel."""
    tf = t.float()
    c = cos.float()[:, None, :]                       # [S, 1, D]
    s = sin.float()[:, None, :]
    if inverse:
        s = -s
    d = t.shape[-1]
    if neox:
        rot = torch.cat([-tf[..., d // 2:], tf[..., :d // 2]], dim=-1)
        o = tf * c + rot * s
    else:
        t1, t2 = tf[..., 0::2], tf[..., 1::2]
        ce, se = c[..., 0::2], s[..., 0::2]
        o = torch.stack([t1 * ce - t2 * se, t2 * ce + t1 * se],
                        dim=-1).reshape(tf.shape)
    return o.to(t.dtype)


def rope(t, cos, sin, neox=True, inverse=False):
    """t: [B, S, H, D]; cos/sin: fp32 [S, D] → like t.  CPU tensors take
    `rope_ref`; CUDA tensors launch the kernel."""
    if t.device.type == "cpu":
        return rope_ref(t, cos, sin, neox, inverse)
    if t.device.type != "cuda":
        raise ValueError(f"rope: unsupported device {t.device}")
    t = t.contiguous()
    cos, sin = cos.contiguous(), sin.contiguous()
    check_cuda("rope", t, cos, sin)
    if t.dim() != 4:
        raise ValueError(f"rope: t {tuple(t.shape)} must be [B, S, H, D]")
    b, s, h, d = t.shape
    if d % 2 or cos.shape != (s, d) or sin.shape != (s, d) \
            or cos.dtype != torch.float32 or sin.dtype != torch.float32:
        raise ValueError(f"rope: tables {tuple(cos.shape)} {cos.dtype} / "
                         f"{tuple(sin.shape)} {sin.dtype} must be fp32 "
                         f"[{s}, {d}] with an even head dim")
    out = torch.empty_like(t)
    if not t.numel():
        return out
    fn = _build.function("ptt_rope", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    with torch.cuda.device(t.device):
        err = fn(_build.ptr(t), _build.ptr(cos), _build.ptr(sin),
                 _build.ptr(out), b, s, h, d, int(bool(neox)),
                 int(bool(inverse)), dtype_code(t), _build.stream(t.device))
    _build.check(err, "ptt_rope")
    rope.launches += 1
    return out


rope.launches = 0


class RopeFunction(torch.autograd.Function):
    """`rope` under autograd: the backward rotates the incoming gradient
    by the opposite angle with the same kernel; the tables are position
    constants and get no gradient."""

    @staticmethod
    def forward(ctx, t, cos, sin, neox):
        ctx.save_for_backward(cos, sin)
        ctx.neox = neox
        return rope(t, cos, sin, neox)

    @staticmethod
    def backward(ctx, g):
        cos, sin = ctx.saved_tensors
        return rope(g, cos, sin, ctx.neox, inverse=True), None, None, None
