"""Adam / AdamW update: the CUDA kernel ``csrc/adam.cu`` and its plain
version (port of paddle_tpu/pallas/fused.py ``adam_update_pallas``, the
Pallas lane of ``optimizer.Adam._fused_update``).

One parameter per call, in place: ``w`` is the fp32 working value (the
master of a 16-bit parameter, or the fp32 parameter itself), ``m1``/``m2``
the fp32 moments, ``g`` the gradient, and ``p``, when given, receives the
new ``w`` rounded to its dtype.  Both versions run the JAX package's jnp
lane op for op in fp32, each product, sum, quotient and root rounded on its
own, so they agree bitwise with each other and with the Pallas kernel,
which is bitwise equal to that lane by its own contract.

The step's scalars live on the device, as the Pallas kernel's ``scal_ref``:
``scal`` is an fp32 ``[4]`` tensor on w's device, ``[lr * lr_scale, 1 -
b1^t, 1 - b2^t, gscale]`` (`adam_scalars` makes it from the device step
counter), and ``skip``, when given, a 0-dim bool tensor there: set, the
update writes nothing (a loss-scaled step whose gradients overflowed).
``gscale`` is the global-norm clip's scale (1 without one): both versions
read the gradient as ``float(G(float(g) * gscale))``, the JAX clip's
``(g.astype(f32) * s).astype(g.dtype)`` followed by the update's cast to
fp32, so the clip writes no scaled copy of any gradient; at ``gscale ==
1`` the product and the rounding are exact.  Nothing is read back to the
host, so one launch serves every replay of a CUDA graph.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build, check_cuda, dtype_code

_NO_DECAY, _COUPLED, _DECOUPLED = 0, 1, 2


def _decay(wd, decoupled):
    if not wd:
        return _NO_DECAY
    return _DECOUPLED if decoupled else _COUPLED


def bias_correction(beta, step):
    """``1 - beta ** step`` as fp32 on step's device, ``step`` a 0-dim fp32
    tensor: the power of fp32(beta) taken in double and rounded once, then
    the fp32 subtraction.  The one computation both optimizer lanes share;
    rounding a double power gives the same float on the CPU and the card
    (each libm's float power may differ by an ulp)."""
    base = float(np.float32(beta))
    return 1.0 - torch.pow(base, step.double()).float()


def adam_scalars(lr, step, b1, b2, lr_scale=1.0, gscale=None):
    """The kernel's device scalars ``[lr * lr_scale, 1 - b1^t, 1 - b2^t,
    gscale]`` (fp32 ``[4]``) from the 0-dim fp32 tensors ``lr``, ``step``
    (the updated counter) and ``gscale`` (the clip's scale; None: 1), on
    their device; no host read."""
    lr_s = lr * float(lr_scale) if lr_scale != 1.0 else lr
    gs = torch.ones_like(lr) if gscale is None else gscale
    return torch.stack([lr_s, bias_correction(b1, step),
                        bias_correction(b2, step), gs])


def adam_update_ref(w, g, m1, m2, p, scal, *, b1, b2, eps, wd, decoupled,
                    skip=None):
    """Plain PyTorch version.  The scalars divide and multiply as 0-dim
    tensors on w's device (a CUDA tensor divided by a Python number is
    multiplied by its reciprocal, one rounding more than the JAX lane's
    division); with ``skip`` set every tensor keeps its value (a select,
    no host read)."""
    lr, bc1, bc2, gs = scal[0], scal[1], scal[2], scal[3]
    outs = [t for t in (w, m1, m2, p) if t is not None]
    old = [t.clone() for t in outs] if skip is not None else None
    decay = _decay(wd, decoupled)
    gf = g.float() * gs
    if g.dtype != torch.float32:
        gf = gf.to(g.dtype).float()
    if decay == _COUPLED:
        gf = gf + wd * w
    m1.mul_(b1).add_(gf * (1 - b1))
    m2.mul_(b2).add_(gf.square().mul_(1 - b2))
    upd = (m1 / bc1).div_((m2 / bc2).sqrt_().add_(eps))
    if decay == _DECOUPLED:
        upd.add_(w * wd)
    w.sub_(upd.mul_(lr))
    if p is not None:
        p.copy_(w)
    if skip is not None:
        for t, o in zip(outs, old):
            t.copy_(torch.where(skip, o, t))


def adam_update(w, g, m1, m2, p, scal, *, b1, b2, eps, wd, decoupled,
                skip=None):
    """Update ``w``, ``m1``, ``m2`` (and ``p``) in place.  CPU tensors take
    `adam_update_ref`; CUDA tensors launch the kernel."""
    if w.device.type == "cpu":
        return adam_update_ref(w, g, m1, m2, p, scal, b1=b1, b2=b2, eps=eps,
                               wd=wd, decoupled=decoupled, skip=skip)
    if w.device.type != "cuda":
        raise ValueError(f"adam_update: unsupported device {w.device}")
    g = g.contiguous()
    check_cuda("adam_update", w, g, m1, m2, *(() if p is None else (p,)))
    n = w.numel()
    for name, t in (("m1", m1), ("m2", m2), ("w", w)):
        if t.dtype != torch.float32 or t.numel() != n:
            raise ValueError(f"adam_update: {name} must be fp32 with w's "
                             f"{n} elements ({t.dtype}, {t.numel()})")
    if g.numel() != n or (p is not None and p.numel() != n):
        raise ValueError(f"adam_update: g / p must have w's {n} elements")
    if scal.dtype != torch.float32 or scal.shape != (4,) \
            or scal.device != w.device:
        raise ValueError(f"adam_update: scal must be fp32 [4] on {w.device}"
                         f" ({scal.dtype} {tuple(scal.shape)} "
                         f"{scal.device})")
    if skip is not None and (skip.dtype != torch.bool or skip.numel() != 1
                             or skip.device != w.device):
        raise ValueError(f"adam_update: skip must be one bool on {w.device}")
    if not n:
        return
    if not vector_path(w, g, m1, m2, p):
        adam_update.scalar_launches += 1
    scal = scal.contiguous()
    fn = _build.function("ptt_adam_update", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
        ctypes.c_void_p] + [ctypes.c_float] * 6 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    with torch.cuda.device(w.device):
        err = fn(_build.ptr(w), _build.ptr(g), _build.ptr(m1), _build.ptr(m2),
                 None if p is None else _build.ptr(p), n, _build.ptr(scal),
                 None if skip is None else _build.ptr(skip), b1, 1 - b1, b2,
                 1 - b2, eps, float(wd) if wd else 0.0,
                 _decay(wd, decoupled), dtype_code(g),
                 dtype_code(w if p is None else p), _build.stream(w.device))
    _build.check(err, "ptt_adam_update")
    adam_update.launches += 1


adam_update.launches = 0
#: launches that took the kernel's scalar path (a pointer off alignment)
adam_update.scalar_launches = 0


def vector_path(w, g, m1, m2, p=None):
    """Whether the kernel takes its 4-wide vector path for these tensors
    (``csrc/adam.cu`` ``launch``): w, m1 and m2 16-byte aligned, g and p
    aligned to four of their elements."""
    return all(t.data_ptr() % 16 == 0 for t in (w, m1, m2)) and \
        g.data_ptr() % (4 * g.element_size()) == 0 and \
        (p is None or p.data_ptr() % (4 * p.element_size()) == 0)
