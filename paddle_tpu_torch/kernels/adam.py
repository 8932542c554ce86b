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
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, check_cuda, dtype_code

_NO_DECAY, _COUPLED, _DECOUPLED = 0, 1, 2


def _decay(wd, decoupled):
    if not wd:
        return _NO_DECAY
    return _DECOUPLED if decoupled else _COUPLED


def adam_update_ref(w, g, m1, m2, p, lr, bc1, bc2, *, b1, b2, eps, wd,
                    decoupled):
    """Plain PyTorch version.  The bias corrections divide as 0-dim tensors
    on w's device: a CUDA tensor divided by a Python number is multiplied
    by its reciprocal, one rounding more than the JAX lane's division."""
    bc1_t = torch.full((), bc1, dtype=torch.float32, device=w.device)
    bc2_t = torch.full((), bc2, dtype=torch.float32, device=w.device)
    decay = _decay(wd, decoupled)
    gf = g.float()
    if decay == _COUPLED:
        gf = gf + wd * w
    m1.mul_(b1).add_(gf * (1 - b1))
    m2.mul_(b2).add_(gf.square().mul_(1 - b2))
    upd = (m1 / bc1_t).div_((m2 / bc2_t).sqrt_().add_(eps))
    if decay == _DECOUPLED:
        upd.add_(w * wd)
    w.sub_(upd.mul_(lr))
    if p is not None:
        p.copy_(w)


def adam_update(w, g, m1, m2, p, lr, bc1, bc2, *, b1, b2, eps, wd,
                decoupled):
    """Update ``w``, ``m1``, ``m2`` (and ``p``) in place.  CPU tensors take
    `adam_update_ref`; CUDA tensors launch the kernel."""
    if w.device.type == "cpu":
        return adam_update_ref(w, g, m1, m2, p, lr, bc1, bc2, b1=b1, b2=b2,
                               eps=eps, wd=wd, decoupled=decoupled)
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
    if not n:
        return
    fn = _build.function("ptt_adam_update", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_float] * 9 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    with torch.cuda.device(w.device):
        err = fn(_build.ptr(w), _build.ptr(g), _build.ptr(m1), _build.ptr(m2),
                 None if p is None else _build.ptr(p), n, lr, bc1, bc2, b1,
                 1 - b1, b2, 1 - b2, eps, float(wd) if wd else 0.0,
                 _decay(wd, decoupled), dtype_code(g),
                 dtype_code(w if p is None else p), _build.stream(w.device))
    _build.check(err, "ptt_adam_update")
    adam_update.launches += 1


adam_update.launches = 0
