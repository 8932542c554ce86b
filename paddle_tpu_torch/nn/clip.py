"""Gradient clipping (port of paddle_tpu/nn/clip.py: ``ClipGradByValue``,
``ClipGradByNorm``, ``ClipGradByGlobalNorm``, ``clip_grad_norm_``).

The three classes are called by the optimizer with ``[(param, grad),
...]`` and return new gradients, leaving ``param.grad`` untouched, as the
JAX package does; they compute on the device and read nothing back, so a
captured train step runs them.  `clip_grad_norm_` reads its norm to the
host, as JAX's does: it is for eager loops only.
"""
from __future__ import annotations

import torch


class ClipGradBase:
    def __call__(self, params_grads):
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    """Every element clamped to ``[min, max]`` (``min`` defaults to
    ``-max``)."""

    def __init__(self, max, min=None):  # noqa: A002
        self.max = float(max)
        self.min = float(min) if min is not None else -float(max)

    def __call__(self, params_grads):
        return [(p, None if g is None else g.clamp(self.min, self.max))
                for p, g in params_grads]


class ClipGradByNorm(ClipGradBase):
    """Each gradient on its own: ``g * min(clip_norm / max(||g||, 1e-12),
    1)``, the norm in fp32."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        out = []
        for p, g in params_grads:
            if g is None:
                out.append((p, g))
                continue
            gf = g.float()
            n = gf.square().sum().sqrt()
            scale = torch.clamp_max(self.clip_norm / n.clamp_min(1e-12), 1.0)
            out.append((p, (gf * scale).to(g.dtype)))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    """``g * clip_norm / max(global_norm, clip_norm)`` for every gradient:
    gradients are left as they are while the norm is within ``clip_norm``.
    One global L2 norm over every gradient, in fp32."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        grads = [g for _, g in params_grads if g is not None]
        if not grads:
            return params_grads
        sq = torch.zeros((), dtype=torch.float32, device=grads[0].device)
        for g in grads:
            sq = sq + g.float().square().sum()
        norm = torch.sqrt(sq)
        scale = self.clip_norm / torch.clamp_min(norm, self.clip_norm)
        return [(p, None if g is None else (g.float() * scale).to(g.dtype))
                for p, g in params_grads]


@torch.no_grad()
def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    """Scale every ``p.grad`` in place by ``max_norm / (norm + 1e-6)`` when
    that is below 1; returns the total norm (fp32 0-dim).  The norm is read
    to the host (eager only)."""
    if torch.is_tensor(parameters):
        parameters = [parameters]
    grads = [p.grad for p in parameters if p.grad is not None]
    if not grads:
        return torch.zeros(())
    if norm_type == float("inf"):
        total = torch.stack([g.abs().max().float() for g in grads]).max()
    else:
        total = sum(g.float().abs().pow(norm_type).sum() for g in grads) \
            ** (1.0 / norm_type)
    if error_if_nonfinite and not bool(torch.isfinite(total)):
        raise RuntimeError(f"clip_grad_norm_: the total norm {total} of "
                           "the gradients is not finite")
    clip_coef = max_norm / (float(total) + 1e-6)
    if clip_coef < 1:
        for g in grads:
            g.copy_(g * clip_coef)
    return total
