"""Gradient clipping (port of paddle_tpu/nn/clip.py ``ClipGradByGlobalNorm``):
one global L2 norm over every gradient, in fp32."""
from __future__ import annotations

import torch


class ClipGradByGlobalNorm:
    """``g * clip_norm / max(global_norm, clip_norm)`` for every gradient:
    gradients are left as they are while the norm is within ``clip_norm``.
    Called by the optimizer with ``[(param, grad), ...]``; returns new
    gradients and leaves ``param.grad`` untouched, as the JAX package does."""

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
