"""Gradient clipping (port of paddle_tpu/nn/clip.py: ``ClipGradByValue``,
``ClipGradByNorm``, ``ClipGradByGlobalNorm``, ``clip_grad_norm_``).

The three classes are called with ``[(param, grad), ...]`` and return
new gradients, leaving ``param.grad`` untouched, as the JAX package does;
the optimizer calls `ClipGradByGlobalNorm.scale` instead and applies that
scale inside its update.  They compute on the device and read nothing
back, so a captured train step runs them.  `clip_grad_norm_` reads its norm to the
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
    ``group_name`` and ``auto_skip_clip`` are stored, as the JAX package
    stores them; neither changes the result.

    The optimizers take only `scale`, one device scalar, and apply it as
    they read each gradient (the Adam kernel as it loads g), so no scaled
    copy of any gradient is written.  ``__call__`` returns the scaled
    gradients for a caller that clips by hand."""

    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name
        self.auto_skip_clip = auto_skip_clip

    def scale(self, params_grads):
        """``clip_norm / max(norm, clip_norm)`` (JAX nn/clip.py
        ``scale_fn``'s ``s``, a true fp32 division) as an fp32 0-dim
        tensor on the gradients' device, or None without gradients;
        nothing is read back to the host.  The norm is `global_norm`'s."""
        norm = global_norm(params_grads)
        if norm is None:
            return None
        denom = torch.clamp_min(norm, self.clip_norm)
        return torch.full_like(denom, self.clip_norm) / denom

    def __call__(self, params_grads):
        s = self.scale(params_grads)
        if s is None:
            return params_grads
        return [(p, None if g is None else (g.float() * s).to(g.dtype))
                for p, g in params_grads]


def global_norm(params_grads):
    """The global L2 norm of the gradients, an fp32 0-dim tensor (None
    without gradients).  One `torch._foreach_norm` pass reads each
    gradient once in its own dtype and sums in fp32 (no fp32 copy of a
    gradient; a fixed order of partial sums, so the same bits on every
    run), then the norm of those norms.  A model split over mp: each rank
    holds the gradients of its shards (parameters marked ``mp_split``)
    and copies of the others; the shards' squared norms are summed over
    the group they are split over (the parameter's ``mp_group``: one fp32
    all-reduce), the copies' counted once.  Shards without a group, or
    over two groups, raise."""
    grads = [g for _, g in params_grads if g is not None]
    if not grads:
        return None
    split = [(p, g) for p, g in params_grads
             if g is not None and getattr(p, "mp_split", False)]
    if not split:
        norms = torch._foreach_norm(grads, 2.0, dtype=torch.float32)
        return torch.linalg.vector_norm(torch.stack(norms))
    groups = {getattr(p, "mp_group", None) for p, _ in split}
    if None in groups or len(groups) > 1:
        raise ValueError(
            "ClipGradByGlobalNorm: gradients split over mp (mp_split) must "
            f"name the one group they are split over, not {groups}")
    from ..distributed import collective
    sq = _sq_sum([g for _, g in split])
    collective.all_reduce(sq, group=groups.pop())
    rest = [g for p, g in params_grads
            if g is not None and not getattr(p, "mp_split", False)]
    if rest:
        sq = sq + _sq_sum(rest)
    return sq.sqrt()


def _sq_sum(grads):
    norms = torch._foreach_norm(grads, 2.0, dtype=torch.float32)
    return torch.stack(norms).square().sum()


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
