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
    run), then the norm of those norms.  A gradient may be a part of the
    global one: of a parameter split over mp (``mp_split``: the group is
    its ``mp_group``), or the rows a ZeRO optimizer reads of it over the
    sharding group (``zero_group``), or both.  Each part's squared norm
    is summed over the groups that split it (one fp32 all-reduce of the
    stacked sums a group), and copies are counted once.  An mp-split
    parameter without its group raises.  A pipeline stage's parameters
    (``pp_group``) are a part of the model: the stage's squared norm is
    summed over the pp group (one fp32 all-reduce), a tied weight's later
    copies (``pp_tied_copy``) left out."""
    live = [(p, g) for p, g in params_grads if g is not None]
    if not live:
        return None
    pp = next((p.pp_group for p, _ in live
               if getattr(p, "pp_group", None) is not None), None)
    if pp is not None:
        sq = _stage_sq([(p, g) for p, g in live
                        if not getattr(p, "pp_tied_copy", False)])
        sq = torch.zeros(1, dtype=torch.float32, device=live[0][1].device) \
            if sq is None else sq.reshape(1).clone()
        from ..distributed import collective
        collective.all_reduce(sq, group=pp)
        return sq[0].sqrt()
    if not any(_split_groups(p) for p, _ in live):
        norms = torch._foreach_norm([g for _, g in live], 2.0,
                                    dtype=torch.float32)
        return torch.linalg.vector_norm(torch.stack(norms))
    return _stage_sq(live).sqrt()


def _stage_sq(params_grads):
    """The squared norm of ``params_grads`` summed over the groups that
    split them (`global_norm`'s rule); None without gradients."""
    grads = [g for _, g in params_grads if g is not None]
    if not grads:
        return None
    cats = {}
    for p, g in params_grads:
        if g is not None:
            cats.setdefault(_split_groups(p), []).append(g)
    from ..distributed import collective
    keys = list(cats)
    sums = [_sq_sum(cats[k]) for k in keys]
    groups = []
    for k in keys:
        groups += [g for g in k if all(g is not h for h in groups)]
    for group in groups:
        idx = [i for i, k in enumerate(keys) if any(g is group for g in k)]
        v = torch.stack([sums[i] for i in idx])
        collective.all_reduce(v, group=group)
        for j, i in enumerate(idx):
            sums[i] = v[j]
    return torch.stack(sums).sum()


def _split_groups(p):
    """The groups a parameter's gradient is split over: its ZeRO group,
    then its mp group (groups of one rank left out)."""
    out = []
    zg = getattr(p, "zero_group", None)
    if zg is not None and zg.nranks > 1:
        out.append(zg)
    if getattr(p, "mp_split", False):
        mg = getattr(p, "mp_group", None)
        if mg is None:
            raise ValueError(
                "ClipGradByGlobalNorm: gradients split over mp (mp_split) "
                "must name the one group they are split over (mp_group)")
        out.append(mg)
    return tuple(out)


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
