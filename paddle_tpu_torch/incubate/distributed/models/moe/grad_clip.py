"""MoE-aware global-norm gradient clipping (port of paddle_tpu/incubate/
distributed/models/moe/grad_clip.py; reference: moe/grad_clip.py:56):
every expert counted exactly once in the global norm.

The stacked experts are split over mp (`ExpertFFN`: each parameter
``mp_split`` with its ``mp_group``), so `nn.clip.ClipGradByGlobalNorm`
already sums their squares over the mp group and counts the copies
(the gate, list experts, the dense layers' copies) once: what remains
is the reference's API, a clip usable as any optimizer's
``grad_clip=``, with ``is_expert_param_func`` and ``moe_group`` kept as
given (the norm needs neither)."""
from __future__ import annotations

from .....nn.clip import ClipGradByGlobalNorm


class ClipGradForMOEByGlobalNorm(ClipGradByGlobalNorm):
    """reference: moe/grad_clip.py:56."""

    def __init__(self, clip_norm, is_expert_param_func=None,
                 moe_group=None, group_name="default_moe_group"):
        super().__init__(clip_norm, group_name=group_name)
        self.is_expert_param_func = is_expert_param_func
        self.moe_group = moe_group


ClipGradForMoEByGlobalNorm = ClipGradForMOEByGlobalNorm
