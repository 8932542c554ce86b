"""SegmentParallel (port of paddle_tpu/distributed/fleet/meta_parallel/
segment_parallel.py): the model wrapper of a sep (context-parallel)
layout.  The port runs sep 1 (a degree above raises in the topology,
ROADMAP A8): the parameters stay whole and record their placements; the
forward is the model's."""
from __future__ import annotations

from torch import nn

from ...mesh import get_mesh


class SegmentParallel(nn.Module):
    def __init__(self, layers, hcg=None, strategy=None):
        super().__init__()
        from ..base import _commit_params
        self._layers = layers
        mesh = get_mesh()
        if mesh is not None:
            _commit_params(layers, mesh)

    def forward(self, *args, **kwargs):
        return self._layers(*args, **kwargs)
