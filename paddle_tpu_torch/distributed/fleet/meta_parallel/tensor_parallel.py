"""TensorParallel (port of paddle_tpu/distributed/fleet/meta_parallel/
tensor_parallel.py): the model wrapper of an mp layout.  Each
tensor-parallel layer of ``layers`` keeps its shard over the topology's
mp group (a layer built before `fleet.init`, holding the global
parameters, is split now) and every parameter records its placements, as
`fleet.distributed_model` does; the forward is the model's."""
from __future__ import annotations

from torch import nn

from ...mesh import get_mesh
from ... import topology


class TensorParallel(nn.Module):
    def __init__(self, layers, hcg=None, strategy=None):
        super().__init__()
        from ..base import _commit_params
        from ..mp_layers import _MPLayer
        self._layers = layers
        group = topology.mp_group()
        for layer in layers.modules():
            if isinstance(layer, _MPLayer):
                layer.shard_(group)
        mesh = get_mesh()
        if mesh is not None:
            _commit_params(layers, mesh)

    def forward(self, *args, **kwargs):
        return self._layers(*args, **kwargs)
