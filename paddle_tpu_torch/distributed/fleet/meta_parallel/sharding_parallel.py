"""ShardingParallel (port of paddle_tpu/distributed/fleet/meta_parallel/
sharding_parallel.py): the ZeRO entry of ``distributed_model``.

It commits the layers' placements over the topology's mesh: at stage 3
(``strategy.sharding_configs["stage"]``) each parameter whose dim 0
tiles over the sharding axis keeps its rows, gathered on use; at stages
1 and 2 the parameters stay whole (the optimizer's state is sharded by
``fleet.group_sharded_parallel``).  See `fleet.sharding`."""
from __future__ import annotations

from torch import nn

from ...mesh import get_mesh


class ShardingParallel(nn.Module):
    def __init__(self, layers, hcg=None, strategy=None):
        super().__init__()
        self._layers = layers
        from ..base import _commit_params
        stage = 1
        if strategy is not None:
            stage = int(getattr(strategy, "sharding_configs",
                                {}).get("stage", 1))
        mesh = get_mesh()
        if mesh is not None:
            _commit_params(layers, mesh,
                           shard_axis="sharding" if stage >= 3 else None)

    def forward(self, *args, **kwargs):
        return self._layers(*args, **kwargs)
