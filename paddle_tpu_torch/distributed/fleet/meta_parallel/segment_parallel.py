"""SegmentParallel (port of paddle_tpu/distributed/fleet/meta_parallel/
segment_parallel.py): the model wrapper of a sep (context-parallel)
layout.  The parameters stay whole on every rank of a sep group and
record their placements; each rank runs its chunk of the sequence (the
parallel models cut it, `models.gpt_parallel`), so its gradients are its
chunk's part.  After each backward they are averaged over the ranks that
hold copies of the parameters along the data axes, dp × sep
(`distributed.parallel.DataParallel`'s sync: a rank's loss is the mean
over its chunk, and the mean of the chunks' means is the global mean
when the chunks hold equal counts of labelled tokens).  JAX needs no
sync: GSPMD sums over sep inside its program.

`fleet.distributed_model` wraps a model in it when the topology's sep
degree is above 1 (the reference's dispatch, fleet/model.py); attributes
the wrapper lacks are the model's (``generate``, ``config``, ...), and
its state dict is the model's.  At sep 1 it syncs nothing.
"""
from __future__ import annotations

from ... import topology
from ...mesh import get_mesh
from ...parallel import DataParallel


def sep_data_group(hcg):
    """The group of ranks holding the same parameters along dp and sep
    (this rank's dp group at sep 1)."""
    if hcg.get_sep_parallel_world_size() <= 1:
        return hcg.get_data_parallel_group()
    if hcg.get_data_parallel_world_size() <= 1:
        return hcg.get_sep_parallel_group()
    return hcg.mesh.get_group(("dp", "sep"))


class SegmentParallel(DataParallel):
    def __init__(self, layers, hcg=None, strategy=None):
        from ..base import _commit_params
        from ...context_parallel import check_sep_pp
        hcg = hcg or topology.get_hybrid_communicate_group()
        group = None
        if hcg is not None and hcg.get_sep_parallel_world_size() > 1:
            check_sep_pp(hcg)
            group = sep_data_group(hcg)
        super().__init__(layers, group=group)
        if group is None:
            self.group = None
        mesh = get_mesh()
        if mesh is not None:
            _commit_params(layers, mesh)

    def forward(self, *args, **kwargs):
        if self.group is None:
            return self._layers(*args, **kwargs)
        return super().forward(*args, **kwargs)

    def __getattr__(self, name):
        try:
            return super().__getattr__(name)
        except AttributeError:
            return getattr(self._modules["_layers"], name)
