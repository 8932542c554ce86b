"""Fleet facade (port of paddle_tpu/distributed/fleet/base.py): ``init``,
``distributed_model``, ``distributed_optimizer``.

`init` joins the process group (`distributed.env.init_parallel_env`,
which reads the JAX package's variables) and builds the hybrid topology
(`distributed.topology.HybridCommunicateGroup`: the mesh, the dp and mp
groups) from the strategy's degrees.  `distributed_model` puts a model on
this rank: every tensor-parallel layer keeps only its shard (a layer
built before `init`, holding the global parameters, is split now; one
built after is checked), and a model with its own hook
(``_bind_topology``) takes its rank's place.  Every parameter then
records its placements (`_commit_params`, JAX's rule); under a strategy
with ``sharding`` (or ``sharding_configs["stage"] >= 3``) that is the
ZeRO-3 layout: the rank keeps the rows of each parameter whose dim 0
tiles over the sharding axis and is not split by mp, gathered on use
(`fleet.sharding`).  The gradient sync over dp and the mp-aware clip
are the train step's (`framework.train_step.CompiledTrainStep` with the
mesh, or `hapi.Model`) or, under ZeRO, the optimizer's
(`fleet.group_sharded_parallel`), so `distributed_optimizer` returns
the optimizer as JAX's does.  A `PipelineLayer` is wrapped as JAX wraps
it: `PipelineParallelWithInterleave` with virtual stages, else
`PipelineParallel` with more than one stage; at a sep degree above 1
the model is wrapped in `SegmentParallel` (the reference's dispatch),
which averages the gradients over dp × sep after each backward.

`Role`, `UtilBase` (the collective utilities over the world: numbers,
objects, a file shard a worker) and `Fleet` (the stateful facade over the
module's functions, its ``util`` a `UtilBase`) are JAX's.
"""
from __future__ import annotations

import dataclasses

from .. import env as _env
from ..mesh import get_mesh
from ..placement import commit_param, held_placements
from ..topology import (HybridCommunicateGroup, get_hybrid_communicate_group,
                        set_hybrid_communicate_group)


@dataclasses.dataclass
class HybridConfig:
    dp_degree: int = -1
    mp_degree: int = 1
    pp_degree: int = 1
    sharding_degree: int = 1
    sep_degree: int = 1


class DistributedStrategy:
    """reference: fleet/base/distributed_strategy.py:121."""

    def __init__(self):
        self.hybrid_configs = {"dp_degree": -1, "mp_degree": 1,
                               "pp_degree": 1, "sharding_degree": 1,
                               "sep_degree": 1}
        self.amp = False
        self.amp_configs = {"init_loss_scaling": 32768.0,
                            "use_pure_bf16": True}
        self.recompute = False
        self.recompute_configs = {}
        self.sharding = False
        self.sharding_configs = {"sharding_degree": 1, "stage": 1}
        self.pipeline = False
        self.pipeline_configs = {"accumulate_steps": 1,
                                 "micro_batch_size": 1}
        self.gradient_merge = False
        self.gradient_merge_configs = {"k_steps": 1}
        self.lamb = False
        self.localsgd = False
        self.find_unused_parameters = False

    def __repr__(self):
        return f"DistributedStrategy(hybrid={self.hybrid_configs})"


_fleet_state = {"initialized": False, "strategy": None}


def init(role_maker=None, is_collective=True, strategy=None,
         log_level="INFO", *, backend=None, device=None):
    """reference: fleet/fleet.py:169.  ``backend`` and ``device`` (the
    port's) go to `init_parallel_env`; every rank calls it alike."""
    _env.init_parallel_env(backend=backend, device=device)
    strategy = strategy or DistributedStrategy()
    cfg = strategy.hybrid_configs
    hcg = HybridCommunicateGroup(
        dp_degree=cfg.get("dp_degree", -1),
        mp_degree=cfg.get("mp_degree", 1),
        pp_degree=cfg.get("pp_degree", 1),
        sharding_degree=cfg.get("sharding_degree", 1),
        sep_degree=cfg.get("sep_degree", 1))
    set_hybrid_communicate_group(hcg)
    _fleet_state["initialized"] = True
    _fleet_state["strategy"] = strategy
    return hcg


def get_hybrid_communicate_group_():
    return get_hybrid_communicate_group()


def _commit_params(model, mesh, shard_axis=None):
    """Commit every parameter to the mesh (JAX's rule): a tensor-parallel
    layer's by its ``mp_placement``, the others replicated; with
    ``shard_axis`` each also ``Shard(0)`` over it when dim 0 tiles evenly
    and mp does not split dim 0 (`sharding.shard_parameters`), its rows
    kept and gathered on use."""
    for _, p in model.named_parameters():
        placements = held_placements(p, mesh)
        ann = getattr(p, "mp_placement", None)
        if ann is not None and ann[0] in mesh.dim_names:
            placements[mesh.dim_names.index(ann[0])] = ann[1]
        commit_param(p, mesh, placements)
    if shard_axis is not None and shard_axis in mesh.dim_names:
        from .sharding import shard_parameters
        shard_parameters(list(model.parameters()), shard_axis, mesh,
                         layer=model)
    return model


def _stage3(strategy):
    return strategy is not None and (
        strategy.sharding or strategy.sharding_configs.get("stage", 0) >= 3)


def distributed_model(model):
    """reference: fleet/model.py:31.  Splits (or checks) every
    tensor-parallel layer's parameters over the topology's mp group, lets
    the model bind its rank (``_bind_topology``) and commits every
    parameter's placements (the ZeRO-3 layout under a sharding strategy);
    returns the model, a `PipelineLayer` wrapped for its schedule, a
    model at sep > 1 in `SegmentParallel` (``fleet.init`` first when it
    was not called)."""
    from .meta_parallel import (PipelineLayer, PipelineParallel,
                                PipelineParallelWithInterleave)
    from .mp_layers import _MPLayer
    if not _fleet_state["initialized"]:
        init()
    hcg = get_hybrid_communicate_group()
    group = hcg.get_model_parallel_group()
    for layer in model.modules():
        if isinstance(layer, _MPLayer):
            layer.shard_(group)
    bind = getattr(model, "_bind_topology", None)
    if bind is not None:
        bind(hcg)
    strategy = _fleet_state["strategy"]
    if isinstance(model, PipelineLayer):
        _commit_params(model, get_mesh())
        if model._num_chunks > 1:
            return PipelineParallelWithInterleave(model, hcg=hcg,
                                                  strategy=strategy)
        if model.get_num_stages() > 1:
            return PipelineParallel(model, hcg=hcg, strategy=strategy)
        return model
    _commit_params(model, get_mesh(),
                   "sharding" if _stage3(strategy) else None)
    if hcg.get_sep_parallel_world_size() > 1:
        from .meta_parallel import SegmentParallel
        return SegmentParallel(model, hcg=hcg, strategy=strategy)
    return model


def distributed_optimizer(optimizer, strategy=None):
    """reference: fleet/fleet.py:1059.  The optimizer as it is: each rank
    updates its own shards; the dp average and the clip across mp run in
    the train step."""
    return optimizer


class UserDefinedRoleMaker:
    def __init__(self, **kwargs):
        self.kwargs = kwargs


class PaddleCloudRoleMaker:
    def __init__(self, is_collective=True, **kwargs):
        self.is_collective = is_collective


def worker_index():
    return _env.get_rank()


def worker_num():
    return _env.get_world_size()


def is_first_worker():
    return _env.get_rank() == 0


def barrier_worker():
    from ..collective import barrier
    barrier()


class Role:
    """reference: fleet/base/role_maker.py:33."""
    WORKER = 1
    SERVER = 2
    HETER_WORKER = 3
    ALL = 4
    COORDINATOR = 5


class UtilBase:
    """reference: fleet/base/util_factory.py:49 — collective utilities
    over the world's ranks."""

    def __init__(self):
        self.role_maker = None
        self.dist_strategy = None

    def _set_strategy(self, dist_strategy):
        self.dist_strategy = dist_strategy

    def _set_role_maker(self, role_maker):
        self.role_maker = role_maker

    def all_reduce(self, input, mode="sum", comm_world="worker"):  # noqa: A002
        """``input`` (a number, array or tensor) reduced over the world
        (``mode`` sum, max or min), as a numpy array."""
        import numpy as np
        import torch
        from .. import collective as C
        t = torch.as_tensor(np.asarray(
            input.detach().cpu() if torch.is_tensor(input) else input))
        t = t.to(_env.current_device())
        op = {"sum": C.ReduceOp.SUM, "max": C.ReduceOp.MAX,
              "min": C.ReduceOp.MIN}[mode]
        C.all_reduce(t, op=op)
        return t.cpu().numpy()

    def barrier(self, comm_world="worker"):
        from .. import collective as C
        C.barrier()

    def all_gather(self, input, comm_world="worker"):  # noqa: A002
        """Every rank's ``input`` (any picklable object), in rank order."""
        from ..compat import all_gather_object
        out = []
        all_gather_object(out, input)
        return out

    def get_file_shard(self, files):
        """Contiguous file shard for this worker (reference:
        util_factory.get_file_shard)."""
        n, w, r = len(files), _env.get_world_size(), _env.get_rank()
        base, rem = divmod(n, w)
        start = r * base + min(r, rem)
        return files[start:start + base + (1 if r < rem else 0)]

    def print_on_rank(self, message, rank_id):
        if _env.get_rank() == rank_id:
            print(message)


class Fleet:
    """reference: fleet/fleet.py:99 — the stateful facade behind the
    module-level fleet.init/distributed_model/... functions; exposed for
    users who instantiate it directly."""

    def __init__(self):
        self._util = UtilBase()
        self._strategy = None

    def init(self, role_maker=None, is_collective=True, strategy=None,
             log_level="INFO", *, backend=None, device=None):
        self._strategy = strategy
        return init(role_maker, is_collective=is_collective,
                    strategy=strategy, log_level=log_level, backend=backend,
                    device=device)

    def distributed_model(self, model):
        return distributed_model(model)

    def distributed_optimizer(self, optimizer, strategy=None):
        return distributed_optimizer(optimizer, strategy=strategy)

    def worker_index(self):
        return worker_index()

    def worker_num(self):
        return worker_num()

    def is_first_worker(self):
        return is_first_worker()

    def barrier_worker(self):
        return barrier_worker()

    @property
    def util(self):
        return self._util
