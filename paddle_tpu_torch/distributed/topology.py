"""Hybrid-parallel topology (port of paddle_tpu/distributed/topology.py):
the degrees of each axis, the mesh of ranks over them and, unlike JAX
(where an axis group is a mesh axis name), the torch process groups of
the pipeline, data-parallel, sharding (ZeRO) and model-parallel axes.

The axes are JAX's, outermost to innermost: ``pp``, ``dp``,
``sharding``, ``sep``, ``mp``; rank = (((pp index × dp + dp index) ×
sharding + sharding index) × sep + sep index) × mp + mp index, so the
ranks of one mp group are neighbours (on a multi-card host, the cards
that share the most links), a sep group's ranks are mp apart and a
pipeline stage is a contiguous block of ranks.
"""
from __future__ import annotations

import collections
import itertools

import numpy as np

from . import env as _env
from .mesh import ProcessMesh, set_mesh

HYBRID_AXES = ("pp", "dp", "sharding", "sep", "mp")


def hybrid_degrees(ndev, dp_degree=-1, mp_degree=1, pp_degree=1,
                   sharding_degree=1, sep_degree=1):
    """``{axis: degree}`` for ``ndev`` ranks, JAX's rules: ``dp_degree``
    -1 (or None) fills whatever the other axes leave; an explicit one
    must make the product ``ndev``."""
    degrees = {"pp": pp_degree, "dp": dp_degree,
               "sharding": sharding_degree, "sep": sep_degree,
               "mp": mp_degree}
    rest = int(np.prod([v for k, v in degrees.items() if k != "dp"]))
    if dp_degree in (-1, None):
        if ndev % rest != 0:
            raise ValueError(
                f"cannot auto-fill dp: {ndev} devices not divisible by "
                f"mp*pp*sharding*sep product {rest}")
        degrees["dp"] = ndev // rest
    elif rest * dp_degree != ndev:
        raise ValueError(
            f"hybrid degrees {degrees} (product {rest * dp_degree}) "
            f"!= device count {ndev}; set dp_degree=-1 to auto-fill")
    return degrees


class HybridCommunicateGroup:
    """reference: fleet/base/topology.py:174.  ``devices`` (a list, one
    rank each) sizes the topology; None: the world.  Builds the mesh
    (set as the default, as JAX's does) and the dp, mp, sharding, pp
    and sep groups, in that order, so every rank constructs it alike."""

    def __init__(self, dp_degree=-1, mp_degree=1, pp_degree=1,
                 sharding_degree=1, sep_degree=1, devices=None):
        world = _env.get_world_size()
        ndev = len(devices) if devices is not None else world
        degrees = hybrid_degrees(ndev, dp_degree, mp_degree, pp_degree,
                                 sharding_degree, sep_degree)
        if ndev != world:
            raise ValueError(f"HybridCommunicateGroup: {ndev} devices, but "
                             f"the world has {world} ranks (a rank is a "
                             "process with one device)")
        self._degrees = degrees
        shape = [degrees[a] for a in HYBRID_AXES]
        self.mesh = ProcessMesh(np.arange(ndev).reshape(shape),
                                list(HYBRID_AXES))
        # every rank builds the groups in this order
        self._dp_group = self.mesh.get_group("dp")
        self._mp_group = self.mesh.get_group("mp")
        self._sharding_group = self.mesh.get_group("sharding")
        self._pp_group = self.mesh.get_group("pp")
        self._sep_group = self.mesh.get_group("sep")
        set_mesh(self.mesh)

    # ---- degrees (reference: topology.py:180-184) ----
    def get_data_parallel_world_size(self):
        return self._degrees["dp"]

    def get_model_parallel_world_size(self):
        return self._degrees["mp"]

    def get_pipe_parallel_world_size(self):
        return self._degrees["pp"]

    def get_sharding_parallel_world_size(self):
        return self._degrees["sharding"]

    def get_sep_parallel_world_size(self):
        return self._degrees["sep"]

    @property
    def nranks(self):
        return int(np.prod(list(self._degrees.values())))

    # ---- this rank's place ----
    def get_data_parallel_rank(self):
        return self.mesh.get_coord("dp")

    def get_model_parallel_rank(self):
        return self.mesh.get_coord("mp")

    def get_sharding_parallel_rank(self):
        return self.mesh.get_coord("sharding")

    def get_pipe_parallel_rank(self):
        """This rank's pipeline stage."""
        return self.mesh.get_coord("pp")

    def get_sep_parallel_rank(self):
        """This rank's sequence chunk (its index on the sep axis)."""
        return self.mesh.get_coord("sep")

    # ---- groups (JAX: the axis names; here the process groups) ----
    def get_data_parallel_group(self):
        return self._dp_group

    def get_model_parallel_group(self):
        return self._mp_group

    def get_sharding_parallel_group(self):
        return self._sharding_group

    def get_pipe_parallel_group(self):
        return self._pp_group

    def get_sep_parallel_group(self):
        return self._sep_group

    def get_check_parallel_group(self):
        return tuple(a for a, d in self._degrees.items() if d > 1)

    def topology(self):
        return dict(self._degrees)

    def __repr__(self):
        return f"HybridCommunicateGroup({self._degrees})"


_HCG: list = [None]


def set_hybrid_communicate_group(hcg):
    _HCG[0] = hcg


def get_hybrid_communicate_group():
    return _HCG[0]


def mp_group():
    """The model-parallel group of the current topology (None without
    one)."""
    hcg = _HCG[0]
    return None if hcg is None else hcg.get_model_parallel_group()


def sharding_group():
    """The sharding (ZeRO) group of the current topology (None without
    one)."""
    hcg = _HCG[0]
    return None if hcg is None else hcg.get_sharding_parallel_group()


def dp_group():
    """The data-parallel group of the current topology (None without
    one)."""
    hcg = _HCG[0]
    return None if hcg is None else hcg.get_data_parallel_group()


def sep_group():
    """The sep (context-parallel) group of the current topology (None
    without one)."""
    hcg = _HCG[0]
    return None if hcg is None else hcg.get_sep_parallel_group()


class CommunicateTopology:
    """Named-axis hybrid topology: coordinate <-> rank arithmetic
    (reference: fleet/base/topology.py:61), row-major over the axis order
    given."""

    def __init__(self, hybrid_group_names=("data", "pipe", "sharding",
                                           "sep", "model"),
                 dims=(1, 1, 1, 1, 1)):
        self._parallel_names = list(hybrid_group_names)
        self._dims = list(dims)
        self._world_size = int(np.prod(self._dims))
        self._strides = []
        acc = 1
        for d in reversed(self._dims):
            self._strides.append(acc)
            acc *= d
        self._strides.reverse()

    def get_hybrid_group_names(self):
        return self._parallel_names

    def get_dim(self, axis_name):
        return self._dims[self._parallel_names.index(axis_name)]

    get_dim_size = get_dim

    def world_size(self):
        return self._world_size

    def get_rank(self, **coords):
        if sorted(coords) != sorted(self._parallel_names):
            raise ValueError(f"need every axis of {self._parallel_names}")
        rank = 0
        for name, stride, dim in zip(self._parallel_names, self._strides,
                                     self._dims):
            c = coords[name]
            if not 0 <= c < dim:
                raise ValueError(f"{name}={c} out of range {dim}")
            rank += c * stride
        return rank

    def get_coord(self, rank):
        if not 0 <= rank < self._world_size:
            raise ValueError(f"rank {rank} out of range")
        coordinate = collections.namedtuple("Coordinate",
                                            self._parallel_names)
        return coordinate(*[(rank // stride) % dim for stride, dim in
                            zip(self._strides, self._dims)])

    def get_axis_list(self, axis_name, index):
        """All ranks whose coordinate on ``axis_name`` equals ``index``."""
        axis = self._parallel_names.index(axis_name)
        return sorted(r for r in range(self._world_size)
                      if self.get_coord(r)[axis] == index)

    def get_fused_ranks(self, fused_axis):
        """Rank groups that vary only over ``fused_axis``."""
        fixed = [n for n in self._parallel_names if n not in fused_axis]
        groups = []
        fixed_ranges = [range(self.get_dim(n)) for n in fixed]
        fused_ranges = [range(self.get_dim(n)) for n in fused_axis]
        for fixed_vals in itertools.product(*fixed_ranges):
            group = []
            for fused_vals in itertools.product(*fused_ranges):
                coords = dict(zip(fixed, fixed_vals))
                coords.update(dict(zip(fused_axis, fused_vals)))
                group.append(self.get_rank(**coords))
            groups.append(sorted(group))
        return groups
