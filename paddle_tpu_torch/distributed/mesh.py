"""The process mesh (port of paddle_tpu/distributed/mesh.py): an N-D
arrangement of ranks with named axes, the substrate the hybrid layout
shards over.

``ProcessMesh(mesh, dim_names)`` holds ranks (integers: here a rank is a
process with its one device).  JAX's ``jax_mesh`` has no counterpart;
instead `get_group` gives the process group of this rank's line along an
axis (the ranks whose other coordinates equal this rank's), building the
groups of every line of that axis at its first call, so every rank of
the world must make that first call alike (torch's ``new_group`` rule).
"""
from __future__ import annotations

from contextlib import contextmanager

import numpy as np

from . import env as _env


class ProcessMesh:
    """N-D named rank mesh (reference: process_mesh.h:31).  ``mesh``: an
    array of ranks shaped like the topology; ``dim_names``: one name per
    axis, e.g. ``["dp", "mp"]``."""

    def __init__(self, mesh, dim_names=None, process_ids=None):
        arr = np.asarray(mesh)
        if dim_names is None:
            dim_names = [f"d{i}" for i in range(arr.ndim)]
        if len(dim_names) != arr.ndim:
            raise ValueError(
                f"dim_names {dim_names} does not match mesh ndim {arr.ndim}")
        self._shape = tuple(arr.shape)
        self._dim_names = tuple(dim_names)
        self._process_ids = arr.astype(np.int64)
        self._groups = {}

    @property
    def shape(self):
        return list(self._shape)

    @property
    def ndim(self):
        return len(self._shape)

    @property
    def dim_names(self):
        return list(self._dim_names)

    @property
    def process_ids(self):
        return [int(x) for x in self._process_ids.flat]

    @property
    def mesh(self):
        return self._process_ids

    def get_dim_size(self, name):
        return self._shape[self._dim_names.index(name)]

    def coord(self, rank=None):
        """This rank's (or ``rank``'s) coordinate on each axis."""
        rank = _env.get_rank() if rank is None else rank
        hit = np.argwhere(self._process_ids == rank)
        if not len(hit):
            raise ValueError(f"rank {rank} is not in {self}")
        return tuple(int(c) for c in hit[0])

    def get_coord(self, name, rank=None):
        """This rank's index along axis ``name``."""
        return self.coord(rank)[self._dim_names.index(name)]

    def lines(self, name):
        """Every line of ranks along axis ``name``, each in axis order;
        ``name`` a tuple of axes: the blocks of ranks that differ only
        on those axes (row-major over them, in the tuple's order)."""
        names = (name,) if isinstance(name, str) else tuple(name)
        axes = [self._dim_names.index(n) for n in names]
        moved = np.moveaxis(self._process_ids, axes,
                            list(range(-len(axes), 0)))
        width = int(np.prod([self._shape[a] for a in axes]))
        return [[int(r) for r in line]
                for line in moved.reshape(-1, width)]

    def get_group(self, name):
        """The `collective.Group` of this rank's line along ``name`` (an
        axis, or a tuple of axes: `lines`); the groups of all its lines
        are built at the first call."""
        if name not in self._groups:
            from .collective import Group, new_group
            me, world = _env.get_rank(), _env.get_world_size()
            for line in self.lines(name):
                g = Group(line) if len(line) == 1 or \
                    line == list(range(world)) else new_group(line)
                if me in line:
                    self._groups[name] = g
        return self._groups[name]

    def __eq__(self, other):
        return (isinstance(other, ProcessMesh)
                and self._dim_names == other._dim_names
                and np.array_equal(self._process_ids, other._process_ids))

    def __hash__(self):
        return hash((self._dim_names, self._process_ids.tobytes()))

    def __repr__(self):
        return (f"ProcessMesh(shape={list(self._shape)}, "
                f"dim_names={list(self._dim_names)})")

    def __enter__(self):
        _MESH_STACK.append(self)
        return self

    def __exit__(self, *exc):
        _MESH_STACK.pop()


_MESH_STACK: list = []
_DEFAULT: list = [None]


def get_mesh():
    """The innermost ``with mesh:`` scope, else the default set by
    `set_mesh` (or `fleet.init`)."""
    if _MESH_STACK:
        return _MESH_STACK[-1]
    return _DEFAULT[0]


def set_mesh(mesh):
    _DEFAULT[0] = mesh


@contextmanager
def suspended():
    """Lift the scoped and the default mesh for the body."""
    saved_stack = _MESH_STACK[:]
    saved_default = _DEFAULT[0]
    del _MESH_STACK[:]
    _DEFAULT[0] = None
    try:
        yield
    finally:
        _MESH_STACK[:] = saved_stack
        _DEFAULT[0] = saved_default


def init_mesh(shape, dim_names, devices=None):
    """A mesh over the first prod(shape) ranks of ``devices`` (None: the
    world's ranks), in order."""
    ranks = list(range(_env.get_world_size())) if devices is None \
        else [int(d) for d in devices]
    n = int(np.prod(shape))
    if n > len(ranks):
        raise ValueError(f"mesh shape {shape} needs {n} devices, "
                         f"have {len(ranks)}")
    return ProcessMesh(np.array(ranks[:n]).reshape(shape), dim_names)
