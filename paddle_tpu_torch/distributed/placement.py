"""Tensor placements on a mesh (port of
paddle_tpu/distributed/placement.py): `Shard`, `Replicate`, `Partial`,
`shardable_on`, the spec of a placement (`placements_to_spec`,
`spec_to_placements`), the rank's part of a global tensor under a
placement (`local_slice`) and `commit_param`, the one write path of a
parameter's placement.

JAX turns placements into a ``PartitionSpec`` for a ``NamedSharding``;
here a spec is a plain tuple (one entry a tensor dim: None, an axis name
or a tuple of names), and a rank holds its part as an ordinary tensor:
the placement records how the parts make the global tensor
(`convert.shard_paddle_tpu_state` and `gather_paddle_tpu_state` read it).
"""
from __future__ import annotations


class Placement:
    def is_shard(self, dim=None):
        return False

    def is_replicate(self):
        return False

    def is_partial(self):
        return False


class Replicate(Placement):
    def is_replicate(self):
        return True

    def __repr__(self):
        return "Replicate()"

    def __eq__(self, other):
        return isinstance(other, Replicate)

    def __hash__(self):
        return hash("Replicate")


class Shard(Placement):
    def __init__(self, dim):
        self.dim = dim

    def is_shard(self, dim=None):
        return dim is None or dim == self.dim

    def get_dim(self):
        return self.dim

    def __repr__(self):
        return f"Shard(dim={self.dim})"

    def __eq__(self, other):
        return isinstance(other, Shard) and other.dim == self.dim

    def __hash__(self):
        return hash(("Shard", self.dim))


class Partial(Placement):
    def __init__(self, reduce_type="sum"):
        self.reduce_type = reduce_type

    def is_partial(self):
        return True

    def __repr__(self):
        return f"Partial({self.reduce_type})"

    def __eq__(self, other):
        return (isinstance(other, Partial)
                and other.reduce_type == self.reduce_type)

    def __hash__(self):
        return hash(("Partial", self.reduce_type))


def shardable_on(shape, mesh, axis, dim=0):
    """Whether ``shape`` tiles evenly over mesh axis ``axis`` along
    ``dim``."""
    deg = mesh.get_dim_size(axis)
    return (deg > 1 and len(shape) > dim and shape[dim] % deg == 0
            and shape[dim] >= deg)


def shard_bounds(size, parts, index):
    """``[start, stop)`` of part ``index`` of ``parts`` equal parts of
    ``size`` (raises when they are not equal)."""
    if size % parts:
        raise ValueError(f"a dimension of {size} does not split into "
                         f"{parts} equal parts")
    step = size // parts
    return index * step, (index + 1) * step


def local_slice(tensor, mesh, placements, rank=None):
    """The part of global ``tensor`` (torch or numpy) that ``rank`` (None:
    this one) holds under ``placements`` (one a mesh axis); a dim sharded
    over several axes splits in mesh-axis order."""
    coord = mesh.coord(rank)
    index = [slice(None)] * tensor.ndim
    sizes = list(tensor.shape)
    starts = [0] * tensor.ndim
    for axis, p in enumerate(placements):
        if isinstance(p, Shard):
            d = p.dim % tensor.ndim
            lo, hi = shard_bounds(sizes[d], mesh.shape[axis], coord[axis])
            starts[d] += lo
            sizes[d] = hi - lo
            index[d] = slice(starts[d], starts[d] + sizes[d])
    return tensor[tuple(index)]


def placements_to_spec(mesh, placements, ndim):
    """[Placement a mesh axis] → spec, a tuple with an entry a tensor
    dim: None, the axis name it is split over, or a tuple of names (in
    mesh-axis order); trailing Nones dropped, as JAX's ``PartitionSpec``
    entries."""
    entries: list = [None] * ndim
    for axis_idx, p in enumerate(placements):
        if isinstance(p, Shard):
            d = p.dim if p.dim >= 0 else p.dim + ndim
            name = mesh.dim_names[axis_idx]
            if entries[d] is None:
                entries[d] = name
            elif isinstance(entries[d], tuple):
                entries[d] = entries[d] + (name,)
            else:
                entries[d] = (entries[d], name)
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def spec_to_placements(mesh, spec, ndim):
    """The inverse of `placements_to_spec` (a Partial never round-trips:
    a spec has no entry for it)."""
    placements = [Replicate() for _ in mesh.dim_names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        names = entry if isinstance(entry, tuple) else (entry,)
        for name in names:
            placements[mesh.dim_names.index(name)] = Shard(d)
    return placements


def held_placements(param, mesh):
    """The placements ``param``'s data has now: its committed ones, else
    its tensor-parallel layer's split over mp (``mp_placement`` when
    ``mp_split``), else every axis replicated."""
    held = getattr(param, "placements", None)
    if held and getattr(param, "process_mesh", None) == mesh:
        return list(held)
    out = [Replicate() for _ in mesh.dim_names]
    ann = getattr(param, "mp_placement", None)
    if ann is not None and ann[0] in mesh.dim_names and \
            getattr(param, "mp_split", False):
        out[mesh.dim_names.index(ann[0])] = ann[1]
    return out


def commit_param(param, mesh, placements=None):
    """The one write path of a parameter's placement (JAX's, shared by
    ``fleet.distributed_model``, `api.shard_layer` and ZeRO's
    ``shard_parameters``): the rank keeps its part of each axis that
    ``placements`` shards and ``param`` holds whole now (a new
    contiguous tensor of its own, ``param`` keeps its identity), and
    ``param`` records ``placements``, ``process_mesh`` and
    ``is_dist_param``.  None: the placements it holds.  A part it holds
    cannot be made whole here (a gather: `api.reshard`), nor can a dim
    that an axis splits already be split by another."""
    held = held_placements(param, mesh)
    if placements is None:
        placements = held
    placements = list(placements)
    coord = mesh.coord()
    data = param.data
    for axis, (old, new) in enumerate(zip(held, placements)):
        if old == new or mesh.shape[axis] == 1:
            continue
        if isinstance(new, Partial) or isinstance(old, Partial):
            raise NotImplementedError(
                "commit_param: Partial is a reshard state, not a "
                "parameter placement")
        if isinstance(old, Shard):
            raise ValueError(
                f"commit_param: {mesh.dim_names[axis]} holds a part "
                f"({old}); a parameter is not gathered here")
        d = new.dim % data.dim()
        if any(isinstance(p, Shard) and p.dim % data.dim() == d
               for i, p in enumerate(held) if i != axis):
            raise ValueError(
                f"commit_param: dim {d} is split over another axis "
                f"already; it cannot be split over {mesh.dim_names[axis]}")
        lo, hi = shard_bounds(data.shape[d], mesh.shape[axis], coord[axis])
        data = data.narrow(d, lo, hi - lo)
    if data is not param.data:
        param.data = data.contiguous().clone()
    param.placements = placements
    param.process_mesh = mesh
    param.is_dist_param = True
    return param
