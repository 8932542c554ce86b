"""Tensor placements on a mesh (port of
paddle_tpu/distributed/placement.py): `Shard`, `Replicate`, `Partial`,
`shardable_on`, and the rank's part of a global tensor under a
placement (`local_slice`).

JAX turns placements into a ``PartitionSpec`` for a ``NamedSharding``;
those have no counterpart here: a rank holds its part as an ordinary
tensor, and the placement records how the parts make the global tensor
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
