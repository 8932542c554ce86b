"""The single-program pipeline's structure check (port of paddle_tpu/
distributed/fleet/meta_parallel/pipeline_spmd.py): `NotHomogeneous`,
`homogenize` and `SPMDPipeline`.

JAX compiles the whole schedule into one ``shard_map`` program over the
``pp`` axis, which needs every stage's body to have one structure (the
parts are stacked ``[S, C, ...]`` and run through a template part).
`homogenize` decides that, as pure logic on the parts' signatures (each
item's class or callable name, its forward function's and its
parameters' shapes and dtypes), so ``schedule="spmd"`` refuses the
stages JAX refuses.

A torch process runs no single SPMD program: `SPMDPipeline` checks the
structure as JAX does, then the cross-rank 1F1B of `pipeline_parallel`
(`Host1F1B`) computes the same function.  A rank holds only its own
stage's parts, so the signatures of the others come from their ranks
(one object all-gather over the pp group at construction).  Unlike JAX,
`SPMDPipeline.parameters()` is the rank's stage parameters, not stacked
``[S, C, ...]`` tensors (compare the packages through ``state_dict``).
"""
from __future__ import annotations

from torch import nn


class NotHomogeneous(ValueError):
    """Stage parts cannot be stacked (heterogeneous structure)."""


class _Remote:
    """A part item held by another rank: its signature entry only."""

    def __init__(self, entry):
        self.entry = entry


def _part_items(part):
    return [(item, fwd) for item, fwd, _shared in part]


def _item_params(item):
    return list(item.parameters()) if isinstance(item, nn.Module) else []


def _entry(item, fwd):
    if isinstance(item, _Remote):
        return item.entry
    if isinstance(item, nn.Module):
        ident = type(item).__name__
    else:
        ident = getattr(item, "__qualname__", type(item).__name__)
    fident = (getattr(fwd, "__qualname__", repr(fwd))
              if fwd is not None else None)
    psig = tuple((tuple(p.shape), str(p.dtype).replace("torch.", ""))
                 for p in _item_params(item))
    return ident, fident, psig


def _sig(items):
    """Stackability signature: per-item structural identity (layer class /
    callable name, forward-func name) plus per-param (shape, dtype).
    Structure matters, not just parameters — stages with identical params
    but different param-free ops (ReLU vs Tanh) must NOT stack."""
    return tuple(_entry(item, fwd) for item, fwd in items)


def homogenize(parts):
    """Split execution-ordered parts into (pre_items, body_parts,
    post_items): strip leading items of the first part / trailing items of
    the last part until every part has the same param signature.  Raises
    NotHomogeneous when no such split exists (e.g. unequal blocks per
    stage)."""
    parts = [_part_items(p) for p in parts]
    if len(parts) < 2:
        raise NotHomogeneous("pipelining needs >= 2 parts")
    mid = [_sig(p) for p in parts[1:-1]]
    if mid and any(s != mid[0] for s in mid):
        raise NotHomogeneous(f"middle stage parts differ: {set(mid)}")
    target = mid[0] if mid else None

    first, last = list(parts[0]), list(parts[-1])
    pre, post = [], []
    if target is None:
        # two parts: strip first down until its sig matches last's remainder
        for cut in range(len(first) + 1):
            for rcut in range(len(last) + 1):
                body_f = first[cut:]
                body_l = last[:len(last) - rcut]
                if _sig(body_f) == _sig(body_l) and _sig(body_f):
                    return (first[:cut],
                            [body_f] + [body_l],
                            last[len(last) - rcut:])
        raise NotHomogeneous("no common stage structure between the 2 parts")
    while first and _sig(first) != target:
        pre.append(first.pop(0))
    while last and _sig(last) != target:
        post.insert(0, last.pop())
    if _sig(first) != target or _sig(last) != target or not target:
        raise NotHomogeneous(
            f"first/last stage parts irreducible to middle signature "
            f"(first={_sig(first)}, mid={target}, last={_sig(last)})")
    return pre, [first] + parts[1:-1] + [last], post


def global_parts(pipeline_layer):
    """Every part of ``pipeline_layer`` with the items of parts other
    ranks hold as their signature entries (`_Remote`), gathered over the
    pp group."""
    from ...compat import all_gather_object
    pl = pipeline_layer
    mine = {i: [_entry(item, fwd) for item, fwd, _ in part]
            for i, part in enumerate(pl._parts)
            if i % pl._num_stages in pl._local_stages}
    if pl._pp_group is None:
        return pl._parts
    gathered = []
    all_gather_object(gathered, mine, group=pl._pp_group)
    entries = {}
    for d in gathered:
        entries.update(d)
    return [part if i in mine else
            [(_Remote(e), None, shared)
             for e, (_, _, shared) in zip(entries[i], part)]
            for i, part in enumerate(pl._parts)]


class SPMDPipeline:
    """JAX's single-program schedule, here its structure check: raises
    `NotHomogeneous` where JAX's does (the mesh's pp axis against
    ``num_stages``, then `homogenize` of every part); the pipeline then
    runs the cross-rank 1F1B (`pipeline_parallel.Host1F1B`), the same
    function.  ``remat`` runs each stage's body under `recompute`."""

    def __init__(self, pipeline_layer, n_micro, remat=True):
        from ... import topology
        hcg = topology.get_hybrid_communicate_group()
        pp = 1 if hcg is None else hcg.get_pipe_parallel_world_size()
        self._pl = pipeline_layer
        self._S = pipeline_layer._num_stages
        self._C = pipeline_layer._num_chunks
        self._n_micro = n_micro
        self._remat = remat
        if pp != self._S:
            raise NotHomogeneous("mesh pp axis does not match num_stages")
        self.pre, self._body_parts, self.post = homogenize(
            global_parts(pipeline_layer))
        if not any(entry[2] for entry in _sig(self._body_parts[0])):
            raise NotHomogeneous("stage body has no parameters")

    def parameters(self):
        return list(self._pl.parameters())
