"""Elastic world-size resharding for checkpoints (port of
paddle_tpu/distributed/reshard.py).

A committed checkpoint's manifest (`framework.checkpoint_manager`'s
commit protocol) carries a **layout section**: each array's global shape,
dtype and partition over a named mesh, and the per-rank shard files.  A
restore on any dp×mp factorisation of another world size computes, per
array, the overlap of every saved shard with the slice the rank needs and
assembles it; identical layouts take the fast path (the rank's own shard
file, verbatim).  A shard file this host cannot read rides the guardian
store (`offer_shards` / the store fetch).

Save protocol (multi-rank, one directory per step)::

    <root>/ckpt-00000003/
        gen.json                  {"nonce", "step"}: the save generation
        shard-00000.<nonce>.pkl   rank 0's arrays (its slices) + objects
        shard-00001.<nonce>.pkl   ...
        manifest.json             the commit point, with "layout"

The coordinator (rank 0) clears the directory and writes ``gen.json``;
every rank writes its shard file (tmp + ``os.replace``); the coordinator
waits for all ``world`` files of this generation and commits the
manifest; the other ranks return once the commit is visible.  A rank
dying mid-save leaves a directory without a manifest: torn, skipped by
the newest-valid scan.

**Process-local shards.**  A JAX process holds global arrays and
`save_sharded` slices them by ``partition_fn``; that stays the default
here (``local=False``: ``state`` holds full tensors).  A port rank of a
tensor-parallel model holds only its slice, so ``local=True`` takes the
rank's local tensors with ``partition_fn`` naming how each is split over
the mesh; the global shape is the local one times the axis size (or
``global_shapes[key]``), and each local shape must be `split_bounds`'s
share of it.  Either way the layout section reads the same to both
packages.

**The files cross the packages.**  A shard file is the JAX package's
payload ``{"rank", "step", "arrays", "objects"}``: numpy arrays (a
bfloat16 or float8 array as the ``ml_dtypes`` array JAX pickles) and the
objects tree with ``paddle_tpu.distributed.reshard._ArrayRef``
placeholders.  The port writes those names through ``importlib`` /
``getattr`` reductions (it imports neither ``paddle_tpu`` nor
``ml_dtypes``), and `framework.io`'s unpickler reads them, and JAX's
own files, back without importing either.
"""
from __future__ import annotations

import importlib
import json
import os
import pickle
import shutil
import threading
import time

import numpy as np
import torch

from ..framework.checkpoint_manager import (CheckpointError, read_manifest,
                                            scan_steps, step_dir_name,
                                            verify_checkpoint, write_manifest)
from ..framework import io as fio
from ..utils import monitor as _monitor
from ..utils.flags import flag as _flag
from ..utils.log import get_logger

LAYOUT_VERSION = 1
_SHARD_FMT = "shard-{rank:05d}.{nonce}.pkl"
_GEN_NAME = "gen.json"
_PROTOCOL = 5


class LayoutError(CheckpointError):
    """Checkpoint layout section missing or unusable (callers see this,
    never a KeyError, on pre-layout checkpoints)."""


class LayoutMismatchError(LayoutError):
    """Saved and requested layouts are incompatible; the message names
    both."""


class MeshSpec:
    """A named process mesh as checkpoint metadata: axis names and sizes,
    ranks row-major (the last axis varies fastest)."""

    __slots__ = ("axes", "shape")

    def __init__(self, axes, shape):
        self.axes = tuple(str(a) for a in axes)
        self.shape = tuple(int(s) for s in shape)
        if len(self.axes) != len(self.shape):
            raise ValueError(
                f"mesh axes {self.axes} do not match shape {self.shape}")
        if any(s < 1 for s in self.shape):
            raise ValueError(f"mesh shape {self.shape} has empty axes")

    @property
    def world(self):
        return int(np.prod(self.shape)) if self.shape else 1

    def axis_size(self, name):
        return self.shape[self.axes.index(name)]

    def coords(self, rank):
        """{axis: index} of ``rank`` in the row-major rank grid."""
        if not 0 <= rank < self.world:
            raise ValueError(f"rank {rank} outside mesh {self!r}")
        idx = np.unravel_index(rank, self.shape) if self.shape else ()
        return {a: int(i) for a, i in zip(self.axes, idx)}

    def to_json(self):
        return {"axes": list(self.axes), "shape": list(self.shape)}

    @classmethod
    def from_json(cls, obj):
        return cls(obj["axes"], obj["shape"])

    def __eq__(self, other):
        return (isinstance(other, MeshSpec) and self.axes == other.axes
                and self.shape == other.shape)

    def __hash__(self):
        return hash((self.axes, self.shape))

    def __repr__(self):
        body = "×".join(f"{a}={s}" for a, s in zip(self.axes, self.shape))
        return f"MeshSpec({body or 'world=1'})"


# ---------------------------------------------------------------------------
# shard math
# ---------------------------------------------------------------------------

def split_bounds(n, parts, idx):
    """[start, stop) of chunk ``idx`` when ``n`` elements split into
    ``parts`` chunks, ``np.array_split`` style: the first ``n % parts``
    chunks get one element more."""
    if parts < 1:
        raise ValueError(f"parts must be >= 1, got {parts}")
    if not 0 <= idx < parts:
        raise ValueError(f"chunk index {idx} outside [0, {parts})")
    q, r = divmod(int(n), parts)
    start = idx * q + min(idx, r)
    return start, start + q + (1 if idx < r else 0)


def shard_slices(global_shape, partition, mesh: MeshSpec, rank):
    """Per-dim slices of ``rank``'s shard of an array partitioned as
    ``partition`` (one mesh-axis name or None per dim) over ``mesh``."""
    global_shape = tuple(int(s) for s in global_shape)
    partition = tuple(partition)
    if len(partition) != len(global_shape):
        raise LayoutError(
            f"partition {partition} does not match array rank "
            f"{len(global_shape)} (shape {global_shape})")
    coords = mesh.coords(rank)
    out = []
    for dim, axis in enumerate(partition):
        if axis is None:
            out.append(slice(0, global_shape[dim]))
            continue
        if axis not in mesh.axes:
            raise LayoutMismatchError(
                f"array partition {partition} shards dim {dim} over mesh "
                f"axis {axis!r}, absent from mesh {mesh!r}")
        start, stop = split_bounds(global_shape[dim],
                                   mesh.axis_size(axis), coords[axis])
        out.append(slice(start, stop))
    return tuple(out)


def slices_shape(slices):
    return tuple(s.stop - s.start for s in slices)


def overlap_slices(src, dst):
    """Intersection of two same-rank slice tuples in each side's LOCAL
    coordinates: ``(sel_in_src, sel_in_dst)``, or None when they do not
    overlap (including when either side is empty)."""
    sel_src, sel_dst = [], []
    for a, b in zip(src, dst):
        lo, hi = max(a.start, b.start), min(a.stop, b.stop)
        if lo >= hi:
            return None
        sel_src.append(slice(lo - a.start, hi - a.start))
        sel_dst.append(slice(lo - b.start, hi - b.start))
    return tuple(sel_src), tuple(sel_dst)


def replicated(ndim):
    """The all-replicate partition for an ``ndim``-dim array."""
    return (None,) * ndim


# ---------------------------------------------------------------------------
# dtypes: the layout's names (numpy's; bfloat16 and the float8 types by
# ml_dtypes' names) against torch's types
# ---------------------------------------------------------------------------

def dtype_name(arr):
    """The layout's dtype string of a tensor or numpy array."""
    if torch.is_tensor(arr):
        name = fio._BIT_NAMES.get(arr.dtype)
        if name is not None:
            return name
        return str(torch.empty(0, dtype=arr.dtype).numpy().dtype)
    return str(np.asarray(arr).dtype)


def _torch_dtype(name):
    """torch dtype of a layout dtype string (bfloat16 and float8 by their
    bits, as `framework.io` reads them)."""
    name = str(name)
    if name in fio._BIT_TYPES:
        return fio._BIT_TYPES[name][0]
    try:
        return torch.from_numpy(np.empty(0, dtype=np.dtype(name))).dtype
    except (TypeError, ValueError):
        raise LayoutError(
            f"checkpoint layout names dtype {name!r}, which the port cannot "
            f"hold (readable: numpy's types and {sorted(fio._BIT_TYPES)})"
        ) from None


def _host_tensor(arr):
    """A CPU tensor over a shard file's array (numpy, or the bits of an
    ml_dtypes array), without a copy when numpy allows one."""
    if torch.is_tensor(arr):
        return arr
    if isinstance(arr, fio._RawArray):
        bits = np.asarray(arr.bits)
        return _from_numpy(bits).view(fio._BIT_TYPES[arr.dtype_name][0])
    return _from_numpy(np.asarray(arr))


def _from_numpy(a):
    if not (a.flags.writeable and a.flags.c_contiguous):
        a = a.copy()              # (ascontiguousarray makes 0-d arrays 1-d)
    return torch.from_numpy(a)


# ---------------------------------------------------------------------------
# writing JAX's names without importing them
# ---------------------------------------------------------------------------

class _ModuleImport:
    """Pickles as ``importlib.import_module(name)``."""

    __slots__ = ("name",)

    def __init__(self, name):
        self.name = name

    def __reduce__(self):
        return importlib.import_module, (self.name,)


class _ForeignGlobal:
    """Pickles as ``getattr(import_module(module), name)``: a global of a
    package this one never imports (the reader resolves it)."""

    __slots__ = ("module", "name")

    def __init__(self, module, name):
        self.module = module
        self.name = name

    def __reduce__(self):
        return getattr, (_ModuleImport(self.module), self.name)


class _MlDtype:
    """Pickles as ``numpy.dtype(ml_dtypes.<name>)``."""

    __slots__ = ("name",)

    def __init__(self, name):
        self.name = name

    def __reduce__(self):
        return np.dtype, (_ForeignGlobal("ml_dtypes", self.name), False,
                          True)


class _BitArray:
    """A bfloat16 / float8 array on the host as its bits; pickles as the
    ``ml_dtypes`` array the JAX package writes (numpy's ``_frombuffer``
    over the raw bytes, written without a copy at protocol 5)."""

    __slots__ = ("bits", "dtype_name")

    def __init__(self, bits, dtype_name):
        self.bits = np.require(bits, requirements="C")
        self.dtype_name = dtype_name

    def __reduce__(self):
        return _np_frombuffer, (pickle.PickleBuffer(self.bits),
                                _MlDtype(self.dtype_name),
                                tuple(self.bits.shape), "C")


def _frombuffer_fn():
    try:
        from numpy._core.numeric import _frombuffer
    except ImportError:                         # numpy 1.x
        from numpy.core.numeric import _frombuffer
    return _frombuffer


_np_frombuffer = _frombuffer_fn()
_JAX_ARRAY_REF = _ForeignGlobal("paddle_tpu.distributed.reshard",
                                "_ArrayRef")


def _host_array(t):
    """A tensor's host copy as what a shard file holds: a numpy array, or
    a `_BitArray` for the types numpy lacks."""
    if not torch.is_tensor(t):
        return np.asarray(t)
    t = t.detach().cpu().contiguous()
    name = fio._BIT_NAMES.get(t.dtype)
    if name is None:
        return t.numpy()
    return _BitArray(t.view(fio._BITS[fio._BIT_TYPES[name][1]]).numpy(),
                     name)


# ---------------------------------------------------------------------------
# state flatten / rebuild (the objects tree keeps the nesting with the
# array leaves swapped for refs)
# ---------------------------------------------------------------------------

class _ArrayRef:
    """Placeholder left in the objects tree where an array leaf was;
    pickled under the JAX package's name, so either package rebuilds it."""

    __slots__ = ("key", "tensor", "name", "trainable")

    def __init__(self, key, tensor, name=None, trainable=False):
        self.key = key
        self.tensor = tensor          # rebuild as a tensor vs a bare array
        self.name = name
        self.trainable = trainable

    def __reduce__(self):
        import copyreg
        return (copyreg._reconstructor, (_JAX_ARRAY_REF, object, None),
                (None, {"key": self.key, "tensor": self.tensor,
                        "name": self.name, "trainable": self.trainable}))


def _flatten(obj, prefix, arrays):
    if torch.is_tensor(obj):
        key = prefix or "value"
        arrays[key] = obj.detach()
        return _ArrayRef(key, True, getattr(obj, "param_name", None),
                         bool(obj.requires_grad))
    if isinstance(obj, np.ndarray):
        key = prefix or "value"
        arrays[key] = obj
        return _ArrayRef(key, False)
    if isinstance(obj, dict):
        return {k: _flatten(v, f"{prefix}.{k}" if prefix else str(k),
                            arrays)
                for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        items = [_flatten(v, f"{prefix}.{i}" if prefix else str(i), arrays)
                 for i, v in enumerate(obj)]
        if isinstance(obj, tuple):
            return (type(obj)(*items) if hasattr(obj, "_fields")
                    else type(obj)(items))
        return items
    return obj


def _rebuild(tree, arrays, device=None):
    if isinstance(tree, _ArrayRef):
        t = _host_tensor(arrays[tree.key])
        if not tree.tensor and t.dtype not in fio._BIT_NAMES:
            return t.numpy()
        if device is not None and t.device != device:
            t = t.to(device)
        if tree.trainable and t.is_floating_point():
            t.requires_grad_(True)
        return t
    if isinstance(tree, dict):
        return {k: _rebuild(v, arrays, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_rebuild(v, arrays, device) for v in tree]
    if isinstance(tree, tuple):
        items = [_rebuild(v, arrays, device) for v in tree]
        return (type(tree)(*items) if hasattr(tree, "_fields")
                else type(tree)(items))
    return tree


def flatten_state(state):
    """``state`` tree → ``(objects_tree, arrays)``: the array leaves
    replaced by `_ArrayRef` placeholders and hoisted into a flat
    ``{key: tensor or ndarray}`` dict (the hot-spare snapshots use the
    same shape)."""
    arrays = {}
    tree = _flatten(state, "", arrays)
    return tree, arrays


def rebuild_state(tree, arrays, *, device=None):
    """Inverse of `flatten_state`: tensors on ``device`` (None: where the
    arrays are)."""
    return _rebuild(tree, arrays, device)


# ---------------------------------------------------------------------------
# shard files
# ---------------------------------------------------------------------------

def _dump(obj, path):
    """Atomic pickle of ``obj`` to ``path`` (tmp, fsync, ``os.replace``).
    The arrays' buffers are written straight to the file; with the
    ``ckpt_write`` fault point armed the payload goes through it."""
    from ..utils import fault_injection
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
    try:
        with open(tmp, "wb") as f:
            if fault_injection.active("ckpt_write") is not None:
                fault_injection.write_bytes(
                    f, pickle.dumps(obj, protocol=_PROTOCOL), filename=path)
            else:
                pickle.dump(obj, f, protocol=_PROTOCOL)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise


def _load_shard_bytes(raw):
    import io as _io
    return fio._resolve(fio._Unpickler(_io.BytesIO(raw)).load())


def _load_shard(path):
    with open(path, "rb") as f:
        return fio._resolve(fio._Unpickler(f).load())


# ---------------------------------------------------------------------------
# save
# ---------------------------------------------------------------------------

def _poll(predicate, timeout_s, what, interval=0.01):
    deadline = time.monotonic() + timeout_s
    while True:
        got = predicate()
        if got:
            return got
        if time.monotonic() >= deadline:
            raise CheckpointError(
                f"timed out after {timeout_s:g}s waiting for {what}")
        time.sleep(interval)


def _partition(partition_fn, key, arr):
    part = tuple(partition_fn(key, arr)) if partition_fn \
        else replicated(arr.ndim)
    if len(part) != arr.ndim:
        raise LayoutError(
            f"partition_fn returned {part} for {key!r} of rank {arr.ndim}")
    return part


def global_shapes_of(arrays, mesh: MeshSpec, rank, partition_fn=None,
                     global_shapes=None):
    """``{key: global shape}`` of a rank's LOCAL arrays split by
    ``partition_fn`` over ``mesh``: each split dim times its axis size,
    unless ``global_shapes`` names the key.  Raises `LayoutError` when a
    local shape is not `split_bounds`'s share of the global one."""
    out = {}
    for key, arr in arrays.items():
        part = _partition(partition_fn, key, arr)
        if global_shapes is not None and key in global_shapes:
            gshape = tuple(int(s) for s in global_shapes[key])
        else:
            gshape = tuple(int(s) * (mesh.axis_size(a) if a is not None
                                     and a in mesh.axes else 1)
                           for s, a in zip(arr.shape, part))
        want = slices_shape(shard_slices(gshape, part, mesh, rank))
        if want != tuple(arr.shape):
            raise LayoutError(
                f"array {key!r}: rank {rank}'s local shape "
                f"{list(arr.shape)} is not its share {list(want)} of the "
                f"global shape {list(gshape)} split as {list(part)} over "
                f"{mesh!r}")
        out[key] = gshape
    return out


def build_layout(arrays, mesh: MeshSpec, partition_fn=None, nonce=None,
                 *, global_shapes=None):
    """The manifest layout section for ``arrays`` (flat {key: tensor or
    ndarray}) partitioned by ``partition_fn(key, arr) -> partition``; an
    array's global shape is ``global_shapes[key]`` when given, else its
    own shape."""
    entries = {}
    for key, arr in arrays.items():
        part = _partition(partition_fn, key, arr)
        shape = global_shapes[key] if global_shapes is not None \
            and key in global_shapes else arr.shape
        entries[key] = {
            "global_shape": [int(s) for s in shape],
            "dtype": dtype_name(arr),
            "partition": list(part),
        }
    layout = {
        "layout_version": LAYOUT_VERSION,
        "format": "pickle-shards",
        "world_size": mesh.world,
        "mesh": mesh.to_json(),
        "rank_files": {str(r): _SHARD_FMT.format(rank=r, nonce=nonce)
                       for r in range(mesh.world)},
        "arrays": entries,
    }
    if nonce is not None:
        layout["nonce"] = nonce
    return layout


def save_sharded(dirpath, state, mesh: MeshSpec, rank, partition_fn=None,
                 step=None, meta=None, barrier_timeout_s=120.0,
                 coordinator_rank=0, *, local=False, global_shapes=None):
    """One rank's half of a sharded checkpoint save into ``dirpath``.

    ``local=False`` (JAX's): ``state`` holds the FULL state and
    ``partition_fn(key, arr)`` declares the on-disk partition (default:
    replicate, every rank writes a full copy); each rank writes its
    slices.  ``local=True``: ``state`` holds this rank's local tensors,
    split over ``mesh`` as ``partition_fn`` says; each is written as it
    is and the layout records the global shapes (`global_shapes_of`).
    The coordinator commits the manifest once every rank's shard file
    landed; every rank returns only after the commit is visible."""
    rank = int(rank)
    arrays = {}
    objects = _flatten(state, "", arrays)
    gshapes = global_shapes_of(arrays, mesh, rank, partition_fn,
                               global_shapes) if local else None

    if rank == coordinator_rank:
        if os.path.exists(dirpath):
            # an overwrite or a torn leftover: cleared, so this
            # generation is unambiguous (peers wait for OUR gen.json)
            shutil.rmtree(dirpath, ignore_errors=True)
        os.makedirs(dirpath, exist_ok=True)
        nonce = f"{os.getpid():x}{time.time_ns() & 0xFFFFFF:06x}"
        gen = {"nonce": nonce, "step": None if step is None else int(step)}
        tmp = os.path.join(dirpath, f"{_GEN_NAME}.tmp.{os.getpid()}")
        with open(tmp, "w") as f:
            json.dump(gen, f)
        os.replace(tmp, os.path.join(dirpath, _GEN_NAME))

    def _write_shard(nonce):
        shard = {"rank": rank, "step": step, "arrays": {},
                 "objects": objects}
        for key, arr in arrays.items():
            if not local:
                part = _partition(partition_fn, key, arr)
                arr = arr[shard_slices(arr.shape, part, mesh, rank)]
            shard["arrays"][key] = _host_array(arr)
        fname = _SHARD_FMT.format(rank=rank, nonce=nonce)
        _dump(shard, os.path.join(dirpath, fname))

    if rank == coordinator_rank:
        _write_shard(nonce)
        expect = [_SHARD_FMT.format(rank=r, nonce=nonce)
                  for r in range(mesh.world)]

        def _all_in():
            return all(os.path.exists(os.path.join(dirpath, n))
                       for n in expect)
        _poll(_all_in, barrier_timeout_s,
              f"{mesh.world} shard files in {dirpath}")
        layout = build_layout(arrays, mesh, partition_fn, nonce=nonce,
                              global_shapes=gshapes)
        write_manifest(dirpath, step=step, meta=meta,
                       files=expect + [_GEN_NAME], layout=layout)
        _monitor.incr("ckpt.sharded_saves")
        return dirpath

    def _read_gen():
        try:
            with open(os.path.join(dirpath, _GEN_NAME)) as f:
                g = json.load(f)
            want = None if step is None else int(step)
            if (want is None or g.get("step") in (None, want)) \
                    and g.get("nonce"):
                return g
        except (OSError, ValueError):
            pass
        return None

    while True:
        gen = _poll(_read_gen, barrier_timeout_s,
                    f"save-generation marker in {dirpath}")
        nonce = gen["nonce"]
        _write_shard(nonce)

        def _committed_or_regen():
            m = read_manifest(dirpath)
            if m is not None and \
                    m.get("layout", {}).get("nonce") == nonce:
                return "done"
            g = _read_gen()
            if g is not None and g["nonce"] != nonce:
                # the coordinator restarted the generation: write our
                # shard again under the fresh nonce
                return "regen"
            return None
        r = _poll(_committed_or_regen, barrier_timeout_s,
                  f"manifest commit in {dirpath}")
        if r == "done":
            break
    _monitor.incr("ckpt.sharded_saves")
    return dirpath


# ---------------------------------------------------------------------------
# restore
# ---------------------------------------------------------------------------

def read_layout(dirpath):
    """The manifest's layout section, or None (no manifest, or a
    pre-layout checkpoint)."""
    m = read_manifest(dirpath)
    return m.get("layout") if m else None


def offer_shards(store, dirpath, prefix="reshard"):
    """Post every shard file this host can read into ``store`` so peers
    without the directory can fetch them; returns how many."""
    layout = read_layout(dirpath)
    if not layout:
        return 0
    n = 0
    for fname in layout.get("rank_files", {}).values():
        p = os.path.join(dirpath, fname)
        try:
            with open(p, "rb") as f:
                store.set(f"{prefix}/{layout.get('nonce', '0')}/{fname}",
                          f.read())
            n += 1
        except OSError:
            continue
    return n


def _default_store():
    from . import host_collectives as hc
    return hc.guardian_store() or hc.coord_kv_store()


class _ShardReader:
    """Lazy per-rank shard-file loader (one cached copy a rank) that
    fetches a file this host cannot read from the store."""

    def __init__(self, dirpath, layout, store=None, fetch_timeout_s=60.0,
                 prefix="reshard"):
        self.dirpath = dirpath
        self.layout = layout
        self.store = store
        self.fetch_timeout_s = fetch_timeout_s
        self.prefix = prefix
        self._cache = {}
        self.files_read = 0

    def shard(self, r):
        if r in self._cache:
            return self._cache[r]
        fname = self.layout["rank_files"][str(r)]
        path = os.path.join(self.dirpath, fname)
        try:
            data = _load_shard(path)
        except OSError:
            data = self._fetch(fname)
        if not isinstance(data, dict) or "arrays" not in data:
            raise CheckpointError(
                f"shard file {path} is not a reshard shard payload")
        data["arrays"] = {k: _host_tensor(v)
                          for k, v in data["arrays"].items()}
        self._cache[r] = data
        self.files_read += 1
        return data

    def _fetch(self, fname):
        store = self.store if self.store is not None else _default_store()
        if store is None:
            raise CheckpointError(
                f"shard file {fname} is unreadable in {self.dirpath} and "
                "no guardian/coordination store is configured to fetch "
                "it from a peer (see offer_shards)")
        key = f"{self.prefix}/{self.layout.get('nonce', '0')}/{fname}"
        raw = _poll(lambda: store.get(key), self.fetch_timeout_s,
                    f"peer-offered shard {key} in the guardian store")
        return _load_shard_bytes(raw)


def _check_format(dirpath, layout):
    fmt = layout.get("format", "pickle-shards")
    if fmt != "pickle-shards":
        raise LayoutError(
            f"checkpoint {dirpath} has layout format {fmt!r}: the port "
            "reads the pickle-shards format only (an orbax checkpoint "
            "of the JAX package cannot be read without orbax)")


def restore_resharded(dirpath, target_mesh: MeshSpec, target_rank,
                      target_partition_fn=None, store=None,
                      fetch_timeout_s=60.0, *, map_location=None):
    """Restore ``target_rank``'s state slice under ``target_mesh`` from a
    layout-bearing checkpoint directory, resharding as needed; tensors
    on ``map_location`` (None: the card).

    Default target partition: replicate (the FULL array);
    ``target_partition_fn(key, meta) -> partition`` restores slices.
    Returns ``(state, report)``: ``fast_path`` (identical layouts: the
    rank's own shard file, verbatim), ``files_read``,
    ``arrays_resharded``.  Raises `LayoutError` on a pre-layout
    checkpoint and `LayoutMismatchError` when the layouts cannot be
    mapped (or differ while ``FLAGS_reshard_on_resume`` is off), naming
    both."""
    from ..device import resolve_device
    device = resolve_device(map_location)
    manifest = read_manifest(dirpath)
    if manifest is None:
        raise CheckpointError(f"no manifest in {dirpath}")
    layout = manifest.get("layout")
    if layout is None:
        raise LayoutError(
            f"checkpoint {dirpath} has no layout section (manifest "
            f"version {manifest.get('version')}, written before elastic "
            "resharding): it can only be restored whole on a matching "
            "topology, not resharded — re-save it with a layout-aware "
            "saver to enable resize-and-resume")
    ver = layout.get("layout_version")
    if ver != LAYOUT_VERSION:
        raise LayoutError(
            f"checkpoint {dirpath} has layout version {ver}; this build "
            f"understands version {LAYOUT_VERSION}")
    _check_format(dirpath, layout)
    saved_mesh = MeshSpec.from_json(layout["mesh"])
    target_rank = int(target_rank)
    if not 0 <= target_rank < target_mesh.world:
        raise LayoutMismatchError(
            f"target rank {target_rank} outside requested mesh "
            f"{target_mesh!r}")

    arrays_meta = layout.get("arrays", {})

    def _target_part(key, meta):
        if target_partition_fn is not None:
            return tuple(target_partition_fn(key, meta))
        return replicated(len(meta["global_shape"]))

    fast = saved_mesh == target_mesh and \
        str(target_rank) in layout.get("rank_files", {}) and all(
            tuple(meta["partition"]) == _target_part(key, meta)
            for key, meta in arrays_meta.items())
    reader = _ShardReader(dirpath, layout, store=store,
                          fetch_timeout_s=fetch_timeout_s)
    report = {
        "fast_path": bool(fast),
        "saved_mesh": repr(saved_mesh),
        "target_mesh": repr(target_mesh),
        "saved_world": saved_mesh.world,
        "target_world": target_mesh.world,
        "arrays_resharded": 0,
        "files_read": 0,
        "format": "pickle-shards",
    }
    if fast:
        shard = reader.shard(target_rank)
        state = _rebuild(shard["objects"], shard["arrays"], device)
        report["files_read"] = reader.files_read
        _monitor.incr("ckpt.reshard_fast_path")
        return state, report

    if not _flag("FLAGS_reshard_on_resume", True):
        raise LayoutMismatchError(
            f"checkpoint {dirpath} was saved on {saved_mesh!r} "
            f"(world={saved_mesh.world}) but rank {target_rank} of "
            f"{target_mesh!r} (world={target_mesh.world}) requested it "
            "and FLAGS_reshard_on_resume is off — resharding disabled; "
            "restore on the original topology or re-enable the flag")

    out_arrays = {}
    for key, meta in arrays_meta.items():
        gshape = tuple(meta["global_shape"])
        saved_part = tuple(meta["partition"])
        tgt_part = _target_part(key, meta)
        try:
            tslices = shard_slices(gshape, tgt_part, target_mesh,
                                   target_rank)
        except LayoutMismatchError as e:
            raise LayoutMismatchError(
                f"array {key!r} (global shape {list(gshape)}): saved on "
                f"{saved_mesh!r} as partition {list(saved_part)}, "
                f"requested partition {list(tgt_part)} on "
                f"{target_mesh!r}: {e}") from None
        out = torch.empty(slices_shape(tslices),
                          dtype=_torch_dtype(meta["dtype"]))
        covered = 0
        if all(a is None for a in saved_part):
            # replicated on disk: one file suffices, the rank-aligned one
            # so a shrink reads no peer's file
            prefer = target_rank if target_rank < saved_mesh.world else 0
            src = reader.shard(prefer)["arrays"][key]
            out.copy_(src[tuple(slice(s.start, s.stop) for s in tslices)])
            covered = out.numel()
        else:
            for r in range(saved_mesh.world):
                sslices = shard_slices(gshape, saved_part, saved_mesh, r)
                ov = overlap_slices(sslices, tslices)
                if ov is None:
                    continue
                src_sel, dst_sel = ov
                src = reader.shard(r)["arrays"][key]
                out[dst_sel] = src[src_sel]
                covered += int(np.prod(
                    [s.stop - s.start for s in dst_sel]))
        if covered != out.numel():
            raise LayoutMismatchError(
                f"array {key!r}: saved shards on {saved_mesh!r} "
                f"(partition {list(saved_part)}) cover only {covered} of "
                f"{out.numel()} elements of the slice requested by rank "
                f"{target_rank} on {target_mesh!r} — the layouts do not "
                "tile the same global array")
        if tuple(saved_part) != tuple(tgt_part) or \
                saved_mesh != target_mesh:
            report["arrays_resharded"] += 1
        out_arrays[key] = out

    # the objects (non-array leaves) travel replicated in every file
    src_rank = target_rank if str(target_rank) in layout["rank_files"] \
        and target_rank < saved_mesh.world else 0
    objects = reader.shard(src_rank)["objects"]
    state = _rebuild(objects, out_arrays, device)
    report["files_read"] = reader.files_read
    _monitor.incr("ckpt.reshard_restores")
    return state, report


def restore_latest_resharded(root, target_mesh: MeshSpec, target_rank,
                             target_partition_fn=None, store=None,
                             strict_layout=False, *, map_location=None,
                             gc_invalid=False):
    """``(state, step, report)`` from the newest VALID checkpoint under
    ``root``, resharded onto ``target_mesh`` / ``target_rank`` when the
    saved layout differs.  A directory without a layout section is
    loaded whole (``state.pkl``), unless ``strict_layout``, which raises
    `LayoutError`.  A torn directory is skipped (logged) and, with
    ``gc_invalid`` (one rank's choice: `CheckpointManager.restore_latest`
    does the same), removed.  None when nothing valid exists."""
    from ..device import resolve_device
    device = resolve_device(map_location)
    log = get_logger()
    for step, path in scan_steps(root):
        if not verify_checkpoint(path):
            log.warning("checkpoint %s is torn/corrupt; skipping%s", path,
                        " and removing" if gc_invalid else "")
            _monitor.incr("ckpt.torn_skipped")
            if gc_invalid:
                shutil.rmtree(path, ignore_errors=True)
            continue
        layout = read_layout(path)
        try:
            if layout is None:
                if strict_layout:
                    raise LayoutError(
                        f"checkpoint {path} has no layout section "
                        "(pre-elastic) and strict_layout was requested")
                state = fio.load(os.path.join(path, "state.pkl"),
                                 map_location=device)
                report = {"fast_path": True, "format": "legacy",
                          "files_read": 1, "arrays_resharded": 0,
                          "saved_mesh": None,
                          "target_mesh": repr(target_mesh)}
            else:
                state, report = restore_resharded(
                    path, target_mesh, target_rank,
                    target_partition_fn=target_partition_fn, store=store,
                    map_location=device)
        except LayoutError:
            raise                      # loud by design: never fall back
        except Exception as e:
            log.warning("checkpoint %s failed to load (%s); skipping",
                        path, e)
            _monitor.incr("ckpt.torn_skipped")
            continue
        _monitor.incr("ckpt.restores")
        return state, step, report
    return None


# ---------------------------------------------------------------------------
# manager-shaped wrapper
# ---------------------------------------------------------------------------

def partition_from_tensor(t, mesh: MeshSpec):
    """The on-disk partition of a distributed tensor from the placements
    it records (`placement.commit_param`, `api.shard_tensor`): a tuple
    with an entry a dim, the first axis of ``mesh`` that splits it or
    None; a plain tensor is replicated (JAX's, reshard.py:803)."""
    placements = getattr(t, "placements", None)
    pmesh = getattr(t, "process_mesh", None)
    ndim = len(getattr(t, "shape", ()) or ())
    part = [None] * ndim
    if placements and pmesh is not None:
        for axis_idx, p in enumerate(placements):
            if getattr(p, "is_shard", lambda *_: False)():
                d = p.dim if p.dim >= 0 else p.dim + ndim
                name = pmesh.dim_names[axis_idx]
                if name in mesh.axes and part[d] is None:
                    part[d] = name
    return tuple(part)


class ShardedCheckpointer:
    """Multi-rank, layout-aware sibling of `framework.checkpoint_manager.
    CheckpointManager`: the same step-numbered directories, manifest
    commit point and newest-valid restore scan, but every rank writes its
    own shard file and a restore reshards onto the mesh the resumed job
    runs.

    ``partition_fn(key, arr) -> partition`` fixes the on-disk layout
    (default replicate); with ``local=True`` the saved tensors are the
    rank's local parts split as ``partition_fn`` says (`save_sharded`).
    ``restore_latest`` restores FULL arrays unless a target partition is
    given; ``last_report`` records the fast path and the arrays
    resharded.  Retention keeps the newest ``max_to_keep`` valid
    checkpoints and removes torn directories older than the newest valid
    one."""

    def __init__(self, root, mesh: MeshSpec, rank, partition_fn=None,
                 max_to_keep=None, barrier_timeout_s=120.0,
                 coordinator_rank=0, store=None, *, local=False,
                 global_shapes=None, map_location=None):
        self.root = str(root)
        self.mesh = mesh
        self.rank = int(rank)
        self.partition_fn = partition_fn
        self.max_to_keep = max_to_keep
        self.barrier_timeout_s = float(
            os.environ.get("PADDLE_RESHARD_BARRIER_S", barrier_timeout_s))
        self.coordinator_rank = int(coordinator_rank)
        self.store = store
        self.local = bool(local)
        self.global_shapes = global_shapes
        self.map_location = map_location
        self.last_report = None
        self._next_step = None
        self._log = get_logger()
        self._lock = threading.Lock()
        os.makedirs(self.root, exist_ok=True)

    @property
    def is_coordinator(self):
        return self.rank == self.coordinator_rank

    def save(self, state, step=None, meta=None):
        """Save ``state`` as ``step``.  Without a step the ranks number
        their saves alike with no exchange: one past the newest valid
        checkpoint when this checkpointer first saves, then one more a
        save (a scan at each save would race the coordinator's new
        directory on the other ranks)."""
        if step is None:
            if self._next_step is None:
                # past the newest committed directory (its manifest
                # written: a save in flight has none yet)
                committed = [s for s, path in scan_steps(self.root)
                             if read_manifest(path) is not None]
                self._next_step = committed[0] + 1 if committed else 0
            step = self._next_step
        self._next_step = int(step) + 1
        final = os.path.join(self.root, step_dir_name(step))
        save_sharded(final, state, self.mesh, self.rank,
                     partition_fn=self.partition_fn, step=step, meta=meta,
                     barrier_timeout_s=self.barrier_timeout_s,
                     coordinator_rank=self.coordinator_rank,
                     local=self.local, global_shapes=self.global_shapes)
        if self.is_coordinator:
            self._retain()
        return final

    def wait(self):
        """`CheckpointManager`'s surface: a save here is synchronous (the
        manifest commit is its return)."""

    def restore_latest(self, target_mesh=None, target_rank=None,
                       target_partition_fn=None):
        """``(state, step)`` from the newest valid checkpoint, resharded
        onto this job's mesh and rank; None when nothing valid exists."""
        out = restore_latest_resharded(
            self.root, target_mesh or self.mesh,
            self.rank if target_rank is None else target_rank,
            target_partition_fn=target_partition_fn, store=self.store,
            map_location=self.map_location)
        if out is None:
            return None
        state, step, report = out
        self.last_report = report
        if not report.get("fast_path"):
            self._log.warning(
                "checkpoint step %s resharded: %s -> %s (%s arrays, %s "
                "shard files read)", step, report.get("saved_mesh"),
                report.get("target_mesh"), report.get("arrays_resharded"),
                report.get("files_read"))
        return state, step

    def latest_step(self):
        for step, path in scan_steps(self.root):
            if verify_checkpoint(path):
                return step
        return None

    def _retain(self):
        """Newest first, the first ``max_to_keep`` valid directories stay
        (each checked by size and crc32); every directory older than the
        last of them goes, valid or torn, so its files are not read
        again (a committed one counts as ``retention_deleted``, one
        without a manifest as ``torn_gcd``).  A torn directory between
        valid ones goes too."""
        if not self.max_to_keep or self.max_to_keep < 1:
            return
        with self._lock:
            kept = 0
            for _step, path in scan_steps(self.root):   # newest first
                if kept >= self.max_to_keep:
                    committed = read_manifest(path) is not None
                    shutil.rmtree(path, ignore_errors=True)
                    _monitor.incr("ckpt.retention_deleted" if committed
                                  else "ckpt.torn_gcd")
                elif verify_checkpoint(path):
                    kept += 1
                elif kept >= 1:
                    shutil.rmtree(path, ignore_errors=True)
                    _monitor.incr("ckpt.torn_gcd")
