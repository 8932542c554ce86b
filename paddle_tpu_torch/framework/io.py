"""``save`` and ``load`` of nested state (port of
paddle_tpu/framework/io.py): pickled host data, written atomically.

Every tensor becomes a `_TensorState` (a numpy array, the parameter's
name, whether it is trainable) with the nested dicts, lists and tuples
around it kept.  numpy has no bfloat16 or float8 type, so a tensor of
such a type is stored as its raw bits (a ``uint16`` or ``uint8`` array)
beside the type's name, and rebuilt on load by a ``view``; float16 and
every other type are stored as numpy arrays of their own type.

`load` reads the port's files and the JAX package's: its unpickler maps
``paddle_tpu.framework.io._TensorState`` to the port's class and reads
an ``ml_dtypes`` array (how the JAX package pickles bfloat16) through
its bits, so neither JAX nor ``ml_dtypes`` is imported; a sharded
checkpoint's files (`distributed.reshard`) name the JAX package's
``_ArrayRef`` and the ``ml_dtypes`` types through ``importlib`` /
``getattr`` reductions, which it reads the same way.  Any other global
of ``paddle_tpu``, ``jax`` or ``ml_dtypes`` is refused.
"""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from ..device import resolve_device

#: types numpy cannot hold, stored as their bits: name -> (type, bits)
_BIT_TYPES = {
    "bfloat16": (torch.bfloat16, np.uint16),
    "float8_e4m3fn": (torch.float8_e4m3fn, np.uint8),
    "float8_e5m2": (torch.float8_e5m2, np.uint8),
    "float8_e4m3fnuz": (torch.float8_e4m3fnuz, np.uint8),
    "float8_e5m2fnuz": (torch.float8_e5m2fnuz, np.uint8),
}
_BIT_NAMES = {t: name for name, (t, _) in _BIT_TYPES.items()}
_BITS = {np.uint16: torch.uint16, np.uint8: torch.uint8}


class _TensorState:
    """One tensor on the host: ``array`` (numpy; the bits for a type in
    `_BIT_TYPES`), ``name``, ``trainable`` and ``dtype`` (that type's
    name, else unset)."""
    __slots__ = ("array", "name", "trainable", "dtype")

    def __init__(self, array, name, trainable, dtype=None):
        self.array = array
        self.name = name
        self.trainable = trainable
        self.dtype = dtype


def _host_array(t):
    """``(numpy array, dtype name or None)`` of a tensor."""
    t = t.detach().cpu().contiguous()
    name = _BIT_NAMES.get(t.dtype)
    if name is None:
        return t.numpy(), None
    return t.view(_BITS[_BIT_TYPES[name][1]]).numpy(), name


def _to_host(obj):
    if torch.is_tensor(obj):
        arr, dtype = _host_array(obj)
        return _TensorState(arr, getattr(obj, "param_name", None),
                            bool(obj.requires_grad), dtype)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _tensor(array, dtype_name, device):
    if isinstance(array, _RawArray):
        array, dtype_name = array.bits, array.dtype_name
    t = torch.from_numpy(np.array(array, copy=True))
    if dtype_name is not None:
        t = t.view(_BIT_TYPES[dtype_name][0])
    return t.to(device)


def _from_host(obj, device):
    if isinstance(obj, _TensorState):
        t = _tensor(obj.array, getattr(obj, "dtype", None), device)
        if obj.trainable and t.is_floating_point():
            t.requires_grad_(True)
        return t
    if isinstance(obj, _RawArray):
        return _tensor(obj, None, device)
    if isinstance(obj, dict):
        return {k: _from_host(v, device) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_from_host(v, device) for v in obj)
    return obj


def save(obj, path, protocol=4, **configs):
    """Atomic save: pickle to ``path + .tmp.<pid>``, fsync, then
    ``os.replace`` into place, so a crash mid-write leaves the old file
    or nothing.  The payload goes through the ``ckpt_write`` fault point
    (`utils.fault_injection.write_bytes`)."""
    from ..utils import fault_injection
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    data = pickle.dumps(_to_host(obj), protocol=protocol)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            fault_injection.write_bytes(f, data, filename=path)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise


# ---------------------------------------------------------------------------
# reading the JAX package's files
# ---------------------------------------------------------------------------

class _MlType:
    """An ``ml_dtypes`` scalar type named in a pickle (never imported)."""

    def __init__(self, name):
        if name not in _BIT_TYPES:
            raise pickle.UnpicklingError(
                f"ml_dtypes.{name}: no torch type to read it as "
                f"(readable: {sorted(_BIT_TYPES)})")
        self.name = name


class _PendingDtype:
    """``numpy.dtype(<ml_dtypes type>)`` while unpickling; its pickled
    state (byte order, sizes) is fixed by the type and ignored."""

    def __init__(self, ml):
        self.name = ml.name

    def __setstate__(self, state):
        pass


class _RawArray:
    """An array of an ``ml_dtypes`` type read as its bits: ``bits`` (a
    ``uint16``/``uint8`` numpy array) and ``dtype_name``.  The pickle
    rebuilds it by ``_reconstruct`` then ``__setstate__``; for any other
    type ``value`` is the real numpy array and `_resolve` unwraps it."""

    def __init__(self, *args):
        self.bits = self.dtype_name = self.value = None

    def __setstate__(self, state):
        _version, shape, dtype, fortran, raw = state
        if isinstance(dtype, _PendingDtype):
            bits = _BIT_TYPES[dtype.name][1]
            arr = np.frombuffer(raw, dtype=bits)
            self.bits = arr.reshape(shape, order="F" if fortran else "C")
            self.dtype_name = dtype.name
        else:
            self.value = np.ndarray.__new__(np.ndarray, (0,), np.uint8)
            self.value.__setstate__(state)


def _np_dtype(obj, align=False, copy=False):
    if isinstance(obj, _MlType):
        return _PendingDtype(obj)
    return np.dtype(obj, align, copy)


def _np_frombuffer(buf, dtype, shape, order):
    """numpy's ``_frombuffer`` (protocol 5 arrays); an ``ml_dtypes`` type
    reads as its bits (`_RawArray`)."""
    if isinstance(dtype, _PendingDtype):
        r = _RawArray()
        bits = np.frombuffer(buf, dtype=_BIT_TYPES[dtype.name][1])
        r.bits = bits.reshape(shape, order=order)
        r.dtype_name = dtype.name
        return r
    return np.frombuffer(buf, dtype=dtype).reshape(shape, order=order)


class _ModuleRef:
    """``importlib.import_module(name)`` in a pickle, never imported: the
    port writes the JAX package's globals this way
    (`distributed.reshard`)."""

    _READABLE = ("ml_dtypes", "paddle_tpu.distributed.reshard")

    def __init__(self, name):
        if name not in self._READABLE:
            raise pickle.UnpicklingError(
                f"refusing to import module {name!r} from a pickle")
        self.name = name


def _getattr(obj, name):
    """``getattr(module, name)`` in a pickle: a module of `_ModuleRef`'s
    list only."""
    if not isinstance(obj, _ModuleRef):
        raise pickle.UnpicklingError(
            f"refusing getattr({type(obj).__name__}, {name!r}) in a pickle")
    if obj.name == "ml_dtypes":
        return _MlType(name)
    if name == "_ArrayRef":
        from ..distributed.reshard import _ArrayRef
        return _ArrayRef
    raise pickle.UnpicklingError(
        f"refusing to load the global {obj.name}.{name}")


def _np_scalar(dtype, raw=None):
    if isinstance(dtype, _PendingDtype):
        r = _RawArray()
        r.bits = np.frombuffer(raw, dtype=_BIT_TYPES[dtype.name][1])\
            .reshape(())
        r.dtype_name = dtype.name
        return r
    return np.frombuffer(raw, dtype=dtype).reshape(())[()]


_FORBIDDEN_ROOTS = ("paddle_tpu", "jax", "jaxlib", "ml_dtypes")


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) == ("paddle_tpu.framework.io", "_TensorState"):
            return _TensorState
        if (module, name) == ("paddle_tpu.distributed.reshard",
                              "_ArrayRef"):
            from ..distributed.reshard import _ArrayRef
            return _ArrayRef
        if (module, name) == ("importlib", "import_module"):
            return _ModuleRef
        if (module, name) == ("builtins", "getattr"):
            return _getattr
        if module in ("numpy._core.numeric", "numpy.core.numeric") and \
                name == "_frombuffer":
            return _np_frombuffer
        if module == "ml_dtypes":
            return _MlType(name)
        if module in ("numpy._core.multiarray", "numpy.core.multiarray"):
            if name == "_reconstruct":
                return _RawArray
            if name == "scalar":
                return _np_scalar
        if (module, name) == ("numpy", "dtype"):
            return _np_dtype
        if module.split(".")[0] in _FORBIDDEN_ROOTS:
            raise pickle.UnpicklingError(
                f"refusing to load the global {module}.{name}: only the "
                f"JAX package's _TensorState and ml_dtypes arrays are read")
        return super().find_class(module, name)


def _resolve(obj):
    """Unwrap the `_RawArray` holders of ordinary numpy arrays."""
    if isinstance(obj, _RawArray):
        return obj.value if obj.dtype_name is None else obj
    if isinstance(obj, _TensorState):
        obj.array = _resolve(obj.array)
        return obj
    if isinstance(obj, dict):
        return {k: _resolve(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_resolve(v) for v in obj)
    return obj


def load(path, *, map_location=None, **configs):
    """The state `save` (or the JAX package's ``paddle_tpu.save``) wrote,
    with every tensor on ``map_location``: None means the card, as every
    entry point of the port; ``"cpu"`` must be asked for."""
    device = resolve_device(map_location)
    with open(path, "rb") as f:
        obj = _resolve(_Unpickler(f).load())
    return _from_host(obj, device)
