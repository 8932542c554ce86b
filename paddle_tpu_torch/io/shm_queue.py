"""The shared-memory ring queue between the DataLoader's worker processes
and the trainer (port of paddle_tpu/io/shm_queue.py), over the port's own
copy of the host C++ queue, ``csrc/shm_queue.cpp``, built with g++ by
`utils.cpp_extension.load` into ``csrc/build/`` (no CUDA: the CPU tests
build it too).  Items are pickled Python objects, one a slot; ctypes
releases the GIL while a call blocks."""
from __future__ import annotations

import ctypes
import os
import pickle

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from ..utils.cpp_extension import load
        lib = load("paddle_tpu_torch_shm_queue", ["shm_queue.cpp"])
        lib.ptq_create.restype = ctypes.c_void_p
        lib.ptq_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64,
                                   ctypes.c_uint64]
        lib.ptq_open.restype = ctypes.c_void_p
        lib.ptq_open.argtypes = [ctypes.c_char_p]
        lib.ptq_push.restype = ctypes.c_int
        lib.ptq_push.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                 ctypes.c_uint64, ctypes.c_double]
        lib.ptq_pop.restype = ctypes.c_int64
        lib.ptq_pop.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.c_uint64, ctypes.c_double]
        lib.ptq_close.argtypes = [ctypes.c_void_p]
        lib.ptq_release.argtypes = [ctypes.c_void_p]
        lib.ptq_unlink.argtypes = [ctypes.c_char_p]
        lib.ptq_slot_size.restype = ctypes.c_uint64
        lib.ptq_slot_size.argtypes = [ctypes.c_void_p]
        lib.ptq_size.restype = ctypes.c_uint64
        lib.ptq_size.argtypes = [ctypes.c_void_p]
        _LIB = lib
    return _LIB


class QueueClosed(Exception):
    pass


class ShmQueue:
    """Bounded multi-process queue of pickled Python objects:
    ``capacity`` slots of ``slot_size`` bytes in a POSIX shared-memory
    segment ``name`` (made by the creator, unlinked at its
    `release`)."""

    def __init__(self, name=None, capacity=8, slot_size=1 << 20,
                 create=True):
        self.name = (name or f"/ptq_{os.getpid()}_{id(self):x}").encode()
        lib = _lib()
        if create:
            self._q = lib.ptq_create(self.name, capacity, slot_size)
        else:
            self._q = lib.ptq_open(self.name)
        if not self._q:
            raise OSError(f"cannot {'create' if create else 'open'} shm "
                          f"queue {self.name!r}")
        self._owner = create
        self.slot_size = lib.ptq_slot_size(self._q)
        self._buf = ctypes.create_string_buffer(int(self.slot_size))

    @classmethod
    def attach(cls, name):
        return cls(name=name if isinstance(name, str)
                   else name.decode(), create=False)

    def put(self, obj, timeout=0.0):
        """Push ``obj`` (``timeout`` 0: wait as long as it takes)."""
        data = pickle.dumps(obj, protocol=4)
        rc = _lib().ptq_push(self._q, data, len(data), timeout)
        if rc == -3:
            raise ValueError(
                f"object of {len(data)} bytes exceeds slot_size "
                f"{self.slot_size}; raise DataLoader use_shared_memory "
                "slot size")
        if rc == -2:
            raise QueueClosed()
        if rc == -1:
            raise TimeoutError()

    def get(self, timeout=0.0):
        n = _lib().ptq_pop(self._q, self._buf, self.slot_size, timeout)
        if n == -2:
            raise QueueClosed()
        if n == -1:
            raise TimeoutError()
        if n < 0:
            raise OSError(f"shm queue pop failed ({n})")
        return pickle.loads(self._buf.raw[:n])

    def qsize(self):
        return int(_lib().ptq_size(self._q))

    def close(self):
        if self._q:
            _lib().ptq_close(self._q)

    def release(self):
        if self._q:
            _lib().ptq_release(self._q)
            if self._owner:
                _lib().ptq_unlink(self.name)
            self._q = None

    def __getstate__(self):
        return {"name": self.name.decode()}

    def __setstate__(self, state):
        self.__init__(name=state["name"], create=False)
