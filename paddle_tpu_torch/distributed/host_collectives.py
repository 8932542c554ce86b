"""Host-mediated collectives (port of
paddle_tpu/distributed/host_collectives.py): the store lane.

Every rank posts its contribution into a shared KV store under
``{job}/hc/g{gid}/s{seq}/r{rank}``, polls for its peers' contributions,
stacks them and derives the op's result locally (all_reduce a reduction
over the stacked axis, all_to_all a transpose): the JAX module's host
lane.  ``FLAGS_collective_backend=host`` routes the collectives that
lane serves through it (`distributed.collective`); the default
(``auto``) runs them on the process group.

The poll loop is a Python-level blocking point, so the collective
watchdog (`distributed.watchdog`) can abort a gather stuck on a dead
peer with an asynchronously raised `CollectiveTimeoutError` or
`PeerFailureError`, where a call blocked in C needs the watchdog's hard
abort.

The store is the one the job already has: the launch controller's
guardian store (``PADDLE_GUARDIAN_STORE`` / ``PADDLE_GUARDIAN_DIR``),
else the process group's rendezvous store (`CoordKVStore`, where the
JAX module reads its coordination service's KV).
"""
from __future__ import annotations

import io
import os
import threading
import time

import numpy as np


class CoordKVStore:
    """TCPStore-shaped KV (set, get, list_prefix, delete_key) over the
    default process group's rendezvous store (torch's c10d ``Store``):
    host collectives need no other infrastructure.  c10d stores cannot
    list keys, so ``list_prefix`` returns nothing."""

    def __init__(self, store):
        self._store = store

    def set(self, key, value):
        self._store.set(key, value)

    def get(self, key, default=None):
        if not self._store.check([key]):
            return default
        return self._store.get(key)

    def list_prefix(self, prefix):
        return {}

    def delete_key(self, key):
        self._store.delete_key(key)

    def close(self):
        pass


def coord_kv_store():
    """The default process group's store, or None without one."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        return None
    from torch.distributed import distributed_c10d as c10d
    return CoordKVStore(c10d._get_default_store())


def guardian_store():
    """The store the launch controller exported for the guardian, if any
    (shared with the error trap: one substrate, two protocols)."""
    endpoint = os.environ.get("PADDLE_GUARDIAN_STORE")
    root = os.environ.get("PADDLE_GUARDIAN_DIR")
    if endpoint:
        from .store import TCPStore
        host, port = endpoint.rsplit(":", 1)
        return TCPStore(host, int(port), timeout=20.0)
    if root:
        from .store import FileKVStore
        return FileKVStore(root)
    return None


class HostCollectives:
    """One gather primitive; every host collective derives from it."""

    def __init__(self, store, job="default"):
        self.store = store
        self.job = str(job)
        self._seq: dict[int, int] = {}
        self._lock = threading.Lock()

    def _key(self, gid, seq, rank):
        return f"{self.job}/hc/g{gid}/s{seq}/r{rank}"

    def gather(self, group, local, poll_s=0.005, rank=None):
        """Post this rank's array, block until every group member's
        contribution for the same per-group sequence number arrived, and
        return them stacked ``[nranks, ...]`` in group order.  ``rank``
        overrides the process group's (a worker with no process group
        passes its ``PADDLE_TRAINER_ID``).  The wait polls in short
        sleeps, where the watchdog's asynchronous exception lands."""
        from . import env as _env
        gid = getattr(group, "id", 0)
        with self._lock:
            seq = self._seq.get(gid, 0)
            self._seq[gid] = seq + 1
        local = np.asarray(local)
        me = _env.get_rank() if rank is None else int(rank)
        buf = io.BytesIO()
        np.save(buf, local, allow_pickle=False)
        self.store.set(self._key(gid, seq, me), buf.getvalue())
        if seq >= 2:
            # a peer inside seq - 1 has consumed every seq - 2
            # contribution: reclaim ours (bounded store growth)
            self.store.delete_key(self._key(gid, seq - 2, me))
        parts: dict[int, np.ndarray] = {}
        while True:
            for idx, r in enumerate(group.ranks):
                if idx in parts:
                    continue
                val = self.store.get(self._key(gid, seq, r))
                if val is not None:
                    parts[idx] = np.load(io.BytesIO(val),
                                         allow_pickle=False)
            if len(parts) == group.nranks:
                return np.stack([parts[i] for i in range(group.nranks)])
            time.sleep(poll_s)


_HC = None
_HC_LOCK = threading.Lock()


def bootstrap():
    """The process-wide HostCollectives over the best store the process
    has, or None (no shared store: a single process)."""
    global _HC
    with _HC_LOCK:
        if _HC is None:
            store = guardian_store() or coord_kv_store()
            _HC = False if store is None else HostCollectives(
                store, job=os.environ.get("PADDLE_JOB_ID", "default"))
        return _HC or None


def reset():
    global _HC
    with _HC_LOCK:
        _HC = None
