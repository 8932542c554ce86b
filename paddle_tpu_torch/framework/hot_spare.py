"""Hot-spare recovery: buddy-replicated in-memory snapshots (port of
paddle_tpu/framework/hot_spare.py).

- Every ``FLAGS_hot_spare_every`` update steps a rank copies its state
  (the parameters, the optimizer's moments and masters, the scaler, the
  generators' states, a data pipeline's position: `hapi.Model`'s
  ``_hot_spare_state``) into host memory at the step boundary, and a
  background thread streams it to its **ring buddy**'s memory over the
  rpc plane's raw `Blob` frames: chunked, a crc32 per chunk, and double
  buffered on the receiver, where staged chunks replace the owner's last
  valid copy only at a commit whose every chunk arrived and whose whole
  crc checks.  One transfer is in flight at a time: a slow buddy skips
  cadences (``HotSpareAgent.stats["skipped"]``).
- The buddy of rank ``i`` is the next process in the mesh's process
  order (`derive_buddies`); the launch controller advertises the map in
  the guardian store for each (re)launched world.
- On an exit into a relaunch (a preemption, a peer's failure) the
  agent **parks** what it holds, its own snapshot and its buddies'
  replicas, in the guardian store, so a relaunch of the whole job finds
  a dead rank's state: the holder's live endpoint first, the parked copy
  second.

The recovery ladder, loudest first: (1) `peer_restore` (the advertised
map, the buddy's copy, crc and finiteness validated); (2) the sentinel's
rollback takes a validated local snapshot fresher than its disk anchor
(`sentinel_candidate`); (3) the disk (`restore_with_ladder`'s
``disk_fn``).  Each fall-through warns with `PeerRestoreWarning`.  The
``ckpt.peer.*`` families are declared when an agent is armed.

What differs from the JAX module, and why:

- The host copy is taken by the agent (`HotSpareAgent.capture`: every
  tensor into a reused host buffer, pinned for the card, one stream
  sync) before the step loop goes on, and only then handed to the
  thread: the port's optimizer and captured step write the parameters
  and moments in place, so a snapshot taken at step k is the state after
  step k, bit for bit, whatever later steps do.
- The chunks of a transfer ride in batches (up to ``_BATCH_BYTES``) a
  call; the whole payload's crc is combined from the chunks' own
  (`crc32_combine`) instead of read again, and a receiver keeps the
  chunks as they came rather than joining them.
- A rank keeps its last two snapshots, and parks the one whose step the
  replicas it holds have (`park`): a crashed rank's replica and its
  survivor's own copy then restore the same step.
"""
from __future__ import annotations

import functools
import io
import json
import os
import pickle
import sys
import threading
import time
import warnings
import zlib
from collections import deque

import torch

from ..utils.flags import flag as _flag

SCHEMA_VERSION = 1

#: guardian-store keys (all under ``{job}/hot_spare/``), JAX's
_K_BUDDIES = "{job}/hot_spare/buddies"
_K_ENDPOINT = "{job}/hot_spare/endpoints/r{rank}"
_K_PARKED = "{job}/hot_spare/parked/r{rank}"

#: chunks sent in one rpc call, at most this many bytes
_BATCH_BYTES = 64 << 20


class PeerSnapshotError(RuntimeError):
    """A hot-spare snapshot or restore failed."""


class BuddyUnavailableError(PeerSnapshotError):
    """The buddy holding this rank's replica cannot serve it (dead
    endpoint, no parked copy, or the ``buddy_crash`` drill)."""


class SnapshotIntegrityError(PeerSnapshotError):
    """A snapshot failed its crc or finiteness check."""


class PeerRestoreWarning(UserWarning):
    """Warned whenever the recovery ladder falls through a rung."""


# ----------------------------------------------------------------------
# telemetry: declared at arm time, so every series shows from zero
# ----------------------------------------------------------------------
def declare_metrics():
    """Register the ``ckpt.peer.*`` family (JAX's names and help)."""
    from ..observability import registry as _registry
    _registry.counter("ckpt.peer.snapshots",
                      "peer snapshots committed to a buddy's RAM")
    _registry.counter("ckpt.peer.bytes_sent",
                      "snapshot payload bytes streamed to buddies")
    _registry.counter("ckpt.peer.restores",
                      "recoveries served from a peer snapshot")
    _registry.counter("ckpt.peer.stale_skipped",
                      "peer snapshots consulted but older than the "
                      "competing disk state")
    _registry.counter("ckpt.peer.crc_failures",
                      "snapshot chunks/payloads failing crc or "
                      "finiteness validation")
    _registry.histogram("ckpt.peer.transfer_ms",
                        "wall time of one snapshot stream to the buddy")
    _registry.histogram("ckpt.peer.restore_ms",
                        "wall time of a peer-snapshot restore")
    return _registry


def _counter(name):
    from ..observability import registry as _registry
    return _registry.counter(name)


def _observe(name, value):
    from ..observability import registry as _registry
    _registry.histogram(name).observe(value)


# ----------------------------------------------------------------------
# crc32 of a concatenation from its parts' crcs (zlib's crc32_combine)
# ----------------------------------------------------------------------
def _gf2_times(mat, vec):
    s, i = 0, 0
    while vec:
        if vec & 1:
            s ^= mat[i]
        vec >>= 1
        i += 1
    return s


def _gf2_square(mat):
    return [_gf2_times(mat, mat[n]) for n in range(32)]


@functools.lru_cache(maxsize=16)
def _shift_operator(nbytes):
    """The GF(2) matrix that appends ``nbytes`` zero bytes to a crc."""
    odd = [0xEDB88320] + [1 << (n - 1) for n in range(1, 32)]
    even = _gf2_square(odd)                  # two zero bits
    odd = _gf2_square(even)                  # four zero bits
    op = [1 << n for n in range(32)]         # identity
    n = int(nbytes)
    while n:
        even = _gf2_square(odd)
        if n & 1:
            op = [_gf2_times(even, v) for v in op]
        n >>= 1
        if not n:
            break
        odd = _gf2_square(even)
        if n & 1:
            op = [_gf2_times(odd, v) for v in op]
        n >>= 1
    return tuple(op)


def crc32_combine(crc1, crc2, len2):
    """``zlib.crc32(a + b)`` from ``crc32(a)``, ``crc32(b)`` and
    ``len(b)``."""
    if len2 <= 0:
        return crc1
    return _gf2_times(_shift_operator(len2), crc1) ^ crc2


def _parts(payload):
    return payload if isinstance(payload, (list, tuple)) else (payload,)


def _nbytes(payload):
    return sum(memoryview(p).nbytes for p in _parts(payload))


def _crc(payload):
    crc = 0
    for p in _parts(payload):
        crc = zlib.crc32(p, crc)
    return crc


def _own_bytes(data):
    """``data`` as bytes, without a copy when it views a whole bytes
    object (an rpc frame as received)."""
    if isinstance(data, memoryview) and isinstance(data.obj, bytes) and \
            len(data.obj) == data.nbytes:
        return data.obj
    return bytes(data)


def _joined(payload):
    parts = _parts(payload)
    return parts[0] if len(parts) == 1 else b"".join(parts)


# ----------------------------------------------------------------------
# buddy ring
# ----------------------------------------------------------------------
def derive_buddies(world, mesh=None):
    """``{rank: holder}``: rank ``r``'s replica lives on ``buddies[r]``,
    the next process in ring order, the mesh's process order when the
    mesh covers this world (`distributed.mesh.get_mesh` when ``mesh`` is
    None), else rank order.  A world of one has no buddy."""
    world = int(world)
    if mesh is None:
        from ..distributed.mesh import get_mesh
        mesh = get_mesh()
    order = None
    pids = list(getattr(mesh, "process_ids", None) or []) \
        if mesh is not None else []
    if len(pids) == world:
        order = [int(p) for p in pids]
    if order is None:
        order = list(range(world))
    if len(order) < 2:
        return {}
    n = len(order)
    return {order[i]: order[(i + 1) % n] for i in range(n)}


def advertise_buddy_map(store, job, world, mesh=None, resized_from=None):
    """Write the buddy map into the guardian store (the launch controller,
    each incarnation); returns it."""
    buddies = derive_buddies(world, mesh=mesh)
    doc = {"schema": SCHEMA_VERSION, "world": int(world),
           "buddies": {str(k): v for k, v in buddies.items()}}
    if resized_from is not None:
        doc["resized_from"] = int(resized_from)
    store.set(_K_BUDDIES.format(job=job), json.dumps(doc).encode())
    return buddies


def read_buddy_map(store, job):
    """The advertised ``{rank: holder}`` map, or None."""
    raw = store.get(_K_BUDDIES.format(job=job))
    if not raw:
        return None
    try:
        doc = json.loads(bytes(raw).decode())
        return {int(k): int(v) for k, v in doc["buddies"].items()}
    except (ValueError, KeyError, TypeError):
        return None


# ----------------------------------------------------------------------
# snapshot records and the receiver's double buffer
# ----------------------------------------------------------------------
class Captured:
    """A state tree already flattened, its arrays copied to the host
    (`HotSpareAgent.capture`)."""

    __slots__ = ("tree", "arrays")

    def __init__(self, tree, arrays):
        self.tree = tree
        self.arrays = arrays


def pack_state(state):
    """Host state tree (or `Captured`) → payload bytes: the flattened
    tree (`distributed.reshard.flatten_state`) and its arrays, pickled as
    a shard file's are."""
    from ..distributed.reshard import _host_array, flatten_state
    if isinstance(state, Captured):
        tree, arrays = state.tree, state.arrays
    else:
        tree, arrays = flatten_state(state)
    return pickle.dumps(
        {"tree": tree, "arrays": {k: _host_array(v)
                                  for k, v in arrays.items()}},
        protocol=5)


def unpack_state(payload):
    """Payload → the state tree, tensors on the CPU."""
    from ..distributed.reshard import _host_tensor, rebuild_state
    from .io import _resolve, _Unpickler
    doc = _resolve(_Unpickler(io.BytesIO(_joined(payload))).load())
    return rebuild_state(doc["tree"], {k: _host_tensor(v)
                                       for k, v in doc["arrays"].items()})


def chunk_crcs(payload, chunk_bytes):
    """The crc32 of each ``chunk_bytes`` slice of ``payload`` and, combined
    from them, the whole payload's: one pass over the bytes."""
    view = memoryview(payload)
    crcs = [zlib.crc32(view[i:i + chunk_bytes])
            for i in range(0, len(view), chunk_bytes)] or [0]
    whole = 0
    for i, c in enumerate(crcs):
        whole = crc32_combine(whole, c,
                              len(view[i * chunk_bytes:
                                       (i + 1) * chunk_bytes]))
    return crcs, whole


def make_record(owner, step, book, state, *, chunk_bytes=None):
    """A snapshot record; with ``chunk_bytes`` it also keeps each chunk's
    crc (``chunk_crcs``) for the stream, the whole crc combined from them
    instead of read again."""
    payload = pack_state(state)
    if chunk_bytes:
        crcs, crc = chunk_crcs(payload, chunk_bytes)
    else:
        crcs, crc = None, zlib.crc32(payload)
    record = {"schema": SCHEMA_VERSION, "owner": int(owner),
              "step": int(step), "book": dict(book or {}),
              "nbytes": len(payload), "crc": crc,
              "payload": payload, "parked_by": None}
    if crcs is not None:
        record["chunk_crcs"] = (int(chunk_bytes), crcs)
    return record


def verify_record(record):
    """crc-check a record's payload; raises `SnapshotIntegrityError`
    (counting ``ckpt.peer.crc_failures``) on a mismatch."""
    crc = _crc(record["payload"])
    n = _nbytes(record["payload"])
    if crc != record["crc"] or n != record["nbytes"]:
        _counter("ckpt.peer.crc_failures").inc()
        raise SnapshotIntegrityError(
            f"peer snapshot for rank {record.get('owner')} step "
            f"{record.get('step')} failed crc (got {crc:#x}, recorded "
            f"{record['crc']:#x}, {n} of {record['nbytes']} bytes)")
    return record


def validated_state(record):
    """Record → ``(state, book)`` after the crc and finiteness checks (a
    non-finite snapshot counts as a crc failure too)."""
    verify_record(record)
    state = unpack_state(record["payload"])
    from .checkpoint_manager import validate_finite_state
    try:
        validate_finite_state(state)
    except Exception as e:
        _counter("ckpt.peer.crc_failures").inc()
        raise SnapshotIntegrityError(
            f"peer snapshot for rank {record.get('owner')} step "
            f"{record.get('step')} failed finiteness validation: {e}"
        ) from e
    return state, record["book"]


class HotSpareStore:
    """The receiver's replicas: one valid record an owner plus staging
    buffers by transfer.  Chunks stage under their transfer id; only a
    commit that has every chunk and whose whole crc checks replaces the
    owner's valid record, so a sender dying mid-transfer leaves the
    previous copy as it was."""

    def __init__(self):
        self._lock = threading.Lock()
        self._valid = {}      # owner -> committed record
        self._staging = {}    # (owner, xfer_id) -> staging dict

    def begin(self, owner, xfer_id, step, book, total_chunks,
              total_bytes, payload_crc):
        with self._lock:
            self._staging[(int(owner), str(xfer_id))] = {
                "step": int(step), "book": dict(book or {}),
                "total_chunks": int(total_chunks),
                "total_bytes": int(total_bytes),
                "crc": int(payload_crc), "chunks": {}, "poisoned": False}

    def chunk(self, owner, xfer_id, idx, chunk_crc, data):
        key = (int(owner), str(xfer_id))
        if zlib.crc32(data) != int(chunk_crc):
            _counter("ckpt.peer.crc_failures").inc()
            with self._lock:
                st = self._staging.get(key)
                if st is not None:
                    st["poisoned"] = True
            raise SnapshotIntegrityError(
                f"chunk {idx} of transfer {xfer_id} (owner {owner}) "
                "failed crc32 — rejected before staging")
        with self._lock:
            st = self._staging.get(key)
            if st is None:
                raise PeerSnapshotError(
                    f"chunk for unknown transfer {xfer_id} "
                    f"(owner {owner}) — no begin seen")
            st["chunks"][int(idx)] = (_own_bytes(data), int(chunk_crc))

    def commit(self, owner, xfer_id):
        """Replace the owner's valid record, or refuse (the previous
        copy survives every refusal)."""
        key = (int(owner), str(xfer_id))
        with self._lock:
            st = self._staging.pop(key, None)
        if st is None:
            raise PeerSnapshotError(
                f"commit for unknown transfer {xfer_id} (owner {owner})")
        if st["poisoned"] or len(st["chunks"]) != st["total_chunks"]:
            raise PeerSnapshotError(
                f"transfer {xfer_id} (owner {owner}) incomplete at "
                f"commit: {len(st['chunks'])}/{st['total_chunks']} "
                f"chunks{' (poisoned)' if st['poisoned'] else ''}")
        parts, crc, n = [], 0, 0
        for i in range(st["total_chunks"]):
            data, c = st["chunks"][i]
            crc = crc32_combine(crc, c, len(data))
            n += len(data)
            parts.append(data)
        if n != st["total_bytes"] or crc != st["crc"]:
            _counter("ckpt.peer.crc_failures").inc()
            raise SnapshotIntegrityError(
                f"transfer {xfer_id} (owner {owner}) payload failed "
                "whole-payload crc at commit — last valid copy kept")
        record = {"schema": SCHEMA_VERSION, "owner": int(owner),
                  "step": st["step"], "book": st["book"],
                  "nbytes": st["total_bytes"], "crc": st["crc"],
                  "payload": parts, "parked_by": None}
        with self._lock:
            self._valid[int(owner)] = record
        return record["step"]

    def latest(self, owner):
        with self._lock:
            return self._valid.get(int(owner))

    def install(self, record):
        """Install a committed record directly (a local agent)."""
        with self._lock:
            self._valid[int(record["owner"])] = record

    def owners(self):
        with self._lock:
            return sorted(self._valid)


#: per-job receiver stores; module-level so the rpc-served functions
#: (pickled by reference) reach the same objects in the server process
_STORES: dict = {}
_STORES_LOCK = threading.Lock()


def store_for(job):
    with _STORES_LOCK:
        st = _STORES.get(str(job))
        if st is None:
            st = _STORES[str(job)] = HotSpareStore()
        return st


# ------ rpc-served endpoints (module-level: pickled by reference) -----
def _rpc_begin(job, owner, xfer_id, step, book_json, total_chunks,
               total_bytes, payload_crc):
    store_for(job).begin(owner, xfer_id, step, json.loads(book_json),
                         total_chunks, total_bytes, payload_crc)
    return "ok"


def _rpc_chunks(job, owner, xfer_id, first, crcs, *blobs):
    """Chunks ``first`` .. ``first + len(blobs) - 1`` of a transfer, each
    a raw frame."""
    st = store_for(job)
    for i, (c, blob) in enumerate(zip(crcs, blobs)):
        st.chunk(owner, xfer_id, first + i, c,
                 blob.data if hasattr(blob, "data") else blob)
    return "ok"


def _rpc_commit(job, owner, xfer_id):
    return store_for(job).commit(owner, xfer_id)


def _rpc_fetch(job, owner):
    """The newest valid replica held for ``owner`` (a live peer restore),
    pickled, or None."""
    rec = store_for(job).latest(owner)
    if rec is None:
        return None
    return pickle.dumps(rec, protocol=pickle.HIGHEST_PROTOCOL)


# ----------------------------------------------------------------------
# the per-rank agent
# ----------------------------------------------------------------------
_XFER_SEQ = [0]


def _next_xfer_id(rank):
    _XFER_SEQ[0] += 1
    return f"{os.getpid()}-{rank}-{_XFER_SEQ[0]}"


def worker_name(job, rank):
    return f"hotspare:{job}:r{int(rank)}"


class HotSpareAgent:
    """One a training process: the rank's own snapshots (its last two),
    an rpc endpoint receiving its buddies' streams into the process's
    `HotSpareStore` (a world above one), and the park on exit.

    ``stats``: snapshots taken, cadences ``skipped`` (a transfer still in
    flight), ``capture_ms`` (the step boundary's host copy), ``bytes`` of
    the newest payload, ``transfer_ms`` of each committed stream,
    ``failures``, and the park's ``park_ms`` / ``park_bytes``."""

    def __init__(self, job, rank, world, store=None, every=None,
                 chunk_bytes=None, timeout_s=None, serve=None):
        self.job = str(job)
        self.rank = int(rank)
        self.world = int(world)
        self.every = max(int(every if every is not None
                             else _flag("FLAGS_hot_spare_every", 8)), 1)
        self.chunk_bytes = max(int(
            chunk_bytes if chunk_bytes is not None
            else _flag("FLAGS_hot_spare_chunk_kb", 1024) * 1024), 1)
        self.timeout_s = float(timeout_s if timeout_s is not None
                               else _flag("FLAGS_hot_spare_timeout_s",
                                          10.0))
        if store is None:
            from ..distributed.host_collectives import guardian_store
            store = guardian_store()
        self.store = store
        self.buddies = derive_buddies(self.world)
        from ..distributed.fleet.elastic import resized_worlds
        resized = resized_worlds()
        if resized is not None:
            old, new = resized
            print(f"hot-spare: buddy ring re-derived after elastic "
                  f"resize {old}->{new}: {self.buddies}",
                  file=sys.stderr, flush=True)
        self._history = deque(maxlen=2)   # own newest records
        self._lock = threading.Lock()
        self._thread = None
        self._parked = False
        self._closing = False             # a stream in flight stops
        self._host = {}                   # flat key -> reused host buffer
        self.stats = {"snapshots": 0, "skipped": 0, "capture_ms": [],
                      "bytes": 0, "transfer_ms": [], "failures": 0,
                      "park_ms": None, "park_bytes": 0}
        self._server = None
        if serve is None:
            serve = self.world > 1
        if serve:
            from ..distributed.rpc.rpc import RpcServer
            self._server = RpcServer(worker_name(self.job, self.rank))
            if self.store is not None:
                self.store.set(
                    _K_ENDPOINT.format(job=self.job, rank=self.rank),
                    json.dumps({"name": self._server.info.name,
                                "ip": self._server.info.ip,
                                "port": self._server.info.port,
                                "pid": os.getpid()}).encode())

    # -- snapshot side -------------------------------------------------
    def capture(self, state):
        """`Captured` ``state``: every tensor copied into this agent's
        host buffers (pinned for a tensor on the card; one sync of the
        current stream), so the copy is finished before the caller's
        next step writes.  The buffers are reused by the next capture,
        which one transfer in flight at a time allows."""
        from ..distributed.reshard import flatten_state
        tree, arrays = flatten_state(state)
        host, cuda = {}, False
        for key, t in arrays.items():
            if not torch.is_tensor(t):
                host[key] = torch.from_numpy(t.copy())
                continue
            buf = self._host.get(key)
            if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
                buf = torch.empty(t.shape, dtype=t.dtype,
                                  pin_memory=t.is_cuda)
                self._host[key] = buf
            buf.copy_(t, non_blocking=t.is_cuda)
            cuda = cuda or t.is_cuda
            host[key] = buf
        if cuda:
            torch.cuda.current_stream().synchronize()
        return Captured(tree, host)

    def maybe_snapshot(self, it, state_fn, book):
        """Every ``every``-th update step: copy ``state_fn()`` to the host
        (`capture`) and stream it to the buddy on a background thread.
        One transfer in flight at a time: a cadence that finds one
        running is skipped."""
        if int(it) % self.every != 0:
            return False
        if self._thread is not None and self._thread.is_alive():
            self.stats["skipped"] += 1
            return False
        t0 = time.perf_counter()
        state = self.capture(state_fn())
        self.stats["capture_ms"].append((time.perf_counter() - t0) * 1e3)
        self._thread = threading.Thread(
            target=self._snapshot, args=(int(it), state, dict(book)),
            daemon=True, name=f"hot-spare-snap-{it}")
        self._thread.start()
        return True

    def snapshot_now(self, it, state, book):
        """Synchronous capture and stream (tests, drills)."""
        self.wait()
        self._snapshot(int(it), self.capture(state), dict(book))

    def _snapshot(self, it, state, book):
        try:
            record = make_record(self.rank, it, book, state,
                                 chunk_bytes=self.chunk_bytes)
        except Exception as e:
            print(f"hot-spare: snapshot serialization failed at it "
                  f"{it}: {e}", file=sys.stderr, flush=True)
            self.stats["failures"] += 1
            return
        with self._lock:
            self._history.append(record)
        self.stats["snapshots"] += 1
        self.stats["bytes"] = record["nbytes"]
        holder = self.buddies.get(self.rank)
        if holder is None or self._server is None:
            return
        try:
            self._stream(record, holder)
        except Exception as e:
            # a dead or slow buddy never takes the step loop down: the
            # local copy and the disk rung still stand
            self.stats["failures"] += 1
            print(f"hot-spare: stream to buddy rank {holder} failed: "
                  f"{e}", file=sys.stderr, flush=True)

    def _stream(self, record, holder):
        from ..distributed.rpc.rpc import Blob, rpc_sync
        from ..utils import fault_injection as _fi
        to = self._resolve(holder)
        if to is None:
            return False
        view = memoryview(record["payload"])
        step = self.chunk_bytes
        chunks = [view[i:i + step] for i in range(0, len(view), step)] \
            or [view[:0]]
        size, crcs = record.get("chunk_crcs") or (None, None)
        if size != step:
            crcs = [zlib.crc32(c) for c in chunks]
        xfer = _next_xfer_id(self.rank)
        t0 = time.perf_counter()
        rpc_sync(to, _rpc_begin,
                 (self.job, self.rank, xfer, record["step"],
                  json.dumps(record["book"]), len(chunks),
                  record["nbytes"], record["crc"]),
                 timeout=self.timeout_s)
        drop = _fi.check_peer_snap_drop(record["step"])
        stop_after = drop.get("after_chunks", 1) if drop is not None \
            else None
        limit = len(chunks) if stop_after is None \
            else min(stop_after, len(chunks))
        i = 0
        while i < limit:
            if self._closing:
                return False          # a closed agent sends no more
            j, size = i, 0
            while j < limit and (j == i or size + len(chunks[j])
                                 <= _BATCH_BYTES):
                size += len(chunks[j])
                j += 1
            rpc_sync(to, _rpc_chunks,
                     (self.job, self.rank, xfer, i, crcs[i:j],
                      *[Blob(c) for c in chunks[i:j]]),
                     timeout=self.timeout_s)
            i = j
        if stop_after is not None:
            # the drill's sender death mid-transfer: staging left torn,
            # no commit; the buddy's last valid copy stands
            return False
        rpc_sync(to, _rpc_commit, (self.job, self.rank, xfer),
                 timeout=self.timeout_s)
        ms = (time.perf_counter() - t0) * 1e3
        self.stats["transfer_ms"].append(ms)
        _counter("ckpt.peer.snapshots").inc()
        _counter("ckpt.peer.bytes_sent").inc(record["nbytes"])
        _observe("ckpt.peer.transfer_ms", ms)
        return True

    def _resolve(self, holder):
        """The worker name of ``holder``'s endpoint, registered from the
        guardian store when it is there."""
        name = worker_name(self.job, holder)
        if self.store is not None:
            raw = self.store.get(
                _K_ENDPOINT.format(job=self.job, rank=holder))
            if raw:
                try:
                    ep = json.loads(bytes(raw).decode())
                    from ..distributed.rpc.rpc import connect_worker
                    connect_worker(ep["name"], ep["ip"], ep["port"])
                    return ep["name"]
                except (ValueError, KeyError):
                    pass
        return name

    # -- local accessors -----------------------------------------------
    def latest_record(self):
        with self._lock:
            return self._history[-1] if self._history else None

    def record_at(self, step):
        """This rank's own record of ``step``, if it still has it."""
        with self._lock:
            for rec in reversed(self._history):
                if rec["step"] == int(step):
                    return rec
        return None

    def wait(self, timeout=None):
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout if timeout is not None else self.timeout_s)

    # -- park on exit --------------------------------------------------
    def park(self):
        """Put every snapshot this process holds, its own and its
        buddies' replicas, in the guardian store, so they outlive the
        relaunch.  Its own is the one at the replicas' step when it has
        it (a dead rank's replica and this rank's copy then restore the
        same step), else its newest.  Idempotent; returns how many were
        parked."""
        if self._parked:
            return 0
        self.wait()
        if self.store is None:
            return 0
        t0 = time.perf_counter()
        held = store_for(self.job)
        replicas = [rec for rec in (held.latest(o) for o in held.owners())
                    if rec is not None and rec["owner"] != self.rank]
        own = None
        if replicas:
            own = self.record_at(min(r["step"] for r in replicas))
        own = own or self.latest_record()
        records = ([own] if own is not None else []) + replicas
        parked = 0
        for rec in records:
            rec = dict(rec, parked_by=self.rank)
            try:
                self.store.set(
                    _K_PARKED.format(job=self.job, rank=rec["owner"]),
                    pickle.dumps(rec, protocol=pickle.HIGHEST_PROTOCOL))
                parked += 1
                self.stats["park_bytes"] += rec["nbytes"]
            except Exception as e:
                print(f"hot-spare: parking snapshot for rank "
                      f"{rec['owner']} failed: {e}", file=sys.stderr,
                      flush=True)
        self.stats["park_ms"] = (time.perf_counter() - t0) * 1e3
        self._parked = True
        return parked

    def close(self, park=True):
        """Park (``park``) and stop.  Without a park, a stream in flight
        stops at its next batch of chunks, uncommitted (the buddy keeps
        its last valid copy)."""
        if park:
            self.park()
        else:
            self._closing = True
            self.wait()
        if self._server is not None:
            self._server.close()
            self._server = None
        global _AGENT
        if _AGENT is self:
            _AGENT = None


# ----------------------------------------------------------------------
# the process's armed agent
# ----------------------------------------------------------------------
_AGENT = None


def arm(rank, world, job=None, store=None, **kw):
    """Declare the telemetry and install the process's agent (replacing
    and closing a previous one)."""
    global _AGENT
    declare_metrics()
    if _AGENT is not None:
        _AGENT.close(park=False)
    job = job if job is not None else os.environ.get("PADDLE_JOB_ID",
                                                     "default")
    _AGENT = HotSpareAgent(job, rank, world, store=store, **kw)
    # the guardian's exits (a peer's failure, a hard abort) park too
    from ..distributed import watchdog
    watchdog.add_exit_hook(park_current)
    return _AGENT


def disarm(park=False):
    global _AGENT
    if _AGENT is not None:
        _AGENT.close(park=park)
        _AGENT = None


def current_agent():
    return _AGENT


def park_current():
    """Park the armed agent's snapshots (an exit path: the guardian's
    peer-failure exit, a signal); 0 without an agent."""
    agent = _AGENT
    return agent.park() if agent is not None else 0


def sentinel_candidate():
    """The armed agent's newest finiteness-validated own snapshot as
    ``(state, book)``, or None (a failed check warns)."""
    agent = _AGENT
    if agent is None:
        return None
    rec = agent.latest_record()
    if rec is None:
        return None
    try:
        return validated_state(rec)
    except PeerSnapshotError as e:
        warnings.warn(f"hot-spare: local snapshot unusable for "
                      f"sentinel rollback ({e}); falling back to the "
                      "disk anchor", PeerRestoreWarning, stacklevel=2)
        return None


# ----------------------------------------------------------------------
# the recovery ladder
# ----------------------------------------------------------------------
def peer_restore(job, rank, store=None, timeout_s=None):
    """Rung 1: ``rank``'s state from its buddy's memory, the holder's
    live endpoint first, then the parked copy.  Returns ``(state, book,
    source)``, source ``"peer"`` (a buddy's replica) or ``"self"`` (this
    rank's own parked copy), or None when there is no snapshot.  Raises
    `BuddyUnavailableError` under the ``buddy_crash`` drill and
    `SnapshotIntegrityError` when the snapshot fails its checks."""
    if store is None:
        from ..distributed.host_collectives import guardian_store
        store = guardian_store()
    if store is None:
        return None
    rank = int(rank)
    timeout_s = float(timeout_s if timeout_s is not None
                      else _flag("FLAGS_hot_spare_timeout_s", 10.0))
    buddies = read_buddy_map(store, job) or {}
    holder = buddies.get(rank)
    from ..utils import fault_injection as _fi
    t0 = time.perf_counter()
    raw = None
    if holder is not None:
        if _fi.check_buddy_crash() is not None:
            raise BuddyUnavailableError(
                f"buddy rank {holder} holding rank {rank}'s replica is "
                "down (injected buddy_crash)")
        ep_raw = store.get(_K_ENDPOINT.format(job=job, rank=holder))
        if ep_raw:
            try:
                ep = json.loads(bytes(ep_raw).decode())
                from ..distributed.rpc.rpc import connect_worker, rpc_sync
                connect_worker(ep["name"], ep["ip"], ep["port"])
                raw = rpc_sync(ep["name"], _rpc_fetch, (job, rank),
                               timeout=timeout_s)
            except (ConnectionError, TimeoutError, OSError, ValueError,
                    KeyError):
                raw = None
    if raw is None:
        raw = store.get(_K_PARKED.format(job=job, rank=rank))
    if raw is None:
        if holder is not None and _fi.active("buddy_crash") is not None:
            raise BuddyUnavailableError(
                f"no live endpoint and no parked snapshot for rank "
                f"{rank} (holder rank {holder})")
        return None
    record = pickle.loads(bytes(raw))
    state, book = validated_state(record)
    source = "self" if record.get("parked_by") == rank else "peer"
    ms = (time.perf_counter() - t0) * 1e3
    _counter("ckpt.peer.restores").inc()
    _observe("ckpt.peer.restore_ms", ms)
    print(f"hot-spare: rank {rank} restored from {source} snapshot "
          f"(step {record['step']}, {record['nbytes']} bytes, "
          f"{ms:.0f}ms)", file=sys.stderr, flush=True)
    return state, book, source


def restore_with_ladder(job, rank, disk_fn, store=None, timeout_s=None):
    """The recovery ladder, loudest first: `peer_restore`; a failure
    there warns (`PeerRestoreWarning`) and falls through to ``disk_fn``
    (which returns ``(state, book, "disk")`` or None; None: no disk
    rung)."""
    declare_metrics()
    got = None
    try:
        got = peer_restore(job, rank, store=store, timeout_s=timeout_s)
    except PeerSnapshotError as e:
        msg = (f"hot-spare: peer restore failed for rank {rank} "
               f"({type(e).__name__}: {e}); falling back to disk")
        warnings.warn(msg, PeerRestoreWarning, stacklevel=2)
        print(f"PeerRestoreWarning: {msg}", file=sys.stderr, flush=True)
    if got is not None:
        return got
    if disk_fn is None:
        return None
    return disk_fn()
