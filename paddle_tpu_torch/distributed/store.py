"""Key-value stores for rendezvous and fleet membership (port of
paddle_tpu/distributed/store.py).

- `TCPStore`: a client of the native TCP server in ``csrc/tcp_store.cpp``
  (a copy of the JAX package's, built by ``utils/cpp_extension.py`` with
  g++ and bound with ctypes); ``is_master=True`` hosts the server in this
  process.  Blocking ``wait``, atomic ``add``, prefix listing, and
  heartbeats stamped with the server's clock.
- `FileKVStore`: the same surface over a shared directory (atomic
  ``os.replace`` writes).
- `TCPElasticStore`: TTL leases (register, heartbeat, alive and expired
  nodes, ``reap``) over either store, as the serving fleet's membership.
- `Master`: endpoint rendezvous of ``nnodes`` nodes over a `TCPStore`.
"""
from __future__ import annotations

import ctypes
import os
import threading
import time

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from ..utils.cpp_extension import load
        lib = load("paddle_tpu_torch_tcp_store", ["tcp_store.cpp"])
        lib.ts_server_start.restype = ctypes.c_void_p
        lib.ts_server_start.argtypes = [ctypes.c_uint16]
        lib.ts_server_port.restype = ctypes.c_uint16
        lib.ts_server_port.argtypes = [ctypes.c_void_p]
        lib.ts_server_stop.argtypes = [ctypes.c_void_p]
        lib.ts_connect.restype = ctypes.c_int
        lib.ts_connect.argtypes = [ctypes.c_char_p, ctypes.c_uint16,
                                   ctypes.c_int]
        for name, extra in (("ts_set", [ctypes.c_char_p, ctypes.c_uint32]),
                            ("ts_get", [ctypes.c_char_p, ctypes.c_int64]),
                            ("ts_wait", [ctypes.c_uint32, ctypes.c_char_p,
                                         ctypes.c_int64]),
                            ("ts_del", []),
                            ("ts_list", [ctypes.c_char_p,
                                         ctypes.c_int64])):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int64
            fn.argtypes = [ctypes.c_int, ctypes.c_char_p,
                           ctypes.c_uint32] + extra
        lib.ts_add.restype = ctypes.c_int64
        lib.ts_add.argtypes = [ctypes.c_int, ctypes.c_char_p,
                               ctypes.c_uint32, ctypes.c_int64]
        lib.ts_stamp.restype = ctypes.c_int64
        lib.ts_stamp.argtypes = [ctypes.c_int, ctypes.c_char_p,
                                 ctypes.c_uint32]
        lib.ts_now.restype = ctypes.c_double
        lib.ts_now.argtypes = [ctypes.c_int]
        lib.ts_close.argtypes = [ctypes.c_int]
        _LIB = lib
    return _LIB


class TCPStore:
    """Key-value store client; optionally hosts the server in-process.

    TCPStore(host, port, is_master=True) starts the native server (port 0
    picks a free port — read it back from `.port`) and connects to it.
    """

    def __init__(self, host="127.0.0.1", port=0, is_master=False,
                 timeout=60.0):
        lib = _lib()
        self._server = None
        self.host = host
        # one fd, strict request/response framing: concurrent callers
        # (serving router watcher + dispatch threads, fleet orchestrator)
        # must not interleave on the wire
        self._io = threading.Lock()
        if is_master:
            self._server = lib.ts_server_start(port)
            if not self._server:
                raise RuntimeError(f"TCPStore: cannot bind port {port}")
            port = lib.ts_server_port(self._server)
        self.port = port
        # connect with exponential backoff + jitter (utils/retry.py):
        # short per-attempt timeouts with jittered gaps de-sync a fleet
        # of workers all dialing a restarting master at once
        from ..utils.retry import retry_call
        deadline = time.time() + timeout
        per_try_ms = max(200, int(timeout * 1000 / 5))

        def _connect():
            remaining = int((deadline - time.time()) * 1000)
            if remaining <= 0:
                raise ConnectionError("deadline exceeded")
            fd = lib.ts_connect(host.encode(), port,
                                min(per_try_ms, remaining))
            if fd < 0:
                raise ConnectionError("connect failed")
            return fd

        try:
            self._fd = retry_call(_connect, tries=64,
                                  retry_on=(ConnectionError,),
                                  base=0.05, max_delay=1.0,
                                  deadline=deadline)
        except ConnectionError:
            self._fd = -1
        if self._fd < 0:
            raise RuntimeError(
                f"TCPStore: cannot connect to {host}:{port} "
                f"within {timeout}s")

    def set(self, key, value):
        if isinstance(value, str):
            value = value.encode()
        with self._io:
            r = _lib().ts_set(self._fd, key.encode(), len(key.encode()),
                              value, len(value))
        if r < 0:
            raise RuntimeError(f"TCPStore.set({key!r}) failed")

    def get(self, key, default=None):
        # loop until the buffer fits (as list_prefix does): the value can
        # grow between the size probe and the re-fetch, and a single
        # retry would silently truncate it
        cap = 1 << 16
        while True:
            buf = ctypes.create_string_buffer(cap)
            with self._io:
                r = _lib().ts_get(self._fd, key.encode(),
                                  len(key.encode()), buf, cap)
            if r == -1:
                return default
            if r == -2:
                raise RuntimeError("TCPStore: connection lost")
            if r <= cap:
                return buf.raw[:r]
            cap = int(r)

    def wait(self, key, timeout=60.0):
        buf = ctypes.create_string_buffer(1 << 16)
        with self._io:
            r = _lib().ts_wait(self._fd, key.encode(), len(key.encode()),
                               int(timeout * 1000), buf, len(buf))
        if r == -1:
            raise TimeoutError(f"TCPStore.wait({key!r}): not set within "
                               f"{timeout}s")
        if r < 0:
            raise RuntimeError("TCPStore: connection lost")
        return buf.raw[:r]

    def add(self, key, delta=1):
        with self._io:
            v = _lib().ts_add(self._fd, key.encode(), len(key.encode()),
                              int(delta))
        if v == -(2 ** 63):
            raise RuntimeError(f"TCPStore.add({key!r}) failed")
        return v

    def delete_key(self, key):
        with self._io:
            _lib().ts_del(self._fd, key.encode(), len(key.encode()))

    def stamp(self, key):
        """Write the SERVER's clock under key (liveness heartbeats must
        not mix per-host wall clocks)."""
        with self._io:
            r = _lib().ts_stamp(self._fd, key.encode(),
                                len(key.encode()))
        if r < 0:
            raise RuntimeError(f"TCPStore.stamp({key!r}) failed")

    def server_now(self):
        """The server's clock (f64 seconds since epoch)."""
        with self._io:
            v = _lib().ts_now(self._fd)
        if v < 0:
            raise RuntimeError("TCPStore.server_now failed")
        return v

    def list_prefix(self, prefix):
        """{key: value} for all keys with the prefix."""
        cap = 1 << 16
        while True:
            buf = ctypes.create_string_buffer(cap)
            with self._io:
                r = _lib().ts_list(self._fd, prefix.encode(),
                                   len(prefix.encode()), buf, cap)
            if r < 0:
                raise RuntimeError("TCPStore: connection lost")
            if r <= cap:
                raw, out, off = buf.raw[:r], {}, 0
                while off < len(raw):
                    kl = int.from_bytes(raw[off:off + 4], "little")
                    key = raw[off + 4:off + 4 + kl].decode()
                    off += 4 + kl
                    vl = int.from_bytes(raw[off:off + 4], "little")
                    out[key] = raw[off + 4:off + 4 + vl]
                    off += 4 + vl
                return out
            cap = int(r)

    def close(self):
        with self._io:
            if self._fd >= 0:
                _lib().ts_close(self._fd)
                self._fd = -1
            if self._server:
                _lib().ts_server_stop(self._server)
                self._server = None


class FileKVStore:
    """TCPStore-shaped KV (set/get/add/delete_key/list_prefix) over a
    shared directory — the guardian/error-trap substrate when the job
    has no TCP store endpoint (single-host launch, tests).  Writes are
    tmp+``os.replace`` atomic, so a concurrent reader never sees a torn
    value; keys are percent-encoded into filenames so ``/``-structured
    keys (``{job}/error/{rank}``) round-trip."""

    def __init__(self, root):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _fname(self, key):
        from urllib.parse import quote
        return os.path.join(self.root, "kv." + quote(key, safe=""))

    def set(self, key, value):
        if isinstance(value, str):
            value = value.encode()
        path = self._fname(key)
        tmp = f"{path}.tmp.{os.getpid()}.{id(value)}"
        with open(tmp, "wb") as f:
            f.write(value)
        os.replace(tmp, path)

    def get(self, key, default=None):
        try:
            with open(self._fname(key), "rb") as f:
                return f.read()
        except FileNotFoundError:
            return default

    def add(self, key, delta=1):
        """Atomic counter via an exclusive lock file (retry loop)."""
        lock = os.path.join(self.root, "kv.lock")
        deadline = time.time() + 10.0
        while True:
            try:
                fd = os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                break
            except FileExistsError:
                if time.time() > deadline:
                    raise RuntimeError(
                        f"FileKVStore.add({key!r}): lock file {lock} "
                        "held for >10s (stale lock from a killed "
                        "process? delete it)") from None
                time.sleep(0.005)
        try:
            cur = self.get(key)
            val = (int(cur) if cur else 0) + int(delta)
            self.set(key, str(val))
            return val
        finally:
            os.close(fd)
            os.unlink(lock)

    def delete_key(self, key):
        try:
            os.unlink(self._fname(key))
        except FileNotFoundError:
            pass

    def list_prefix(self, prefix):
        from urllib.parse import unquote
        out = {}
        try:
            names = os.listdir(self.root)
        except FileNotFoundError:
            return out
        for name in names:
            if not name.startswith("kv.") or ".tmp." in name or \
                    name == "kv.lock":
                continue
            key = unquote(name[3:])
            if key.startswith(prefix):
                val = self.get(key)
                if val is not None:
                    out[key] = val
        return out

    def close(self):
        pass


class TCPElasticStore:
    """ElasticManager store interface (register/heartbeat/alive_nodes)
    over TCPStore — the etcd-grade replacement for FileStore when hosts
    share no filesystem.  Heartbeats are stamped with the SERVER's clock
    and compared against the server's clock (etcd leases pattern): a
    worker whose wall clock is skewed must not look dead.

    Also accepts any TCPStore-shaped KV without ``stamp``/``server_now``
    (``FileKVStore``): heartbeats then carry the writer's wall clock —
    fine for the single-host layouts those stores serve.

    Expired nodes are *filtered* by :meth:`alive_nodes` but their keys
    linger until :meth:`reap` deletes them.  The distinction matters to
    consumers like the serving router: a node key that exists-but-expired
    is a node that MISSED heartbeats (suspect, sticky-dead until it
    re-registers), while a reaped/absent key is a clean departure — so a
    flapping node cannot oscillate a consumer's view between polls."""

    def __init__(self, store, ttl=10):
        self.store = store
        self.ttl = ttl

    def _now(self):
        if hasattr(self.store, "server_now"):
            return self.store.server_now()
        return time.time()

    def register(self, node_id):
        self.heartbeat(node_id)

    def heartbeat(self, node_id):
        if hasattr(self.store, "stamp"):
            self.store.stamp(f"node.{node_id}")
        else:
            import struct
            self.store.set(f"node.{node_id}",
                           struct.pack("<d", time.time()))

    def is_registered(self, node_id):
        """Whether the node's key exists at all (expired or not) — a
        heartbeater whose key was reaped must RE-register (fresh join)
        instead of silently stamping a new key into existence."""
        return self.store.get(f"node.{node_id}") is not None

    def deregister(self, node_id):
        self.store.delete_key(f"node.{node_id}")

    def _scan(self):
        import struct
        now = self._now()
        alive, expired = [], []
        for key, val in self.store.list_prefix("node.").items():
            if len(val) != 8:
                continue
            ts = struct.unpack("<d", val)[0]
            node = key[len("node."):]
            (alive if now - ts <= self.ttl else expired).append(node)
        return sorted(alive), sorted(expired)

    def alive_nodes(self):
        return self._scan()[0]

    def expired_nodes(self):
        """Nodes whose key exists but whose lease lapsed (missed
        heartbeats, not yet reaped)."""
        return self._scan()[1]

    def reap(self):
        """Delete every expired-TTL node key and return the reaped ids.
        Until now expiry was only a read-side filter: dead keys lingered
        forever and a node that resumed stamping a stale key would flap
        back into ``alive_nodes()`` with no explicit rejoin.  After a
        reap the node's next heartbeat finds its key gone (see
        ``is_registered``) and must re-register — an explicit membership
        event instead of an oscillation."""
        reaped = self._scan()[1]
        for node in reaped:
            self.store.delete_key(f"node.{node}")
        return reaped


class Master:
    """Multi-node endpoint rendezvous (reference: HTTPMaster/ETCDMaster,
    launch/controllers/master.py:73,186).

    Node 0 hosts the store; every node publishes its endpoint and blocks
    until all `nnodes` endpoints are present, then receives the full
    ordered list — no shared filesystem required.
    """

    def __init__(self, endpoint, rank, nnodes, timeout=300.0):
        host, port = endpoint.rsplit(":", 1)
        self.rank, self.nnodes = rank, nnodes
        self.timeout = timeout
        self.store = TCPStore(host, int(port), is_master=(rank == 0),
                              timeout=timeout)

    def sync_endpoints(self, my_endpoint):
        from ..utils.retry import backoff_delays
        self.store.set(f"ep/{self.rank}", my_endpoint)
        deadline = time.time() + self.timeout
        # jittered exponential backoff (utils/retry.py): N nodes polling
        # in 0.2s lockstep hammer the master exactly together; backoff
        # spreads the polls and caps the idle latency at 1s
        delays = backoff_delays(base=0.05, max_delay=1.0, jitter=0.25)
        while True:
            # check ranks 0..n-1 directly: a stale key from a previous
            # incarnation must not satisfy the count while a rank is absent
            eps = self.store.list_prefix("ep/")
            wanted = [f"ep/{r}" for r in range(self.nnodes)]
            if all(k in eps for k in wanted):
                return [eps[k].decode() for k in wanted]
            if time.time() > deadline:
                missing = [k for k in wanted if k not in eps]
                raise TimeoutError(
                    f"rendezvous: missing {missing} after {self.timeout}s")
            time.sleep(next(delays))

    def close(self):
        self.store.close()
