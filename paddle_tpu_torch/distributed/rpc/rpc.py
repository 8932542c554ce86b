"""The rpc plane (port of paddle_tpu/distributed/rpc/rpc.py).

``init_rpc`` / ``rpc_sync`` / ``rpc_async`` / ``shutdown`` with a
master-coordinated worker registry, and standalone `RpcServer`s whose
endpoints are published out of band (the serving fleet gossips them
through ``distributed/store.py``).  Calls travel over
``multiprocessing.connection`` (authenticated TCP, pickle).  Large
binary arguments, serving's KV-page frames, take the raw-bytes path: a
`Blob` argument (or any bytes-like one of at least `RAW_THRESHOLD`
bytes) is sent as one ``send_bytes`` frame straight from the caller's
buffer, never through pickle's object graph.  The call envelope carries
the caller's trace context (``observability/tracing.py`` ``current_wire``
/ ``bind_wire``), so one request's spans cross processes.  The fault
points ``rpc_drop`` and ``rpc_delay`` fire at connect time, ``rpc_slow``
in the call (``utils/fault_injection.py``).
"""
from __future__ import annotations

import os
import pickle
import threading
import time
from concurrent.futures import Future
from multiprocessing.connection import Listener, Client

from ...observability import tracing as _trace


class WorkerInfo:
    def __init__(self, name, rank, ip, port):
        self.name = name
        self.rank = rank
        self.ip = ip
        self.port = port

    def __repr__(self):
        return (f"WorkerInfo(name={self.name}, rank={self.rank}, "
                f"ip={self.ip}, port={self.port})")


_state = {"workers": {}, "me": None, "listener": None, "thread": None,
          "authkey": b"paddle_tpu_rpc", "running": False}

#: args at least this big ride the raw-bytes fast path automatically
#: (bytes/bytearray/memoryview; other buffer types wrap in `Blob`)
RAW_THRESHOLD = 32 * 1024


class Blob:
    """A large binary rpc argument that rides raw byte frames instead of
    pickle's object graph (the KV-page-migration fast path: a page
    tensor serialized through pickle is walked, memo'd and copied; a
    `send_bytes` frame is written straight from the caller's buffer).

    Wraps any C-contiguous buffer (bytes, numpy array, ...) WITHOUT
    copying: ``data`` is a flat byte memoryview over the original
    object.  On the receiving side the callee gets a `Blob` over the
    received frame; ``np.frombuffer(blob.data, ...)`` reconstructs
    arrays without a further copy.  Pickling a Blob raises — taking the
    slow path silently is exactly the bug this class exists to stop."""

    __slots__ = ("data",)

    def __init__(self, obj):
        view = memoryview(obj)
        if not view.contiguous:
            raise ValueError(
                "Blob needs a C-contiguous buffer; copy first "
                "(np.ascontiguousarray)")
        self.data = view.cast("B")

    def __len__(self):
        return self.data.nbytes

    def tobytes(self):
        return self.data.tobytes()

    def __reduce__(self):
        raise TypeError(
            "rpc.Blob must ride the raw-bytes fast path, never pickle "
            "(a Blob arg reached a pickling code path)")


class _BlobSlot:
    """Pickled placeholder marking where a raw frame re-enters args."""

    __slots__ = ("index",)

    def __init__(self, index):
        self.index = index

    def __reduce__(self):
        return (_BlobSlot, (self.index,))


def _extract_blobs(args):
    """Split (args) into (args with placeholders, blobs).  Explicit
    `Blob`s always go raw; bytes-like args at or past RAW_THRESHOLD are
    promoted automatically (small ones pickle as before — the framing
    overhead only pays for itself on large payloads)."""
    out, blobs = [], []
    for a in args:
        if not isinstance(a, Blob) and isinstance(
                a, (bytes, bytearray, memoryview)) and \
                memoryview(a).nbytes >= RAW_THRESHOLD:
            a = Blob(a)
        if isinstance(a, Blob):
            out.append(_BlobSlot(len(blobs)))
            blobs.append(a)
        else:
            out.append(a)
    return tuple(out), blobs


def _send_blob(conn, blob):
    """One raw frame, written from the caller's own buffer (module-level
    so tests can assert send-side zero-copy by interposing here)."""
    conn.send_bytes(blob.data)


def _serve_loop():
    while _state["running"]:
        try:
            conn = _state["listener"].accept()
        except OSError:
            break
        threading.Thread(target=_handle, args=(conn,), daemon=True).start()


class RpcServer:
    """Standalone rpc agent: a listener serving python callables with NO
    master rendezvous — the endpoint is published out of band (the
    serving fleet gossips it through ``distributed/store.py``).  Unlike
    :func:`init_rpc`'s process-global agent, any number of RpcServers
    can coexist in one process (thread-mode replica tests host several),
    each with its own listener and accept loop.  ``close()`` is
    idempotent."""

    def __init__(self, name, host="127.0.0.1", port=0):
        self.name = name
        # backlog: the default of 1 drops SYNs when several router
        # dispatch threads dial at once — the kernel then retransmits
        # with exponential backoff and a "fast" connect silently takes
        # seconds to minutes.  A serving endpoint needs real depth.
        self._listener = Listener((host, port), backlog=64,
                                  authkey=_state["authkey"])
        self.info = WorkerInfo(name, -1, host, self._listener.address[1])
        self._running = True
        self._thread = threading.Thread(
            target=self._loop, name=f"rpc-server-{name}", daemon=True)
        self._thread.start()
        # reachable through the local registry too (self-calls in tests)
        _state["workers"][name] = self.info

    def _loop(self):
        while self._running:
            try:
                conn = self._listener.accept()
            except OSError:
                return
            except Exception:
                # failed handshake (incl. close()'s wake-up poke):
                # keep serving while running, exit once closed
                continue
            if not self._running:
                conn.close()
                return
            threading.Thread(target=_handle, args=(conn,),
                             daemon=True).start()

    def close(self):
        if not self._running:
            return
        self._running = False
        try:
            self._listener.close()
        except OSError:
            pass
        # a thread blocked in accept() holds the kernel listening socket
        # open — close() alone does NOT wake it, and the port would keep
        # accepting calls.  Poke one throwaway connection to unblock it.
        _poke(self.info.ip, self.info.port)
        self._thread.join(2.0)
        if _state["workers"].get(self.name) is self.info:
            del _state["workers"][self.name]


def _poke(ip, port):
    """Wake a thread blocked in Listener.accept() so the closed socket
    is actually released by the kernel (see RpcServer.close)."""
    import socket
    try:
        s = socket.create_connection((ip, port), timeout=0.5)
        s.close()
    except OSError:
        pass


def connect_worker(name, ip, port, rank=-1):
    """Register a remote worker endpoint discovered out of band (store
    gossip) so ``rpc_sync``/``rpc_async`` can reach it without the
    master-coordinated registry.  Returns the WorkerInfo."""
    info = WorkerInfo(name, rank, ip, int(port))
    _state["workers"][name] = info
    return info


def forget_worker(name):
    """Drop a worker from the local registry (dead replica)."""
    _state["workers"].pop(name, None)


def _handle(conn):
    try:
        while True:
            try:
                msg = conn.recv()
            except (EOFError, OSError):
                return
            kind = msg[0]
            if kind == "call":
                # the envelope optionally carries a 5th trace-context
                # slot (observability/tracing.py); tolerant unpack keeps
                # old 4-tuples from peers without tracing working
                _, fn, args, kwargs = msg[:4]
                wire = msg[4] if len(msg) > 4 else None
                try:
                    with _trace.bind_wire(wire):
                        result = fn(*args, **(kwargs or {}))
                    conn.send(("ok", result))
                except Exception as e:  # serialize the failure
                    conn.send(("err", e))
            elif kind == "callraw":
                # raw-bytes fast path: the pickled header carries
                # _BlobSlot placeholders; each blob follows as one raw
                # frame and re-enters the args as a received-side Blob.
                # The optional trace slot rides the pickled header, so
                # context crosses the fast path without touching the
                # raw frames.
                _, fn, args, kwargs, n_blobs = msg[:5]
                wire = msg[5] if len(msg) > 5 else None
                try:
                    blobs = [Blob(conn.recv_bytes())
                             for _ in range(n_blobs)]
                except (EOFError, OSError):
                    return
                try:
                    args = tuple(blobs[a.index]
                                 if isinstance(a, _BlobSlot) else a
                                 for a in args)
                    with _trace.bind_wire(wire):
                        result = fn(*args, **(kwargs or {}))
                    conn.send(("ok", result))
                except Exception as e:  # serialize the failure
                    conn.send(("err", e))
            elif kind == "register":
                _, info = msg
                _state["workers"][info.name] = info
                conn.send(("ok", list(_state["workers"].values())))
            elif kind == "workers":
                conn.send(("ok", list(_state["workers"].values())))
            elif kind == "bye":
                conn.send(("ok", None))
                return
    finally:
        conn.close()


def init_rpc(name, rank=None, world_size=None, master_endpoint=None):
    """reference: rpc.py init_rpc — start the agent + register with master."""
    rank = rank if rank is not None else int(os.environ.get(
        "PADDLE_TRAINER_ID", "0"))
    master = master_endpoint or os.environ.get("PADDLE_MASTER_ENDPOINT",
                                               "127.0.0.1:29590")
    ip = "127.0.0.1"
    listener = Listener((ip, 0), backlog=64, authkey=_state["authkey"])
    port = listener.address[1]
    me = WorkerInfo(name, rank, ip, port)
    _state.update(me=me, listener=listener, running=True)
    _state["workers"][name] = me
    t = threading.Thread(target=_serve_loop, daemon=True)
    t.start()
    _state["thread"] = t

    mhost, mport = master.rsplit(":", 1)
    if rank == 0:
        # rank0 IS the master registry; rebind listener already done — also
        # listen on the master port for registrations
        reg = Listener((mhost, int(mport)), backlog=64,
                       authkey=_state["authkey"])
        _state["master_listener"] = reg

        def master_loop():
            while _state["running"]:
                try:
                    conn = reg.accept()
                except OSError:
                    return
                threading.Thread(target=_handle, args=(conn,),
                                 daemon=True).start()

        threading.Thread(target=master_loop, daemon=True).start()
    else:
        for _ in range(50):  # wait for master
            try:
                c = Client((mhost, int(mport)), authkey=_state["authkey"])
                c.send(("register", me))
                status, workers = c.recv()
                c.close()
                for w in workers:
                    _state["workers"][w.name] = w
                break
            except (ConnectionRefusedError, OSError):
                time.sleep(0.2)
        else:
            raise TimeoutError(f"cannot reach rpc master at {master}")
    return me


def _connect(to):
    """Dial ``to``.  Transient connect-time failures (listener backlog,
    restarting worker) are retried with jittered exponential backoff —
    connect happens strictly BEFORE the call is sent, so retrying here
    can never double-deliver a call (utils/retry.py; a call that already
    went out is never retried by this layer).  The ``rpc_drop`` /
    ``rpc_delay`` fault-injection points fire here for the same reason:
    an injected failure is always a clean, safe-to-retry connect
    failure."""
    info = _state["workers"].get(to)
    if info is None:
        raise ValueError(f"unknown worker {to!r}; known: "
                         f"{sorted(_state['workers'])}")
    from ...utils import fault_injection as _fi
    _fi.check_rpc("rpc_delay", to)           # sleeps when armed
    if _fi.check_rpc("rpc_drop", to):
        raise ConnectionError(
            f"rpc to worker {to!r}: connect dropped by injected fault "
            "(FLAGS_fault_inject rpc_drop)")
    from ...utils.retry import retry_call

    def _dial():
        return Client((info.ip, info.port), authkey=_state["authkey"])

    try:
        # decorrelated jitter: a fleet of dispatch threads mass-
        # reconnecting after a store blip spreads over the whole backoff
        # window instead of thundering-herding this replica in waves
        return retry_call(_dial, tries=3,
                          retry_on=(ConnectionRefusedError,
                                    ConnectionResetError),
                          base=0.05, max_delay=0.5, decorrelated=True)
    except (ConnectionRefusedError, ConnectionResetError) as e:
        raise ConnectionError(
            f"rpc to worker {to!r} at {info.ip}:{info.port}: connect "
            f"failed after retries ({e})") from e


def rpc_sync(to, fn, args=None, kwargs=None, timeout=None):
    """reference: rpc.py rpc_sync — blocking remote call.  A positive
    ``timeout`` (seconds) bounds the wait for the response: a dead or
    wedged worker raises ``TimeoutError`` naming it instead of blocking
    this process forever in ``recv()``.

    The ``rpc_slow`` fault point fires here, IN-CALL: after the request
    went out, before the response is awaited — modelling latency on an
    already-connected worker (a stalled NIC, a wedged peer), which the
    connect-time ``rpc_delay`` point cannot.  The injected stall counts
    against ``timeout``, exactly as a genuinely slow response would."""
    c = _connect(to)
    try:
        plain, blobs = _extract_blobs(tuple(args or ()))
        # optional trace-context envelope slot: None (tracing off, the
        # default) keeps the wire format byte-identical to the pre-
        # tracing 4/5-tuples
        wire = _trace.current_wire()
        if blobs:
            env = ("callraw", fn, plain, kwargs, len(blobs))
            c.send(env if wire is None else env + (wire,))
            for b in blobs:
                _send_blob(c, b)
        else:
            env = ("call", fn, plain, kwargs)
            c.send(env if wire is None else env + (wire,))
        from ...utils import fault_injection as _fi
        if _fi.active("rpc_slow") is not None:
            t0 = time.monotonic()
            _fi.check_rpc("rpc_slow", to)    # sleeps in-call when armed
            slept = time.monotonic() - t0
            if timeout is not None and timeout > 0:
                timeout = max(1e-6, timeout - slept)
        if timeout is not None and timeout > 0:
            if not c.poll(timeout):
                raise TimeoutError(
                    f"rpc to worker {to!r} ({getattr(fn, '__name__', fn)}) "
                    f"timed out after {timeout}s — worker dead or call "
                    "wedged; no response arrived")
        try:
            status, payload = c.recv()
        except (EOFError, ConnectionResetError, BrokenPipeError) as e:
            # the peer died mid-call: distinct from a clean connect
            # failure — the call MAY have been delivered, so this layer
            # never retries it (callers with idempotent request ids, like
            # the serving router, may)
            raise ConnectionError(
                f"rpc to worker {to!r} "
                f"({getattr(fn, '__name__', fn)}): connection lost "
                f"mid-call ({type(e).__name__}) — worker died") from e
    finally:
        c.close()
    if status == "err":
        raise payload
    return payload


def rpc_async(to, fn, args=None, kwargs=None, timeout=None):
    """reference: rpc.py rpc_async — returns a Future.  ``timeout``
    bounds the remote wait exactly as in :func:`rpc_sync`; the Future
    then resolves with that ``TimeoutError``."""
    fut: Future = Future()
    # capture the CALLER's trace context now: the worker thread below
    # would otherwise read its own (empty) thread-local and the hedged-
    # dispatch spans would lose their trace
    wire = _trace.current_wire()

    def run():
        try:
            with _trace.bind_wire(wire):
                fut.set_result(rpc_sync(to, fn, args=args, kwargs=kwargs,
                                        timeout=timeout))
        except BaseException as e:
            fut.set_exception(e)

    threading.Thread(target=run, daemon=True).start()
    fut.wait = fut.result  # reference API parity
    return fut


def get_worker_info(name):
    return _state["workers"][name]


def get_all_worker_infos():
    return list(_state["workers"].values())


def get_current_worker_info():
    return _state["me"]


def shutdown():
    """Stop the process-global agent.  Idempotent: calling it twice (or
    without ever calling init_rpc) is a no-op — the serving fleet's
    replica teardown and the router's close() both call it defensively."""
    _state["running"] = False
    for key in ("listener", "master_listener"):
        lst = _state.pop(key, None)
        if lst is not None:
            addr = getattr(lst, "address", None)
            try:
                lst.close()
            except (OSError, ValueError):
                pass
            # wake any thread blocked in accept() so the kernel really
            # releases the listening socket (see RpcServer.close)
            if isinstance(addr, tuple) and len(addr) == 2:
                _poke(addr[0], addr[1])
    _state["listener"] = None
    _state["workers"].clear()
    _state["me"] = None
