"""Hang and failure guardian (port of paddle_tpu/distributed/watchdog.py):
the collective watchdog and the cross-rank error trap.

A rank that crashes or stalls mid-step leaves every peer blocked in its
collective until some outer timeout.  This module is the JAX package's
discipline over ``torch.distributed``:

1. **Collective watchdog.**  Every multi-rank op of `distributed.collective`
   registers (op, group, per-group seq, start time, thread) here through
   one choke point (``begin`` → ``preflight`` → the op → ``end``, with
   ``translate`` on the way out).  A daemon thread polls; an op past
   ``FLAGS_collective_timeout_s`` gets a *stall dump* (every thread's
   stack, the last completed collectives, a metrics snapshot, through
   the flight recorder) and a `CollectiveTimeoutError` naming the op, the
   seq and the ranks whose arrival records never reached the store.  The
   error is raised asynchronously in the blocked thread; a thread blocked
   in C cannot take it, so after a grace the watchdog hard-exits
   (``GUARDIAN_ABORT_EXIT_CODE`` 107; ``ELASTIC_EXIT_CODE`` 101 when a
   peer's failure caused the stall) and the launch controller reaps the
   rank (`distributed.launch`).

   **NCCL returns at enqueue.**  A CUDA collective's host call returns
   once the op is queued on the card, long before its transfer ran, so
   ``end`` takes the op's tensor and records a CUDA event on the current
   stream (which waits for the collective's stream): the entry stays in
   flight until the watchdog thread sees the event complete
   (``event.query()``), with no host sync a collective.  A rank whose
   peer never arrives then blocks later, in a stream sync or an
   ``.item()``, in C: the asynchronous exception has nowhere to land, so
   a stalled entry whose calling thread has already left the collective
   goes straight to the hard abort, its stall dump written first.
   A process stalls for its oldest stalled collective only (JAX's loop
   stalls each timed-out entry, so the trap kept the newest one's
   record).  **Collectives under a CUDA graph capture are not registered**: the
   mesh lanes of `framework.train_step.CompiledTrainStep` replay their
   NCCL calls without Python (they are counted once, at the capture), as
   JAX's in-program GSPMD collectives run unguarded.

2. **Cross-rank error trap.**  A failing rank writes ``{job}/error/{rank}``
   (type, message, traceback, the collective seq it died at) into the
   shared store before dying (a ``sys.excepthook`` chain and the
   ``rank_crash`` fault point).  A healthy peer's watchdog polls the
   prefix, so its blocked collective aborts with `PeerFailureError`
   carrying the original rank's error, and the rank exits with
   ``ELASTIC_EXIT_CODE`` for the controller's relaunch into resume.  A
   backend error out of the op itself (gloo's socket sees the dead peer's
   connection close first) is translated the same way when the trap
   holds a peer's record.

3. **Desync detector.**  Each call records ``{job}/arrive/g{gid}/r{rank}
   = "seq:op"``; every ``FLAGS_desync_check_every`` calls of a group it
   compares the peers' records: another op at the same seq raises
   `DesyncError` naming both ops.

The store is the launch contract's: ``PADDLE_GUARDIAN_STORE`` (host:port,
a `store.TCPStore`) or ``PADDLE_GUARDIAN_DIR`` (a `store.FileKVStore`
directory), ``PADDLE_JOB_ID`` the job.  With
``FLAGS_collective_timeout_s=0``, no store and no collective fault point,
``begin`` returns None after a few lookups: the guardian costs nothing
when off.

The thread helpers `async_raise` and `all_thread_stacks` also serve the
serving engine's stall monitor (`serving.engine.Engine`,
``ServingConfig.step_timeout_s``).
"""
from __future__ import annotations

import ctypes
import json
import os
import sys
import threading
import time
import traceback
from collections import deque

from ..utils import fault_injection as _fi
from ..utils.flags import flag as _flag

#: the cooperative relaunch code (fleet.elastic, launch.controller): a
#: peer-failure abort asks the controller to relaunch into resume
ELASTIC_EXIT_CODE = 101
#: the hard-abort code of a plain collective timeout: a hang is a hard
#: fault, not a relaunch request (distinct from the fault injector's
#: DEFAULT_EXIT_CODE, so drills tell them apart)
GUARDIAN_ABORT_EXIT_CODE = 107


class GuardianError(RuntimeError):
    """Base class of the watchdog's failures."""


class CollectiveTimeoutError(GuardianError):
    """A collective exceeded ``FLAGS_collective_timeout_s``."""

    def __init__(self, message="", op=None, seq=None, group_ranks=None,
                 missing_ranks=None, waited_s=None):
        super().__init__(message)
        self.op = op
        self.seq = seq
        self.group_ranks = group_ranks
        self.missing_ranks = missing_ranks
        self.waited_s = waited_s


class PeerFailureError(GuardianError):
    """A peer rank died: this rank's blocked collective was aborted with
    the original rank's error instead of a generic timeout."""

    def __init__(self, message="", rank=None, original_type=None,
                 original_traceback=None):
        super().__init__(message)
        self.rank = rank
        self.original_type = original_type
        self.original_traceback = original_traceback


class DesyncError(GuardianError):
    """Two ranks issued different collectives at the same per-group
    sequence number: the program diverged, it did not hang."""


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def async_raise(thread_ident, exc_type):
    """Schedule ``exc_type`` to be raised in the thread with the given
    ident at its next bytecode boundary.  A thread inside a C call (a
    ``torch.cuda.synchronize``, a sleep) gets it when the call returns.
    Returns False when the thread is gone."""
    res = ctypes.pythonapi.PyThreadState_SetAsyncExc(
        ctypes.c_ulong(thread_ident), ctypes.py_object(exc_type))
    if res > 1:    # pragma: no cover - "affected more than one thread"
        ctypes.pythonapi.PyThreadState_SetAsyncExc(
            ctypes.c_ulong(thread_ident), None)
        return False
    return res == 1


def all_thread_stacks():
    """Stacks of every live thread: name, ident, daemon flag and the
    formatted stack, the heart of a stall dump."""
    names = {t.ident: t for t in threading.enumerate()}
    out = []
    for ident, frame in sys._current_frames().items():
        t = names.get(ident)
        out.append({
            "name": getattr(t, "name", f"thread-{ident}"),
            "ident": ident,
            "daemon": bool(getattr(t, "daemon", False)),
            "stack": traceback.format_stack(frame),
        })
    return out


def _guardian_rank():
    env = os.environ.get("PADDLE_TRAINER_ID")
    if env is not None:
        return int(env)
    from . import env as _env
    return _env.get_rank()


def stall_dump_path(rank=None):
    """Where the stall dump goes: ``FLAGS_stall_dump_path`` with
    ``.rank<R>`` before its extension (peers never clobber each other's
    dump), else ``stall_dump.<pid>.json`` under ``FLAGS_dump_dir``."""
    p = str(_flag("FLAGS_stall_dump_path", "") or "")
    rank = _guardian_rank() if rank is None else rank
    if not p:
        return os.path.join(os.getcwd(),
                            str(_flag("FLAGS_dump_dir") or "."),
                            f"stall_dump.{os.getpid()}.json")
    root, ext = os.path.splitext(p)
    return f"{root}.rank{rank}{ext or '.json'}"


# ---------------------------------------------------------------------------
# cross-rank error trap
# ---------------------------------------------------------------------------


class ErrorTrap:
    """``{job}/error/{rank}`` and ``{job}/arrive/...`` records over a
    TCPStore-shaped KV (set, get, list_prefix, delete_key): the JAX
    package's key layout and JSON, so either package reads the other's
    records."""

    def __init__(self, store, job="default", rank=0):
        self.store = store
        self.job = str(job)
        self.rank = int(rank)
        # a TCPStore client multiplexes one fd: the watchdog thread and
        # the training thread must not interleave frames
        self._lock = threading.Lock()

    def _k(self, *parts):
        return "/".join((self.job,) + parts)

    # ---- error records ----
    def report(self, exc, op=None, seq=None):
        """Record this rank's failure for the peers and the controller.
        Never raises: the trap is a courtesy on the way down."""
        payload = {
            "rank": self.rank,
            "type": type(exc).__name__,
            "message": str(exc)[:2000],
            "traceback": "".join(traceback.format_exception(
                type(exc), exc, exc.__traceback__))[-8000:],
            "op": op,
            "seq": seq,
            "ts": time.time(),
        }
        try:
            with self._lock:
                self.store.set(self._k("error", str(self.rank)),
                               json.dumps(payload))
        except Exception:
            pass

    def peers(self):
        """Error records written by the OTHER ranks, oldest first."""
        try:
            with self._lock:
                raw = self.store.list_prefix(self._k("error") + "/")
        except Exception:
            return []
        out = []
        for val in raw.values():
            try:
                rec = json.loads(val)
            except (ValueError, TypeError):
                continue
            if int(rec.get("rank", -1)) != self.rank:
                out.append(rec)
        return sorted(out, key=lambda r: r.get("ts", 0))

    def clear(self):
        """Drop every guardian record (errors, arrivals, host-collective
        contributions).  The controller calls this between incarnations:
        a stale error would re-trip the new incarnation's watchdogs at
        once, and a stale contribution would answer a new gather at the
        same (group, seq) with the dead incarnation's data."""
        for prefix in ("error", "arrive", "hc"):
            try:
                with self._lock:
                    for key in self.store.list_prefix(self._k(prefix) + "/"):
                        self.store.delete_key(key)
            except Exception:
                pass

    # ---- arrival / desync records ----
    def record_arrival(self, group_id, seq, op):
        try:
            with self._lock:
                self.store.set(
                    self._k("arrive", f"g{group_id}", f"r{self.rank}"),
                    f"{seq}:{op}")
        except Exception:
            pass

    def arrivals(self, group_id):
        """{rank: (seq, op)}: each rank's newest recorded collective."""
        try:
            with self._lock:
                raw = self.store.list_prefix(
                    self._k("arrive", f"g{group_id}") + "/")
        except Exception:
            return {}
        out = {}
        for key, val in raw.items():
            r = key.rsplit("/r", 1)[-1]
            try:
                seq, op = bytes(val).decode().split(":", 1)
                out[int(r)] = (int(seq), op)
            except (ValueError, TypeError):
                continue
        return out


# ---------------------------------------------------------------------------
# the watchdog
# ---------------------------------------------------------------------------


class _InFlight:
    __slots__ = ("op", "group_id", "ranks", "seq", "start", "thread_id",
                 "thread_name", "exc", "kill_at", "exit_code", "event")

    def __init__(self, op, group_id, ranks, seq):
        self.op = op
        self.group_id = group_id
        self.ranks = list(ranks)
        self.seq = seq
        self.start = time.monotonic()
        self.thread_id = threading.get_ident()
        self.thread_name = threading.current_thread().name
        self.exc = None          # the rich instance for translate()
        self.kill_at = None      # the hard-abort deadline once stalled
        self.exit_code = GUARDIAN_ABORT_EXIT_CODE
        # the CUDA event of a call that returned at enqueue: the entry is
        # retired when it completes (the calling thread has left the op)
        self.event = None


class CollectiveWatchdog:
    def __init__(self, trap=None):
        self.trap = trap
        self._lock = threading.Lock()
        self._inflight: dict[int, _InFlight] = {}
        self._recent = deque(maxlen=32)   # last completed collectives
        self._seq: dict[int, int] = {}    # per-group sequence counters
        self._token = 0
        self._thread = None
        self._stop = threading.Event()
        self._dumped = False

    # ---- configuration -------------------------------------------------
    def timeout_s(self):
        try:
            return float(_flag("FLAGS_collective_timeout_s", 0) or 0)
        except (TypeError, ValueError):
            return 0.0

    def _interval(self):
        t = self.timeout_s()
        if t <= 0:
            return 0.5
        return min(max(t / 4.0, 0.05), 1.0)

    def _ensure_thread(self):
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="paddle-tpu-collective-watchdog",
                daemon=True)
            self._thread.start()

    # ---- registration (the collective choke point) -------------------
    def begin(self, op, group):
        gid = getattr(group, "id", 0)
        with self._lock:
            seq = self._seq.get(gid, 0)
            self._seq[gid] = seq + 1
            self._token += 1
            tok = self._token
            entry = _InFlight(op, gid, getattr(group, "ranks", []), seq)
            self._inflight[tok] = entry
        if self.timeout_s() > 0 or self.trap is not None:
            self._ensure_thread()
        return tok, entry

    def preflight(self, entry):
        """Fault injection, the fail-fast peer check and the arrival and
        desync records.  Runs in the calling thread and may raise."""
        self._inject(entry)
        if self.trap is None:
            return
        peers = self.trap.peers()
        if peers:
            raise self._peer_error(peers)
        self.trap.record_arrival(entry.group_id, entry.seq, entry.op)
        every = int(_flag("FLAGS_desync_check_every", 16) or 0)
        if every > 0 and entry.seq % every == 0:
            self._desync_check(entry)

    def end(self, tok, event=None):
        """Retire the entry, or, with the CUDA ``event`` recorded after the
        op's enqueue, keep it in flight until the event completes."""
        if event is not None and not event.query():
            with self._lock:
                entry = self._inflight.get(tok)
                if entry is not None:
                    entry.event = event
            self._ensure_thread()   # the poll loop retires it
            return
        with self._lock:
            self._retire(tok)

    def _retire(self, tok):
        entry = self._inflight.pop(tok, None)
        if entry is not None:
            self._recent.append({
                "op": entry.op, "group": entry.group_id, "seq": entry.seq,
                "duration_s": round(time.monotonic() - entry.start, 4)})

    def in_flight(self):
        """[(op, seq)] of the entries not retired yet, oldest first."""
        with self._lock:
            return [(e.op, e.seq) for e in self._inflight.values()]

    def translate(self, entry, exc):
        """The exception the choke point raises for ``exc``: the rich
        instance the watchdog prepared for a bare asynchronously raised
        GuardianError (``PyThreadState_SetAsyncExc`` delivers a class), or
        a `PeerFailureError` for a backend error when the trap holds a
        peer's record (the dead peer's connection closed under the op;
        the record, written before the peer died, is waited for up to
        a second).  A peer's failure writes the stall dump first, as the
        watchdog's own abort does."""
        if entry is not None and entry.exc is not None and \
                isinstance(exc, GuardianError) and not str(exc):
            return entry.exc
        if self.trap is None or isinstance(exc, GuardianError) or \
                not isinstance(exc, Exception):
            return exc
        deadline = time.monotonic() + 1.0
        peers = self.trap.peers()
        while not peers and time.monotonic() < deadline:
            time.sleep(0.05)
            peers = self.trap.peers()
        if not peers:
            return exc
        rich = self._peer_error(peers)
        if entry is not None:
            entry.exc = rich
            self._write_stall_dump(entry, rich)
        return rich

    def recent(self):
        with self._lock:
            return list(self._recent)

    def prepared(self, exc):
        """The rich instance the watchdog prepared for a bare asynchronously
        raised GuardianError that surfaced outside the choke point (its
        thread took it in other code), else ``exc``."""
        if not isinstance(exc, GuardianError) or str(exc):
            return exc
        with self._lock:
            for e in self._inflight.values():
                if isinstance(e.exc, type(exc)):
                    return e.exc
        return exc

    # ---- fault injection ------------------------------------------------
    def _match(self, params, entry):
        if params is None:
            return False
        if "op" in params and params["op"] != entry.op:
            return False
        if "at_seq" in params and params["at_seq"] != entry.seq:
            return False
        if "rank" in params and params["rank"] != _guardian_rank():
            return False
        once = params.get("once_file")
        return not once or _fi.claim_once(once)

    def _inject(self, entry):
        crash = _fi.active("rank_crash")
        if self._match(crash, entry):
            exc = _fi.InjectedFault(
                f"rank_crash: injected crash of rank {_guardian_rank()} "
                f"at collective {entry.op} seq {entry.seq}")
            if self.trap is not None:
                self.trap.report(exc, op=entry.op, seq=entry.seq)
            if crash.get("mode", "exit") == "raise":
                raise exc
            sys.stderr.write(f"[guardian] {exc}\n")
            sys.stderr.flush()
            os._exit(int(crash.get("exit", _fi.DEFAULT_EXIT_CODE)))
        delay = _fi.active("collective_delay")
        if self._match(delay, entry):
            # short sleeps: the watchdog's asynchronous exception lands
            # at a bytecode boundary
            deadline = time.monotonic() + float(delay.get("delay_s", 30))
            while time.monotonic() < deadline:
                time.sleep(0.02)

    # ---- desync ---------------------------------------------------------
    def _desync_check(self, entry):
        for rank, (seq, op) in self.trap.arrivals(entry.group_id).items():
            if rank == self.trap.rank:
                continue
            if seq == entry.seq and op != entry.op:
                exc = DesyncError(
                    f"collective desync on group {entry.group_id} at "
                    f"seq {entry.seq}: rank {self.trap.rank} called "
                    f"{entry.op!r} but rank {rank} called {op!r}: the "
                    "program diverged across ranks")
                self.trap.report(exc, op=entry.op, seq=entry.seq)
                raise exc

    # ---- the poll loop --------------------------------------------------
    def _run(self):
        while not self._stop.wait(self._interval()):
            try:
                self._poll_once()
            except Exception:       # the guardian must never be the fault
                pass

    def _poll_once(self):
        with self._lock:
            for tok, e in list(self._inflight.items()):
                if e.event is not None and e.kill_at is None and \
                        e.event.query():
                    self._retire(tok)
            entries = list(self._inflight.values())
        if not entries:
            return
        now = time.monotonic()
        hard_abort = bool(_flag("FLAGS_collective_hard_abort", True))
        stalled = [e for e in entries if e.kill_at is not None]
        for e in stalled:
            if now >= e.kill_at and hard_abort:
                self._hard_abort(e)
        if stalled:
            # the rank is going down for its oldest stalled collective:
            # the trap keeps that one's record, not a newer one's
            return
        peers = self.trap.peers() if self.trap is not None else []
        for e in entries:             # oldest first: one stall a process
            if peers:
                self._stall(e, self._peer_error(peers),
                            exit_code=ELASTIC_EXIT_CODE)
                return
            timeout = self.timeout_s()
            if timeout > 0 and now - e.start > timeout:
                waited = now - e.start
                missing = self._missing_ranks(e)
                blame = (f"; ranks never arrived: {missing}"
                         if missing else "")
                exc = CollectiveTimeoutError(
                    f"collective {e.op!r} (group ranks {e.ranks}, seq "
                    f"{e.seq}) stuck for {waited:.1f}s on thread "
                    f"{e.thread_name!r} (FLAGS_collective_timeout_s="
                    f"{timeout:g}){blame}",
                    op=e.op, seq=e.seq, group_ranks=e.ranks,
                    missing_ranks=missing, waited_s=round(waited, 3))
                if self.trap is not None:
                    self.trap.report(exc, op=e.op, seq=e.seq)
                self._stall(e, exc, exit_code=GUARDIAN_ABORT_EXIT_CODE)
                return

    def _peer_error(self, peers):
        p = peers[0]
        return PeerFailureError(
            f"rank {p.get('rank')} failed with {p.get('type')}: "
            f"{p.get('message')} (at collective {p.get('op')!r} seq "
            f"{p.get('seq')}); aborting this rank's blocked collective "
            f"for relaunch\n--- original traceback (rank "
            f"{p.get('rank')}) ---\n{p.get('traceback', '')}",
            rank=p.get("rank"), original_type=p.get("type"),
            original_traceback=p.get("traceback"))

    def _missing_ranks(self, e):
        if self.trap is None:
            return None
        arr = self.trap.arrivals(e.group_id)
        me = self.trap.rank
        return [r for r in e.ranks
                if r != me and arr.get(r, (-1, ""))[0] < e.seq]

    def _stall(self, e, exc, exit_code):
        e.exc = exc
        e.exit_code = exit_code
        self._write_stall_dump(e, exc)
        sys.stderr.write(
            f"[guardian] {type(exc).__name__}: {exc}\n"
            f"[guardian] stall dump: {stall_dump_path()}\n")
        sys.stderr.flush()
        if e.event is not None:
            # the caller left the op at its enqueue and now waits in C
            # (a stream sync, an .item()): an exception raised into it
            # would land in unrelated code, if ever
            e.kill_at = time.monotonic()
            return
        delivered = async_raise(e.thread_id, type(exc))
        grace = max(2 * self._interval(), 1.0)
        if not delivered:
            grace = min(grace, 0.5)   # the thread is gone
        e.kill_at = time.monotonic() + grace

    def _hard_abort(self, e):
        sys.stderr.write(
            f"[guardian] thread {e.thread_name!r} did not unwind from "
            f"{e.op!r} (blocked outside the interpreter); hard-aborting "
            f"with exit code {e.exit_code} so the controller can reap "
            "this rank\n")
        sys.stderr.flush()
        run_exit_hooks()
        os._exit(e.exit_code)

    def _write_stall_dump(self, e, exc):
        if self._dumped:          # one stall dump a process
            return
        self._dumped = True
        from ..observability import flight_recorder as _fr
        peers = self.trap.peers() if self.trap is not None else []
        stall = {
            "op": e.op,
            "seq": e.seq,
            "group_ranks": e.ranks,
            "rank": _guardian_rank(),
            "waited_s": round(time.monotonic() - e.start, 3),
            "timeout_s": self.timeout_s(),
            "missing_ranks": self._missing_ranks(e) or [],
            "peer_errors": peers,
            "recent_collectives": self.recent(),
            "threads": all_thread_stacks(),
        }
        _fr.record("stall", e.op, seq=e.seq, group=e.group_id)
        _fr.dump(path=stall_dump_path(), reason="stall", error=exc,
                 extra={"stall": stall})

    # ---- teardown (tests) ----------------------------------------------
    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


# ---------------------------------------------------------------------------
# process-wide wiring
# ---------------------------------------------------------------------------

_WATCHDOG: CollectiveWatchdog | None = None
_CONFIGURED = False
_TRAP_HOOKED = False
_LOCK = threading.Lock()


def _auto_trap():
    """An ErrorTrap from the launch contract's environment, if any."""
    from . import host_collectives
    try:
        store = host_collectives.guardian_store()
    except Exception as e:     # a broken trap must not block training
        sys.stderr.write(f"[guardian] error trap unavailable: {e}\n")
        return None
    if store is None:
        return None
    return ErrorTrap(store, job=os.environ.get("PADDLE_JOB_ID", "default"),
                     rank=_guardian_rank())


#: callables run before the guardian ends a rank by ``os._exit`` (a
#: peer's failure, a hard abort): the hot-spare agent's park
_EXIT_HOOKS = []


def add_exit_hook(fn):
    """Run ``fn()`` before the guardian ends this rank (once each)."""
    if fn not in _EXIT_HOOKS:
        _EXIT_HOOKS.append(fn)


def run_exit_hooks():
    """Run the exit hooks; a failing one is reported and the next runs."""
    for fn in list(_EXIT_HOOKS):
        try:
            fn()
        except Exception as e:  # noqa: BLE001 — the rank exits anyway
            sys.stderr.write(f"[guardian] exit hook "
                             f"{getattr(fn, '__name__', fn)} failed: {e}\n")
            sys.stderr.flush()


def _install_trap_hook(trap):
    """Chain ``sys.excepthook``: any unhandled exception is recorded for
    the peers before the process dies (the cross-rank error trap)."""
    global _TRAP_HOOKED
    if _TRAP_HOOKED:
        return
    _TRAP_HOOKED = True
    prev = sys.excepthook

    def _hook(etype, value, tb):
        if _WATCHDOG is not None:
            value = _WATCHDOG.prepared(value)
        if not issubclass(etype, (KeyboardInterrupt, SystemExit)):
            try:
                trap.report(value)
            except Exception:
                pass
        prev(etype, value, tb)
        if issubclass(etype, PeerFailureError):
            # this rank is healthy: it died because a PEER failed.  The
            # cooperative relaunch code makes the controller restart the
            # job instead of counting a second independent fault
            sys.stderr.flush()
            run_exit_hooks()
            os._exit(ELASTIC_EXIT_CODE)

    sys.excepthook = _hook


def get_watchdog():
    global _WATCHDOG, _CONFIGURED
    with _LOCK:
        if _WATCHDOG is None:
            trap = _auto_trap()
            if trap is not None:
                _install_trap_hook(trap)
            _WATCHDOG = CollectiveWatchdog(trap)
            _CONFIGURED = True
        return _WATCHDOG


def configure(store=None, job="default", rank=0):
    """(Re)configure the guardian with ``store`` (None: no trap), for
    tests and embedders outside the launch contract."""
    global _WATCHDOG, _CONFIGURED
    with _LOCK:
        if _WATCHDOG is not None:
            _WATCHDOG.stop()
        trap = ErrorTrap(store, job=job, rank=rank) \
            if store is not None else None
        if trap is not None:
            _install_trap_hook(trap)
        _WATCHDOG = CollectiveWatchdog(trap)
        _CONFIGURED = True
        return _WATCHDOG


def reset():
    """Tear down the process-wide watchdog (tests)."""
    global _WATCHDOG, _CONFIGURED
    with _LOCK:
        if _WATCHDOG is not None:
            _WATCHDOG.stop()
        _WATCHDOG = None
        _CONFIGURED = False


def _armed():
    """One cheap check deciding whether begin() does anything at all."""
    if _WATCHDOG is not None and _WATCHDOG.trap is not None:
        return True
    try:
        if float(_flag("FLAGS_collective_timeout_s", 0) or 0) > 0:
            return True
    except (TypeError, ValueError):
        pass
    if _fi.active("collective_delay") is not None or \
            _fi.active("rank_crash") is not None:
        return True
    if not _CONFIGURED and (os.environ.get("PADDLE_GUARDIAN_STORE") or
                            os.environ.get("PADDLE_GUARDIAN_DIR")):
        return True
    return False


def begin(op, group):
    """Guard entry of one collective: None when the guardian is off (the
    zero-cost path), else an opaque token."""
    if not _armed():
        return None
    wd = get_watchdog()
    tok, entry = wd.begin(op, group)
    return (wd, tok, entry)


def preflight(token):
    if token is not None:
        wd, tok, entry = token
        wd.preflight(entry)


def end(token, event=None):
    if token is not None:
        wd, tok, entry = token
        wd.end(tok, event)


def translate(token, exc):
    if token is None:
        return exc
    wd, tok, entry = token
    return wd.translate(entry, exc)


def report_error(exc, op=None, seq=None):
    """Record this rank's failure in the cross-rank trap (nothing without
    a store)."""
    wd = get_watchdog()
    if wd.trap is not None:
        wd.trap.report(exc, op=op, seq=seq)


def peer_errors():
    wd = get_watchdog()
    return wd.trap.peers() if wd.trap is not None else []
