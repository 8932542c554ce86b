"""Crash flight recorder (port of
paddle_tpu/observability/flight_recorder.py): a bounded ring of recent
events (training step ends, sentinel actions, any seam's `record`),
written with a full metrics-registry snapshot to a JSON file

- on an unhandled exception (``sys.excepthook`` and
  ``threading.excepthook``, chained: the previous hooks still run), and
- on SIGTERM, from `distributed.fleet.elastic.PreemptionHandler`'s
  handler, which then goes on to its own work (the flag the training
  loop reads at its next step boundary): the recorder chains with the
  handler and never replaces it.

``FLAGS_flight_recorder_size`` bounds the ring (0 turns recording and the
hooks off: one int compare a call).  The dump goes to
``FLAGS_flight_recorder_path``, else ``flight_recorder.<pid>.json`` under
``FLAGS_dump_dir`` in the working directory; a write is a temporary file
and ``os.replace``, so a crash during the dump leaves no torn file.
"""
from __future__ import annotations

import json
import os
import sys
import threading
import time
import traceback
from collections import deque

from ..utils.flags import flag as _flag
from . import registry as _registry


class FlightRecorder:
    def __init__(self, capacity=None, registry=None):
        self.capacity = int(_flag("FLAGS_flight_recorder_size", 512)
                            if capacity is None else capacity)
        self.registry = registry or _registry.REGISTRY
        self._lock = threading.Lock()
        self._events = deque(maxlen=max(self.capacity, 1))
        self._dumped = set()          # reasons already dumped this run

    @property
    def enabled(self):
        return self.capacity > 0

    def record(self, kind, name, **data):
        if self.capacity <= 0:
            return
        # both clocks on every event: wall time for humans, monotonic
        # for post-mortem alignment of dumps from different replicas
        # against merged traces (which carry the same clock pair)
        ev = {"ts": time.time(), "mono": time.monotonic(),
              "kind": kind, "name": name}
        if data:
            ev.update(data)
        with self._lock:
            self._events.append(ev)

    def events(self):
        with self._lock:
            return list(self._events)

    def clear(self):
        with self._lock:
            self._events.clear()
            self._dumped.clear()

    def default_path(self):
        explicit = str(_flag("FLAGS_flight_recorder_path") or "")
        if explicit:
            return explicit
        return os.path.join(
            os.getcwd(), str(_flag("FLAGS_dump_dir") or "."),
            f"flight_recorder.{os.getpid()}.json")

    def dump(self, path=None, reason="manual", error=None, once=False,
             extra=None):
        """Write the ring + a metrics snapshot to ``path`` (atomic).
        ``once=True`` dedupes per reason (the SIGTERM handler and the
        fit loop may both fire).  ``extra`` is a dict merged into the
        payload top level (the training sentinel's section rides it).
        Returns
        the path, or None when disabled/empty/deduped — telemetry never
        raises."""
        if self.capacity <= 0:
            return None
        with self._lock:
            if once and reason in self._dumped:
                return None
            self._dumped.add(reason)
            events = list(self._events)
        if not events and error is None and extra is None:
            return None               # nothing to say: leave no litter
        payload = {
            "reason": reason,
            "ts": time.time(),
            "pid": os.getpid(),
            "argv": list(sys.argv),
            "events": events,
        }
        if extra:
            payload.update(extra)
        if error is not None:
            payload["error"] = {
                "type": type(error).__name__,
                "message": str(error),
                "traceback": "".join(traceback.format_exception(
                    type(error), error, error.__traceback__)),
            }
        try:
            payload["metrics"] = self.registry.dump_json()
        except Exception:
            payload["metrics"] = None
        path = str(path or self.default_path())
        try:
            d = os.path.dirname(path)
            if d:
                os.makedirs(d, exist_ok=True)
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(payload, f, indent=1, default=str)
            os.replace(tmp, path)
        except OSError:
            return None
        return path


_RECORDER: FlightRecorder | None = None
_LOCK = threading.Lock()
_HOOKS_INSTALLED = False


def get_recorder():
    global _RECORDER
    with _LOCK:
        if _RECORDER is None:
            _RECORDER = FlightRecorder()
            if _RECORDER.enabled:
                _install_hooks()
        return _RECORDER


def record(kind, name, **data):
    """Append one event to the process-wide ring (cheap no-op when
    ``FLAGS_flight_recorder_size`` is 0)."""
    get_recorder().record(kind, name, **data)


def dump(path=None, reason="manual", error=None, once=False, extra=None):
    return get_recorder().dump(path=path, reason=reason, error=error,
                               once=once, extra=extra)


def dump_on_preemption():
    """The PreemptionHandler SIGTERM path: dump once per process."""
    return get_recorder().dump(reason="sigterm", once=True)


def _install_hooks():
    """Chain the crash hooks (idempotent).  KeyboardInterrupt/SystemExit
    are orderly exits, not crashes — no dump."""
    global _HOOKS_INSTALLED
    if _HOOKS_INSTALLED:
        return
    _HOOKS_INSTALLED = True

    prev_except = sys.excepthook

    def _excepthook(etype, value, tb):
        if not issubclass(etype, (KeyboardInterrupt, SystemExit)):
            try:
                get_recorder().record(
                    "crash", etype.__name__, message=str(value)[:500])
                get_recorder().dump(reason="exception", error=value,
                                    once=True)
            except Exception:
                pass
        prev_except(etype, value, tb)

    sys.excepthook = _excepthook

    prev_thread = threading.excepthook

    def _thread_hook(args):
        if args.exc_type is not None and not issubclass(
                args.exc_type, SystemExit):
            try:
                get_recorder().record(
                    "crash", args.exc_type.__name__,
                    thread=getattr(args.thread, "name", None),
                    message=str(args.exc_value)[:500])
                get_recorder().dump(reason="thread-exception",
                                    error=args.exc_value, once=True)
            except Exception:
                pass
        prev_thread(args)

    threading.excepthook = _thread_hook
