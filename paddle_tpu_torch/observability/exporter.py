"""Background metrics exporter (port of
paddle_tpu/observability/exporter.py): every
``FLAGS_metrics_export_interval_s`` seconds, and once at ``stop()``, a
thread appends one JSON line to ``FLAGS_metrics_export_path``: the
registry's ``dump_json()`` with ``schema_version``
(`SNAPSHOT_SCHEMA_VERSION`), a wall-clock ``ts`` and the ``pid``.  With
the flag empty `maybe_start_exporter` starts nothing and costs one flag
read; ``hapi.Model.fit`` calls it, so the flag is all a run configures.
"""
from __future__ import annotations

import json
import os
import threading
import time

from ..utils.flags import flag as _flag
from . import registry as _registry

# stamped on every snapshot line; tools/check_telemetry.py fails LOUDLY
# (SnapshotSchemaError, the COMM_BUDGET BudgetSchemaError precedent) on
# a line whose version it does not understand.  Bump on any change to
# the line layout and teach the checker the new shape in the same PR.
SNAPSHOT_SCHEMA_VERSION = 1


class MetricsExporter:
    """Append a registry snapshot to ``path`` every ``interval_s``
    seconds (and once at ``stop()``, so short runs still export)."""

    def __init__(self, path, interval_s=10.0, registry=None):
        if not path:
            raise ValueError("MetricsExporter needs a file path")
        self.path = str(path)
        self.interval_s = float(interval_s)
        self.registry = registry or _registry.REGISTRY
        self._stop = threading.Event()
        self._thread = None

    def start(self):
        if self._thread is not None:
            return self
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="paddle-tpu-torch-metrics-exporter",
            daemon=True)
        self._thread.start()
        return self

    def _loop(self):
        while not self._stop.wait(self.interval_s):
            self._write_snapshot()

    def _write_snapshot(self):
        rec = {"schema_version": SNAPSHOT_SCHEMA_VERSION,
               "ts": time.time(), "pid": os.getpid()}
        rec.update(self.registry.dump_json())
        try:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        except OSError:
            pass                      # telemetry must never kill the run

    def snapshot_now(self):
        """Force one snapshot line immediately (flush point)."""
        self._write_snapshot()

    def stop(self, final_snapshot=True):
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=10)
        self._thread = None
        if final_snapshot:
            self._write_snapshot()

    @property
    def running(self):
        return self._thread is not None and self._thread.is_alive()


_EXPORTER: MetricsExporter | None = None
_LOCK = threading.Lock()


def maybe_start_exporter():
    """Start the process-wide exporter iff ``FLAGS_metrics_export_path``
    is set.  Idempotent; returns the exporter or None.  Callers on the
    idle path pay one flag read."""
    path = str(_flag("FLAGS_metrics_export_path") or "")
    if not path:
        return None
    global _EXPORTER
    with _LOCK:
        if _EXPORTER is not None and _EXPORTER.running \
                and _EXPORTER.path == path:
            return _EXPORTER
        if _EXPORTER is not None:
            _EXPORTER.stop(final_snapshot=False)
        _EXPORTER = MetricsExporter(
            path,
            interval_s=float(
                _flag("FLAGS_metrics_export_interval_s", 10.0) or 10.0))
        return _EXPORTER.start()


def stop_exporter(final_snapshot=True):
    """Stop the process-wide exporter (tests / clean shutdown); writes a
    last snapshot by default so the file always has the final state."""
    global _EXPORTER
    with _LOCK:
        if _EXPORTER is not None:
            _EXPORTER.stop(final_snapshot=final_snapshot)
            _EXPORTER = None


def get_exporter():
    return _EXPORTER
