"""Cooperative preemption (port of ``PreemptionHandler`` and
``ELASTIC_EXIT_CODE`` of paddle_tpu/distributed/fleet/elastic.py).

SIGTERM (a preemptible machine's eviction notice) sets a flag and dumps
the flight recorder (`observability.flight_recorder`, once a process);
the training loop checkpoints at its next step boundary and exits with
``ELASTIC_EXIT_CODE`` so a launcher relaunches it into auto-resume
(``Model.fit(resume=True)``).  The JAX module's node stores, scale
events and the relaunch controller are not ported (ROADMAP A8).

    handler = PreemptionHandler().install()
    for step in ...:
        train_step()
        if handler.preempted():
            manager.save(state, step)
            manager.wait()
            handler.exit_for_relaunch()
"""
from __future__ import annotations

import signal
import sys
import threading

ELASTIC_EXIT_CODE = 101


class PreemptionHandler:
    def __init__(self, signals=(signal.SIGTERM,)):
        self.signals = tuple(signals)
        self._event = threading.Event()
        self._prev = {}
        self._installed = False
        self._callbacks = []

    def install(self):
        try:
            for s in self.signals:
                self._prev[s] = signal.signal(s, self._on_signal)
            self._installed = True
        except ValueError:
            # not the main thread: stay disarmed rather than crash
            self._prev.clear()
        return self

    def add_callback(self, fn):
        """Run ``fn()`` on a new daemon thread when the signal arrives."""
        self._callbacks.append(fn)
        return self

    def _on_signal(self, signum, frame):
        self._event.set()
        # a post-mortem trail now: the eviction's grace window may end
        # before the loop reaches its next step boundary
        try:
            from ...observability import flight_recorder as _fr
            _fr.record("preemption", f"signal_{signum}")
            _fr.dump_on_preemption()
        except Exception:
            pass                  # telemetry must never mask SIGTERM
        for fn in list(self._callbacks):
            threading.Thread(target=self._run_callback, args=(fn,),
                             daemon=True).start()

    @staticmethod
    def _run_callback(fn):
        try:
            fn()
        except Exception:
            pass                  # a hook must never mask SIGTERM

    def preempted(self):
        return self._event.is_set()

    def uninstall(self):
        if self._installed:
            for s, prev in self._prev.items():
                try:
                    signal.signal(s, prev)
                except (ValueError, TypeError):
                    pass
            self._prev.clear()
            self._installed = False

    def exit_for_relaunch(self):
        """Exit with ELASTIC_EXIT_CODE: the cooperative relaunch
        request."""
        sys.exit(ELASTIC_EXIT_CODE)

    def __enter__(self):
        return self.install()

    def __exit__(self, *exc):
        self.uninstall()
        return False
