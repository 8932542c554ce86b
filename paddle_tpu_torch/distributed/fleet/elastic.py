"""Elastic training (port of paddle_tpu/distributed/fleet/elastic.py):
node liveness, scale events and the relaunch protocol (reference:
`ElasticManager`, fleet/elastic/manager.py:126).

`ElasticManager` registers its node in a heartbeat store with a TTL
(`FileStore` over a shared directory, or `store.TCPElasticStore` over a
TCP store when ``PADDLE_ELASTIC_SERVER`` names one), and its `watch`
turns a membership change into ``ElasticStatus.RESTART``, whose
`exit_code` is ``ELASTIC_EXIT_CODE``: the launch controller's restart
loop (`distributed.launch.controller`) relaunches on it.  The JAX
module's ``plan_topology``, ``resized_worlds`` and ``reshard_mesh_for``
belong to the elastic reshard, which is not ported (ROADMAP A8).

Cooperative preemption (`PreemptionHandler`):
SIGTERM (a preemptible machine's eviction notice) sets a flag and dumps
the flight recorder (`observability.flight_recorder`, once a process);
the training loop checkpoints at its next step boundary and exits with
``ELASTIC_EXIT_CODE`` so a launcher relaunches it into auto-resume
(``Model.fit(resume=True)``).

    handler = PreemptionHandler().install()
    for step in ...:
        train_step()
        if handler.preempted():
            manager.save(state, step)
            manager.wait()
            handler.exit_for_relaunch()
"""
from __future__ import annotations

import os
import signal
import sys
import threading
import time

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


class FileStore:
    """Heartbeat store over a shared directory (the etcd stand-in)."""

    def __init__(self, root, ttl=10):
        self.root = root
        self.ttl = ttl
        os.makedirs(root, exist_ok=True)

    def register(self, node_id):
        self.heartbeat(node_id)

    def heartbeat(self, node_id):
        # a temporary file and os.replace: a concurrent alive_nodes()
        # never reads a torn timestamp and declares a live node dead
        path = os.path.join(self.root, f"node.{node_id}")
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(str(time.time()))
        os.replace(tmp, path)

    def deregister(self, node_id):
        try:
            os.remove(os.path.join(self.root, f"node.{node_id}"))
        except FileNotFoundError:
            pass

    def alive_nodes(self):
        now = time.time()
        out = []
        for name in os.listdir(self.root):
            if not name.startswith("node.") or ".tmp." in name:
                continue
            try:
                with open(os.path.join(self.root, name)) as f:
                    ts = float(f.read().strip() or 0)
            except (OSError, ValueError):
                continue
            if now - ts <= self.ttl:
                out.append(name[len("node."):])
        return sorted(out)


class ElasticStatus:
    COMPLETED = "completed"
    ERROR = "error"
    HOLD = "hold"
    RESTART = "restart"
    EXIT = "exit"


class ElasticManager:
    """reference: fleet/elastic/manager.py:126."""

    def __init__(self, node_id=None, np=1, store=None, store_root=None,
                 ttl=10, heartbeat_interval=2.0):
        self.node_id = str(node_id if node_id is not None
                           else os.environ.get("PADDLE_TRAINER_ID", "0"))
        self.np = np
        if store is None:
            server = os.environ.get("PADDLE_ELASTIC_SERVER")
            if server:
                # a TCP liveness store: no shared filesystem needed
                # (reference: etcd keys, manager.py:221-242)
                from ..store import TCPElasticStore, TCPStore
                host, port = server.rsplit(":", 1)
                store = TCPElasticStore(
                    TCPStore(host, int(port),
                             is_master=os.environ.get(
                                 "PADDLE_ELASTIC_SERVER_HOST", "0") == "1"),
                    ttl=ttl)
        if store is None:
            import tempfile
            store = FileStore(store_root or os.environ.get(
                "PADDLE_ELASTIC_STORE",
                os.path.join(tempfile.gettempdir(), "pt_elastic")), ttl=ttl)
        self.store = store
        self.interval = heartbeat_interval
        self.level = int(os.environ.get(
            "PADDLE_ELASTIC_FAULT_TOLERANC_LEVEL", "1"))
        self._stop = threading.Event()
        self._thread = None
        self._baseline = None

    # ---- liveness ----
    def start(self):
        self.store.register(self.node_id)
        self._baseline = self.store.alive_nodes()
        self._thread = threading.Thread(target=self._beat_loop, daemon=True)
        self._thread.start()

    def _beat_loop(self):
        while not self._stop.is_set():
            self.store.heartbeat(self.node_id)
            self._stop.wait(self.interval)

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
        self.store.deregister(self.node_id)

    # ---- membership watch (reference watch :237-242) ----
    def watch(self):
        """One poll: an ElasticStatus."""
        alive = self.store.alive_nodes()
        if self._baseline is None:
            self._baseline = alive
            return ElasticStatus.HOLD
        if alive == self._baseline:
            return ElasticStatus.HOLD
        if len(alive) < self.np and self.level <= 1:
            return ElasticStatus.ERROR
        # scale up or down: rebuild the rendezvous and relaunch
        self._baseline = alive
        return ElasticStatus.RESTART

    def exit_code(self, status):
        return ELASTIC_EXIT_CODE if status == ElasticStatus.RESTART else 1
