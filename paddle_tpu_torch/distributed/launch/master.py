"""Multi-pod rendezvous master over the TCP store (port of
paddle_tpu/distributed/launch/master.py; reference: `HTTPMaster`,
launch/controllers/master.py:73 and `ETCDMaster` :186, and the elastic
scale-out/in of fleet/elastic/manager.py:487,510).

The store is `distributed.store.TCPStore` (``csrc/tcp_store.cpp``).
Rendezvous is versioned in rounds:

  {job}/round              monotone counter; bumped once per COMMIT
  {job}/r{N}/pod.{id}      pod info published by each participant
  {job}/r{N}/commit_lock   add()-based leader election for the commit
  {job}/r{N}/commit        final sorted pod list (the membership truth)
  {job}/scale              scale-out request counter (joiners bump it)
  node.{id}                server-clock heartbeats (TTL liveness)

A pod joining a running job writes itself into the current round and
bumps ``scale``; the running pods' watchers see the bump, stop their
workers with the elastic exit protocol and re-enter rendezvous at the
same round: the leader commits the merged membership and every pod
derives new contiguous ranks (scale-out).  A pod whose heartbeat expires
is not in the next round's membership (scale-in)."""
from __future__ import annotations

import json
import threading
import time

from ..store import TCPStore, TCPElasticStore

HOLD = "hold"
RESTART = "restart"


class KVMaster:
    """One pod's handle on the job's rendezvous + liveness state."""

    def __init__(self, endpoint, pod_id, np, is_host=False,
                 job_id="default", ttl=6.0, timeout=300.0):
        host, port = endpoint.rsplit(":", 1)
        self.store = TCPStore(host, int(port), is_master=is_host,
                              timeout=timeout)
        self.pod_id = str(pod_id)
        self.np = int(np)
        self.job = job_id
        self.timeout = timeout
        self._hb = TCPElasticStore(self.store, ttl=ttl)
        self._lock = threading.Lock()     # one client fd, many threads
        self._stop = threading.Event()
        self._thread = None
        self.round = -1
        self._baseline = None
        self._scale_base = 0
        self._peer_error = None   # first {job}/error/* record seen

    def _k(self, *parts):
        return "/".join((self.job,) + parts)

    # ---- liveness (reference: etcd TTL leases) ----
    def start_heartbeat(self, interval=1.0):
        with self._lock:
            self._hb.register(self.pod_id)
        self._thread = threading.Thread(target=self._beat,
                                        args=(interval,), daemon=True)
        self._thread.start()

    def _beat(self, interval):
        while not self._stop.is_set():
            try:
                with self._lock:
                    self._hb.heartbeat(self.pod_id)
            except Exception:
                pass
            # the same loop polls the cross-rank error trap: a worker
            # that died mid-collective recorded its exception under
            # {job}/error/{rank} (distributed/watchdog.py); caching it
            # here lets watch() turn the ORIGINAL error into a RESTART
            # without waiting for heartbeat TTL expiry
            try:
                if self._peer_error is None:
                    errs = self.peer_errors()
                    if errs:
                        self._peer_error = errs[0]
            except Exception:
                pass
            self._stop.wait(interval)

    # ---- cross-rank error trap (distributed/watchdog.py) ----
    def peer_errors(self):
        """Error records workers trapped under ``{job}/error/*``."""
        with self._lock:
            raw = self.store.list_prefix(self._k("error") + "/")
        out = []
        for val in raw.values():
            try:
                out.append(json.loads(val))
            except (ValueError, TypeError):
                continue
        return sorted(out, key=lambda r: r.get("ts", 0))

    def clear_errors(self):
        """Drop all guardian state (trapped errors, arrival markers,
        host-collective contributions) so a fresh incarnation neither
        re-trips on a stale error nor reads a dead incarnation's
        collective data at a colliding (group, seq)."""
        self._peer_error = None
        for prefix in ("error", "arrive", "hc"):
            try:
                with self._lock:
                    for key in self.store.list_prefix(
                            self._k(prefix) + "/"):
                        self.store.delete_key(key)
            except Exception:
                pass

    def alive(self):
        with self._lock:
            return self._hb.alive_nodes()

    def wait_peers_gone(self):
        """The host pod's store outlives the job's other pods: wait (at most
        the rendezvous timeout) until no other pod heartbeats, each having
        deregistered or let its lease expire.  Closing it first would cut
        a pod whose workers still run off its watch (a lost connection)."""
        deadline = time.time() + self.timeout
        while time.time() < deadline and set(self.alive()) - {self.pod_id}:
            time.sleep(0.2)

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
        try:
            with self._lock:
                self._hb.deregister(self.pod_id)
        except Exception:
            pass
        self.store.close()

    # ---- rendezvous (reference: master.py sync_peers) ----
    def rendezvous(self, min_nodes, max_nodes, quiet=1.0):
        """Join the current round; block until membership commits.
        Returns (round, pods, my_index) with pods sorted by id.  Raises
        TimeoutError if no commit including this pod within timeout."""
        deadline = time.time() + self.timeout
        requested_scale = False
        while time.time() < deadline:
            with self._lock:
                r = self.store.add(self._k("round"), 0)
                self.store.set(
                    self._k(f"r{r}", f"pod.{self.pod_id}"),
                    json.dumps({"id": self.pod_id, "np": self.np}))
                committed = self.store.get(self._k(f"r{r}", "commit"))
            if committed is not None:
                # this round already closed; if we're not in it, ask the
                # running job to rebuild (scale-out request) and retry at
                # the next round
                pods = json.loads(committed)
                if not any(p["id"] == self.pod_id for p in pods):
                    if not requested_scale:
                        with self._lock:
                            self.store.add(self._k("scale"), 1)
                        requested_scale = True
                    time.sleep(0.2)
                    continue
            else:
                # joining a RUNNING job (a previous round committed
                # without us): ask the members to rebuild — they exit
                # workers with the elastic protocol and rejoin this round
                if not requested_scale and r > 0:
                    prev = self._commit_of(r - 1)
                    if prev is not None and not any(
                            p["id"] == self.pod_id for p in prev):
                        with self._lock:
                            self.store.add(self._k("scale"), 1)
                        requested_scale = True
                pods = self._await_commit(r, min_nodes, max_nodes, quiet,
                                          deadline)
                if pods is None:
                    continue
            ids = [p["id"] for p in pods]
            if self.pod_id in ids:
                self.round = r
                self._baseline = set(self.alive()) or None
                with self._lock:
                    self._scale_base = self.store.add(self._k("scale"), 0)
                return r, pods, ids.index(self.pod_id)
        raise TimeoutError(
            f"rendezvous: no committed membership including pod "
            f"{self.pod_id!r} within {self.timeout}s")

    def _pods_in(self, r):
        with self._lock:
            raw = self.store.list_prefix(self._k(f"r{r}", "pod."))
        return [json.loads(v) for v in raw.values()]

    def _commit_of(self, r):
        with self._lock:
            c = self.store.get(self._k(f"r{r}", "commit"))
        return None if c is None else json.loads(c)

    def _await_commit(self, r, min_nodes, max_nodes, quiet, deadline):
        commit_key = self._k(f"r{r}", "commit")
        # merge semantics: every still-alive member of the previous
        # committed round must rejoin before this round may commit — a
        # late joiner must never fork the job into a second world
        prev = self._commit_of(r - 1) if r > 0 else None
        prev_ids = {p["id"] for p in prev} if prev else set()
        stable_since, last_ids = time.time(), None
        while time.time() < deadline:
            with self._lock:
                c = self.store.get(commit_key)
            if c is not None:
                return json.loads(c)
            pods = self._pods_in(r)
            alive = set(self.alive())
            if alive:          # drop writers that died before commit
                pods = [p for p in pods if p["id"] in alive]
            ids = sorted(p["id"] for p in pods)
            if ids != last_ids:
                stable_since, last_ids = time.time(), ids
            n = len(ids)
            required = (prev_ids & alive) if alive else prev_ids
            ready = (n >= max_nodes or (
                n >= min_nodes
                and time.time() - stable_since >= quiet)) \
                and required.issubset(ids)
            if ready and ids and ids[0] == self.pod_id:
                # leader: take the commit lock, write membership, open
                # the next round's namespace
                with self._lock:
                    if self.store.add(self._k(f"r{r}", "commit_lock"),
                                      1) == 1:
                        pods_sorted = sorted(pods, key=lambda p: p["id"])
                        self.store.set(commit_key,
                                       json.dumps(pods_sorted))
                        self.store.add(self._k("round"), 1)
                        return pods_sorted
            time.sleep(0.15)
        return None

    # ---- membership watch (reference: etcd watch + scale triggers) ----
    def watch(self):
        """One poll while workers run: HOLD or RESTART (membership must
        be rebuilt — a joiner requested scale-out, a pod died, or a
        worker trapped a fatal error in {job}/error/*)."""
        if self._peer_error is not None:
            return RESTART
        with self._lock:
            scale = self.store.add(self._k("scale"), 0)
        if scale != self._scale_base:
            self._scale_base = scale
            return RESTART
        alive = set(self.alive())
        if self._baseline and not self._baseline.issubset(alive):
            self._baseline = alive or None
            return RESTART            # a member died → scale-in
        if alive and self._baseline and alive != self._baseline:
            self._baseline = alive    # growth waits for the scale bump
        return HOLD
