"""Drain-aware serving router, the fleet's front door (port of
paddle_tpu/serving/router.py).  `ServingRouter` spreads requests over N
`Engine` replicas in separate processes (or threads, in tests), with

- **membership and gossip** over `distributed/store.py`: each replica
  heartbeats a TTL lease (`TCPElasticStore`) and gossips a
  ``fleet.{name}`` record (rpc endpoint, lifecycle state
  ``warming|ready|draining``, join generation, role, load), which the
  router polls to maintain its ring;
- **session-affine consistent hashing** (`HashRing`): requests with the
  same ``session_id`` (or the same prompt prefix) hash to the same
  replica, whose prefix cache keeps serving them; a replica joining or
  leaving remaps only the sessions it owns;
- **load shedding** with the engine's own admission: a replica at
  capacity raises `QueueFullError` through the rpc plane, the router
  spills to ring successors and, when every ready replica sheds, fails
  fast with `QueueFullError(retry_after_s=...)`.  Deadlines propagate end
  to end;
- **failure detection and resubmission**: a dead replica shows as a
  dropped rpc connection or an expired lease; its in-flight requests are
  resubmitted to survivors under the SAME idempotent request id, so a
  request's future resolves exactly once.  An rpc timeout against a
  replica still heartbeating is ambiguous and fails loudly;
- **drain awareness**: a replica entering ``draining`` stops receiving
  routes within one poll; its queued requests bounce back as
  `EngineShutdownError` and are resubmitted;
- **prefill/decode disaggregation** (``RouterConfig.disaggregation``):
  candidates order prefill > mixed > decode, and every submit carries the
  least-loaded ready decode replica as its KV-page migration target
  (`_pick_decode_target`);
- **the gray-failure guardian** (off by default): per-replica health
  scores (`_ReplicaHealth`), circuit breakers (`_Breaker`), a fleet-wide
  retry budget (`_RetryBudget`), hedged dispatch, robust-z ejection and
  canary readmission.

Anti-flap protocol (with `TCPElasticStore.reap`): a replica whose lease
expires is marked dead *sticky* under its join generation — resumed
heartbeats on the stale lease do NOT resurrect it.  The watcher reaps
the expired lease; the replica's own heartbeat loop notices the reap
and re-registers with a bumped generation, which the router accepts as
an explicit rejoin.  Membership events are edges, never oscillation.
"""
from __future__ import annotations

import bisect
import hashlib
import itertools
import json
import threading
import time
from collections import deque
from concurrent.futures import FIRST_COMPLETED, Future
from concurrent.futures import wait as _futures_wait
from dataclasses import dataclass

import numpy as np

from . import stats
from ..observability import tracing
from .api import (DeadlineExceededError, EngineShutdownError,
                  NoReplicaError, QueueFullError,
                  RequestCancelledError, RequestOutput,
                  SamplingParams, ServingError)

#: membership key prefixes on the fleet store (shared with fleet.py)
INFO_PREFIX = "fleet."


@dataclass
class RouterConfig:
    """Router knobs.

    heartbeat_ttl_s      replica lease: heartbeats older than this mark
                         the replica dead (sticky until it re-registers)
    poll_interval_s      membership watcher cadence; also bounds how
                         long a draining replica keeps receiving routes
    rpc_timeout_s        per-attempt cap on one replica call (a request
                         deadline below this wins)
    max_resubmits        resubmission budget per request across replica
                         deaths before the router fails it loudly
    retry_after_s        backoff hint carried by shed requests'
                         QueueFullError (the 429 Retry-After analog)
    virtual_nodes        consistent-hash vnodes per replica: higher =
                         smoother spread, slower ring rebuild
    no_replica_patience_s how long submit-time dispatch waits for ANY
                         ready replica (fleet warming up / mid-failover)
                         before NoReplicaError
    request_timeout_s    sync generate()'s Future wait
    disaggregation       prefill/decode disaggregation: route new
                         requests to prefill-role replicas first
                         (prefill > mixed > decode preference, ring
                         order within a class — roles are preferences,
                         so a lone decode replica still serves direct
                         traffic) and assign each request the least-
                         loaded ready decode replica as its KV-page
                         migration target.  Off (default): roles are
                         ignored entirely — routing is byte-identical
                         to the symmetric fleet
    migrate_min_new_tokens  only requests decoding at least this many
                         tokens get a migration target — a short tail
                         is cheaper to decode where it prefilled than
                         to move (requests without an explicit
                         max_new_tokens always qualify)

    Gray-failure guardian (every knob defaults OFF; routing is then
    byte-identical to the guardian-less router):

    health_ejection      master switch for health-scored outlier
                         ejection: per-replica EWMA latency and error
                         rates are fed from EVERY dispatch; a replica
                         whose score exceeds a robust z-threshold vs
                         the fleet median is ejected from the candidate
                         order (reversible + generation-preserving,
                         unlike sticky-dead), canary-probed, and
                         readmitted on sustained recovery
    health_alpha         EWMA coefficient of the latency/error score
    eject_zscore         robust z (median/MAD) beyond which a replica
                         is an outlier
    eject_min_samples    dispatches a replica must have served before
                         it can be ejected (no ejection on noise)
    eject_max_fraction   never eject more than this fraction of the
                         ready fleet (and never the last replica)
    canary_interval_s    probe cadence for ejected replicas
    canary_timeout_s     rpc budget of one canary probe
    readmit_canaries     consecutive healthy canaries before
                         readmission (sustained recovery, not one
                         lucky probe)
    hedge_percentile     > 0 arms hedged dispatch: a primary attempt
                         still unanswered past this percentile of
                         recent route latencies fires ONE hedge to the
                         next candidate under the SAME idempotent rid
                         (the replica dedup cache makes the pair
                         at-most-once); first answer wins, the loser
                         is cancelled (`Engine.cancel`).  0 = off
    hedge_min_samples    recent-latency samples required before the
                         percentile is trusted (no hedging cold)
    breaker_failures     > 0 arms per-replica circuit breakers: this
                         many transport failures within
                         breaker_window_s opens the breaker (replica
                         skipped without paying an rpc), one trial
                         call after breaker_cooldown_s half-opens it,
                         and a trial success recloses.  0 = off
    breaker_window_s     sliding failure-count window
    breaker_cooldown_s   open -> half-open delay
    retry_budget_per_s   > 0 arms the fleet-wide token-bucket retry
                         budget: resubmissions (failover, drain
                         bounce, dead-timeout) spend a token; an empty
                         bucket fails the request instead of letting a
                         resubmission storm amplify an outage.  0 =
                         unlimited (the pre-guardian behavior)
    retry_budget_burst   bucket capacity (burst tolerance)
    """

    heartbeat_ttl_s: float = 3.0
    poll_interval_s: float = 0.2
    rpc_timeout_s: float = 120.0
    max_resubmits: int = 3
    retry_after_s: float = 1.0
    virtual_nodes: int = 64
    no_replica_patience_s: float = 30.0
    request_timeout_s: float = 120.0
    disaggregation: bool = False
    migrate_min_new_tokens: int = 2
    health_ejection: bool = False
    health_alpha: float = 0.3
    eject_zscore: float = 4.0
    eject_min_samples: int = 8
    eject_max_fraction: float = 0.5
    canary_interval_s: float = 0.5
    canary_timeout_s: float = 5.0
    readmit_canaries: int = 3
    hedge_percentile: float = 0.0
    hedge_min_samples: int = 16
    breaker_failures: int = 0
    breaker_window_s: float = 10.0
    breaker_cooldown_s: float = 2.0
    retry_budget_per_s: float = 0.0
    retry_budget_burst: int = 10

    def validate(self):
        if self.heartbeat_ttl_s <= 0:
            raise ValueError(f"heartbeat_ttl_s must be > 0, got "
                             f"{self.heartbeat_ttl_s}")
        if self.poll_interval_s <= 0:
            raise ValueError(f"poll_interval_s must be > 0, got "
                             f"{self.poll_interval_s}")
        if self.virtual_nodes < 1:
            raise ValueError(f"virtual_nodes must be >= 1, got "
                             f"{self.virtual_nodes}")
        if self.max_resubmits < 0:
            raise ValueError(f"max_resubmits must be >= 0, got "
                             f"{self.max_resubmits}")
        if not (0.0 < self.health_alpha <= 1.0):
            raise ValueError(f"health_alpha must be in (0, 1], got "
                             f"{self.health_alpha}")
        if self.eject_zscore <= 0:
            raise ValueError(f"eject_zscore must be > 0, got "
                             f"{self.eject_zscore}")
        if self.eject_min_samples < 1:
            raise ValueError(f"eject_min_samples must be >= 1, got "
                             f"{self.eject_min_samples}")
        if not (0.0 <= self.eject_max_fraction <= 1.0):
            raise ValueError(f"eject_max_fraction must be in [0, 1], "
                             f"got {self.eject_max_fraction}")
        if self.canary_interval_s <= 0 or self.canary_timeout_s <= 0:
            raise ValueError("canary_interval_s and canary_timeout_s "
                             "must be > 0")
        if self.readmit_canaries < 1:
            raise ValueError(f"readmit_canaries must be >= 1, got "
                             f"{self.readmit_canaries}")
        if not (0.0 <= self.hedge_percentile < 100.0):
            raise ValueError(f"hedge_percentile must be in [0, 100), "
                             f"got {self.hedge_percentile}")
        if self.hedge_min_samples < 1:
            raise ValueError(f"hedge_min_samples must be >= 1, got "
                             f"{self.hedge_min_samples}")
        if self.breaker_failures < 0 or self.breaker_window_s <= 0 \
                or self.breaker_cooldown_s <= 0:
            raise ValueError("breaker_failures must be >= 0 and "
                             "breaker_window_s/breaker_cooldown_s > 0")
        if self.retry_budget_per_s < 0 or self.retry_budget_burst < 1:
            raise ValueError("retry_budget_per_s must be >= 0 and "
                             "retry_budget_burst >= 1")
        return self


def _as_transport_error(exc):
    """A candidate list is a snapshot: a dispatch thread can race a
    concurrent `_mark_dead` + `rpc.forget_worker` and dial a replica
    the registry no longer knows.  That 'unknown worker' ValueError IS
    a dead-replica signal — coerce it to the ConnectionError failover
    path instead of failing the request with an app-level error."""
    if isinstance(exc, ValueError) and "unknown worker" in str(exc):
        return ConnectionError(str(exc))
    return exc


def _hash64(data):
    if isinstance(data, str):
        data = data.encode()
    return int.from_bytes(hashlib.blake2b(data, digest_size=8).digest(),
                          "big")


class HashRing:
    """Consistent-hash ring with virtual nodes.  `lookup(key)` returns
    the owner; `successors(key)` yields every member once, owner first,
    in ring order — the router's spill/failover candidate order."""

    def __init__(self, virtual_nodes=64):
        self.vnodes = virtual_nodes
        self._points: list[tuple[int, str]] = []
        self._members: set[str] = set()

    def rebuild(self, members):
        members = set(members)
        if members == self._members:
            return False
        pts = []
        for name in members:
            for v in range(self.vnodes):
                pts.append((_hash64(f"{name}#{v}"), name))
        pts.sort()
        self._points = pts
        self._members = members
        return True

    @property
    def members(self):
        return set(self._members)

    def lookup(self, key):
        nxt = next(self.successors(key), None)
        return nxt

    def successors(self, key):
        """Distinct members starting at the key's owner, ring order."""
        if not self._points:
            return
        h = _hash64(key)
        idx = bisect.bisect_left(self._points, (h, ""))
        seen = set()
        n = len(self._points)
        for i in range(n):
            _, name = self._points[(idx + i) % n]
            if name not in seen:
                seen.add(name)
                yield name


class _ReplicaView:
    __slots__ = ("name", "ip", "port", "state", "gen", "load",
                 "load_ts", "tp", "role", "adapters")

    def __init__(self, info):
        self.name = info["name"]
        self.ip = info.get("ip", "127.0.0.1")
        self.port = int(info.get("port", 0))
        self.state = info.get("state", "warming")
        self.gen = int(info.get("gen", 0))
        self.load = info.get("load") or {}
        self.load_ts = float(info.get("load_ts", 0.0))
        self.tp = int(info.get("tp", 1))
        self.role = info.get("role", "mixed")
        self.adapters = frozenset(info.get("adapters") or ())


class _RoutedRequest:
    __slots__ = ("rid", "prompt", "max_new_tokens", "sampling",
                 "eos_token_id", "deadline", "session_key", "future",
                 "submit_t", "attempts", "resubmits", "adapter_id",
                 "trace")

    def __init__(self, rid, prompt, max_new_tokens, sampling,
                 eos_token_id, deadline, session_key, adapter_id=None):
        self.rid = rid
        self.prompt = prompt
        self.max_new_tokens = max_new_tokens
        self.sampling = sampling
        self.eos_token_id = eos_token_id
        self.deadline = deadline            # absolute monotonic or None
        self.session_key = session_key
        self.adapter_id = adapter_id        # multi-tenant LoRA affinity
        self.future = Future()
        self.submit_t = time.monotonic()
        self.attempts = 0                   # dispatch rounds
        self.resubmits = 0                  # re-sends after the first
        self.trace = None                   # root Span (tracing armed)


class _ReplicaHealth:
    """EWMA latency + error-rate score of one replica, fed from every
    dispatch.  `score()` is the health scalar the guardian compares
    across the fleet: EWMA route latency (ms) inflated by the EWMA
    transport-error rate — a replica that is slow OR flaky scores high.
    Backpressure (`QueueFullError`) and lifecycle bounces are neutral:
    a full queue is load, not sickness."""

    __slots__ = ("ewma_ms", "err_ewma", "samples")

    def __init__(self):
        self.ewma_ms = None
        self.err_ewma = 0.0
        self.samples = 0

    def observe(self, alpha, latency_ms, error):
        self.samples += 1
        if self.ewma_ms is None:
            self.ewma_ms = float(latency_ms)
        else:
            self.ewma_ms += alpha * (float(latency_ms) - self.ewma_ms)
        self.err_ewma += alpha * ((1.0 if error else 0.0)
                                  - self.err_ewma)

    def score(self):
        if self.ewma_ms is None:
            return None
        return self.ewma_ms * (1.0 + 4.0 * self.err_ewma)


class _Breaker:
    """Per-replica circuit breaker: closed -> open -> half-open.
    `breaker_failures` transport failures inside `breaker_window_s`
    open it (calls skipped without paying an rpc); after
    `breaker_cooldown_s` ONE trial call is admitted (half-open); a
    trial success recloses, a trial failure re-opens."""

    __slots__ = ("state", "fail_times", "open_until")

    def __init__(self):
        self.state = "closed"
        self.fail_times: list[float] = []
        self.open_until = 0.0

    def allow(self, now, cooldown_s):
        if self.state == "closed":
            return True
        if self.state == "open" and now >= self.open_until:
            self.state = "half"          # admit exactly one trial
            return True
        return False                     # open (cooling) or half (trial
        #                                  already in flight)

    def on_success(self):
        self.state = "closed"
        self.fail_times.clear()

    def on_failure(self, now, threshold, window_s, cooldown_s):
        """Record one transport failure; returns True on a transition
        into `open` (the caller counts those)."""
        if self.state == "half":
            self.state = "open"
            self.open_until = now + cooldown_s
            return True
        self.fail_times.append(now)
        self.fail_times = [t for t in self.fail_times
                           if now - t <= window_s]
        if self.state == "closed" and len(self.fail_times) >= threshold:
            self.state = "open"
            self.open_until = now + cooldown_s
            return True
        return False


class _RetryBudget:
    """Fleet-wide token bucket spent by resubmissions.  A replica
    outage that triggers mass failover drains the bucket; once empty,
    further resubmissions fail loudly instead of amplifying the outage
    with a retry storm (the classic metastable-failure feedback
    loop)."""

    __slots__ = ("rate", "burst", "tokens", "stamp", "_lock")

    def __init__(self, rate, burst):
        self.rate = float(rate)
        self.burst = float(burst)
        self.tokens = float(burst)
        self.stamp = time.monotonic()
        self._lock = threading.Lock()

    def take(self):
        with self._lock:
            now = time.monotonic()
            self.tokens = min(self.burst,
                              self.tokens + (now - self.stamp)
                              * self.rate)
            self.stamp = now
            if self.tokens >= 1.0:
                self.tokens -= 1.0
                return True
            return False


class ServingRouter:
    """`ServingRouter(store).start()`; then `submit()` / `generate()`
    exactly like a local `Engine` — the fleet is one logical engine.
    `close()` stops the watcher and fails outstanding futures."""

    def __init__(self, store, config: RouterConfig | None = None,
                 name="router"):
        from ..distributed.store import TCPElasticStore
        self.store = store
        self.cfg = (config or RouterConfig()).validate()
        self.name = name
        self.membership = TCPElasticStore(store,
                                          ttl=self.cfg.heartbeat_ttl_s)
        self.ring = HashRing(self.cfg.virtual_nodes)
        self._replicas: dict[str, _ReplicaView] = {}
        self._dead_gen: dict[str, int] = {}   # sticky-dead by generation
        self._lock = threading.RLock()
        self._inflight: dict[str, _RoutedRequest] = {}
        self._running = False
        self._watcher = None
        self._rid_prefix = f"{name}-{_hash64(repr(time.time())) % 10**6}"
        self._ids = itertools.count()
        # ---- gray-failure guardian state (all knobs default off) ----
        cfg = self.cfg
        self._guardian = bool(cfg.health_ejection
                              or cfg.hedge_percentile > 0
                              or cfg.breaker_failures > 0)
        self._health: dict[str, _ReplicaHealth] = {}
        self._ejected: dict[str, dict] = {}   # name -> canary state
        self._breakers: dict[str, _Breaker] = {}
        self._lat_ring: deque[float] = deque(maxlen=512)
        self._shed_times: deque[float] = deque(maxlen=256)
        self._retry_budget = (_RetryBudget(cfg.retry_budget_per_s,
                                           cfg.retry_budget_burst)
                              if cfg.retry_budget_per_s > 0 else None)

    # ---------------- lifecycle ----------------
    def start(self):
        with self._lock:
            if self._running:
                return self
            stats.reset_router_stats()
            stats.declare_trace_stats()
            if tracing.enabled():
                tracing.set_process_name(self.name, default=True)
            self._running = True
        self._poll_membership()               # synchronous first view
        self._watcher = threading.Thread(
            target=self._watch_loop, name="paddle-tpu-serving-router",
            daemon=True)
        self._watcher.start()
        return self

    def close(self):
        with self._lock:
            if not self._running:
                return
            self._running = False
            pending = list(self._inflight.values())
            self._inflight.clear()
        for req in pending:
            if not req.future.done():
                try:
                    req.future.set_exception(EngineShutdownError(
                        "serving router closed"))
                except Exception:
                    pass
            if req.trace is not None:
                req.trace.end(status="shutdown")
                tracing.decide(
                    req.trace.ctx.trace_id, status="shutdown",
                    latency_ms=(time.monotonic() - req.submit_t) * 1e3)
        if tracing.enabled():
            tracing.spool_now()
        w = self._watcher
        if w is not None:
            w.join(5.0)
            self._watcher = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()

    # ---------------- membership ----------------
    def _watch_loop(self):
        while self._running:
            try:
                self._poll_membership()
            except Exception:
                # a flaky store read must not kill routing; the next
                # poll retries and the sticky-dead set is unchanged
                pass
            try:
                self._guardian_tick()
            except Exception:
                # guardian bookkeeping must never kill membership
                # polling either
                pass
            time.sleep(self.cfg.poll_interval_s)

    def _poll_membership(self):
        alive, expired = self.membership._scan()
        alive, expired = set(alive), set(expired)
        infos = {}
        for key, val in self.store.list_prefix(INFO_PREFIX).items():
            try:
                view = _ReplicaView(json.loads(val.decode()))
            except (ValueError, KeyError):
                continue
            infos[view.name] = view
        with self._lock:
            ready = set()
            for name, view in infos.items():
                dead_gen = self._dead_gen.get(name)
                if dead_gen is not None and view.gen <= dead_gen:
                    continue                      # sticky dead, no rejoin
                if dead_gen is not None and view.gen > dead_gen:
                    del self._dead_gen[name]      # explicit rejoin
                if name in expired or (name not in alive
                                       and name not in infos):
                    self._mark_dead_locked(name, view.gen)
                    continue
                if name not in alive:
                    # info published but no lease yet (registering) —
                    # not ready, not dead
                    continue
                if view.state == "ready":
                    ready.add(name)
            self._replicas = infos
            was = self.ring.members
            self.ring.rebuild(ready)
            for name in ready - was:
                from ..distributed import rpc
                rpc.connect_worker(name, infos[name].ip,
                                   infos[name].port)
            stats.set_value("router.replicas_alive", len(ready))
        # reap expired leases so a paused-then-resumed heartbeater must
        # explicitly re-register (anti-flap; see module docstring)
        if expired:
            self.membership.reap()

    def _mark_dead_locked(self, name, gen):
        if self._dead_gen.get(name, -1) < gen:
            self._dead_gen[name] = gen
        if name in self.ring.members:
            self.ring.rebuild(self.ring.members - {name})
            stats.incr("router.replicas_lost")
        # a dead replica's guardian state dies with it: its eventual
        # rejoin (bumped generation) starts with a clean slate
        self._ejected.pop(name, None)
        self._health.pop(name, None)
        self._breakers.pop(name, None)
        from ..distributed import rpc
        rpc.forget_worker(name)

    def _mark_dead(self, name):
        with self._lock:
            view = self._replicas.get(name)
            self._mark_dead_locked(name, view.gen if view else 0)
            stats.set_value("router.replicas_alive",
                            len(self.ring.members))

    def replicas(self):
        """Current membership snapshot: {name: state} (ready members are
        routable; draining/warming/dead ones are not)."""
        with self._lock:
            out = {}
            for name, view in self._replicas.items():
                if name in self._dead_gen and \
                        view.gen <= self._dead_gen[name]:
                    out[name] = "dead"
                else:
                    out[name] = view.state
            return out

    # ---------------- client API ----------------
    def submit(self, prompt_ids, max_new_tokens=None, sampling=None,
               eos_token_id=None, deadline_s=None, session_id=None,
               adapter_id=None):
        """Route one request; returns a `Future[RequestOutput]`.  The
        Future resolves exactly once — with the output, or with the
        loudest-applicable error (`QueueFullError` when the fleet sheds,
        `DeadlineExceededError`, `NoReplicaError`, ...)."""
        if not self._running:
            raise EngineShutdownError("router is not running")
        prompt = np.asarray(prompt_ids).astype(np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        sampling = (sampling or SamplingParams()).validate()
        deadline = (time.monotonic() + deadline_s) \
            if deadline_s is not None else None
        key = str(session_id) if session_id is not None \
            else prompt[:16].tobytes()
        rid = f"{self._rid_prefix}-{next(self._ids)}"
        req = _RoutedRequest(
            rid, prompt, max_new_tokens, sampling, eos_token_id,
            deadline, key,
            adapter_id=str(adapter_id) if adapter_id is not None
            else None)
        if tracing.enabled():
            # the router owns the ROOT span of a routed trace: it ends
            # it in _complete/_fail and makes the one tail-sampling
            # decision for the whole request (engine-side spans of a
            # routed request are always children, never roots)
            req.trace = tracing.start_span(
                "router.request", rid=rid,
                prompt_tokens=int(prompt.size))
        with self._lock:
            self._inflight[rid] = req
        threading.Thread(target=self._dispatch, args=(req,),
                         name=f"route-{rid}", daemon=True).start()
        return req.future

    def generate(self, prompt_ids, max_new_tokens=None, sampling=None,
                 eos_token_id=None, deadline_s=None, session_id=None,
                 timeout=None, adapter_id=None):
        fut = self.submit(prompt_ids, max_new_tokens=max_new_tokens,
                          sampling=sampling, eos_token_id=eos_token_id,
                          deadline_s=deadline_s, session_id=session_id,
                          adapter_id=adapter_id)
        return fut.result(timeout or self.cfg.request_timeout_s)

    def stats(self):
        return stats.serving_stats()

    # ---------------- dispatch ----------------
    def _remaining(self, req):
        if req.deadline is None:
            return None
        return req.deadline - time.monotonic()

    def _candidates(self, req):
        """Ready replicas in affinity order, cheap-shed filtered: a
        replica whose fresh gossip already says its queue is full is
        skipped without paying an rpc.  Disaggregation reorders the
        candidates by role preference (prefill > mixed > decode, ring
        order within a class) — new prompts land on prefill replicas,
        but a decode replica still serves as the last resort, so a
        fleet mid-role-flip never strands a request.

        Adapter affinity is the OUTERMOST (final, stable) sort: a
        request carrying an `adapter_id` prefers replicas whose gossip
        advertises that adapter as hot-loaded, so a warm pool slot is
        reused instead of paying a hot-load; a cold replica is still a
        valid fallback (it hot-loads on admission), so no adapter ever
        strands a request."""
        with self._lock:
            order = list(self.ring.successors(req.session_key))
            views = dict(self._replicas)
            blocked = set()
            if self._guardian:
                if self.cfg.health_ejection and self._ejected:
                    blocked |= set(self._ejected)
                if self.cfg.breaker_failures > 0 and self._breakers:
                    mono = time.monotonic()
                    for n in order:
                        br = self._breakers.get(n)
                        if br is not None and n not in blocked and \
                                not br.allow(
                                    mono, self.cfg.breaker_cooldown_s):
                            blocked.add(n)
        now = time.time()
        out, skipped_full = [], 0
        for name in order:
            view = views.get(name)
            if view is None:
                continue
            if name in blocked:
                # ejected by the health guardian or breaker-open:
                # reversible, generation-preserving skip — the replica
                # stays in the ring and rejoins the order on
                # readmission / breaker reclose
                continue
            load = view.load
            fresh = (now - view.load_ts) <= \
                max(2 * self.cfg.heartbeat_ttl_s, 1.0)
            if fresh and load and \
                    load.get("queue_depth", 0) >= load.get(
                        "max_queue", float("inf")):
                skipped_full += 1
                continue
            out.append(name)
        if self.cfg.disaggregation:
            rank = {"prefill": 0, "mixed": 1, "decode": 2}
            out.sort(key=lambda n: rank.get(
                getattr(views.get(n), "role", "mixed"), 1))
        if req.adapter_id is not None:
            out.sort(key=lambda n: 0 if req.adapter_id in getattr(
                views.get(n), "adapters", ()) else 1)
        return out, skipped_full, sorted(blocked)

    def _fail(self, req, exc):
        with self._lock:
            self._inflight.pop(req.rid, None)
        if not req.future.done():
            try:
                req.future.set_exception(exc)
            except Exception:
                pass
        if req.trace is not None:
            status = type(exc).__name__
            req.trace.end(status=status, error=str(exc)[:200])
            tracing.decide(
                req.trace.ctx.trace_id, status=status,
                latency_ms=(time.monotonic() - req.submit_t) * 1e3)

    def _complete(self, req, payload, replica):
        """Deliver one payload to the request future.  Returns True iff
        THIS call won the exactly-once delivery (the caller marks its
        attempt span as the trace's single winner on True)."""
        out = RequestOutput(
            request_id=req.rid, prompt_ids=req.prompt,
            output_ids=np.asarray(payload["output_ids"], np.int32),
            finish_reason=payload["finish_reason"],
            ttft_ms=payload.get("ttft_ms"),
            latency_ms=(time.monotonic() - req.submit_t) * 1e3,
            decoded_by=payload.get("decoded_by") or replica)
        with self._lock:
            self._inflight.pop(req.rid, None)
            view = self._replicas.get(replica)
        if req.future.done():            # at-most-once delivery
            return False
        try:
            req.future.set_result(out)
        except Exception:
            return False
        stats.route_observe(replica, view.role if view else "mixed")
        stats.observe("router.route_latency_ms", out.latency_ms)
        if req.resubmits:
            stats.incr("router.requests_recovered")
        if req.trace is not None:
            req.trace.end(status="ok",
                          finish_reason=out.finish_reason,
                          replica=replica,
                          decoded_by=out.decoded_by,
                          resubmits=req.resubmits)
            tracing.decide(req.trace.ctx.trace_id, status="ok",
                           latency_ms=out.latency_ms)
        return True

    def _dispatch(self, req):
        cfg = self.cfg
        patience = time.monotonic() + cfg.no_replica_patience_s
        while True:
            if req.future.done():
                return
            if not self._running:
                self._fail(req, EngineShutdownError(
                    "serving router closed"))
                return
            remaining = self._remaining(req)
            if remaining is not None and remaining <= 0:
                self._fail(req, DeadlineExceededError(
                    f"request {req.rid} expired after "
                    f"{time.monotonic() - req.submit_t:.3f}s at the "
                    "router"))
                return
            candidates, skipped_full, blocked = self._candidates(req)
            if req.trace is not None:
                req.trace.event("candidates", order=list(candidates),
                                skipped_full=skipped_full,
                                blocked=blocked)
            if not candidates:
                if skipped_full:
                    if req.trace is not None:
                        req.trace.event("shed",
                                        skipped_full=skipped_full)
                    self._shed(req)
                    return
                # no ready replica AT ALL: wait for the fleet (warming
                # up or mid-failover) within the patience window
                if time.monotonic() >= patience:
                    self._fail(req, NoReplicaError(
                        f"no ready replica for request {req.rid} "
                        f"within {cfg.no_replica_patience_s:.1f}s "
                        f"(membership: {self.replicas()})"))
                    return
                time.sleep(cfg.poll_interval_s)
                continue
            all_full = True
            for i, name in enumerate(candidates):
                remaining = self._remaining(req)
                if remaining is not None and remaining <= 0:
                    self._fail(req, DeadlineExceededError(
                        f"request {req.rid} expired mid-dispatch"))
                    return
                budget = cfg.rpc_timeout_s if remaining is None \
                    else min(cfg.rpc_timeout_s, remaining)
                # hedging applies to the PRIMARY attempt only (first
                # candidate, first round) — hedging a spill chain would
                # amplify load exactly when the fleet is struggling
                hedge_peer = (candidates[i + 1]
                              if cfg.hedge_percentile > 0 and i == 0
                              and req.attempts == 0
                              and len(candidates) > 1 else None)
                err = self._try_replica(req, name, budget,
                                        hedge_peer=hedge_peer)
                if err is None:
                    return                       # delivered
                if isinstance(err, QueueFullError):
                    if req.trace is not None:
                        req.trace.event("spill", replica=name)
                    continue                     # spill to successor
                if isinstance(err, EngineShutdownError):
                    # draining/stopped: resubmit elsewhere — counted
                    # against the same budget as death-failovers so a
                    # replica stuck bouncing every submit can never pin
                    # a request in the dispatch loop forever
                    if not self._retry_allowed(req, err):
                        return
                    stats.incr("router.resubmissions")
                    req.resubmits += 1
                    req.attempts += 1
                    if req.trace is not None:
                        req.trace.event("resubmit", replica=name,
                                        reason="drain_bounce")
                    all_full = False
                    if req.attempts > cfg.max_resubmits:
                        self._fail(req, ServingError(
                            f"request {req.rid}: exhausted "
                            f"{cfg.max_resubmits} resubmits (last: "
                            f"replica {name} refused: {err})"))
                        return
                    continue
                if isinstance(err, (ConnectionError, OSError)):
                    self._mark_dead(name)
                    stats.incr("router.failovers")
                    if req.trace is not None:
                        req.trace.event("failover", replica=name,
                                        reason="transport")
                    if not self._retry_allowed(req, err):
                        return
                    stats.incr("router.resubmissions")
                    req.resubmits += 1
                    req.attempts += 1
                    all_full = False
                    if req.attempts > cfg.max_resubmits:
                        self._fail(req, ServingError(
                            f"request {req.rid}: exhausted "
                            f"{cfg.max_resubmits} resubmits across "
                            f"replica failures (last: {err})"))
                        return
                    continue
                if isinstance(err, TimeoutError):
                    # ambiguous: the replica may still be computing.
                    # Dead (lease expired) -> safe to resubmit under the
                    # idempotent rid; alive -> fail LOUDLY, never hang.
                    if name in self.membership.alive_nodes():
                        self._fail(req, DeadlineExceededError(
                            f"request {req.rid}: rpc to live replica "
                            f"{name} timed out after {budget:.1f}s; "
                            "not retrying a possibly-executing call "
                            "on a healthy replica"))
                        return
                    self._mark_dead(name)
                    stats.incr("router.failovers")
                    if req.trace is not None:
                        req.trace.event("failover", replica=name,
                                        reason="timeout_dead")
                    if not self._retry_allowed(req, err):
                        return
                    stats.incr("router.resubmissions")
                    req.resubmits += 1
                    req.attempts += 1
                    all_full = False
                    if req.attempts > cfg.max_resubmits:
                        self._fail(req, ServingError(
                            f"request {req.rid}: exhausted "
                            f"{cfg.max_resubmits} resubmits (last: "
                            f"rpc timeout on dead replica {name})"))
                        return
                    continue
                self._fail(req, err)             # app-level error
                return
            if all_full:
                if req.trace is not None:
                    req.trace.event("shed", all_full=True)
                self._shed(req)
                return
            # unsuccessful round that wasn't a shed: give the watcher
            # one poll to settle the ring before re-reading membership
            time.sleep(cfg.poll_interval_s)

    def _shed(self, req):
        stats.incr("router.requests_shed")
        hint = self._retry_after_hint()
        self._fail(req, QueueFullError(
            f"request {req.rid}: every ready replica is at capacity; "
            f"retry after {hint:.1f}s",
            retry_after_s=hint))

    def _retry_after_hint(self):
        """The Retry-After hint, scaled by current shed pressure: the
        busier the last 5 s of sheds, the longer clients are told to
        back off — fleet-side pushback that spreads the retry wave
        instead of inviting it back all at once.  The FIRST shed in a
        quiet window returns exactly `retry_after_s`."""
        now = time.monotonic()
        with self._lock:
            self._shed_times.append(now)
            recent = sum(1 for t in self._shed_times
                         if now - t <= 5.0)
        return self.cfg.retry_after_s * min(
            8.0, 1.0 + 0.25 * (recent - 1))

    def _pick_decode_target(self, exclude):
        """The migration target for a request about to land on
        `exclude`: the least-loaded ready decode-role replica, or None
        when the fleet has none (the prefill replica then decodes
        locally — disaggregation degrades to mixed, never to a
        failure)."""
        with self._lock:
            ready = self.ring.members
            views = [v for n, v in self._replicas.items()
                     if n in ready and n != exclude
                     and v.role == "decode"]
        if not views:
            return None
        v = min(views, key=lambda v: (
            v.load.get("queue_depth", 0) + v.load.get("active_slots", 0),
            v.name))
        return {"name": v.name, "ip": v.ip, "port": v.port}

    def _submit_args(self, req, name):
        """The `_remote_submit` args tuple for one attempt against
        `name` (the handoff target is picked per target replica, so a
        hedge recomputes it)."""
        remaining = self._remaining(req)
        sampling = {"temperature": req.sampling.temperature,
                    "top_k": req.sampling.top_k,
                    "top_p": req.sampling.top_p,
                    "repetition_penalty":
                        req.sampling.repetition_penalty,
                    "seed": req.sampling.seed}
        migratable = req.max_new_tokens is None or \
            req.max_new_tokens >= self.cfg.migrate_min_new_tokens
        handoff = self._pick_decode_target(name) \
            if self.cfg.disaggregation and migratable else None
        return (name, req.rid, req.prompt, req.max_new_tokens,
                sampling, req.eos_token_id, remaining, handoff,
                req.adapter_id)

    def _try_replica(self, req, name, budget, hedge_peer=None):
        """One delivery attempt.  Returns None on success (future
        completed) or the exception describing why this replica did not
        serve it.  With hedging armed and warmed up, the attempt runs
        through `_try_replica_hedged` instead."""
        from ..distributed import rpc
        from .fleet import _remote_submit
        if hedge_peer is not None:
            threshold_s = self._hedge_threshold_s()
            if threshold_s is not None and threshold_s < budget:
                return self._try_replica_hedged(
                    req, name, hedge_peer, budget, threshold_s)
        span = None
        if req.trace is not None:
            span = tracing.start_span(
                "router.attempt", parent=req.trace,
                replica=name, attempt=req.attempts)
        t0 = time.monotonic()
        try:
            # bind the attempt span so rpc_sync attaches its wire form
            # to the call envelope — the replica's engine spans parent
            # under THIS attempt, not the root
            with tracing.bind(span):
                payload = rpc.rpc_sync(
                    name, _remote_submit,
                    args=self._submit_args(req, name),
                    timeout=budget + 1.0)
        except Exception as e:               # noqa: BLE001
            e = _as_transport_error(e)
            self._observe_attempt(name, time.monotonic() - t0, e)
            if span is not None:
                span.end(status=type(e).__name__)
            return e
        self._observe_attempt(name, time.monotonic() - t0, None)
        won = self._complete(req, payload, name)
        if span is not None:
            span.end(status="ok", winner=won)
        return None

    # ---------------- gray-failure guardian ----------------
    def _observe_attempt(self, name, dt_s, exc):
        """Health/breaker bookkeeping for one finished attempt.  Fed
        from EVERY dispatch (successes included), which is what lets
        the guardian see a replica that is slow-but-alive.  Transport
        failures (connection loss, timeout) count as errors;
        backpressure and lifecycle errors (`QueueFullError`,
        `EngineShutdownError`) are neutral — a shedding replica is
        busy, not sick.  A hedged loser's `RequestCancelledError` is a
        LATENCY observation, not an error: the attempt was at least
        `dt_s` slow before the hedge beat it and we gave up — without
        this, hedging would mask exactly the slow replica that
        health-scored ejection exists to catch (every slow primary
        gets hedged away and cancelled, so it never reports a slow
        success)."""
        if not self._guardian:
            return
        transport = exc is not None and isinstance(
            exc, (OSError, TimeoutError))
        cancelled = isinstance(exc, RequestCancelledError)
        success = exc is None
        with self._lock:
            if self.cfg.breaker_failures > 0:
                br = self._breakers.setdefault(name, _Breaker())
                if transport:
                    if br.on_failure(time.monotonic(),
                                     self.cfg.breaker_failures,
                                     self.cfg.breaker_window_s,
                                     self.cfg.breaker_cooldown_s):
                        stats.incr("router.breaker_open")
                elif success:
                    br.on_success()
            if success or transport or cancelled:
                h = self._health.setdefault(name, _ReplicaHealth())
                h.observe(self.cfg.health_alpha, dt_s * 1e3,
                          error=transport)
            if success:
                self._lat_ring.append(dt_s * 1e3)

    def _attempt_observer(self, name, t0):
        """`add_done_callback` adapter for async (hedged) attempts."""
        def _cb(fut):
            try:
                exc = fut.exception()
            except Exception as e:           # noqa: BLE001
                exc = e
            self._observe_attempt(name, time.monotonic() - t0, exc)
        return _cb

    def _hedge_threshold_s(self):
        """p{hedge_percentile} of recent route latencies, or None until
        `hedge_min_samples` successes have been seen (no hedging on a
        cold or idle fleet — a made-up threshold would hedge every
        request)."""
        if self.cfg.hedge_percentile <= 0:
            return None
        with self._lock:
            if len(self._lat_ring) < self.cfg.hedge_min_samples:
                return None
            arr = np.fromiter(self._lat_ring, dtype=np.float64)
        return float(np.percentile(arr,
                                   self.cfg.hedge_percentile)) / 1e3

    def _try_replica_hedged(self, req, name, peer, budget,
                            threshold_s):
        """Hedged primary attempt: fire `name`, wait the latency
        percentile, and if still unanswered fire ONE hedge to `peer`
        under the SAME rid.  The replica-side dedup cache makes the
        pair at-most-once on any single replica, and `_complete`'s
        done-check makes delivery exactly-once across both.  First
        answer wins; the loser is cancelled (`Engine.cancel` via
        `_remote_cancel`) so its slot/pages/adapter rows come back
        instead of decoding a stream nobody will read."""
        from ..distributed import rpc
        from .fleet import _remote_cancel, _remote_submit
        spans = {}                           # future -> attempt Span
        span1 = None
        if req.trace is not None:
            span1 = tracing.start_span(
                "router.attempt", parent=req.trace,
                replica=name, attempt=req.attempts, hedged="primary")
        t0 = time.monotonic()
        # rpc_async captures the caller's thread-bound context at CALL
        # time, so each attempt's wire context is its own span — both
        # hedge arms stay under the SAME trace, each as its own child
        with tracing.bind(span1):
            fut1 = rpc.rpc_async(name, _remote_submit,
                                 args=self._submit_args(req, name),
                                 timeout=budget + 1.0)
        fut1.add_done_callback(self._attempt_observer(name, t0))
        spans[fut1] = span1
        done, _ = _futures_wait([fut1], timeout=threshold_s)
        futs = {fut1: name}
        hedge_fut = None
        if not done:
            left = budget - (time.monotonic() - t0)
            if left > 0:
                stats.incr("router.hedges")
                hedge_span = None
                if req.trace is not None:
                    req.trace.event("hedge", primary=name, peer=peer,
                                    threshold_ms=round(
                                        threshold_s * 1e3, 3))
                    hedge_span = tracing.start_span(
                        "router.attempt", parent=req.trace,
                        replica=peer, attempt=req.attempts,
                        hedged="hedge")
                t1 = time.monotonic()
                with tracing.bind(hedge_span):
                    hedge_fut = rpc.rpc_async(
                        peer, _remote_submit,
                        args=self._submit_args(req, peer),
                        timeout=left + 1.0)
                hedge_fut.add_done_callback(
                    self._attempt_observer(peer, t1))
                futs[hedge_fut] = peer
                spans[hedge_fut] = hedge_span
        pending = set(futs)
        primary_err = None
        other_err = None
        while pending:
            # each attempt carries its own rpc timeout, so this wait
            # always terminates; the outer timeout is a backstop
            done, pending = _futures_wait(
                pending, timeout=budget + 5.0,
                return_when=FIRST_COMPLETED)
            if not done:
                break
            for fut in done:
                who = futs[fut]
                try:
                    exc = fut.exception()
                except Exception as e:       # noqa: BLE001
                    exc = e
                exc = _as_transport_error(exc) if exc is not None \
                    else None
                if exc is None:
                    won = self._complete(req, fut.result(), who)
                    if spans.get(fut) is not None:
                        spans[fut].end(status="ok", winner=won)
                    if fut is hedge_fut:
                        stats.incr("router.hedge_wins")
                    for loser, loser_name in futs.items():
                        if loser is not fut and not loser.done():
                            try:             # fire-and-forget cancel
                                rpc.rpc_async(
                                    loser_name, _remote_cancel,
                                    args=(loser_name, req.rid),
                                    timeout=self.cfg.rpc_timeout_s)
                            except Exception:
                                pass
                            if spans.get(loser) is not None:
                                # the explicitly-cancelled loser: one
                                # winning span + this, never two wins
                                spans[loser].end(status="cancelled",
                                                 cancelled=True)
                    for f2, sp2 in spans.items():
                        # a loser that FINISHED before the winner was
                        # processed (same done batch): not cancelled,
                        # just beaten — end() is idempotent, so spans
                        # already closed above keep their status
                        if sp2 is not None and f2 is not fut:
                            sp2.end(status="superseded")
                    return None
                if spans.get(fut) is not None:
                    spans[fut].end(status=type(exc).__name__)
                if fut is fut1:
                    primary_err = exc
                else:
                    other_err = exc
        # both attempts failed (or the primary failed before a hedge
        # fired): report the primary's error so the dispatch loop's
        # spill/failover semantics match the unhedged path
        for sp in spans.values():
            if sp is not None:               # idempotent for ended ones
                sp.end(status="unresolved")
        if primary_err is not None:
            return primary_err
        if other_err is not None:
            return other_err
        return TimeoutError(
            f"hedged attempt pair for {req.rid} did not resolve "
            f"within {budget:.1f}s")

    def _retry_allowed(self, req, err):
        """Spend one fleet-wide retry-budget token for a resubmission;
        an empty bucket fails the request loudly (no retry storm).
        Unlimited when the budget knob is off."""
        if self._retry_budget is None or self._retry_budget.take():
            return True
        stats.incr("router.retry_budget_exhausted")
        self._fail(req, ServingError(
            f"request {req.rid}: fleet retry budget exhausted "
            f"({self.cfg.retry_budget_per_s:.1f}/s, burst "
            f"{self.cfg.retry_budget_burst}); not amplifying the "
            f"outage (last error: {err})"))
        return False

    def _healthy_median_locked(self, exclude=None):
        """Median health score of ready, non-ejected replicas (the
        canary's yardstick), or None when nothing has a score yet."""
        vals = []
        for n in self.ring.members:
            if n == exclude or n in self._ejected:
                continue
            h = self._health.get(n)
            s = h.score() if h is not None else None
            if s is not None:
                vals.append(s)
        return float(np.median(vals)) if vals else None

    def _guardian_tick(self):
        """One watcher-cadence pass of the health guardian: publish
        per-replica scores, eject robust-z outliers, and canary-probe
        ejected replicas toward readmission."""
        cfg = self.cfg
        if not cfg.health_ejection:
            return
        now = time.monotonic()
        probes = []
        with self._lock:
            ready = self.ring.members
            # scores -> gauge (ejected replicas keep publishing so the
            # recovery is visible on the dashboard)
            scored = {}
            for n in ready | set(self._ejected):
                h = self._health.get(n)
                s = h.score() if h is not None else None
                if s is not None:
                    scored[n] = s
                    stats.health_observe(n, s)
            # robust-z outlier ejection over warmed-up, still-in
            # candidates
            eligible = {
                n: s for n, s in scored.items()
                if n in ready and n not in self._ejected
                and self._health[n].samples >= cfg.eject_min_samples}
            # never eject past the fraction cap, and never the last
            # standing replica
            allowed = min(max(0, len(ready) - 1),
                          int(cfg.eject_max_fraction * len(ready)))
            if len(eligible) >= 2 and len(self._ejected) < allowed:
                vals = sorted(eligible.values())
                med = float(np.median(vals))
                mad = float(np.median([abs(v - med) for v in vals]))
                # MAD floor: an all-identical fleet (MAD 0) must not
                # turn noise into ejections
                scale = max(1.4826 * mad, 0.05 * med, 1.0)
                for n, s in sorted(eligible.items(),
                                   key=lambda kv: -kv[1]):
                    if len(self._ejected) >= allowed:
                        break
                    if (s - med) / scale > cfg.eject_zscore:
                        self._ejected[n] = {
                            "since": now, "ok": 0,
                            "last_probe": 0.0, "probing": False}
                        stats.incr("router.ejections")
            # due canaries (fired outside the lock)
            for n, st in self._ejected.items():
                if st["probing"]:
                    continue
                if now - st["last_probe"] < cfg.canary_interval_s:
                    continue
                st["probing"] = True
                st["last_probe"] = now
                probes.append(n)
        for n in probes:
            threading.Thread(target=self._canary_probe, args=(n,),
                             name=f"canary-{n}", daemon=True).start()

    def _canary_probe(self, name):
        """One canary against an ejected replica: a real 1-token
        generate through the full engine path (a connect-level ping
        would pass right through an `engine_slow` gray failure).
        Healthy = completed within the canary budget AND at a latency
        comparable to the healthy fleet; `readmit_canaries` consecutive
        healthy probes readmit the replica with a fresh health slate."""
        from ..distributed import rpc
        from .fleet import _remote_canary
        cfg = self.cfg
        t0 = time.monotonic()
        ok, lat_ms = False, None
        try:
            res = rpc.rpc_sync(name, _remote_canary, args=(name,),
                               timeout=cfg.canary_timeout_s)
            lat_ms = float(res.get(
                "latency_ms", (time.monotonic() - t0) * 1e3))
            ok = True
        except Exception:                    # noqa: BLE001
            ok = False
        with self._lock:
            st = self._ejected.get(name)
            if st is None:
                return
            st["probing"] = False
            if ok:
                med = self._healthy_median_locked(exclude=name)
                # a 1-token canary is cheaper than a typical request,
                # so "comparable" is generous: 3x the healthy median
                # score (floor 100 ms); with no yardstick, finishing
                # inside the canary budget counts
                limit = max(3.0 * med, 100.0) if med is not None \
                    else cfg.canary_timeout_s * 1e3
                ok = lat_ms <= limit
            if not ok:
                st["ok"] = 0
                return
            st["ok"] += 1
            if st["ok"] >= cfg.readmit_canaries:
                del self._ejected[name]
                self._health[name] = _ReplicaHealth()
                stats.incr("router.readmissions")
