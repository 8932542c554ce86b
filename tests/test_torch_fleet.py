"""The port's router and fleet against the JAX package (tests/
test_fleet.py and test_gray_failure.py, run on the port): `HashRing`
lookups and successors equal to JAX's, the guardian's state machines
(`_ReplicaHealth`, `_Breaker`, `_RetryBudget`) driven by the same event
sequence under an injected clock into JAX's states, the configs'
validation; thread-mode fleets (several `ReplicaServer`s in one process)
for routing and affinity, shedding with ``retry_after_s``, failover and
resubmission, the rpc fault points, drain-aware routing, the anti-flap
rejoin, idempotent submits, hedged dispatch and the guardian's units; and
one process-mode `ServingFleet` of two tiny CPU replicas through
``spawn``: a prefill → decode handoff equal to a single engine, one
cross-process trace a request, a SIGKILL recovered, a role flip."""
import functools
import json
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from paddle_tpu.serving import router as jax_router
from paddle_tpu.serving.fleet import ReplicaConfig as JaxReplicaConfig
from paddle_tpu.serving.router import RouterConfig as JaxRouterConfig
from paddle_tpu_torch.distributed.store import TCPStore
from paddle_tpu_torch.models import LlamaForCausalLM, llama_config
from paddle_tpu_torch.observability import tracing
from paddle_tpu_torch.serving import (Engine, EngineShutdownError, HashRing,
                                      QueueFullError, ReplicaConfig,
                                      ReplicaServer, RequestCancelledError,
                                      RouterConfig, SamplingParams,
                                      ServingConfig, ServingError,
                                      ServingFleet, ServingRouter,
                                      serving_stats)
from paddle_tpu_torch.serving import router as port_router
from paddle_tpu_torch.utils.flags import set_flags

ROOT = Path(__file__).resolve().parents[1]
VOCAB = 512


def _prompts(lens, seed=0, vocab=VOCAB):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (n,)).astype("int32") for n in lens]


def _factory():
    return functools.partial(LlamaForCausalLM,
                             llama_config("tiny", max_seq_len=64),
                             device="cpu", seed=0)


@pytest.fixture(scope="module")
def model():
    return _factory()().eval()


_REFS = {}


def _ref(model, prompt, max_new, sampling=None):
    """The port's single-engine tokens (computed before a fleet starts:
    an engine's start resets the serving families)."""
    key = (prompt.tobytes(), max_new, sampling)
    if key not in _REFS:
        with Engine(model, ServingConfig(num_slots=2)) as eng:
            _REFS[key] = eng.generate(prompt, max_new_tokens=max_new,
                                      sampling=sampling).output_ids
    return _REFS[key]


# ------------------------------------------------------------ parity
@pytest.mark.parametrize("n", [3, 4, 5])
def test_hash_ring_matches_jax(n):
    """64 keys over 3-5 members: the same owner and successor order as
    JAX's ring, every member once, and the same minimal remap when one
    member leaves and comes back."""
    members = {f"replica-{i}" for i in range(n)}
    keys = [f"session-{i}" for i in range(64)] + \
        [np.arange(i, i + 16, dtype=np.int32).tobytes() for i in range(8)]
    rings = (HashRing(virtual_nodes=32), jax_router.HashRing(32))
    for ring in rings:
        ring.rebuild(members)
    owners = {}
    for k in keys:
        succ = list(rings[0].successors(k))
        assert succ == list(rings[1].successors(k))
        assert sorted(succ) == sorted(members)
        assert succ[0] == rings[0].lookup(k) == rings[1].lookup(k)
        owners[k] = succ[0]
    gone = sorted(members)[1]
    for ring in rings:
        ring.rebuild(members - {gone})
    for k in keys:
        assert rings[0].lookup(k) == rings[1].lookup(k)
        if owners[k] != gone:
            assert rings[0].lookup(k) == owners[k]
    rings[0].rebuild(members)
    assert {k: rings[0].lookup(k) for k in keys} == owners


def _guardian_states(mod, events, clock):
    """Drive one package's guardian classes through ``events`` and
    return their state after each event."""
    clock[0] = 0.0
    health, breaker = mod._ReplicaHealth(), mod._Breaker()
    budget = mod._RetryBudget(rate=2.0, burst=3)
    out = []
    for kind, t, a, b in events:
        clock[0] = t
        if kind == "observe":
            health.observe(0.3, a, b)
            res = health.score()
        elif kind == "allow":
            res = breaker.allow(t, 0.5)
        elif kind == "fail":
            res = breaker.on_failure(t, 3, 2.0, 0.5)
        elif kind == "ok":
            res = breaker.on_success()
        else:
            res = budget.take()
        out.append((res, health.ewma_ms, health.err_ewma, health.samples,
                    breaker.state, list(breaker.fail_times),
                    breaker.open_until, budget.tokens))
    return out


def test_guardian_state_machines_match_jax(monkeypatch):
    """A seeded sequence of 400 events (latency observations with and
    without errors, breaker allows, failures and successes, retry-budget
    takes) at injected clock times: the port's states equal JAX's after
    every event."""
    clock = [0.0]
    monkeypatch.setattr(time, "monotonic", lambda: clock[0])
    rng = np.random.default_rng(0)
    t, events = 0.0, []
    for _ in range(400):
        t += float(rng.exponential(0.2))
        kind = ["observe", "allow", "fail", "ok", "take"][
            int(rng.integers(0, 5))]
        events.append((kind, t, float(rng.uniform(1, 300)),
                       bool(rng.random() < 0.3)))
    ours = _guardian_states(port_router, events, clock)
    theirs = _guardian_states(jax_router, events, clock)
    assert ours == theirs
    assert {s[4] for s in ours} == {"closed", "open", "half"}
    assert {s[0] for s in ours if isinstance(s[0], bool)} == {True, False}


def _errors(fn, cases):
    out = []
    for kw in cases:
        try:
            fn(**kw)
            out.append(None)
        except ValueError as e:
            out.append(str(e))
    return out


def test_config_validation_matches_jax():
    router_cases = [dict(heartbeat_ttl_s=0), dict(virtual_nodes=0),
                    dict(health_alpha=0.0), dict(health_alpha=1.5),
                    dict(eject_zscore=0.0), dict(eject_min_samples=0),
                    dict(eject_max_fraction=1.5),
                    dict(hedge_percentile=100.0),
                    dict(hedge_min_samples=0), dict(breaker_failures=-1),
                    dict(retry_budget_per_s=-1.0), dict(readmit_canaries=0),
                    dict(health_ejection=True, hedge_percentile=95.0,
                         breaker_failures=3, retry_budget_per_s=10.0)]
    replica_cases = [dict(heartbeat_interval_s=2.0, heartbeat_ttl_s=1.0),
                     dict(heartbeat_interval_s=0),
                     dict(tensor_parallel_degree=0), dict(dedup_results=0),
                     dict(tensor_parallel_degree=2)]
    for cases, ours, theirs in (
            (router_cases, RouterConfig, JaxRouterConfig),
            (replica_cases, ReplicaConfig, JaxReplicaConfig)):
        got = _errors(lambda **kw: ours(**kw).validate(), cases)
        want = _errors(lambda **kw: theirs(**kw).validate(), cases)
        assert got == want
        assert got[-1] is None


# ------------------------------------------------- thread-mode fleets
_FAST = dict(heartbeat_interval_s=0.15, heartbeat_ttl_s=1.2)


class _Fleet:
    """N ReplicaServers and a router on one TCP store, in this process."""

    def __init__(self, model, names=("rep-0", "rep-1"),
                 serving_config=None, replica_config=None,
                 router_config=None):
        self.master = TCPStore(is_master=True)
        scfg = serving_config or ServingConfig(num_slots=2, max_queue=16)
        rcfg = (replica_config or ReplicaConfig(**_FAST)).validate()
        self.reps = {n: ReplicaServer(
            n, model, TCPStore("127.0.0.1", self.master.port), scfg, rcfg)
            for n in names}
        self.router = ServingRouter(
            TCPStore("127.0.0.1", self.master.port),
            router_config or RouterConfig(
                heartbeat_ttl_s=rcfg.heartbeat_ttl_s,
                poll_interval_s=0.1)).start()
        deadline = time.monotonic() + 30
        while len(self.router.ring.members) < len(names):
            assert time.monotonic() < deadline, \
                f"ring never filled: {self.router.replicas()}"
            time.sleep(0.05)

    def kill(self, name):
        """A SIGKILL of a threaded replica: rpc listener gone, heartbeats
        stopped, engine dead, no deregistration."""
        rep = self.reps[name]
        rep._stop.set()
        rep._beat.join(5.0)
        rep.rpc_server.close()
        rep.engine.shutdown()

    def close(self):
        self.router.close()
        for rep in self.reps.values():
            rep.close()
        self.master.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def test_fleet_greedy_bit_equal_and_affinity(model):
    prompts = _prompts([5, 7, 3, 9, 6])
    refs = [_ref(model, p, 5) for p in prompts]
    with _Fleet(model) as f:
        futs = [f.router.submit(p, max_new_tokens=5, session_id=f"s{i}")
                for i, p in enumerate(prompts)]
        for want, fut in zip(refs, futs):
            out = fut.result(timeout=120)
            np.testing.assert_array_equal(out.output_ids, want)
            assert out.finish_reason == "length"
            assert out.decoded_by in f.reps
        owner = f.router.ring.lookup("sticky")
        with f.reps[owner]._dedup_lock:
            before = len(f.reps[owner]._dedup)
        for fut in [f.router.submit(prompts[0], max_new_tokens=2,
                                    session_id="sticky") for _ in range(3)]:
            fut.result(timeout=120)
        with f.reps[owner]._dedup_lock:
            assert len(f.reps[owner]._dedup) == before + 3
        snap = serving_stats()
        assert snap["router_requests_routed"] == 8
        assert snap["router_replicas_alive"] == 2
        assert snap["router_route_latency_ms_avg"] > 0


def test_router_load_shedding_fails_fast(model):
    """Past capacity every ready replica sheds; the router fails fast
    with `QueueFullError` carrying ``retry_after_s``, and counts it."""
    scfg = ServingConfig(num_slots=1, max_queue=1)
    with _Fleet(model, serving_config=scfg,
                router_config=RouterConfig(
                    heartbeat_ttl_s=1.2, poll_interval_s=0.1,
                    retry_after_s=0.7)) as f:
        shed_before = serving_stats()["router_requests_shed"]
        futs = [f.router.submit(p, max_new_tokens=40, session_id=i)
                for i, p in enumerate(_prompts([6] * 10, seed=3))]
        done, shed = 0, 0
        for fut in futs:
            try:
                assert fut.result(timeout=180).finish_reason in (
                    "length", "eos")
                done += 1
            except QueueFullError as e:
                assert 0.7 <= e.retry_after_s <= 0.7 * 8
                shed += 1
        assert done + shed == 10 and shed >= 1
        assert serving_stats()["router_requests_shed"] - shed_before \
            == shed


def test_failover_replica_death_recovers_request(model):
    p = _prompts([6], seed=5)[0]
    want = _ref(model, p, 5)
    with _Fleet(model) as f:
        owner = f.router.ring.lookup("victim-session")
        f.kill(owner)
        out = f.router.submit(p, max_new_tokens=5,
                              session_id="victim-session").result(
            timeout=120)
        np.testing.assert_array_equal(out.output_ids, want)
        snap = serving_stats()
        assert snap["router_failovers"] >= 1
        assert snap["router_requests_recovered"] >= 1
        deadline = time.monotonic() + 10
        while f.router.replicas().get(owner) != "dead":
            assert time.monotonic() < deadline
            time.sleep(0.05)
        assert f.router.ring.members == {n for n in f.reps if n != owner}


def test_rpc_drop_injection_drills_failover(model):
    p = _prompts([5], seed=7)[0]
    want = _ref(model, p, 4)
    with _Fleet(model) as f:
        owner = f.router.ring.lookup("drilled")
        try:
            set_flags({"FLAGS_fault_inject": f"rpc_drop:to={owner}"})
            out = f.router.submit(p, max_new_tokens=4,
                                  session_id="drilled").result(timeout=120)
            np.testing.assert_array_equal(out.output_ids, want)
            assert serving_stats()["router_failovers"] >= 1
            assert f.router.replicas()[owner] == "dead"
        finally:
            set_flags({"FLAGS_fault_inject": ""})


def test_drain_aware_routing(model):
    """A draining replica leaves the ring within a poll and its queued
    requests are resubmitted to the survivor: none lost."""
    prompts = _prompts([6] * 4, seed=9)
    refs = [_ref(model, p, 30) for p in prompts]
    with _Fleet(model) as f:
        owner = f.router.ring.lookup("drainee")
        survivor = next(n for n in f.reps if n != owner)
        futs = [f.router.submit(p, max_new_tokens=30, session_id="drainee")
                for p in prompts]
        time.sleep(0.2)
        drainer = threading.Thread(target=f.reps[owner].drain,
                                   kwargs={"deadline_s": 30.0})
        drainer.start()
        outs = [fut.result(timeout=180) for fut in futs]
        drainer.join(60)
        assert not drainer.is_alive()
        for want, o in zip(refs, outs):
            np.testing.assert_array_equal(o.output_ids, want)
        deadline = time.monotonic() + 10
        while f.router.ring.members != {survivor}:
            assert time.monotonic() < deadline
            time.sleep(0.05)
        out = f.router.submit(prompts[0], max_new_tokens=2,
                              session_id="drainee").result(timeout=60)
        assert len(out.output_ids) == 2


def test_replica_reap_and_generation_rejoin(model):
    """A replica that misses heartbeats goes sticky-dead and its lease is
    reaped; resumed heartbeats re-register under a bumped generation,
    which the router accepts as an explicit rejoin."""
    with _Fleet(model) as f:
        victim = sorted(f.reps)[0]
        rep = f.reps[victim]
        gen0 = rep.gen
        rep._stop.set()
        rep._beat.join(5.0)
        deadline = time.monotonic() + 15
        while f.router.replicas().get(victim) != "dead":
            assert time.monotonic() < deadline, "never marked dead"
            time.sleep(0.05)
        deadline = time.monotonic() + 10
        while rep.membership.is_registered(victim):
            assert time.monotonic() < deadline, "lease never reaped"
            time.sleep(0.05)
        rep._stop = threading.Event()
        rep._beat = threading.Thread(target=rep._beat_loop, daemon=True)
        rep._beat.start()
        deadline = time.monotonic() + 15
        while victim not in f.router.ring.members:
            assert time.monotonic() < deadline, "never rejoined"
            time.sleep(0.05)
        assert rep.gen > gen0


def test_submit_drain_race_never_strands_a_future(model):
    """submit() hammered from six threads while drain() runs: every
    future resolves, every late submit raises, the audit set drains."""
    eng = Engine(model, ServingConfig(num_slots=2, max_queue=64)).start()
    prompt = _prompts([5], seed=11)[0]
    futures, rejected = [], []
    flock = threading.Lock()
    stop = threading.Event()

    def _hammer():
        while not stop.is_set():
            try:
                fut = eng.submit(prompt, max_new_tokens=3)
                with flock:
                    futures.append(fut)
            except (EngineShutdownError, QueueFullError) as e:
                with flock:
                    rejected.append(e)
                if isinstance(e, EngineShutdownError):
                    return
            time.sleep(0.002)

    threads = [threading.Thread(target=_hammer) for _ in range(6)]
    for t in threads:
        t.start()
    time.sleep(0.4)
    eng.drain(deadline_s=60.0)
    stop.set()
    for t in threads:
        t.join(30)
        assert not t.is_alive()
    assert futures
    assert any(isinstance(e, EngineShutdownError) for e in rejected)
    resolved = 0
    for fut in futures:
        assert fut.done()
        if fut.exception() is None:
            assert fut.result().finish_reason in ("length", "eos")
            resolved += 1
    assert eng._pending == {} and resolved >= 1


def test_replica_handle_submit_idempotent(model):
    """A resubmitted request id re-awaits the SAME engine future: the
    engine decodes once, both calls return identical payloads."""
    master = TCPStore(is_master=True)
    rep = ReplicaServer("solo", model, TCPStore("127.0.0.1", master.port),
                        ServingConfig(num_slots=2, max_queue=8),
                        ReplicaConfig(**_FAST))
    try:
        p = _prompts([6], seed=13)[0]
        a = rep.handle_submit("rid-1", p, 4, {"temperature": 0.0}, None,
                              None)
        before = serving_stats()["requests_submitted"]
        b = rep.handle_submit("rid-1", p, 4, {"temperature": 0.0}, None,
                              None)
        assert serving_stats()["requests_submitted"] == before
        np.testing.assert_array_equal(a["output_ids"], b["output_ids"])
        assert a["decoded_by"] == b["decoded_by"] == "solo"
        sp = {"temperature": 0.8, "top_k": 8}
        c = rep.handle_submit("rid-2", p, 4, sp, None, None)
        d = rep.handle_submit("rid-2", p, 4, sp, None, None)
        np.testing.assert_array_equal(c["output_ids"], d["output_ids"])
        assert rep.handle_cancel("rid-2") == {"cancelled": False,
                                              "replica": "solo"}
        assert rep.handle_canary()["latency_ms"] > 0
    finally:
        rep.close()
        master.close()


def test_router_submit_validation(model):
    with _Fleet(model, names=("rep-0",)) as f:
        with pytest.raises(ValueError, match="empty prompt"):
            f.router.submit(np.zeros((0,), np.int32))
        with pytest.raises(ValueError):
            f.router.submit(_prompts([4])[0],
                            sampling=SamplingParams(temperature=-1))
    with pytest.raises(EngineShutdownError):
        f.router.submit(_prompts([4])[0])


# ----------------------------------------------- the guardian's units
@pytest.fixture()
def bare_router():
    """An unstarted router on a private store: guardian internals are
    driven directly."""
    routers = []

    def factory(**kw):
        master = TCPStore(is_master=True)
        r = ServingRouter(TCPStore("127.0.0.1", master.port),
                          RouterConfig(**kw).validate())
        r._chaos_master = master
        routers.append(r)
        return r
    yield factory
    for r in routers:
        r.close()
        r._chaos_master.close()


def _views(r, names):
    for n in names:
        r._replicas[n] = port_router._ReplicaView(
            {"name": n, "ip": "127.0.0.1", "port": 1, "gen": 0,
             "state": "ready"})


_REQ = type("R", (), {"session_key": "s", "adapter_id": None})()


def test_guardian_off_is_inert(bare_router):
    r = bare_router()
    assert r._guardian is False
    r._observe_attempt("rep-0", 0.5, None)
    r._observe_attempt("rep-0", 0.5, ConnectionError("x"))
    assert not r._health and not r._breakers and not r._lat_ring
    assert r._hedge_threshold_s() is None
    r._guardian_tick()
    assert not r._ejected


def test_observe_attempt_classification(bare_router):
    r = bare_router(health_ejection=True, breaker_failures=3)
    r._observe_attempt("a", 0.1, None)
    assert r._health["a"].samples == 1 and len(r._lat_ring) == 1
    r._observe_attempt("a", 0.2, ConnectionError("snap"))
    assert r._health["a"].samples == 2 and r._health["a"].err_ewma > 0
    assert len(r._breakers["a"].fail_times) == 1
    assert len(r._lat_ring) == 1
    r._observe_attempt("a", 0.3, QueueFullError("full"))
    assert r._health["a"].samples == 2
    r._observe_attempt("a", 2.0, RequestCancelledError("lost race"))
    assert r._health["a"].samples == 3 and r._health["a"].ewma_ms > 100.0
    e = port_router._as_transport_error(ValueError("unknown worker 'x'"))
    assert isinstance(e, ConnectionError)


def test_breaker_blocks_candidates_until_halfopen(bare_router):
    r = bare_router(breaker_failures=2, breaker_window_s=10.0,
                    breaker_cooldown_s=0.2)
    r.ring.rebuild({"a", "b"})
    _views(r, ("a", "b"))
    for _ in range(2):
        r._observe_attempt("a", 0.1, ConnectionError("snap"))
    assert r._breakers["a"].state == "open"
    out, _, blocked = r._candidates(_REQ)
    assert out == ["b"] and blocked == ["a"]
    time.sleep(0.25)
    assert "a" in r._candidates(_REQ)[0]
    assert r._candidates(_REQ)[0] == ["b"]
    r._observe_attempt("a", 0.1, None)
    assert "a" in r._candidates(_REQ)[0]


def test_hedge_threshold_needs_warmup(bare_router):
    r = bare_router(hedge_percentile=95.0, hedge_min_samples=4)
    for _ in range(3):
        r._observe_attempt("a", 0.1, None)
    assert r._hedge_threshold_s() is None
    r._observe_attempt("a", 0.1, None)
    assert r._hedge_threshold_s() == pytest.approx(0.1, rel=0.05)


def test_guardian_ejects_outlier_never_a_uniform_fleet(bare_router):
    r = bare_router(health_ejection=True, eject_zscore=3.0,
                    eject_min_samples=4)
    r.ring.rebuild({"a", "b", "c"})
    for _ in range(6):
        r._observe_attempt("a", 0.10, None)
        r._observe_attempt("b", 0.11, None)
        r._observe_attempt("c", 2.0, None)
    r._guardian_tick()
    assert set(r._ejected) == {"c"}
    assert serving_stats()["router_ejections"] >= 1
    _views(r, ("a", "b", "c"))
    out, _, blocked = r._candidates(_REQ)
    assert set(out) == {"a", "b"} and blocked == ["c"]
    assert "c" in r.ring.members
    u = bare_router(health_ejection=True, eject_min_samples=2)
    u.ring.rebuild({"a", "b", "c"})
    for _ in range(4):
        for n in ("a", "b", "c"):
            u._observe_attempt(n, 0.1, None)
    u._guardian_tick()
    assert not u._ejected


def test_canary_readmission(bare_router, monkeypatch):
    r = bare_router(health_ejection=True, readmit_canaries=2,
                    canary_interval_s=0.01)
    r.ring.rebuild({"a", "b"})
    for _ in range(6):
        r._observe_attempt("a", 0.1, None)
        r._observe_attempt("b", 0.1, None)
    r._ejected["a"] = {"since": 0.0, "ok": 0, "last_probe": 0.0,
                       "probing": False}
    calls = []

    def fake_rpc_sync(name, fn, args=(), timeout=None):
        calls.append(name)
        if len(calls) == 1:
            raise TimeoutError("canary still slow")
        return {"latency_ms": 5.0}

    monkeypatch.setattr("paddle_tpu_torch.distributed.rpc.rpc_sync",
                        fake_rpc_sync)
    r._canary_probe("a")
    assert r._ejected["a"]["ok"] == 0
    r._canary_probe("a")
    assert r._ejected["a"]["ok"] == 1
    r._canary_probe("a")
    assert "a" not in r._ejected
    assert r._health["a"].samples == 0
    assert serving_stats()["router_readmissions"] >= 1


def test_retry_after_hint_and_retry_budget(bare_router):
    r = bare_router(retry_after_s=1.0)
    assert r._retry_after_hint() == pytest.approx(1.0)
    hints = [r._retry_after_hint() for _ in range(10)]
    assert hints[0] > 1.1 and max(hints) <= 8.0 and hints == sorted(hints)
    b = bare_router(retry_budget_per_s=0.001, retry_budget_burst=1)
    reqs = [port_router._RoutedRequest(
        f"rid-{i}", np.array([1], np.int32), 4, SamplingParams().validate(),
        None, None, "s") for i in range(2)]
    assert b._retry_allowed(reqs[0], ConnectionError("x"))
    assert not b._retry_allowed(reqs[1], ConnectionError("x"))
    with pytest.raises(ServingError, match="retry budget exhausted"):
        reqs[1].future.result(timeout=1)
    assert serving_stats()["router_retry_budget_exhausted"] >= 1


def test_hedged_dispatch_first_answer_wins(model):
    """A primary stalled by `engine_slow` past the latency percentile
    fires one hedge under the same request id: the hedge's answer wins,
    the loser is cancelled, both engines return to idle."""
    p = _prompts([6], seed=11)[0]
    want = _ref(model, p, 4)
    kw = dict(hedge_percentile=80.0, hedge_min_samples=4,
              rpc_timeout_s=60.0)
    with _Fleet(model, names=("g-0", "g-1"),
                replica_config=ReplicaConfig(heartbeat_interval_s=0.2,
                                             heartbeat_ttl_s=2.0),
                router_config=RouterConfig(heartbeat_ttl_s=2.0,
                                           poll_interval_s=0.1,
                                           **kw)) as f:
        base = serving_stats()
        for i, q in enumerate(_prompts([5, 6, 7, 5, 6, 7], seed=10)):
            f.router.generate(q, max_new_tokens=4, session_id=f"warm-{i}",
                              timeout=180)
        sid = "hedge-probe"
        primary = next(iter(f.router.ring.successors(sid)))
        set_flags({"FLAGS_fault_inject":
                   f"engine_slow:to={primary},delay_s=1.5,count=40"})
        try:
            t0 = time.monotonic()
            out = f.router.generate(p, max_new_tokens=4, session_id=sid,
                                    timeout=180)
            hedged_latency = time.monotonic() - t0
        finally:
            set_flags({"FLAGS_fault_inject": ""})
        np.testing.assert_array_equal(out.output_ids, want)
        snap = serving_stats()
        assert snap["router_hedges"] > base["router_hedges"]
        assert snap["router_hedge_wins"] > base["router_hedge_wins"]
        assert hedged_latency < 60.0
        assert snap["router_failovers"] == base["router_failovers"]
        deadline = time.monotonic() + 30
        for rep in f.reps.values():
            while rep.engine.cache.pages_in_use or rep.engine._active:
                assert time.monotonic() < deadline, "hedge leaked"
                time.sleep(0.05)


def test_default_config_keeps_guardian_off_in_fleet(model):
    prompts = _prompts([5, 7], seed=12)
    refs = [_ref(model, p, 4) for p in prompts]
    with _Fleet(model, names=("p-0", "p-1")) as f:
        assert f.router._guardian is False
        base = serving_stats()
        for i, (p, want) in enumerate(zip(prompts, refs)):
            out = f.router.generate(p, max_new_tokens=4, session_id=i,
                                    timeout=180)
            np.testing.assert_array_equal(out.output_ids, want)
        snap = serving_stats()
        for k in ("router_ejections", "router_readmissions",
                  "router_hedges", "router_hedge_wins",
                  "router_breaker_open", "router_retry_budget_exhausted"):
            assert snap[k] == base[k], k
        assert not f.router._health and not f.router._breakers


# ------------------------------------------------------- process mode
def test_process_fleet_handoff_traces_kill_and_flip(model, tmp_path,
                                                    monkeypatch):
    """Two tiny CPU replicas (prefill, decode) spawned as processes: the
    router's outputs equal a single engine's, every request decoded by
    the decode replica; `collect_traces` merges the three processes'
    spools into one trace a request (root → prefill → engine.migrate →
    the resumed decode) that passes ``tools/trace_analyze.py --strict``;
    a SIGKILL of the decode replica is recovered by the router; a role
    flip rejoins under a bumped generation."""
    prompts = _prompts([5, 9, 6], seed=14)
    refs = [_ref(model, p, 5) for p in prompts]
    trace_dir = tmp_path / "traces"
    for k, v in (("FLAGS_trace_dir", str(trace_dir)),
                 ("FLAGS_trace_latency_threshold_ms", "0")):
        monkeypatch.setenv(k, v)
    set_flags({"FLAGS_trace_dir": str(trace_dir),
               "FLAGS_trace_latency_threshold_ms": 0.0})
    tracing.reset()
    fleet = ServingFleet(
        _factory(), 2, ServingConfig(num_slots=2),
        ReplicaConfig(heartbeat_interval_s=0.15, heartbeat_ttl_s=1.5),
        RouterConfig(heartbeat_ttl_s=1.5, poll_interval_s=0.1,
                     disaggregation=True),
        roles=["prefill", "decode"])
    try:
        fleet.start(warmup_timeout_s=120)
        futs = [fleet.submit(p, max_new_tokens=5, session_id=i)
                for i, p in enumerate(prompts)]
        for want, fut in zip(refs, futs):
            out = fut.result(timeout=120)
            np.testing.assert_array_equal(out.output_ids, want)
            assert out.decoded_by == "replica-1"
        fleet.collect_traces(out_path=str(tmp_path / "m.json"))
        set_flags({"FLAGS_trace_dir": ""})
        monkeypatch.delenv("FLAGS_trace_dir")
        r = subprocess.run(
            [sys.executable, str(ROOT / "tools" / "trace_analyze.py"),
             "--trace", str(tmp_path / "m.json"),
             "--out", str(tmp_path / "report.json"), "--strict"],
            capture_output=True, text=True, cwd=ROOT)
        assert r.returncode == 0, r.stdout + r.stderr
        traces = json.loads((tmp_path / "m.json").read_text())["traces"]
        assert len(traces) == 3
        for tr in traces:
            recs = tr["spans"]
            assert tr["decision_count"] == 1
            assert {"engine.prefill", "engine.migrate", "engine.decode",
                    "engine.remote_wait"} <= {s["name"] for s in recs}
            assert len({s["proc"] for s in recs}) == 3
            assert any(s["name"] == "engine.request"
                       and s.get("attrs", {}).get("resumed")
                       for s in recs)
        fleet.kill_replica("replica-1")
        fut = fleet.submit(prompts[0], max_new_tokens=5, session_id=0)
        out = fut.result(timeout=120)
        np.testing.assert_array_equal(out.output_ids, refs[0])
        assert out.decoded_by == "replica-0"
        gen0 = fleet.replica_states(detail=True)["replica-0"]["gen"]
        fleet.flip_role("replica-0", "decode", warmup_timeout_s=120)
        info = fleet.replica_states(detail=True)["replica-0"]
        assert info["role"] == "decode" and info["gen"] > gen0
        out = fleet.generate(prompts[1], max_new_tokens=5, session_id=1,
                             timeout=120)
        np.testing.assert_array_equal(out.output_ids, refs[1])
    finally:
        set_flags({"FLAGS_trace_dir": ""})
        tracing.reset()
        fleet.shutdown()

