"""Serving fleet: replicated engines behind the drain-aware router (port
of paddle_tpu/serving/fleet.py).

- `ReplicaServer` hosts ONE `Engine` and its rpc endpoint
  (`distributed.rpc.RpcServer`), heartbeats a TTL lease and gossips its
  load through `distributed/store.py`, answers idempotent
  `_remote_submit` calls (a resubmitted request id re-awaits the SAME
  engine future: at most one decode per replica), and turns SIGTERM into
  publish-``draining`` → `Engine.drain` → deregister;
- `_replica_proc_main` is the entry of each replica process the fleet
  spawns; the model comes from a picklable top-level factory, which
  names the model's device (None is the card: without CUDA it raises,
  and the CPU tests build their models with ``device="cpu"``);
- `ServingFleet` is the local orchestrator: it starts the membership
  `TCPStore`, spawns N replicas (the ``spawn`` context), waits for them
  to join the ring, fronts them with a `ServingRouter`, and supports
  chaos (SIGKILL), graceful scale-down (SIGTERM → drain), scale-up
  (`add_replica`), role flips and trace collection.

Replica lifecycle states gossiped in the ``fleet.{name}`` record:
``warming`` → ``ready`` (routable) → ``draining`` (finishing in-flight
work, refusing new).  Join generations come from an atomic store
counter, so every (re)incarnation of a name is strictly ordered.

Prefill/decode disaggregation: the record carries the replica's
``role`` (`ServingConfig.role`), and the replica hosts the KV-page
migration plane: `_remote_adopt` installs streamed page frames into the
local pool and `_remote_await` relays the resumed request's result;
`_migrate_request` / `_await_migration` are the sending side the engine
calls through its migrator hooks.  A role-specialized replica's drain
migrates its in-flight slots to a survivor (``migrate_on_drain``), and
`ServingFleet.flip_role` rides drain and the bumped-generation rejoin.

``tensor_parallel_degree`` N > 1 serves one replica id from N processes,
one a rank of the replica's own process group, with the hybrid topology
at mp = N and dp = 1 installed before the model factory runs (JAX's
``"mp"`` mesh; `tp_replica`): rank 0 hosts the `ReplicaServer` and
schedules, the other ranks run its calls on their shards in lockstep.
``kill_replica``, ``drain_replica``, ``flip_role`` and ``shutdown`` act
on the whole replica.
"""
from __future__ import annotations

import json
import os
import signal
import threading
import time
from collections import OrderedDict
from concurrent.futures import TimeoutError as FuturesTimeout
from dataclasses import dataclass, field

import numpy as np

from ..distributed.watchdog import DesyncError, PeerFailureError
from ..observability import tracing
from .api import EngineShutdownError, SamplingParams, ServingConfig
from .router import INFO_PREFIX, RouterConfig, ServingRouter


@dataclass
class ReplicaConfig:
    """Per-replica fleet knobs.

    heartbeat_interval_s    lease-stamp + load-gossip cadence
    heartbeat_ttl_s         lease TTL; must exceed the interval with
                            margin (a missed beat must not look dead)
    drain_deadline_s        SIGTERM → how long in-flight slots may
                            finish before the replica exits anyway
    tensor_parallel_degree  >1 shards the replica's model over an "mp"
                            group of that many ranks, one process each
                            (one replica id, one engine, N shards)
    dedup_results           how many request-id → future entries the
                            idempotency cache keeps (resubmits of a
                            known rid re-await instead of re-decoding)
    migrate_on_drain        role-specialized replicas (role != "mixed")
                            stream their in-flight slots' KV pages to a
                            surviving replica on SIGTERM/drain instead
                            of decoding them out — the request resumes
                            with its cache intact, never recomputing
                            the prompt.  Mixed replicas keep the
                            finish-in-place drain
    device                  (keyword-only, the port's) where a tensor
                            parallel replica's ranks run: None is the
                            card (NCCL), "cpu" gloo; the model factory
                            builds on the same device
    """

    heartbeat_interval_s: float = 0.5
    heartbeat_ttl_s: float = 3.0
    drain_deadline_s: float = 20.0
    tensor_parallel_degree: int = 1
    dedup_results: int = 512
    migrate_on_drain: bool = True
    device: str | None = field(default=None, kw_only=True)

    def validate(self):
        if self.heartbeat_interval_s <= 0:
            raise ValueError(f"heartbeat_interval_s must be > 0, got "
                             f"{self.heartbeat_interval_s}")
        if self.heartbeat_ttl_s <= self.heartbeat_interval_s:
            raise ValueError(
                f"heartbeat_ttl_s ({self.heartbeat_ttl_s}) must exceed "
                f"heartbeat_interval_s ({self.heartbeat_interval_s})")
        if self.tensor_parallel_degree < 1:
            raise ValueError(f"tensor_parallel_degree must be >= 1, "
                             f"got {self.tensor_parallel_degree}")
        if self.dedup_results < 1:
            raise ValueError(f"dedup_results must be >= 1, got "
                             f"{self.dedup_results}")
        return self


#: replicas hosted in THIS process (thread-mode tests host several),
#: resolved by the rpc plane's `_remote_submit`
_REPLICAS: dict[str, "ReplicaServer"] = {}


def _remote_submit(replica_name, rid, prompt, max_new_tokens, sampling,
                   eos_token_id, deadline_s, handoff=None,
                   adapter_id=None):
    """The request plane's rpc target: runs inside the replica process
    (one rpc handler thread per router connection, so blocking on the
    engine future is fine)."""
    rep = _REPLICAS.get(replica_name)
    if rep is None:
        raise EngineShutdownError(
            f"replica {replica_name!r} is not hosted in this process "
            f"(hosted: {sorted(_REPLICAS)})")
    return rep.handle_submit(rid, prompt, max_new_tokens, sampling,
                             eos_token_id, deadline_s, handoff=handoff,
                             adapter_id=adapter_id)


def _remote_cancel(replica_name, rid):
    """Hedged-dispatch loser cancellation rpc target: best-effort
    cancel of the engine attempt behind ``rid`` so the losing replica's
    slot/pages/adapter rows return to the pool instead of decoding a
    result nobody will read.  Never raises for an unknown rid — a
    cancel racing completion is the expected case, not an error."""
    rep = _REPLICAS.get(replica_name)
    if rep is None:
        return {"cancelled": False, "replica": replica_name}
    return rep.handle_cancel(rid)


def _remote_canary(replica_name, max_new_tokens=1):
    """Canary-probe rpc target (gray-failure guardian): decode a
    minimal request through the full engine path — admission, prefill,
    one decode step — so an `engine_slow`-class degradation shows up in
    the probe's wall time, which a bare connect ping would never see.
    Returns the probe latency; raises whatever the engine raises."""
    rep = _REPLICAS.get(replica_name)
    if rep is None:
        raise EngineShutdownError(
            f"replica {replica_name!r} is not hosted in this process "
            f"(hosted: {sorted(_REPLICAS)})")
    return rep.handle_canary(max_new_tokens=max_new_tokens)


def _remote_adopt(replica_name, rid, meta, header, *blobs):
    """Migration phase 1 rpc target (decode side): adopt the page
    frames — which arrive as `rpc.Blob` raw frames, never pickle —
    into this replica's pool and queue the resumed request.  Returns
    as soon as the adoption is queued, so the SENDER's pages free
    immediately; the result is fetched by `_remote_await`."""
    rep = _REPLICAS.get(replica_name)
    if rep is None:
        raise EngineShutdownError(
            f"replica {replica_name!r} is not hosted in this process "
            f"(hosted: {sorted(_REPLICAS)})")
    return rep.handle_resume_begin(rid, meta, header, blobs)


def _remote_await(replica_name, rid, timeout_s):
    """Migration phase 2 rpc target (decode side): block for the
    resumed request's completion and return its payload."""
    rep = _REPLICAS.get(replica_name)
    if rep is None:
        raise EngineShutdownError(
            f"replica {replica_name!r} is not hosted in this process "
            f"(hosted: {sorted(_REPLICAS)})")
    return rep.handle_resume_await(rid, timeout_s)


def _remote_spool_traces(replica_name):
    """Trace-collector rpc target: flush this process's span ring to
    its atomic spool file under ``FLAGS_trace_dir`` so the fleet
    collector's merge sees everything recorded so far.  The span ring
    is process-global, so this works regardless of how many replicas
    the process hosts; returns the spool path (None when tracing is
    off or nothing was recorded)."""
    return {"replica": replica_name, "spool": tracing.spool_now()}


def _open_store(spec):
    """("tcp", host, port) | ("file", dir) → TCPStore-shaped client."""
    from ..distributed.store import FileKVStore, TCPStore
    kind = spec[0]
    if kind == "tcp":
        return TCPStore(spec[1], int(spec[2]))
    if kind == "file":
        return FileKVStore(spec[1])
    raise ValueError(f"unknown store spec {spec!r}")


class ReplicaServer:
    """One engine replica: rpc endpoint + membership lease + gossip.

    Thread-mode (tests): construct directly in-process — several can
    coexist.  Process-mode: `_replica_proc_main` builds one per spawned
    process.  `close()` is idempotent."""

    def __init__(self, name, model, store, serving_config=None,
                 config: ReplicaConfig | None = None,
                 warmup_prompt=None, *, mirror=None):
        """``mirror`` (the port's): the `tp_replica.StepMirror` of a
        tensor-parallel replica's leader, whose followers run every
        engine call with it; a lost rank takes the replica down
        (`_die`)."""
        from ..distributed import rpc
        from ..distributed.store import TCPElasticStore
        from .engine import Engine
        self.name = name
        self.cfg = (config or ReplicaConfig()).validate()
        self.store = store
        self.membership = TCPElasticStore(
            store, ttl=self.cfg.heartbeat_ttl_s)
        # store-side atomic counter: strictly ordered join generations
        # across every incarnation of this name (anti-flap rejoins)
        self.gen = int(store.add(f"fleetgen.{name}", 1))
        self._state = "warming"
        self._closed = False
        self._dedup: OrderedDict[str, object] = OrderedDict()
        self._dedup_lock = threading.Lock()
        self._store_lock = threading.Lock()
        self.engine = Engine(model, serving_config)
        if mirror is not None:
            mirror.fatal_hook = self._die
            mirror.attach(self.engine)
        # name the engine for the `engine_slow` gray-failure point (the
        # `to=` filter targets one replica of a thread-mode fleet too)
        self.engine.fault_name = name
        # label this process's trace spans/spool with the replica name
        tracing.set_process_name(name)
        self.engine.start()
        # live KV-page migration: the engine exports/adopts pages; the
        # replica supplies the transport (rpc) + target selection
        self.engine.migrator = self._migrate_request
        self.engine.migration_awaiter = self._await_migration
        self.rpc_server = rpc.RpcServer(name)
        _REPLICAS[name] = self
        self.membership.register(name)
        self._publish()
        self._stop = threading.Event()
        self._beat = threading.Thread(
            target=self._beat_loop, name=f"fleet-beat-{name}",
            daemon=True)
        self._beat.start()
        if warmup_prompt is not None:
            # pay the first-compile cost before joining the ring
            self.engine.generate(warmup_prompt, max_new_tokens=2)
        self.set_state("ready")

    # ---------------- membership ----------------
    def _load(self):
        eng = self.engine
        return {"queue_depth": len(eng._queue),
                "active_slots": len(eng._active),
                "max_queue": eng.scfg.max_queue,
                "num_slots": eng.scfg.num_slots}

    def _publish(self):
        info = {"name": self.name, "ip": self.rpc_server.info.ip,
                "port": self.rpc_server.info.port, "state": self._state,
                "gen": self.gen, "pid": os.getpid(),
                "tp": self.cfg.tensor_parallel_degree,
                "role": self.engine.scfg.role,
                "adapters": self.engine.loaded_adapters(),
                "load": self._load(), "load_ts": time.time()}
        with self._store_lock:
            self.store.set(INFO_PREFIX + self.name, json.dumps(info))

    def set_state(self, state):
        self._state = state
        self._publish()

    def _beat_loop(self):
        while not self._stop.wait(self.cfg.heartbeat_interval_s):
            try:
                if not self.membership.is_registered(self.name):
                    # our lease was reaped (we looked dead): rejoin
                    # EXPLICITLY with a fresh generation instead of
                    # stamping the old key back into existence
                    self.gen = int(self.store.add(
                        f"fleetgen.{self.name}", 1))
                with self._store_lock:
                    self.membership.heartbeat(self.name)
                self._publish()
            except Exception:
                # a flaky store write must not kill the replica; the
                # next beat retries (and the router's TTL covers us)
                pass

    # ---------------- request plane ----------------
    def handle_submit(self, rid, prompt, max_new_tokens, sampling,
                      eos_token_id, deadline_s, handoff=None,
                      adapter_id=None):
        """Idempotent submit: a rid seen before re-awaits the SAME
        engine future (a router resubmission after an ambiguous timeout
        can never make this replica decode — or deliver — twice).
        ``handoff`` names the decode replica this request's KV pages
        should migrate to once its prompt is hot (disaggregation)."""
        from .api import RequestCancelledError
        with self._dedup_lock:
            fut = self._dedup.get(rid)
            if fut is not None and fut.done() and \
                    isinstance(fut.exception(),
                               (EngineShutdownError,
                                RequestCancelledError)):
                # the cached attempt failed without ever delivering
                # (e.g. its migration target died after adopting, or a
                # hedged-dispatch loser was cancelled): a resubmission
                # under the same rid deserves a FRESH attempt —
                # re-awaiting the corpse would bounce the request until
                # its resubmit budget ran out
                fut = None
            if fut is None:
                fut = self.engine.submit(
                    prompt, max_new_tokens=max_new_tokens,
                    sampling=SamplingParams(**(sampling or {})),
                    eos_token_id=eos_token_id, deadline_s=deadline_s,
                    handoff=handoff, adapter_id=adapter_id)
                self._dedup[rid] = fut
                while len(self._dedup) > self.cfg.dedup_results:
                    self._dedup.popitem(last=False)
        timeout = deadline_s if deadline_s is not None \
            else self.engine.scfg.request_timeout_s
        try:
            out = fut.result(timeout=timeout + 1.0)
        except FuturesTimeout:
            # normalize (on py<3.11 futures.TimeoutError is NOT the
            # builtin): the engine missed the deadline without evicting
            # (deadline_policy="ignore") — surface the serving error
            from .api import DeadlineExceededError
            raise DeadlineExceededError(
                f"request {rid} exceeded its {timeout:.1f}s budget on "
                f"replica {self.name}") from None
        return {"request_id": rid, "replica": self.name,
                "output_ids": np.asarray(out.output_ids, np.int32),
                "finish_reason": out.finish_reason,
                "ttft_ms": out.ttft_ms, "latency_ms": out.latency_ms,
                "decoded_by": out.decoded_by or self.name}

    def handle_cancel(self, rid):
        """Best-effort cancel of the engine attempt behind ``rid``
        (hedged-dispatch loser, chaos drills).  The dedup cache keeps
        its entry: a late resubmission of the rid finds a future done
        with `RequestCancelledError` and takes a fresh attempt (see
        `handle_submit`)."""
        with self._dedup_lock:
            fut = self._dedup.get(rid)
        if fut is None or fut.done():
            return {"cancelled": False, "replica": self.name}
        eid = getattr(fut, "request_id", None)
        ok = self.engine.cancel(eid) if eid is not None else False
        return {"cancelled": bool(ok), "replica": self.name}

    def handle_canary(self, max_new_tokens=1):
        """Serve one minimal probe request through the full engine path
        and return its wall time — the guardian's readmission signal
        for an ejected replica.  A degraded engine (`engine_slow`, a
        wedged host) inflates the latency; a draining/stopped one
        raises."""
        t0 = time.monotonic()
        self.engine.generate(np.asarray([1], np.int32),
                             max_new_tokens=max(1, int(max_new_tokens)))
        return {"replica": self.name,
                "latency_ms": (time.monotonic() - t0) * 1e3}

    # ---------------- migration plane ----------------
    def handle_resume_begin(self, rid, meta, header, blobs):
        """Adopt a migrated request (idempotent under the sender-scoped
        rid, sharing the submit dedup cache): install its page frames
        into the pool and queue decoding from its prior tokens.
        Returns the ack the sender's `_remote_await` call echoes back —
        from this moment the SENDER's copy of the pages is dead
        weight."""
        from . import migration
        with self._dedup_lock:
            fut = self._dedup.get(rid)
            if fut is None:
                pages = migration.unpack(header, *blobs)
                # the sender's transfer-span context rides the meta
                # dict (the Blob raw frames never carry it): bind it so
                # the resumed request's spans stay on the SAME trace,
                # parented under the transfer hop
                with tracing.bind_wire(meta.get("trace")):
                    fut = self.engine.submit_resume(
                        meta["prompt"], meta["tokens"], pages,
                        max_new_tokens=meta["max_new_tokens"],
                        sampling=SamplingParams(
                            **(meta["sampling"] or {})),
                        eos_token_id=meta["eos_token_id"],
                        deadline_s=meta["deadline_s"],
                        ttft_ms=meta["ttft_ms"])
                self._dedup[rid] = fut
                while len(self._dedup) > self.cfg.dedup_results:
                    self._dedup.popitem(last=False)
        return {"rid": rid, "replica": self.name}

    def handle_resume_await(self, rid, timeout_s):
        """Block for a previously adopted request's completion."""
        with self._dedup_lock:
            fut = self._dedup.get(rid)
        if fut is None:
            raise EngineShutdownError(
                f"replica {self.name} holds no migrated request {rid!r}"
                " (evicted from the dedup cache or never adopted)")
        out = fut.result(timeout=timeout_s)
        return {"request_id": rid, "replica": self.name,
                "output_ids": np.asarray(out.output_ids, np.int32),
                "finish_reason": out.finish_reason,
                "ttft_ms": out.ttft_ms, "latency_ms": out.latency_ms,
                "decoded_by": out.decoded_by or self.name}

    def _migration_meta(self, req):
        tr = getattr(req, "trace", None)
        return {"prompt": req.prompt, "tokens": list(req.tokens),
                "trace": tr.transfer.ctx.wire()
                if tr is not None and tr.transfer is not None else None,
                "max_new_tokens": req.max_new_tokens,
                "sampling": {"temperature": req.sampling.temperature,
                             "top_k": req.sampling.top_k,
                             "top_p": req.sampling.top_p,
                             "repetition_penalty":
                                 req.sampling.repetition_penalty,
                             "seed": req.sampling.seed},
                "eos_token_id": req.eos_token_id,
                "deadline_s": (req.deadline - time.monotonic())
                if req.deadline is not None else None,
                "ttft_ms": req.ttft_ms}

    def _migrate_request(self, req, header, blobs, target):
        """The engine's migrator hook (phase 1): ship one request's
        pages to `target` (router-assigned) or — drain-time, target
        None — to a survivor picked from the fleet gossip.  Returns
        once the target adopted; raises on any failure and the engine
        falls back to decoding locally."""
        from ..distributed import rpc
        from .api import NoReplicaError
        if target is None:
            target = self._pick_peer()
        if target is None:
            raise NoReplicaError(
                f"replica {self.name}: no ready peer to migrate "
                f"request {req.id} to")
        rpc.connect_worker(target["name"], target["ip"], target["port"])
        meta = self._migration_meta(req)
        rid = f"mig-{self.name}-{self.gen}-{req.id}"
        ack = rpc.rpc_sync(
            target["name"], _remote_adopt,
            args=(target["name"], rid, meta, header) + tuple(blobs),
            timeout=30.0)
        ack["target"] = dict(target)
        ack["deadline_s"] = meta["deadline_s"]
        return ack

    def _await_migration(self, req, ack):
        """The engine's awaiter hook (phase 2): relay the remote
        result, holding nothing locally while the decode replica
        works."""
        from ..distributed import rpc
        timeout = ack["deadline_s"] if ack["deadline_s"] is not None \
            else self.engine.scfg.request_timeout_s
        return rpc.rpc_sync(
            ack["target"]["name"], _remote_await,
            args=(ack["target"]["name"], ack["rid"], timeout + 1.0),
            timeout=timeout + 2.0)

    def _pick_peer(self):
        """Drain-time migration target from the fleet gossip: a ready
        peer, decode-role first, then mixed, then prefill; least loaded
        within a class.  None when this replica is alone."""
        rank = {"decode": 0, "mixed": 1, "prefill": 2}
        best = None
        with self._store_lock:
            records = self.store.list_prefix(INFO_PREFIX)
        for key, val in records.items():
            try:
                info = json.loads(val.decode())
            except ValueError:
                continue
            if info.get("name") == self.name or \
                    info.get("state") != "ready":
                continue
            load = info.get("load") or {}
            score = (rank.get(info.get("role", "mixed"), 1),
                     load.get("queue_depth", 0)
                     + load.get("active_slots", 0), info["name"])
            if best is None or score < best[0]:
                best = (score, info)
        if best is None:
            return None
        info = best[1]
        return {"name": info["name"], "ip": info.get("ip", "127.0.0.1"),
                "port": int(info.get("port", 0))}

    # ---------------- lifecycle ----------------
    def drain(self, deadline_s=None):
        """The SIGTERM path: advertise `draining` (the router stops
        routing here within a poll), let in-flight slots finish inside
        the deadline — role-specialized replicas instead MIGRATE them
        to a survivor with their KV pages intact (migrate_on_drain) —
        fail whatever is still queued, then leave the ring."""
        try:
            self.set_state("draining")
        except Exception:
            pass
        migrate = self.cfg.migrate_on_drain and \
            self.engine.scfg.role != "mixed"
        self.engine.drain(deadline_s if deadline_s is not None
                          else self.cfg.drain_deadline_s,
                          migrate=migrate)
        self.close()

    def close(self):
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        self._beat.join(5.0)
        try:
            with self._store_lock:
                self.membership.deregister(self.name)
                self.store.delete_key(INFO_PREFIX + self.name)
        except Exception:
            pass
        self.engine.shutdown()
        if self.engine.mirror is not None:
            self.engine.mirror.stop()
        self.rpc_server.close()
        if _REPLICAS.get(self.name) is self:
            del _REPLICAS[self.name]

    def _die(self, exc):
        """A tensor-parallel replica lost a rank (or its lockstep): leave
        the ring at once and exit, as a SIGKILLed replica would; the
        router resubmits the in-flight requests elsewhere."""
        import sys

        from ..distributed.watchdog import ELASTIC_EXIT_CODE
        sys.stderr.write(f"[fleet] replica {self.name} goes down: "
                         f"{type(exc).__name__}: {exc}\n")
        sys.stderr.flush()
        self._stop.set()
        try:
            self.membership.deregister(self.name)
            self.store.delete_key(INFO_PREFIX + self.name)
        except Exception:
            pass
        os._exit(ELASTIC_EXIT_CODE)


def _replica_proc_main(name, store_spec, serving_config, replica_config,
                       model_factory, warmup_prompt=None, *, tp_rank=0,
                       tp_init=None):
    """Subprocess entry: host one replica until SIGTERM (drain) or the
    parent kills us.  `model_factory` must be a picklable top-level
    callable (a ``functools.partial`` of a model class with its config,
    device and seed, say); it builds the model on its device, and runs
    after a tensor-parallel replica's topology is installed, so a
    parallel model finds its mp group.  ``tp_rank`` and ``tp_init``
    (``(init_method, key)``) place a tensor-parallel replica's rank; a
    rank above 0 runs the follower loop (`_follower_main`)."""
    stop = {"mode": None}
    evt = threading.Event()

    def _sigterm(signum, frame):
        stop["mode"] = "drain"
        evt.set()

    cfg = (replica_config or ReplicaConfig()).validate()
    ctx = None
    if cfg.tensor_parallel_degree > 1:
        from . import tp_replica
        ctx = tp_replica.init_ranks(cfg.tensor_parallel_degree, tp_rank,
                                    tp_init[0], tp_init[1], cfg.device)
    if tp_rank > 0:
        # a follower leaves with its leader, never on its own SIGTERM
        signal.signal(signal.SIGTERM, signal.SIG_IGN)
        _follower_main(ctx, store_spec, serving_config, cfg, model_factory)
    signal.signal(signal.SIGTERM, _sigterm)
    store = _open_store(store_spec)
    mirror = None
    if ctx is not None:
        mirror = tp_replica.StepMirror(ctx)
        tp_replica.start_beat(
            ctx, _open_store(store_spec), cfg.heartbeat_interval_s,
            cfg.heartbeat_ttl_s, lambda r, age: mirror.fatal(
                PeerFailureError(f"rank {r} of replica {name} stopped "
                                 f"beating {age:.1f} s ago", rank=r)))
    model = model_factory()
    rep = ReplicaServer(name, model, store, serving_config, cfg,
                        warmup_prompt=warmup_prompt, mirror=mirror)
    try:
        while not evt.wait(0.25):
            pass
        if stop["mode"] == "drain":
            rep.drain()
        else:
            rep.close()
    finally:
        try:
            store.close()
        except Exception:
            pass
    # daemon rpc/scheduler threads may linger; exit deliberately
    os._exit(0)


def _follower_main(ctx, store_spec, serving_config, cfg, model_factory):
    """A tensor-parallel replica's rank above 0: build the model's shard,
    run the leader's calls until it stops (exit 0), goes (its channel
    closes or its beat goes stale: exit 101), or this rank diverges
    (`DesyncError`, exit 1)."""
    import sys
    import traceback

    from ..distributed.watchdog import ELASTIC_EXIT_CODE
    from . import tp_replica

    def _lost(rank, age):
        sys.stderr.write(f"[fleet] tp rank {ctx.rank}: the leader stopped "
                         f"beating {age:.1f} s ago\n")
        sys.stderr.flush()
        os._exit(ELASTIC_EXIT_CODE)
    held = {}
    tp_replica.start_beat(ctx, _open_store(store_spec),
                          cfg.heartbeat_interval_s, cfg.heartbeat_ttl_s,
                          _lost, lambda: tp_replica.follower_stats(
                              held.get("follower")))
    code = 0
    try:
        held["follower"] = tp_replica.StepFollower(ctx, model_factory(),
                                                   serving_config)
        held["follower"].run()
    except DesyncError:
        traceback.print_exc()
        code = 1
    except BaseException:                # noqa: BLE001 - the leader is gone
        traceback.print_exc()
        code = ELASTIC_EXIT_CODE
    ctx.beat.stop()
    sys.stderr.flush()
    os._exit(code)


class ServingFleet:
    """Local multi-process fleet: membership store + N replica
    processes + router, one object.  The chaos bench and CI drive this;
    deployments across hosts run `ReplicaServer`s on their own hosts
    against a shared TCPStore endpoint and a standalone
    `ServingRouter`."""

    def __init__(self, model_factory, num_replicas=2,
                 serving_config: ServingConfig | None = None,
                 replica_config: ReplicaConfig | None = None,
                 router_config: RouterConfig | None = None,
                 warmup_prompt=None, name_prefix="replica",
                 roles=None, *, replica_configs=None):
        """``replica_configs`` (the port's): a `ReplicaConfig` a replica,
        positional like ``roles`` (a tp 1 prefill replica beside a tp 2
        decode replica, say); None gives each ``replica_config``."""
        self.model_factory = model_factory
        self.num_replicas = int(num_replicas)
        self.scfg = serving_config
        self.rcfg = (replica_config or ReplicaConfig()).validate()
        self.router_cfg = router_config or RouterConfig(
            heartbeat_ttl_s=self.rcfg.heartbeat_ttl_s)
        self.warmup_prompt = warmup_prompt
        self.name_prefix = name_prefix
        #: per-replica role, positional (disaggregated fleets spawn
        #: asymmetric: e.g. roles=["prefill", "decode"]); None = every
        #: replica "mixed" (byte-identical to the symmetric fleet)
        self.roles = list(roles) if roles is not None else None
        if self.roles is not None and \
                len(self.roles) != self.num_replicas:
            raise ValueError(
                f"{len(self.roles)} roles for {self.num_replicas} "
                "replicas")
        self.rcfgs = [c.validate() for c in replica_configs] \
            if replica_configs is not None else None
        if self.rcfgs is not None and \
                len(self.rcfgs) != self.num_replicas:
            raise ValueError(
                f"{len(self.rcfgs)} replica configs for "
                f"{self.num_replicas} replicas")
        self.router: ServingRouter | None = None
        self._store = None
        #: name -> the replica's process (its leader, rank 0)
        self._procs: dict[str, object] = {}
        #: name -> every process of the replica (tensor parallel: a rank
        #: each, the leader first)
        self._ranks: dict[str, list] = {}
        self._rcfg_of: dict[str, ReplicaConfig] = {}
        self._configs: dict[str, ServingConfig | None] = {}
        self._next_idx = 0
        self._ctx = None

    def _role_config(self, role, serving_config=None):
        """The ServingConfig a replica of `role` runs: an explicit
        per-replica config wins; otherwise the fleet default with the
        role stamped in."""
        import dataclasses
        cfg = serving_config if serving_config is not None else self.scfg
        if role is None:
            return cfg
        cfg = cfg if cfg is not None else ServingConfig()
        return dataclasses.replace(cfg, role=role)

    # ---------------- lifecycle ----------------
    def start(self, warmup_timeout_s=300.0):
        import multiprocessing as mp

        from ..distributed.store import TCPStore
        self._store = TCPStore(is_master=True)
        self._store_spec = ("tcp", "127.0.0.1", self._store.port)
        self._ctx = mp.get_context("spawn")
        for i in range(self.num_replicas):
            self._spawn(role=self.roles[i] if self.roles else None,
                        replica_config=self.rcfgs[i] if self.rcfgs
                        else None)
        self.wait_ready(self.num_replicas, timeout=warmup_timeout_s)
        self.router = ServingRouter(self._store,
                                    self.router_cfg).start()
        return self

    def _spawn(self, role=None, serving_config=None, name=None, *,
               replica_config=None):
        if name is None:
            name = f"{self.name_prefix}-{self._next_idx}"
            self._next_idx += 1
        scfg = self._role_config(role, serving_config)
        self._configs[name] = scfg
        rcfg = (replica_config or self._rcfg_of.get(name)
                or self.rcfg).validate()
        self._rcfg_of[name] = rcfg
        tp = rcfg.tensor_parallel_degree
        tp_init = None
        if tp > 1:
            # the replica's own process group: a rendezvous port and a
            # beat key of this incarnation
            import socket
            import uuid
            with socket.socket() as sock:
                sock.bind(("127.0.0.1", 0))
                port = sock.getsockname()[1]
            tp_init = (f"tcp://127.0.0.1:{port}",
                       f"{name}-{uuid.uuid4().hex[:12]}")
        ranks = []
        for r in range(tp):
            p = self._ctx.Process(
                target=_replica_proc_main,
                args=(name, self._store_spec, scfg, rcfg,
                      self.model_factory, self.warmup_prompt),
                kwargs={"tp_rank": r, "tp_init": tp_init},
                name=name if r == 0 else f"{name}-rank{r}")
            p.start()
            ranks.append(p)
        self._procs[name] = ranks[0]
        self._ranks[name] = ranks
        return name

    def wait_ready(self, n, timeout=300.0):
        """Block until >= n replicas gossip `ready` with a live lease."""
        deadline = time.time() + timeout
        while True:
            ready = [name for name, state in self.replica_states().items()
                     if state == "ready"]
            if len(ready) >= n:
                return ready
            for name, ranks in self._ranks.items():
                for p in ranks:
                    if p.exitcode not in (None, 0):
                        raise RuntimeError(
                            f"replica {name} died during warmup "
                            f"({p.name} exitcode {p.exitcode})")
            if time.time() > deadline:
                raise TimeoutError(
                    f"only {len(ready)}/{n} replicas ready within "
                    f"{timeout}s: {self.replica_states()}")
            time.sleep(0.2)

    def replica_states(self, detail=False):
        """{name: state} snapshot from the gossip, or — ``detail=True``
        — {name: {"state", "role", "gen", "pid", "tp"}} so asymmetric-
        fleet tests and the disagg bench can assert role assignment and
        each replica's tensor-parallel degree directly."""
        out = {}
        for key, val in self._store.list_prefix(INFO_PREFIX).items():
            try:
                info = json.loads(val.decode())
                if detail:
                    out[info["name"]] = {
                        "state": info.get("state", "?"),
                        "role": info.get("role", "mixed"),
                        "gen": info.get("gen", 0),
                        "pid": info.get("pid"),
                        "tp": info.get("tp", 1)}
                else:
                    out[info["name"]] = info.get("state", "?")
            except (ValueError, KeyError):
                continue
        return out

    # ---------------- client passthrough ----------------
    def submit(self, *args, **kwargs):
        return self.router.submit(*args, **kwargs)

    def generate(self, *args, **kwargs):
        return self.router.generate(*args, **kwargs)

    def generate_with_retry(self, *args, shed_retries=8, timeout=None,
                            **kwargs):
        """Sync generate that honors shed backpressure: when the fleet
        sheds (`QueueFullError`), sleep the router-suggested
        ``retry_after_s`` — scaled by current shed pressure on the
        router side — and resubmit, instead of hot-spinning the
        admission path.  Re-raises the last `QueueFullError` after
        ``shed_retries`` resubmissions."""
        from .api import QueueFullError
        attempt = 0
        while True:
            try:
                return self.router.generate(*args, timeout=timeout,
                                            **kwargs)
            except QueueFullError as e:
                attempt += 1
                if attempt > shed_retries:
                    raise
                time.sleep(e.retry_after_s if e.retry_after_s
                           else self.router.cfg.retry_after_s)

    def stats(self):
        return self.router.stats()

    # ---------------- distributed tracing ----------------
    def collect_traces(self, out_path=None, chrome_path=None,
                       timeout_s=10.0):
        """Fleet trace collector: ask every live replica process to
        flush its span ring to its atomic spool file, flush this
        (router/client) process too, then merge every spool under
        ``FLAGS_trace_dir`` into one document (optionally written as
        JSON and/or exported as Perfetto-loadable chrome-trace JSON).
        Best-effort by design: a dead or unreachable replica
        contributes whatever it last spooled — engines also spool on
        shutdown and every 64 tail-sampling decisions, so even a
        SIGKILLed replica usually left most of its spans behind, and a
        trace missing its tail is itself the post-mortem signal.
        Returns the merged document, or None with tracing off."""
        if not tracing.enabled():
            return None
        from ..distributed import rpc
        for name, p in list(self._procs.items()):
            if not p.is_alive():
                continue
            try:
                rpc.rpc_sync(name, _remote_spool_traces, args=(name,),
                             timeout=timeout_s)
            except Exception:
                continue        # merge picks up its last on-disk spool
        tracing.spool_now()
        merged = tracing.merge_spools()
        if out_path:
            tracing.write_merged(merged, out_path)
        if chrome_path:
            tracing.export_chrome(merged, chrome_path)
        return merged

    # ---------------- chaos / elasticity ----------------
    def kill_replica(self, name, sig=signal.SIGKILL, *, rank=None):
        """SIGKILL (default) = chaos: no drain, no deregistration — the
        router must detect the death itself.  A tensor-parallel replica
        is killed whole; ``rank`` (the port's) signals that rank alone
        (a lost follower takes its replica down).  SIGTERM goes to the
        leader, which drains and then releases its followers.  Returns
        the pid signalled (the leader's for the whole replica)."""
        ranks = self._ranks[name]
        if rank is not None:
            targets = [ranks[rank]]
        elif sig == signal.SIGTERM:
            targets = ranks[:1]
        else:
            targets = ranks
        for p in targets:
            try:
                os.kill(p.pid, sig)
            except ProcessLookupError:
                pass
        return targets[0].pid

    def drain_replica(self, name):
        """SIGTERM = graceful scale-down: the replica drains and leaves
        the ring before the deadline."""
        return self.kill_replica(name, sig=signal.SIGTERM)

    def add_replica(self, role=None, serving_config=None, name=None, *,
                    replica_config=None):
        """Scale up: spawn a fresh replica; it registers, warms, and
        the router's watcher rings it in.  ``role`` stamps a
        disaggregation role onto the fleet's serving config (or pass a
        full per-replica ``serving_config``) so chaos tests and the
        bench can build asymmetric fleets directly; ``replica_config``
        (the port's) gives it its own `ReplicaConfig` (its
        tensor-parallel degree, say)."""
        return self._spawn(role=role, serving_config=serving_config,
                           name=name, replica_config=replica_config)

    def flip_role(self, name, role, serving_config=None,
                  warmup_timeout_s=300.0):
        """Mid-load role flip: SIGTERM-drain `name` (its in-flight
        requests migrate to survivors or finish; its queue bounces back
        to the router for resubmission), wait for the process to exit,
        then respawn the SAME name with the new role — the store's
        generation counter bumps, so the router admits the rejoin
        through its anti-flap protocol.  Zero requests are lost
        across the flip."""
        ranks = self._ranks[name]
        self.drain_replica(name)
        for proc in ranks:
            proc.join(self._rcfg_of[name].drain_deadline_s + 30)
            if proc.is_alive():               # pragma: no cover
                raise RuntimeError(
                    f"replica {name} ({proc.name}) did not exit within the "
                    "drain deadline; refusing to respawn its name")
        self._spawn(role=role, serving_config=serving_config, name=name)
        deadline = time.time() + warmup_timeout_s
        while True:
            states = self.replica_states(detail=True)
            info = states.get(name)
            if info and info["state"] == "ready" \
                    and info["role"] == role:
                return name
            p = self._procs[name]
            if p.exitcode not in (None, 0):
                raise RuntimeError(
                    f"replica {name} died during role flip "
                    f"(exitcode {p.exitcode})")
            if time.time() > deadline:
                raise TimeoutError(
                    f"replica {name} never came back ready as "
                    f"{role!r}: {states.get(name)}")
            time.sleep(0.2)

    def shutdown(self, timeout=30.0):
        if self.router is not None:
            self.router.close()
            self.router = None
        for name, p in self._procs.items():
            if p.is_alive():
                try:
                    os.kill(p.pid, signal.SIGTERM)
                except ProcessLookupError:
                    pass
        every = [p for ranks in self._ranks.values() for p in ranks]
        deadline = time.time() + timeout
        for p in every:
            p.join(max(0.1, deadline - time.time()))
        for p in every:
            if p.is_alive():                 # pragma: no cover
                os.kill(p.pid, signal.SIGKILL)
                p.join(5.0)
        self._procs.clear()
        self._ranks.clear()
        if self._store is not None:
            self._store.close()
            self._store = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.shutdown()
