"""Serving observability (port of paddle_tpu/serving/stats.py): queue
depth, TTFT, per-token latency, slot occupancy, throughput, and the
compiled tick's, the adapter pool's, speculation's, resilience's and
tracing's families.

The engine publishes through `utils.monitor` under the ``serving.``
prefix, into the process's one metrics registry
(`observability.registry`), so every family reaches
``render_prometheus()``, the exporter's snapshots and
``tools/check_telemetry.py``; histograms keep their bucket counts, not
their observations.  `Engine.start` resets the families and declares
them at 0; `serving_stats()` derives the dashboard quantities at read
time.  Engines in one process share the families, as in JAX.  The
router's families (``serving.router.*``: `route_observe`,
`health_observe`, `declare_router_stats`, `reset_router_stats`) reset
only with the router, and the migration families (``serving.migration.*``)
are fed by the engines' KV-page handoffs.
"""
from __future__ import annotations

from ..utils import monitor

PREFIX = "serving."
ROUTER_PREFIX = PREFIX + "router."


def incr(name, value=1):
    return monitor.incr(PREFIX + name, value)


def request_observe(name, request_id, value, help=""):  # noqa: A002
    """Per-request labeled series ``serving.<name>{request_id=...}`` —
    the same monotonically increasing id the engine's request span
    carries (``rid``), so one request's trace and metrics join on it.  Cardinality is bounded TWICE:
    ``reset_serving_stats()`` clears the families at engine start, and
    within one engine run the family is LRU-rotated to at most
    ``FLAGS_serving_request_label_cap`` children (the oldest request's
    series is dropped when a new request would exceed the cap), so a
    long-lived engine's registry converges instead of growing one child
    per request forever."""
    from ..observability import registry as _registry
    from ..utils.flags import flag as _flag
    cap = int(_flag("FLAGS_serving_request_label_cap", 1024) or 0)
    _registry.counter(PREFIX + name, help,
                      labelnames=("request_id",)) \
        .labels_lru(cap, request_id=str(request_id)).inc(value)


def set_value(name, value):
    monitor.set_value(PREFIX + name, value)


def observe(name, value):
    monitor.observe(PREFIX + name, value)


def route_observe(replica, role="mixed"):
    """One routed request: the per-replica labeled counter
    ``serving.router.requests_routed{replica=...}``, the per-role
    ``serving.router.requests_routed_role{role=...}`` disaggregation
    view, plus the flat total the snapshot reads."""
    from ..observability import registry as _registry
    _registry.counter(ROUTER_PREFIX + "requests_routed",
                      "requests routed per replica",
                      labelnames=("replica",)) \
        .labels(replica=str(replica)).inc()
    _registry.counter(ROUTER_PREFIX + "requests_routed_role",
                      "requests routed per replica role",
                      labelnames=("role",)) \
        .labels(role=str(role or "mixed")).inc()
    monitor.incr(ROUTER_PREFIX + "requests_routed_total")


def health_observe(replica, score):
    """Publish one replica's current health score (EWMA-latency-based,
    error-inflated — serving/router.py `_ReplicaHealth`) as the
    ``serving.router.replica_health_score{replica=...}`` gauge the
    gray-failure dashboard plots against the ejection threshold."""
    from ..observability import registry as _registry
    _registry.gauge(ROUTER_PREFIX + "replica_health_score",
                    "per-replica health score (EWMA latency ms, "
                    "error-inflated); outliers vs the fleet median "
                    "are ejected",
                    labelnames=("replica",)) \
        .labels(replica=str(replica)).set(float(score))


def reset_serving_stats():
    """Clear every ``serving.*`` counter EXCEPT the router's (engine
    start does this so each engine run's snapshot is self-contained;
    the router outlives engine restarts across the fleet, so its
    counters reset only with the router: `reset_router_stats`)."""
    for key in monitor.all_stats():
        if key.startswith(PREFIX) and not key.startswith(ROUTER_PREFIX):
            monitor.reset(key)


def declare_tick_stats():
    """Get-or-create the compiled-tick metric families at engine start
    so the Prometheus exposition carries the full tick schema before
    the first iteration — a dashboard must see ``tick_fallbacks`` at 0,
    not a missing series, on an engine that never fell back
    (tools/check_telemetry.py --serving-tick gates on exactly this)."""
    from ..observability import registry as _registry
    _registry.counter(PREFIX + "tick.compiled_hits",
                      "scheduler iterations run as ONE compiled tick "
                      "program")
    _registry.counter(PREFIX + "tick.fallbacks",
                      "scheduler iterations that latched the "
                      "uncompiled fallback")
    _registry.histogram(PREFIX + "tick_ms",
                        "wall time of one scheduler iteration (ms)")


def declare_migration_stats():
    """Get-or-create the KV-page-migration metric families at engine
    start so the Prometheus exposition carries the full disaggregation
    schema before the first transfer — a dashboard must see
    ``migrations`` at 0, not a missing series, on a replica that never
    migrated (tools/check_telemetry.py --migration gates on this)."""
    from ..observability import registry as _registry
    _registry.counter(PREFIX + "migration.pages_sent",
                      "KV pages exported to another replica")
    _registry.counter(PREFIX + "migration.pages_received",
                      "KV pages adopted from another replica")
    _registry.counter(PREFIX + "migration.migrations",
                      "requests whose decode was handed off and "
                      "completed remotely")
    _registry.counter(PREFIX + "migration.resumed_requests",
                      "migrated requests resumed from adopted pages "
                      "on this replica")
    _registry.counter(PREFIX + "migration.fallbacks",
                      "failed transfers that fell back to decoding "
                      "locally (dead target, pool full, timeout)")
    _registry.counter(PREFIX + "migration.remote_failures",
                      "targets that died AFTER adopting pages; the "
                      "request was failed for router resubmission")
    _registry.histogram(PREFIX + "migration.migrate_ms",
                        "wall time of one page transfer + remote "
                        "resume handshake (ms)")


def declare_adapter_stats():
    """Get-or-create the multi-tenant LoRA metric families at engine
    start so the Prometheus exposition carries the full adapter schema
    before the first hot-load — a dashboard must see
    ``adapter_evictions`` at 0, not a missing series, on an engine that
    never evicted (tools/check_telemetry.py --lora gates on this)."""
    from ..observability import registry as _registry
    _registry.counter(PREFIX + "adapter.adapters_loaded",
                      "adapters hot-loaded into pool slots")
    _registry.counter(PREFIX + "adapter.adapter_evictions",
                      "LRU evictions of idle adapters from pool slots")
    _registry.counter(PREFIX + "adapter.requests_routed_adapter_total",
                      "requests admitted carrying any adapter_id")
    _registry.counter(PREFIX + "adapter.requests_routed_adapter",
                      "requests admitted per adapter",
                      labelnames=("adapter",))
    _registry.histogram(PREFIX + "adapter.adapter_load_ms",
                        "wall time of one adapter hot-load into its "
                        "pool slot (ms)")


def declare_trace_stats():
    """Get-or-create the distributed-tracing metric families at router/
    engine start so the Prometheus exposition carries the full tracing
    schema before the first span — a dashboard must see
    ``trace_spans_dropped`` at 0, not a missing series, on a process
    that never overflowed its span ring (tools/check_telemetry.py
    --trace gates on this)."""
    from ..observability import registry as _registry
    _registry.counter(PREFIX + "trace.spans",
                      "completed spans recorded into the per-process "
                      "trace ring")
    _registry.counter(PREFIX + "trace.spans_dropped",
                      "completed spans dropped oldest-first when the "
                      "ring exceeded FLAGS_trace_buffer_cap")
    _registry.counter(PREFIX + "trace.decisions",
                      "tail-sampling decisions made at root-request "
                      "completion (exactly one per trace)")
    _registry.counter(PREFIX + "trace.decisions_kept",
                      "tail-sampling decisions that KEPT the trace "
                      "(error/evicted/deadline, latency threshold, or "
                      "probabilistic floor)")
    _registry.counter(PREFIX + "trace.spools",
                      "atomic JSONL spool writes under FLAGS_trace_dir")


def declare_router_stats():
    """Get-or-create every ``serving.router.*`` metric family so the
    Prometheus exposition carries the full fleet schema from router
    start — a dashboard must see ``requests_shed`` at 0, not a missing
    series, before the first shed (tools/check_telemetry.py --router
    gates on exactly this)."""
    from ..observability import registry as _registry
    _registry.counter(ROUTER_PREFIX + "requests_routed",
                      "requests routed per replica",
                      labelnames=("replica",))
    _registry.counter(ROUTER_PREFIX + "requests_routed_role",
                      "requests routed per replica role",
                      labelnames=("role",))
    for name, doc in (
            ("requests_routed_total", "requests routed, all replicas"),
            ("requests_shed", "fail-fast rejections: every ready "
                              "replica at capacity"),
            ("failovers", "replica deaths detected mid-request"),
            ("resubmissions", "re-sends under the same idempotent id"),
            ("requests_recovered", "requests completed after >= 1 "
                                   "resubmission"),
            ("replicas_lost", "replicas marked sticky-dead"),
            ("ejections", "replicas ejected by the gray-failure "
                          "guardian (health-score outliers; reversible, "
                          "unlike sticky-dead)"),
            ("readmissions", "ejected replicas readmitted after "
                             "sustained canary recovery"),
            ("hedges", "hedge requests fired past the latency "
                       "percentile (same idempotent rid)"),
            ("hedge_wins", "requests whose hedge answered before the "
                           "primary attempt"),
            ("breaker_open", "circuit-breaker closed->open transitions "
                             "(per-replica rpc breakers)"),
            ("retry_budget_exhausted", "resubmissions refused by the "
                                       "fleet-wide token-bucket retry "
                                       "budget")):
        _registry.counter(ROUTER_PREFIX + name, doc)
    _registry.gauge(ROUTER_PREFIX + "replicas_alive",
                    "ready replicas in the routing ring")
    _registry.gauge(ROUTER_PREFIX + "replica_health_score",
                    "per-replica health score (EWMA latency ms, "
                    "error-inflated); outliers vs the fleet median "
                    "are ejected",
                    labelnames=("replica",))
    _registry.histogram(ROUTER_PREFIX + "route_latency_ms",
                        "submit-to-completion through the fleet (ms)")


def reset_router_stats():
    """Clear the ``serving.router.*`` counters (router start).  Labeled
    children (``requests_routed{replica=...}``) reset with their family
    — ``monitor.reset`` resolves the flat key back to the registry
    metric."""
    declare_router_stats()
    for key in monitor.all_stats():
        if key.startswith(ROUTER_PREFIX):
            monitor.reset(key)


def adapter_observe(adapter_id):
    """One admitted adapter request: the per-adapter labeled counter
    ``serving.adapter.requests_routed_adapter{adapter=...}`` plus the
    flat total the snapshot reads.  Cardinality is bounded by the
    engine run, like ``request_tokens`` (``reset_serving_stats()``
    clears the family at engine start)."""
    from ..observability import registry as _registry
    _registry.counter(PREFIX + "adapter.requests_routed_adapter",
                      "requests admitted per adapter",
                      labelnames=("adapter",)) \
        .labels(adapter=str(adapter_id)).inc()
    monitor.incr(PREFIX + "adapter.requests_routed_adapter_total")


def serving_stats():
    """One consistent snapshot of the serving counters plus derived
    quantities:

    - ``ttft_ms_avg``       mean time-to-first-token (submit → first
                            sampled token, prefill inclusive)
    - ``per_token_ms_avg``  mean decode-step wall time (each active
                            request gains one token per step)
    - ``slot_occupancy``    active-slot steps / total slot steps — how
                            full the continuous batch ran
    - ``tokens_per_sec``    generated tokens / engine busy time
                            (prefill + decode wall)

    Compiled-tick quantities: ``tick_ms_avg`` — mean wall
    time of one whole scheduler iteration (admissions + prefill chunk +
    decode, whichever lane ran it) — plus ``tick_compiled_hits`` /
    ``tick_fallbacks`` counting iterations the ONE-program compiled
    tick executed vs iterations that latched the uncompiled scheduler
    (flag off mid-run, slot layout, speculation, unhostable sampling,
    hooks); all three ride the Prometheus exposition
    (``serving_tick_ms`` histogram, ``serving_tick_compiled_hits`` /
    ``serving_tick_fallbacks`` counters, gated by
    tools/check_telemetry.py --serving-tick).

    Paged-cache quantities (kv_layout="paged", zero otherwise):
    ``kv_pages_in_use``/``kv_pages_free`` pool gauges plus the
    ``kv_pages_peak`` high-water mark (the int8-KV capacity gate reads
    it: at equal token load a quantized pool's peak ~halves),
    ``prefix_cache_hits``/``misses``/``evictions`` and
    ``prefix_cache_hit_tokens`` tree counters, ``prefill_chunks`` and
    ``prefill_chunk_ms_avg`` chunked-prefill cadence, and
    ``max_active_slots`` — the high-water mark of concurrent decoding
    sequences (the paged pool admits more of them than
    ``pool_bytes / max_seq_len`` stripes would).

    Speculative-decoding quantities (``speculation_k > 0``, zero
    otherwise): ``spec_windows`` (draft→verify→rollback iterations),
    ``spec_proposed_tokens``/``spec_accepted_tokens`` and the derived
    ``spec_acceptance_rate``, and per-phase latency
    ``spec_draft_ms_avg``/``spec_verify_ms_avg``/
    ``spec_rollback_ms_avg`` — all in the Prometheus exposition too.

    Migration quantities (prefill/decode disaggregation, zero without
    it): ``migrations`` (requests handed off and completed remotely),
    ``migration_pages_sent``/``migration_pages_received`` page-transfer
    volume, ``migration_resumed_requests`` (requests resumed here from
    adopted pages), ``migration_fallbacks`` (failed transfers that
    decoded locally instead), and ``migrate_ms_avg`` — all declared at
    engine start and in the Prometheus exposition, gated by
    tools/check_telemetry.py --migration, which also requires the
    router's per-role ``requests_routed_role{role=...}`` family.

    Multi-tenant LoRA quantities (``max_adapters > 0``, zero
    otherwise): ``adapters_loaded`` (hot-loads into pool slots),
    ``adapter_evictions`` (LRU evictions of idle adapters),
    ``adapter_load_ms_avg`` (mean hot-load wall time), and
    ``requests_routed_adapter`` — total admitted adapter requests, with
    the per-adapter ``requests_routed_adapter{adapter=...}`` series in
    the Prometheus exposition (gated by check_telemetry.py --lora).

    Fleet/router quantities (``serving.router.*``, zero without a
    router; per-replica ``requests_routed{replica=...}`` series live in
    the Prometheus exposition): ``router_requests_routed`` total,
    ``router_requests_shed`` (fail-fast admission rejections),
    ``router_failovers`` (replica deaths detected mid-request),
    ``router_resubmissions`` (re-sends under the same idempotent id),
    ``router_requests_recovered`` (requests that completed after >= 1
    resubmission), ``router_replicas_alive``/``router_replicas_lost``,
    and ``router_route_latency_ms_avg`` (submit → completion through
    the fleet).

    Gray-failure guardian quantities (zero with the guardian off):
    ``router_ejections``/``router_readmissions`` (reversible
    health-score ejections and canary readmissions),
    ``router_hedges``/``router_hedge_wins`` (hedged dispatch),
    ``router_breaker_open`` (circuit-breaker trips),
    ``router_retry_budget_exhausted`` (token-bucket refusals), and
    ``requests_cancelled`` (engine-side hedged-loser cancellations);
    the per-replica ``replica_health_score{replica=...}`` gauge rides
    the Prometheus exposition (gated by check_telemetry.py
    --gray-failure).
    """
    s = monitor.all_stats()

    def g(name, default=0):
        return s.get(PREFIX + name, default)

    def avg(name):
        count = g(name + ".count")
        return (g(name + ".sum") / count) if count else None

    busy_s = (g("prefill_ms.sum") + g("decode_ms.sum")
              + g("spec_draft_ms.sum") + g("spec_verify_ms.sum")
              + g("spec_rollback_ms.sum")) / 1e3
    tokens = g("tokens_generated")
    slot_steps = g("slot_steps")
    active_steps = g("slot_steps_active")
    spec_proposed = g("spec_proposed_tokens")
    return {
        "queue_depth": g("queue_depth"),
        "active_slots": g("active_slots"),
        "requests_submitted": g("requests_submitted"),
        "requests_completed": g("requests_completed"),
        "requests_rejected_queue_full": g("requests_rejected_queue_full"),
        "requests_evicted_deadline": g("requests_evicted_deadline"),
        "requests_cancelled_shutdown": g("requests_cancelled_shutdown"),
        "requests_cancelled_drain": g("requests_cancelled_drain"),
        "scheduler_restarts": g("scheduler_restarts"),
        "scheduler_stalls": g("scheduler_stalls"),
        "tokens_generated": tokens,
        "prefill_steps": g("prefill_steps"),
        "prefill_chunks": g("prefill_chunks"),
        "prefill_chunk_ms_avg": avg("prefill_chunk_ms"),
        "decode_steps": g("decode_steps"),
        "tick_ms_avg": avg("tick_ms"),
        "tick_compiled_hits": g("tick.compiled_hits"),
        "tick_fallbacks": g("tick.fallbacks"),
        "kv_pages_in_use": g("kv_pages_in_use"),
        "kv_pages_free": g("kv_pages_free"),
        "kv_pages_peak": g("kv_pages_peak"),
        "spec_windows": g("spec_windows"),
        "spec_proposed_tokens": spec_proposed,
        "spec_accepted_tokens": g("spec_accepted_tokens"),
        "spec_acceptance_rate": (g("spec_accepted_tokens")
                                 / spec_proposed) if spec_proposed
        else None,
        "spec_draft_ms_avg": avg("spec_draft_ms"),
        "spec_verify_ms_avg": avg("spec_verify_ms"),
        "spec_rollback_ms_avg": avg("spec_rollback_ms"),
        "migrations": g("migration.migrations"),
        "migration_pages_sent": g("migration.pages_sent"),
        "migration_pages_received": g("migration.pages_received"),
        "migration_resumed_requests": g("migration.resumed_requests"),
        "migration_fallbacks": g("migration.fallbacks"),
        "migrate_ms_avg": avg("migration.migrate_ms"),
        "prefix_cache_hits": g("prefix_cache_hits"),
        "prefix_cache_misses": g("prefix_cache_misses"),
        "prefix_cache_evictions": g("prefix_cache_evictions"),
        "prefix_cache_hit_tokens": g("prefix_cache_hit_tokens"),
        "max_active_slots": g("max_active_slots"),
        "adapters_loaded": g("adapter.adapters_loaded"),
        "adapter_evictions": g("adapter.adapter_evictions"),
        "adapter_load_ms_avg": avg("adapter.adapter_load_ms"),
        "requests_routed_adapter": g(
            "adapter.requests_routed_adapter_total"),
        "ttft_ms_avg": avg("ttft_ms"),
        "per_token_ms_avg": avg("decode_ms"),
        "slot_occupancy": (active_steps / slot_steps) if slot_steps
        else 0.0,
        "tokens_per_sec": (tokens / busy_s) if busy_s > 0 else 0.0,
        "router_requests_routed": g("router.requests_routed_total"),
        "router_requests_shed": g("router.requests_shed"),
        "router_failovers": g("router.failovers"),
        "router_resubmissions": g("router.resubmissions"),
        "router_requests_recovered": g("router.requests_recovered"),
        "router_replicas_alive": g("router.replicas_alive"),
        "router_replicas_lost": g("router.replicas_lost"),
        "router_route_latency_ms_avg": avg("router.route_latency_ms"),
        "router_ejections": g("router.ejections"),
        "router_readmissions": g("router.readmissions"),
        "router_hedges": g("router.hedges"),
        "router_hedge_wins": g("router.hedge_wins"),
        "router_breaker_open": g("router.breaker_open"),
        "router_retry_budget_exhausted": g(
            "router.retry_budget_exhausted"),
        "requests_cancelled": g("requests_cancelled"),
        "trace_spans": g("trace.spans"),
        "trace_spans_dropped": g("trace.spans_dropped"),
        "trace_decisions": g("trace.decisions"),
        "trace_decisions_kept": g("trace.decisions_kept"),
        "trace_spools": g("trace.spools"),
    }
