"""Serving engine of the port: paged KV cache (float, int8 or fp8 pools),
chunked prefill, prefix cache, continuous batching, multi-LoRA adapter
pool, the compiled scheduler tick (one CUDA graph replay a decode step,
`compiled_tick`), speculative decoding with a draft model, the dense slot
layout (`kv_slots`), the engine's resilience (drain, the preemption
drain, the stall watchdog and bounded scheduler restarts), its
telemetry (the ``serving.*`` families on the metrics registry, `stats`,
and request tracing), and past one process the fleet: replicated engines
behind a drain-aware, session-affine router (`router`, `fleet`) with
prefill/decode disaggregation by live KV-page migration (`migration`)."""
from .adapters import AdapterPool
from .api import (AdapterConfigError, DeadlineExceededError,
                  EngineShutdownError, NoReplicaError, PageMigrationError,
                  QueueFullError, RequestCancelledError, RequestOutput,
                  SamplingParams, SchedulerStallError, ServingConfig,
                  ServingError, UnknownAdapterError)
from .compiled_tick import CompiledServingTick, TickFallbackWarning
from .engine import Engine
from .fleet import ReplicaConfig, ReplicaServer, ServingFleet
from .kv_slots import SlotKVCache
from .paged_kv import PagedKVCache, PrefixTree
from .router import HashRing, RouterConfig, ServingRouter
from .stats import reset_router_stats, reset_serving_stats, serving_stats

__all__ = ["AdapterConfigError", "AdapterPool", "CompiledServingTick",
           "DeadlineExceededError", "Engine", "EngineShutdownError",
           "HashRing", "NoReplicaError", "PageMigrationError",
           "PagedKVCache", "PrefixTree", "QueueFullError", "ReplicaConfig",
           "ReplicaServer", "RequestCancelledError", "RequestOutput",
           "RouterConfig", "SamplingParams", "SchedulerStallError",
           "ServingConfig", "ServingError", "ServingFleet",
           "ServingRouter", "SlotKVCache", "TickFallbackWarning",
           "UnknownAdapterError", "reset_router_stats",
           "reset_serving_stats", "serving_stats"]
