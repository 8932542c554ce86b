"""Serving engine of the port: paged KV cache (float, int8 or fp8 pools),
chunked prefill, prefix cache, continuous batching, multi-LoRA adapter
pool, the compiled scheduler tick (one CUDA graph replay a decode step,
`compiled_tick`), speculative decoding with a draft model, the dense slot
layout (`kv_slots`), the engine's resilience (drain, the preemption
drain, the stall watchdog and bounded scheduler restarts), and its
telemetry: the ``serving.*`` families on the metrics registry (`stats`:
`serving_stats`, `reset_serving_stats`) and request tracing."""
from .adapters import AdapterPool
from .api import (AdapterConfigError, DeadlineExceededError,
                  EngineShutdownError, QueueFullError, RequestCancelledError,
                  RequestOutput, SamplingParams, SchedulerStallError,
                  ServingConfig, ServingError, UnknownAdapterError)
from .compiled_tick import CompiledServingTick, TickFallbackWarning
from .engine import Engine
from .kv_slots import SlotKVCache
from .paged_kv import PagedKVCache, PrefixTree
from .stats import reset_serving_stats, serving_stats

__all__ = ["AdapterConfigError", "AdapterPool", "CompiledServingTick",
           "DeadlineExceededError", "Engine", "EngineShutdownError",
           "PagedKVCache", "PrefixTree", "QueueFullError",
           "RequestCancelledError", "RequestOutput", "SamplingParams",
           "SchedulerStallError", "ServingConfig", "ServingError",
           "SlotKVCache", "TickFallbackWarning", "UnknownAdapterError",
           "reset_serving_stats", "serving_stats"]
