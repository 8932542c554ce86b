"""Serving engine of the port: paged KV cache (float, int8 or fp8 pools),
chunked prefill, prefix cache, continuous batching, multi-LoRA adapter
pool, and the compiled scheduler tick (one CUDA graph replay a decode
step, `compiled_tick`)."""
from .adapters import AdapterPool
from .api import (AdapterConfigError, DeadlineExceededError,
                  EngineShutdownError, QueueFullError, RequestCancelledError,
                  RequestOutput, SamplingParams, ServingConfig, ServingError,
                  UnknownAdapterError)
from .engine import Engine
from .paged_kv import PagedKVCache, PrefixTree

__all__ = ["AdapterConfigError", "AdapterPool", "DeadlineExceededError",
           "Engine", "EngineShutdownError", "PagedKVCache", "PrefixTree",
           "QueueFullError", "RequestCancelledError", "RequestOutput",
           "SamplingParams", "ServingConfig", "ServingError",
           "UnknownAdapterError"]
