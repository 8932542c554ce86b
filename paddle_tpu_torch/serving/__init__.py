"""Serving engine of the port: paged KV cache, chunked prefill, prefix
cache, continuous batching."""
from .api import (DeadlineExceededError, EngineShutdownError,
                  QueueFullError, RequestCancelledError, RequestOutput,
                  SamplingParams, ServingConfig, ServingError)
from .engine import Engine
from .paged_kv import PagedKVCache, PrefixTree

__all__ = ["DeadlineExceededError", "Engine", "EngineShutdownError",
           "PagedKVCache", "PrefixTree", "QueueFullError",
           "RequestCancelledError", "RequestOutput", "SamplingParams",
           "ServingConfig", "ServingError"]
