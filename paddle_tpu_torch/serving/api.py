"""Serving frontend types (port of paddle_tpu/serving/api.py): config,
sampling params, results, errors.

Clients build a `ServingConfig`, call ``Engine(model, config).start()``,
then the sync ``generate()`` or async ``submit() -> Future``.  A bounded
queue rejects with `QueueFullError` instead of buffering without limit,
and per-request deadlines evict the slot (`DeadlineExceededError`).

Options of the JAX engine that this port does not carry yet raise
``NotImplementedError`` from `ServingConfig.validate` (ROADMAP Queue A):
quantized KV (``int8``/``fp8``), speculation, LoRA adapters,
prefill/decode roles and the dense slot layout.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


class ServingError(RuntimeError):
    """Base class for serving-layer failures."""


class QueueFullError(ServingError):
    """Admission rejected: the bounded request queue is at capacity."""


class DeadlineExceededError(ServingError):
    """The request's deadline passed; its slot was evicted (or it was
    dropped from the queue before ever reaching a slot)."""


class EngineShutdownError(ServingError):
    """The engine stopped while the request was queued or in flight."""


class RequestCancelledError(ServingError):
    """The request was cancelled via ``Engine.cancel`` before it
    finished; its slot and KV pages were released."""


@dataclass(frozen=True)
class SamplingParams:
    """Per-request decoding knobs, in the HF processor order of
    `models.generation`; ``temperature=0.0`` is greedy.  ``seed`` seeds
    the request's own ``torch.Generator``."""

    temperature: float = 0.0
    top_k: int | None = None
    top_p: float | None = None
    repetition_penalty: float | None = None
    seed: int | None = None

    def validate(self):
        if self.top_p is not None and not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        if self.repetition_penalty is not None and \
                self.repetition_penalty <= 0.0:
            raise ValueError("repetition_penalty must be > 0, got "
                             f"{self.repetition_penalty}")
        if self.temperature < 0.0:
            raise ValueError(
                f"temperature must be >= 0, got {self.temperature}")
        if self.seed is not None and int(self.seed) < 0:
            raise ValueError(f"seed must be >= 0, got {self.seed}")
        return self

    @property
    def greedy(self):
        return self.temperature == 0.0

    @property
    def uses_penalty(self):
        return self.repetition_penalty is not None and \
            self.repetition_penalty != 1.0


CACHE_DTYPES = ("float32", "bfloat16", "float16")


@dataclass
class ServingConfig:
    """Engine knobs.

    num_slots                decode-batch width = max concurrent sequences
    max_queue                bounded admission queue; submit() past this
                             raises QueueFullError
    max_seq_len              per-slot KV capacity; None → the model's
                             config.max_seq_len
    default_max_new_tokens   per-request cap when submit() passes None
    request_timeout_s        sync generate()'s Future.result timeout
    deadline_policy          "evict": a request past its deadline_s is
                             failed and its slot freed; "ignore": never
                             enforced
    cache_dtype              KV pool element type: float32, bfloat16 or
                             float16
    idle_wait_s              scheduler sleep when no work is queued
    kv_layout                "paged" (the only layout ported)
    page_size                tokens per KV page
    kv_pool_pages            physical pages in the pool; None →
                             num_slots * ceil(max_seq_len / page_size)
    enable_prefix_cache      keep released prompt pages in a refcounted
                             prefix tree so requests sharing a prompt
                             prefix reuse its KV
    prefill_chunk_tokens     prompts prefill this many tokens per
                             scheduler iteration, interleaved with decode
    draft_model, speculation_k, role, max_adapters
                             JAX-engine options not ported yet: anything
                             but their defaults raises
    """

    num_slots: int = 4
    max_queue: int = 64
    max_seq_len: int | None = None
    default_max_new_tokens: int = 64
    request_timeout_s: float = 120.0
    deadline_policy: str = "evict"
    cache_dtype: str = "float32"
    idle_wait_s: float = 0.005
    kv_layout: str = "paged"
    page_size: int = 16
    kv_pool_pages: int | None = None
    enable_prefix_cache: bool = True
    prefill_chunk_tokens: int = 32
    draft_model: object | None = None
    speculation_k: int = 0
    role: str = "mixed"
    max_adapters: int = 0

    def validate(self):
        if self.cache_dtype in ("int8", "fp8"):
            raise NotImplementedError(
                f"cache_dtype={self.cache_dtype!r}: quantized KV is not "
                "ported yet (ROADMAP Queue A)")
        if self.cache_dtype not in CACHE_DTYPES:
            raise ValueError(f"cache_dtype must be one of {CACHE_DTYPES}, "
                             f"got {self.cache_dtype!r}")
        if self.kv_layout != "paged":
            raise NotImplementedError(
                f"kv_layout={self.kv_layout!r}: only the paged layout is "
                "ported")
        if self.speculation_k != 0 or self.draft_model is not None:
            raise NotImplementedError(
                "speculative decoding is not ported yet (ROADMAP Queue A)")
        if self.max_adapters != 0:
            raise NotImplementedError(
                "multi-LoRA serving is not ported yet (ROADMAP Queue A)")
        if self.role != "mixed":
            raise NotImplementedError(
                f"role={self.role!r}: prefill/decode disaggregation is not "
                "ported yet (ROADMAP Queue A)")
        if self.num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got "
                             f"{self.num_slots}")
        if self.max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got "
                             f"{self.max_queue}")
        if self.page_size < 1:
            raise ValueError(f"page_size must be >= 1, got "
                             f"{self.page_size}")
        if self.kv_pool_pages is not None and self.kv_pool_pages < 1:
            raise ValueError(f"kv_pool_pages must be >= 1, got "
                             f"{self.kv_pool_pages}")
        if self.prefill_chunk_tokens < 1:
            raise ValueError(f"prefill_chunk_tokens must be >= 1, got "
                             f"{self.prefill_chunk_tokens}")
        if self.deadline_policy not in ("evict", "ignore"):
            raise ValueError(
                "deadline_policy must be 'evict' or 'ignore', got "
                f"{self.deadline_policy!r}")
        return self


@dataclass
class RequestOutput:
    """What a completed request's Future resolves to."""

    request_id: int
    prompt_ids: np.ndarray          # [S] int32, as submitted
    output_ids: np.ndarray          # [T] int32 generated tokens
    finish_reason: str              # "eos" | "length"
    ttft_ms: float                  # submit → first token
    latency_ms: float               # submit → completion

    @property
    def ids(self):
        """[S+T] prompt + generated."""
        return np.concatenate([self.prompt_ids, self.output_ids])
