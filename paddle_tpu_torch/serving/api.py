"""Serving frontend types (port of paddle_tpu/serving/api.py): config,
sampling params, results, errors.

Clients build a `ServingConfig`, call ``Engine(model, config).start()``,
then the sync ``generate()`` or async ``submit() -> Future``.  A bounded
queue rejects with `QueueFullError` instead of buffering without limit,
and per-request deadlines evict the slot (`DeadlineExceededError`).

`ServingConfig.validate` makes the JAX package's checks word for word.
The fleet's errors: `NoReplicaError` (the router found no ready replica),
`QueueFullError` with the router's ``retry_after_s`` hint, and
`PageMigrationError` (a KV-page payload the target's pool cannot adopt).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..quantization import kv_quant_params


class ServingError(RuntimeError):
    """Base class for serving-layer failures."""


class QueueFullError(ServingError):
    """Admission rejected: the bounded request queue is at capacity.

    When the serving router sheds a request because every ready replica
    is at capacity, ``retry_after_s`` carries the suggested client
    backoff (the fleet's analog of an HTTP 429 Retry-After header)."""

    def __init__(self, *args, retry_after_s=None):
        super().__init__(*args)
        self.retry_after_s = retry_after_s


class NoReplicaError(ServingError):
    """The router found no ready replica to route to (none registered,
    all dead, or all draining) and the request's deadline or patience ran
    out: the loud alternative to a client hanging on a dead fleet."""


class DeadlineExceededError(ServingError):
    """The request's deadline passed; its slot was evicted (or it was
    dropped from the queue before ever reaching a slot)."""


class EngineShutdownError(ServingError):
    """The engine stopped (or is draining) while the request was queued
    or in flight."""


class RequestCancelledError(ServingError):
    """The request was cancelled via ``Engine.cancel`` before it
    finished; its slot, KV pages and adapter pin were released."""


class SchedulerStallError(ServingError):
    """One scheduler iteration exceeded ``ServingConfig.step_timeout_s``;
    the engine failed every outstanding future and restarted its loop
    (bounded by ``max_scheduler_restarts``)."""


class AdapterConfigError(ServingError):
    """An adapter registration is infeasible for this engine's pool: rank
    over ``adapter_rank_pool``, factor shapes that do not match the base
    model's projections, or a projection name the model does not have.
    Raised from ``Engine(...)`` / ``AdapterPool.register``, naming the
    layer, never as a shape error mid-decode."""


class UnknownAdapterError(ServingError):
    """A request named an ``adapter_id`` absent from the engine's
    registry.  Delivered by failing THAT request's future; the scheduler
    never sees the request."""


class PageMigrationError(ServingError):
    """A KV-page migration payload cannot be adopted by the target
    replica's pool: another page size, dtype or layer geometry, a bad
    wire version or frame count, or an inconsistent offset.  The sending
    replica treats it as a dead target and decodes locally."""


@dataclass(frozen=True)
class SamplingParams:
    """Per-request decoding knobs, in the HF processor order of
    `models.generation`; ``temperature=0.0`` is greedy.  ``seed`` keys
    the request's draws: token n comes from ``categorical(fold_in(
    PRNGKey(seed), n))``, the JAX engine's stream (`framework.prng`)."""

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


CACHE_DTYPES = ("float32", "bfloat16", "float16", "int8", "fp8")


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
    cache_dtype              KV pool element type: float32, bfloat16,
                             float16, or int8 / fp8 (e4m3): quantized
                             pools with one float32 scale per cached token
                             row; a quantized page packs 2 x page_size
                             tokens in half the bytes of a bf16 page, so
                             the pages in use at equal load halve
    idle_wait_s              scheduler sleep when no work is queued
    drain_grace_s            `Engine.drain`'s deadline when none is
                             passed: how long in-flight slots may run on
                             before the engine shuts down anyway (the
                             SIGTERM path)
    step_timeout_s           scheduler-iteration watchdog budget: an
                             iteration exceeding it fails every
                             outstanding future with SchedulerStallError
                             and restarts the loop; 0 (default) disables
                             the watchdog
    max_scheduler_restarts   bounded restarts of the scheduler loop after
                             a crash or a stall before the engine gives up
                             and stops accepting work
    kv_layout                "paged" (default): KV pages with lazy growth,
                             prefix reuse and chunked prefill; "slots":
                             fixed [num_slots, max_seq_len] stripes a
                             layer, a batch-1 prefill a request
    page_size                tokens per KV page
    kv_pool_pages            physical pages in the pool; None →
                             num_slots * ceil(max_seq_len / page_size)
    enable_prefix_cache      keep released prompt pages in a refcounted
                             prefix tree so requests sharing a prompt
                             prefix reuse its KV
    prefill_chunk_tokens     prompts prefill this many tokens per
                             scheduler iteration, interleaved with decode
    max_adapters             concurrent hot LoRA adapters over the base
                             model; 0 (default) = no adapter pool.  >0
                             allocates per-projection A/B/scale stacks of
                             max_adapters + 1 slots (slot 0 is the exact
                             identity base requests ride) and enables
                             submit(..., adapter_id=...)
    adapter_rank_pool        rank every pool slot is padded to; an adapter
                             of higher rank raises AdapterConfigError
    adapters                 registry {adapter_id: source}, a save_adapter
                             artifact directory or an adapter_spec dict,
                             validated at Engine construction; more via
                             Engine.register_adapter
    draft_model              small proposer model for speculative
                             decoding (same vocab as the target; its
                             config.max_seq_len must cover max_seq_len).
                             None (default) = no speculation
    speculation_k            draft tokens proposed a slot a window; the
                             target verifies all K+1 positions in ONE
                             batched call and the rejected tail is rolled
                             back (paged layout only; 0 = off, the plain
                             decode loop).  Speculation engages when every
                             active request is greedy without a
                             repetition penalty; other iterations take the
                             plain step
    role                     the disaggregation role this engine's
                             replica advertises to the fleet: "mixed"
                             (default), "prefill" (prefers prefill work
                             and hands a finished prompt's KV pages to a
                             decode replica) or "decode" (adopts migrated
                             pages and decodes).  Roles are routing
                             preferences, never fences: a replica of any
                             role serves what the router sends it
    """

    num_slots: int = 4
    max_queue: int = 64
    max_seq_len: int | None = None
    default_max_new_tokens: int = 64
    request_timeout_s: float = 120.0
    deadline_policy: str = "evict"
    cache_dtype: str = "float32"
    idle_wait_s: float = 0.005
    drain_grace_s: float = 30.0
    step_timeout_s: float = 0.0
    max_scheduler_restarts: int = 2
    kv_layout: str = "paged"
    page_size: int = 16
    kv_pool_pages: int | None = None
    enable_prefix_cache: bool = True
    prefill_chunk_tokens: int = 32
    draft_model: object | None = None
    speculation_k: int = 0
    role: str = "mixed"
    max_adapters: int = 0
    adapter_rank_pool: int = 8
    adapters: dict | None = None

    def validate(self):
        if self.role not in ("mixed", "prefill", "decode"):
            raise ValueError(
                "role must be 'mixed', 'prefill' or 'decode', got "
                f"{self.role!r}")
        if self.cache_dtype not in CACHE_DTYPES:
            raise ValueError(f"cache_dtype must be one of {CACHE_DTYPES}, "
                             f"got {self.cache_dtype!r}")
        if self.num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got "
                             f"{self.num_slots}")
        if self.max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got "
                             f"{self.max_queue}")
        if self.kv_layout not in ("paged", "slots"):
            raise ValueError("kv_layout must be 'paged' or 'slots', "
                             f"got {self.kv_layout!r}")
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
        if self.drain_grace_s < 0:
            raise ValueError(f"drain_grace_s must be >= 0, got "
                             f"{self.drain_grace_s}")
        if self.step_timeout_s < 0:
            raise ValueError(f"step_timeout_s must be >= 0, got "
                             f"{self.step_timeout_s}")
        if self.max_scheduler_restarts < 0:
            raise ValueError(f"max_scheduler_restarts must be >= 0, "
                             f"got {self.max_scheduler_restarts}")
        if kv_quant_params(self.cache_dtype) is not None and \
                self.kv_layout != "paged":
            raise ValueError(
                f"cache_dtype={self.cache_dtype!r} (quantized KV with "
                "per-page scales) requires kv_layout='paged'")
        if self.speculation_k < 0:
            raise ValueError(f"speculation_k must be >= 0, got "
                             f"{self.speculation_k}")
        if self.speculation_k > 0:
            if self.draft_model is None:
                raise ValueError(
                    "speculation_k > 0 needs a draft_model to propose "
                    "tokens; pass ServingConfig(draft_model=...)")
            if self.kv_layout != "paged":
                raise ValueError(
                    "speculative decoding requires kv_layout='paged' "
                    "(accept-mask rollback is a page-table/offset move)")
        if self.max_adapters < 0:
            raise ValueError(f"max_adapters must be >= 0, got "
                             f"{self.max_adapters}")
        if self.adapter_rank_pool < 1:
            raise ValueError(f"adapter_rank_pool must be >= 1, got "
                             f"{self.adapter_rank_pool}")
        if self.max_adapters > 0 and self.kv_layout != "paged":
            raise ValueError(
                "max_adapters > 0 (multi-tenant LoRA serving) requires "
                "kv_layout='paged'")
        if self.adapters and self.max_adapters == 0:
            raise ValueError(
                "ServingConfig.adapters given but max_adapters == 0 — "
                "set max_adapters to the concurrent-adapter budget")
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
    #: the replica that decoded the request's tail (fleet only): the
    #: submit target unless KV-page migration resumed it elsewhere
    decoded_by: str | None = None

    @property
    def ids(self):
        """[S+T] prompt + generated."""
        return np.concatenate([self.prompt_ids, self.output_ids])
