"""Continuous-batching inference engine (port of
paddle_tpu/serving/engine.py): a paged KV cache by default, or the dense
slot layout (``kv_layout="slots"``, `kv_slots.SlotKVCache`).

A background scheduler thread, in each iteration of the paged layout:

1. admits queued requests into free slots, matching each prompt against
   the prefix tree so shared prompt pages are reused, not recomputed;
2. runs ONE batched ``[num_slots, prefill_chunk_tokens]`` prefill-chunk
   call for every request still prefilling, sampling a request's first
   token when its prompt is fully cached;
3. runs ONE batched ``[num_slots, 1]`` decode step over every slot (free
   slots ride along on the scratch page): by default the compiled tick
   (`compiled_tick.CompiledServingTick`, one CUDA graph replay on the card
   over device-resident scheduler state, one ``[num_slots]`` read back);
   otherwise the uncompiled step, with one batched argmax when every
   active request is greedy, one fused sampling call when each is greedy
   or seeded, and per-row sampling otherwise;
4. completes futures on EOS, max-tokens, slot capacity or deadline.

With a ``draft_model`` and ``speculation_k = K > 0``, step 3 is a
speculative window (`_spec_step`) whenever every active request is greedy
without a repetition penalty: K ``[num_slots, 1]`` draft steps on the
draft's own paged cache, one ``[num_slots, K+1]`` verify call of the
target, the accepted run plus the bonus token, and `PagedKVCache.rollback`
of both caches.  Both caches hold ``max_seq_len + K`` tokens a slot; the
compiled tick is off while speculation is configured, as in JAX.  The
slot layout prefills each request in one batch-1 call and runs the
uncompiled decode step.

A seeded request (``SamplingParams.seed``) draws token n from
``categorical(fold_in(PRNGKey(seed), n))``, the JAX engine's key stream
bit for bit (`framework.prng`), whichever lane draws it; an unseeded
sampled request draws from its own ``torch.Generator``.  Flags
(`utils.flags`): ``FLAGS_compiled_tick`` (the tick) and
``FLAGS_serving_fused_sampling`` (the uncompiled step's one fused call;
off, each sampled row is drawn by a call of its own, a seeded one from
the same key stream), both on by default.

``cache_dtype="int8"`` or ``"fp8"`` stores K/V quantized with per-row
scales; a quantized page packs ``2 x page_size`` tokens.  With
``max_adapters > 0`` an `AdapterPool` serves LoRA adapters over the base
model: ``submit(..., adapter_id=...)`` pins the adapter's pool slot for
the request's lifetime, every model call adds each row's gathered delta,
and prefix-tree entries are scoped by adapter id.

Resilience: `drain` (and `install_preemption_drain`, on SIGTERM) stops
admissions, fails the queue and lets the in-flight slots finish; with
``step_timeout_s > 0`` a watchdog thread fails every outstanding future
of an iteration past its budget with `SchedulerStallError` and raises
into the scheduler thread; a crash or a stall restarts the loop with a
fresh cache and tick, up to ``max_scheduler_restarts`` times, after
failing every outstanding future with the error.  The flight recorder
gets ``drain_begin``/``drain_end``, ``scheduler_restart`` and
``scheduler_stall`` (with a ``serving-stall`` dump of every thread's
stack), and ``request_done`` / ``request_failed`` for each request.

Telemetry: the engine publishes through `stats` into the process's
metrics registry under ``serving.`` (`start` resets and declares the
families; `stats()` is `stats.serving_stats()`).  With
``FLAGS_trace_dir`` set each request records an ``engine.request`` root
span with ``engine.queue``, ``engine.prefill`` (its chunks and first
token as events) and ``engine.decode`` children, ended on every terminal
path, where the engine makes the trace's one tail-sampling decision
(`observability.tracing`); `shutdown` spools them.

Live KV-page migration (prefill/decode disaggregation, driven by
`fleet.ReplicaServer`): ``submit(handoff=...)`` names a decode replica;
once the request's prompt is cached and its first token sampled, the
engine exports the slot's pages (`migration.export_slot`) and a
background thread hands them to the installed ``migrator`` (phase 1:
transfer and remote adoption, timed as ``migration.migrate_ms``, span
``engine.migrate``), releases the slot, then waits on the
``migration_awaiter`` for the remote stream (phase 2, span
``engine.remote_wait``); the future resolves with
``RequestOutput.decoded_by`` naming the decode replica.  A phase-1
failure decodes the request locally (``migration.fallbacks``): a handoff
can slow a request, never lose it.  `submit_resume` is the receive side:
the request adopts its pages at admission and joins the decode batch
where the sender stopped (its tokens, penalty state and key-stream
position), so its first decode step is the tick's replay like any other
slot's.  ``drain(migrate=True)`` migrates the in-flight slots the same
way.

A tensor-parallel model (``cache_kv_heads``: `ParallelLlamaForCausalLM`,
`ParallelGPTForCausalLM`) sizes the pools by the rank's kv heads.  Its
replica (`tp_replica`) installs ``Engine.mirror``: the one seam through
which every model call (a prefill chunk, the uncompiled decode step, the
compiled tick) and every write to the cache's device state (a
migration's page reads and adoption) is first handed to the replica's
other ranks.  With no mirror (one rank) nothing is sent and a decode
step launches what it launches without it.
"""
from __future__ import annotations

import contextlib
import gc
import itertools
import threading
import time
import traceback
from collections import deque
from concurrent.futures import Future

import numpy as np
import torch

from ..distributed.fleet.elastic import PreemptionHandler
from ..distributed.watchdog import all_thread_stacks, async_raise
from ..models.generation import _kv_heads, init_kv_caches, \
    sample_next_token
from ..observability import flight_recorder as _fr
from ..observability import tracing
from ..observability.exporter import maybe_start_exporter
from ..quantization import kv_quant_params
from ..utils.flags import flag as _flag
from . import stats
from .adapters import AdapterPool
from ..utils import fault_injection as _fi
from .api import (AdapterConfigError, DeadlineExceededError,
                  EngineShutdownError, PageMigrationError, QueueFullError,
                  RequestCancelledError, RequestOutput, SamplingParams,
                  SchedulerStallError, ServingConfig, UnknownAdapterError)
from .compiled_tick import (CompiledServingTick, fused_sample_call,
                            request_key, sampling_hostable)
from .kv_slots import SlotKVCache
from .paged_kv import PagedKVCache, PrefixTree


class _Request:
    __slots__ = ("id", "prompt", "max_new_tokens", "sampling",
                 "eos_token_id", "deadline", "future", "submit_t",
                 "ttft_ms", "tokens", "seen", "last_token", "slot",
                 "prefill_pos", "shared_len", "prefix_nodes",
                 "draft_prefill_pos", "first_tok", "generator",
                 "handoff", "resume", "adapter_id", "adapter_slot",
                 "trace")

    def __init__(self, rid, prompt, max_new_tokens, sampling,
                 eos_token_id, deadline, generator):
        self.id = rid
        self.prompt = prompt
        self.max_new_tokens = max_new_tokens
        self.sampling = sampling
        self.eos_token_id = eos_token_id
        self.deadline = deadline
        self.future = Future()
        self.submit_t = time.monotonic()
        self.ttft_ms = None
        self.tokens = []
        self.seen = None            # [V] bool, only under rep penalty
        self.last_token = 0
        self.slot = None
        self.prefill_pos = 0        # next prompt token to prefill
        self.shared_len = 0         # prompt tokens reused from the tree
        self.prefix_nodes = []      # tree nodes this request references
        self.draft_prefill_pos = 0  # draft-model prefill progress (spec)
        self.first_tok = None       # sampled first token, not yet appended
        self.generator = generator  # unseeded sampling's own stream
        self.handoff = None         # decode-replica target (disagg)
        self.resume = None          # migrated-page payload
        self.adapter_id = None      # LoRA adapter this request decodes
        self.adapter_slot = 0       # its pool slot (0 = base identity)
        self.trace = None           # _ReqTrace (tracing armed)


class _ReqTrace:
    """A request's spans, made only with ``FLAGS_trace_dir`` set: the
    ``engine.request`` root and the phase spans under it (queue wait,
    chunked prefill, decode, the migration transfer and the remote wait).
    ``owns_root`` marks a trace the engine minted (no context bound by a
    caller, such as the router's on the rpc envelope): only then does the
    engine end it with the tail-sampling decision and mark its winner."""

    __slots__ = ("root", "queue", "prefill", "decode", "transfer",
                 "remote", "owns_root")

    def __init__(self, root, owns_root):
        self.root = root
        self.owns_root = owns_root
        self.queue = None
        self.prefill = None
        self.decode = None
        self.transfer = None
        self.remote = None

    def finish(self, status, latency_ms, **attrs):
        """Terminal close: end every phase span still open with the
        request's outcome (``end`` is idempotent: closed spans keep their
        own status), end the root, and decide iff the engine owns it."""
        for sp in (self.queue, self.prefill, self.decode, self.transfer,
                   self.remote):
            if sp is not None:
                sp.end(status=status)
        self.root.end(status=status,
                      winner=True if self.owns_root and status == "ok"
                      else None, **attrs)
        if self.owns_root:
            tracing.decide(self.root.ctx.trace_id, status=status,
                           latency_ms=latency_ms)


class Engine:
    """``Engine(model, config).start()``; then `submit` (async, returns a
    ``Future[RequestOutput]``) or `generate` (sync).  `shutdown` stops the
    scheduler and fails every queued or in-flight future with
    `EngineShutdownError`; `drain` first lets the in-flight slots finish.
    The engine runs on the model's device (the draft model's too)."""

    def __init__(self, model, config: ServingConfig | None = None):
        self.model = model
        self.cfg = model.config
        self.scfg = (config or ServingConfig()).validate()
        model.eval()                # serving never wants dropout
        self.device = next(model.parameters()).device
        self.max_len = self.scfg.max_seq_len or self.cfg.max_seq_len
        # a tensor-parallel model's cache holds its rank's kv heads; GPT
        # has no num_kv_heads: every head is a kv head
        self._kv_heads = _kv_heads(model)
        # a quantized page packs 2x the baseline page's tokens in half its
        # bytes: the pages in use at equal token load halve
        quant = kv_quant_params(self.scfg.cache_dtype) is not None
        self._page_size = self.scfg.page_size * (2 if quant else 1)
        self._paged = self.scfg.kv_layout == "paged"
        self._spec_k = int(self.scfg.speculation_k)
        self._spec = bool(self._paged and self._spec_k > 0
                          and self.scfg.draft_model is not None)
        draft = self.scfg.draft_model if self._spec else None
        if draft is not None:
            if hasattr(draft, "eval"):
                draft.eval()
            dcfg = draft.config
            if dcfg.max_seq_len < self.max_len:
                raise ValueError(
                    f"draft_model.config.max_seq_len {dcfg.max_seq_len} "
                    f"< serving max_seq_len {self.max_len}; the draft "
                    "must cover every position it proposes for")
            if dcfg.vocab_size != self.cfg.vocab_size:
                raise ValueError(
                    f"draft_model vocab {dcfg.vocab_size} != target "
                    f"vocab {self.cfg.vocab_size}")
        # a learned position table (GPT's wpe) must cover every position a
        # slot can hold: the left-shifted last prefill chunk and, with
        # speculation, the verify window's K tokens past the last real
        # one (the target's and the draft's table).  The JAX engine reads
        # a NaN fill past it; the port would clamp a position whose
        # logits are kept
        if self._paged:
            psz = self._page_size
            capacity = -(-(self.max_len + self._spec_k) // psz) * psz
            what = (f"max_seq_len {self.max_len} + speculation_k "
                    f"{self._spec_k} rounded up to whole pages of {psz}")
        else:
            capacity = self.max_len
            what = f"max_seq_len {self.max_len}"
        for name, m in (("model", model), ("draft_model", draft)):
            rows = getattr(m, "position_rows", None)
            if rows is not None and capacity > rows:
                raise ValueError(
                    f"KV capacity of {capacity} tokens a slot ({what}) "
                    f"exceeds the {name}'s {rows} learned positions; lower "
                    "ServingConfig.max_seq_len, page_size or "
                    "speculation_k")
        self.draft_cache = None
        self._queue: deque[_Request] = deque()
        self._active: dict[int, _Request] = {}
        # requests holding a slot whose prompt is mid-(chunked-)prefill
        self._prefilling: deque[_Request] = deque()
        self.prefix_tree = None
        self._max_active = 0
        self._pages_peak = 0
        self._pool_pub = None           # the pool gauges last published
        self._pool_iters = 0
        # EVERY unresolved request, from submit() until its future
        # resolves: the audit set _fail_all drains (a request popped for
        # admission is in neither _queue nor _active)
        self._pending: dict[int, _Request] = {}
        self._lock = threading.RLock()
        self._work = threading.Condition(self._lock)
        self._running = False
        self._draining = False
        self._thread = None
        self._ids = itertools.count()
        self._cancels: set[int] = set()
        self.cache = None
        # compiled scheduler tick (serving/compiled_tick.py): one captured
        # program per iteration over device-resident state.  _mut counts
        # host-lane mutations of request/slot state, so the tick knows
        # when its device mirror must be rebuilt.
        self._tick = None
        self._mut = 0
        # the side stream every tick of this engine warms up and captures
        # on: cuBLAS keeps a workspace for each stream it ran on, so a tick
        # rebuilt by a restart on a stream of its own would leave one more
        self._tick_stream = torch.cuda.Stream(self.device) \
            if self.device.type == "cuda" else None
        # the scheduler watchdog (step_timeout_s > 0) and restarts
        self._sched_tid = None
        self._iter_deadline = None
        self._restarts = 0
        self._monitor = None
        self._monitor_stop = threading.Event()
        self._stall_swept = False
        self._preemption_handler = None
        # live KV-page migration: the hosting ReplicaServer installs
        # `migrator(req, header, blobs, target) -> ack` (phase 1: transfer
        # and remote adoption; once it returns the local pages are free)
        # and `migration_awaiter(req, ack) -> payload` (phase 2: the remote
        # decode's result, holding nothing locally).  None: this engine
        # never migrates
        self.migrator = None
        self.migration_awaiter = None
        self._migrating_out: dict[int, _Request] = {}
        # the seam of a tensor-parallel replica (`tp_replica.StepMirror`):
        # every model call and every write to the cache's device state is
        # sent to the replica's other ranks first, which run it on their
        # shards.  None (one rank): nothing is sent
        self.mirror = None
        self._migration_results: deque = deque()
        self._migrate_failed: set[int] = set()
        self._drain_migrate = False
        # the hosting replica's name, which the `engine_slow` fault point
        # filters on
        self.fault_name = None
        # multi-tenant LoRA: A/B/scale stacks per target projection and
        # the per-slot adapter index, built (and the registry validated)
        # here; None without max_adapters, and then every model call is
        # the plain one
        self.adapter_pool = None
        if self.scfg.max_adapters > 0:
            self.adapter_pool = AdapterPool(
                model, self.scfg.max_adapters, self.scfg.adapter_rank_pool,
                self.scfg.num_slots)
            for aid, source in (self.scfg.adapters or {}).items():
                self.adapter_pool.register(aid, source)

    # ---------------- lifecycle ----------------
    def start(self):
        maybe_start_exporter()          # a no-op unless its flag names a path
        with self._lock:
            if self._running:
                return self
            stats.reset_serving_stats()
            stats.declare_tick_stats()
            stats.declare_migration_stats()
            stats.declare_adapter_stats()
            stats.declare_trace_stats()
            self.cache = self._new_cache()
            self._tick = self._make_tick()
            self._max_active = 0
            self._pool_pub = None
            self._pool_iters = 0
            self._running = True
            self._draining = False
            self._restarts = 0
            self._stall_swept = False
        self._thread = threading.Thread(
            target=self._loop, name="paddle-tpu-torch-serving", daemon=True)
        self._thread.start()
        if self.scfg.step_timeout_s > 0:
            self._monitor_stop.clear()
            self._monitor = threading.Thread(
                target=self._stall_monitor,
                name="paddle-tpu-torch-serving-watchdog", daemon=True)
            self._monitor.start()
        return self

    def _new_cache(self):
        """Fresh KV storage (and prefix tree, and the draft model's mirror
        cache when speculating) for a (re)started loop."""
        if not self._paged:
            return SlotKVCache(
                self.cfg.num_layers, self.scfg.num_slots, self.max_len,
                self._kv_heads, self.cfg.head_dim,
                dtype=self.scfg.cache_dtype, device=self.device)
        # + speculation_k positions of headroom: a verify window writes K
        # tokens past the last real one before the rollback rewinds them
        cache = PagedKVCache(
            self.cfg.num_layers, self.scfg.num_slots,
            self.max_len + self._spec_k, self._kv_heads, self.cfg.head_dim,
            page_size=self._page_size, num_pages=self.scfg.kv_pool_pages,
            dtype=self.scfg.cache_dtype, device=self.device)
        self.prefix_tree = PrefixTree(self._page_size) \
            if self.scfg.enable_prefix_cache else None
        # every prefill chunk call is this wide
        self._chunk = min(self.scfg.prefill_chunk_tokens, cache.capacity)
        self._prefilling.clear()
        self._pages_peak = 0
        if self._spec:
            dcfg = self.scfg.draft_model.config
            # fully preallocated: the draft prefills every prompt itself
            # (no shared pages), so its pool never holds admission back
            self.draft_cache = PagedKVCache(
                dcfg.num_layers, self.scfg.num_slots,
                self.max_len + self._spec_k,
                getattr(dcfg, "num_kv_heads", dcfg.num_heads),
                dcfg.head_dim, page_size=self._page_size, num_pages=None,
                dtype=self.scfg.cache_dtype, device=self.device)
        return cache

    def _make_tick(self):
        """A fresh compiled tick for a new cache, or None with
        ``FLAGS_compiled_tick`` off (no tick object, no state mirrors)."""
        if not _flag("FLAGS_compiled_tick", True):
            return None
        return CompiledServingTick(self)

    def shutdown(self, wait_s=30.0):
        """Stop the scheduler; queued and in-flight futures resolve with
        `EngineShutdownError`, and the scheduler thread is joined."""
        with self._work:
            self._running = False
            self._work.notify_all()
        self._monitor_stop.set()
        t = self._thread
        if t is not None:
            t.join(wait_s)
            if t.is_alive():            # pragma: no cover
                self._fail_all(EngineShutdownError(
                    "engine shut down (scheduler thread wedged)"))
                raise RuntimeError(
                    "serving scheduler thread failed to stop within "
                    f"{wait_s}s")
        self._thread = None
        m = self._monitor
        if m is not None:
            m.join(wait_s)
            self._monitor = None
        # the loop's finally already failed everything; this covers a
        # shutdown racing a never-started or crashed loop
        self._fail_all(EngineShutdownError("engine shut down"))
        if tracing.enabled():
            tracing.spool_now()     # the spans, for the collector

    def drain(self, deadline_s=None, migrate=False):
        """Graceful shutdown (the preemption / SIGTERM path): stop
        admissions at once, fail every still-queued request with
        `EngineShutdownError`, let the slots already decoding run to
        completion within `deadline_s` (default
        ``ServingConfig.drain_grace_s``), then shut the engine down;
        whatever is unfinished at the deadline fails as in `shutdown`.
        Idempotent; safe from any thread.

        ``migrate=True`` (needs an installed `migrator`): the in-flight
        slots' KV pages (prompt and the tokens emitted so far) go to a
        surviving replica, where each request resumes with its cache
        intact; a failed transfer finishes the request here instead."""
        deadline_s = self.scfg.drain_grace_s if deadline_s is None \
            else float(deadline_s)
        with self._work:
            if not self._running:
                return
            already = self._draining
            self._drain_migrate = bool(migrate) and \
                self.migrator is not None and self._paged
            self._draining = True
            queued = list(self._queue)
            self._queue.clear()
            stats.set_value("queue_depth", 0)
            self._work.notify_all()
        if already:
            return
        _fr.record("serving", "drain_begin", queued=len(queued),
                   active=len(self._active),
                   deadline_s=round(deadline_s, 3))
        for req in queued:
            self._fail(req, EngineShutdownError(
                f"engine draining: request {req.id} was still queued"))
            stats.incr("requests_cancelled_drain")
        deadline = time.monotonic() + deadline_s
        # a poll of the unresolved requests: no host read of the device,
        # so it never races a replay of the compiled tick.  The audit set,
        # not the scheduler's containers: a request moving from the active
        # set to a migration (its pages being exported) sits in neither
        # for a moment, but stays pending until its future resolves
        while self._pending and time.monotonic() < deadline:
            time.sleep(0.01)
        _fr.record("serving", "drain_end", unfinished=len(self._active))
        self.shutdown()

    def install_preemption_drain(self, handler=None, deadline_s=None):
        """Wire `drain` to the preemption notice: on SIGTERM the engine
        stops admitting, finishes the in-flight requests within
        `deadline_s` and fails the queue, instead of dying mid-token.
        Installs a fresh `PreemptionHandler` when none is passed; returns
        the handler, so co-located training code can share it."""
        if handler is None:
            handler = PreemptionHandler().install()
        handler.add_callback(lambda: self.drain(deadline_s))
        self._preemption_handler = handler
        return handler

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.shutdown()

    # ---------------- client API ----------------
    def submit(self, prompt_ids, max_new_tokens=None, sampling=None,
               eos_token_id=None, deadline_s=None, handoff=None,
               adapter_id=None):
        """Enqueue one request; returns a ``Future[RequestOutput]``.
        Raises `QueueFullError` when the bounded queue is full and
        ``ValueError`` for prompts a slot cannot hold.  ``handoff``
        (disaggregation) is a migration target the installed `migrator`
        understands: on a paged engine the request's pages go there once
        its prompt is cached, and it decodes there; a failed migration
        decodes it here.  ``adapter_id``
        decodes under that registered LoRA adapter; an id absent from the
        registry fails THIS request's future with `UnknownAdapterError`
        (the scheduler never sees it)."""
        prompt = np.asarray(prompt_ids).astype(np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        if prompt.size >= self.max_len:
            raise ValueError(
                f"prompt of {prompt.size} tokens leaves no room to "
                f"decode in a {self.max_len}-token slot")
        sampling = (sampling or SamplingParams()).validate()
        max_new = int(self.scfg.default_max_new_tokens
                      if max_new_tokens is None else max_new_tokens)
        if max_new < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got "
                             f"{max_new}")
        if self._paged:
            # infeasible requests are rejected up front: admission
            # backpressure only helps when the pool could EVER fit it
            psz = self._page_size
            pool = self.scfg.kv_pool_pages or self.scfg.num_slots * \
                (-(-(self.max_len + self._spec_k) // psz))
            need = -(-(min(prompt.size + max_new, self.max_len)
                       + self._spec_k) // psz)
            if need > pool:
                raise ValueError(
                    f"request needs {need} KV pages (prompt {prompt.size} "
                    f"+ max_new {max_new}) but the pool holds {pool}; "
                    "raise ServingConfig.kv_pool_pages")
        if adapter_id is not None:
            known = self.adapter_pool.known_ids() \
                if self.adapter_pool is not None else []
            if str(adapter_id) not in known:
                msg = (f"adapter_id {adapter_id!r} is not in this "
                       f"engine's registry (registered: {known})")
                if self.adapter_pool is None:
                    msg += ("; the engine has no adapter pool: set "
                            "ServingConfig.max_adapters > 0")
                fut = Future()
                fut.set_exception(UnknownAdapterError(msg))
                return fut
        gen = None
        if not sampling.greedy and sampling.seed is None:
            # a seeded request draws from its key stream (_sample_row)
            gen = torch.Generator(device=self.device)
            gen.seed()
        deadline = (time.monotonic() + deadline_s) \
            if deadline_s is not None else None
        req = _Request(next(self._ids), prompt, max_new, sampling,
                       eos_token_id, deadline, gen)
        if adapter_id is not None:
            req.adapter_id = str(adapter_id)
        if handoff is not None and self._paged:
            req.handoff = handoff
        if tracing.enabled():
            # a caller that bound a context (`tracing.bind`, or the
            # router's attempt span on the rpc envelope) makes the engine
            # span its child and keeps the decision; with none the engine
            # mints the root and owns the decision
            parent = tracing.current()
            root = tracing.start_span(
                "engine.request", parent=parent, rid=req.id,
                prompt_tokens=int(prompt.size))
            req.trace = _ReqTrace(root, owns_root=parent is None)
            req.trace.queue = tracing.start_span(
                "engine.queue", parent=root)
        with self._work:
            if not self._running:
                raise EngineShutdownError(
                    "engine is not running (call start())")
            if self._draining:
                raise EngineShutdownError(
                    "engine is draining (preemption notice); not "
                    "accepting new requests")
            if len(self._queue) >= self.scfg.max_queue:
                stats.incr("requests_rejected_queue_full")
                raise QueueFullError(
                    f"request queue is full ({self.scfg.max_queue} "
                    "waiting); retry later or raise "
                    "ServingConfig.max_queue")
            self._queue.append(req)
            self._pending[req.id] = req
            stats.incr("requests_submitted")
            stats.set_value("queue_depth", len(self._queue))
            self._work.notify()
        req.future.request_id = req.id       # cancel()'s handle
        return req.future

    def generate(self, prompt_ids, max_new_tokens=None, sampling=None,
                 eos_token_id=None, deadline_s=None, timeout=None,
                 adapter_id=None):
        """Sync client: submit + wait.  Returns a `RequestOutput`."""
        fut = self.submit(prompt_ids, max_new_tokens=max_new_tokens,
                          sampling=sampling, eos_token_id=eos_token_id,
                          deadline_s=deadline_s, adapter_id=adapter_id)
        return fut.result(timeout or self.scfg.request_timeout_s)

    def submit_resume(self, prompt_ids, prior_tokens, pages,
                      max_new_tokens=None, sampling=None,
                      eos_token_id=None, deadline_s=None, ttft_ms=None):
        """Resume a migrated request from its transferred KV pages: the
        receive side of disaggregation and of a drained replica's
        recovery.  ``pages`` is `migration.unpack`'s dict (the
        layer-pooled K/V pages, their scales, the offset) and
        ``prior_tokens`` the tokens the sender already emitted (at least
        one: the prefill replica samples the first token).  The request
        is queued like any other; once the pool adopts its pages it
        decodes from where the sender stopped, with the prompt never
        recomputed.  Raises `PageMigrationError` for payloads this
        engine's pool can never hold."""
        if not self._paged:
            raise PageMigrationError(
                "page adoption requires kv_layout='paged'")
        prompt = np.asarray(prompt_ids).astype(np.int32).reshape(-1)
        prior = [int(t) for t in np.asarray(prior_tokens).reshape(-1)]
        if prompt.size == 0 or not prior:
            raise ValueError("resume needs a prompt and >= 1 prior token")
        sampling = (sampling or SamplingParams()).validate()
        max_new = int(self.scfg.default_max_new_tokens
                      if max_new_tokens is None else max_new_tokens)
        if len(prior) >= max_new:
            raise ValueError(
                f"{len(prior)} prior tokens already exhaust the "
                f"max_new_tokens={max_new} budget — nothing to resume")
        if prompt.size + len(prior) >= self.max_len:
            raise ValueError(
                f"prompt {prompt.size} + {len(prior)} prior tokens "
                f"leave no room to decode in a {self.max_len}-token slot")
        if int(pages["offset"]) != prompt.size + len(prior) - 1:
            raise PageMigrationError(
                f"offset {pages['offset']} inconsistent with prompt "
                f"{prompt.size} + {len(prior)} prior tokens (expected "
                f"{prompt.size + len(prior) - 1} cached positions)")
        psz = self._page_size
        pool = self.scfg.kv_pool_pages or self.scfg.num_slots * \
            (-(-(self.max_len + self._spec_k) // psz))
        need = -(-(min(prompt.size + max_new, self.max_len)
                   + self._spec_k) // psz)
        if need > pool:
            raise PageMigrationError(
                f"resumed request needs {need} KV pages but the pool "
                f"holds {pool}")
        gen = None
        if not sampling.greedy and sampling.seed is None:
            gen = torch.Generator(device=self.device)
            gen.seed()
        deadline = (time.monotonic() + deadline_s) \
            if deadline_s is not None else None
        req = _Request(next(self._ids), prompt, max_new, sampling,
                       eos_token_id, deadline, gen)
        req.resume = dict(pages)
        req.tokens = prior
        req.last_token = prior[-1]
        req.ttft_ms = ttft_ms
        if tracing.enabled():
            # the adopting side: the replica binds the SENDER's transfer
            # span before calling here, so the resumed decode is its child
            # and the whole hop chain stays one trace
            parent = tracing.current()
            root = tracing.start_span(
                "engine.request", parent=parent, rid=req.id,
                resumed=True, prior_tokens=len(prior),
                prompt_tokens=int(prompt.size))
            req.trace = _ReqTrace(root, owns_root=parent is None)
            req.trace.queue = tracing.start_span(
                "engine.queue", parent=root)
        with self._work:
            if not self._running:
                raise EngineShutdownError(
                    "engine is not running (call start())")
            if self._draining:
                raise EngineShutdownError(
                    "engine is draining; not adopting migrated requests")
            if len(self._queue) >= self.scfg.max_queue:
                stats.incr("requests_rejected_queue_full")
                raise QueueFullError(
                    f"request queue is full ({self.scfg.max_queue} "
                    "waiting); the sender should fall back or retry")
            self._queue.append(req)
            self._pending[req.id] = req
            stats.incr("requests_submitted")
            stats.set_value("queue_depth", len(self._queue))
            self._work.notify()
        req.future.request_id = req.id       # cancel()'s handle
        return req.future

    def cancel(self, request_id):
        """Cancel one pending request (``future.request_id``).  A queued
        request fails with `RequestCancelledError` here; a slot-resident
        one is unwound by the scheduler in its next iteration.  Returns
        False when the request is unknown, already resolved, or
        mid-migration (it resolves through the migration)."""
        with self._work:
            req = self._pending.get(request_id)
            if req is None or req.future.done():
                return False
            if req.id in self._migrating_out:
                return False
            try:
                self._queue.remove(req)
            except ValueError:
                # slot-resident or mid-admission: the scheduler owns
                # slot state and applies the cancellation itself
                self._cancels.add(req.id)
                self._work.notify()
                return True
            self._fail(req, RequestCancelledError(
                f"request {req.id} cancelled while queued"))
            stats.incr("requests_cancelled")
            stats.set_value("queue_depth", len(self._queue))
            return True

    def _process_cancels_locked(self):
        if not self._cancels:
            return
        cancels, self._cancels = self._cancels, set()
        if self._tick is not None:
            self._tick.flush_to_host()
        for cid in cancels:
            req = self._pending.get(cid)
            if req is None or req.id in self._migrating_out:
                continue
            try:
                self._prefilling.remove(req)
            except ValueError:
                pass
            self._fail(req, RequestCancelledError(
                f"request {req.id} cancelled"))
            stats.incr("requests_cancelled")
            self._release(req)
        stats.set_value("active_slots", len(self._active))

    def stats(self):
        """`stats.serving_stats()`: the process's serving families, which
        this engine's `start` reset."""
        return stats.serving_stats()

    # ---------------- multi-tenant LoRA ----------------
    def register_adapter(self, adapter_id, source):
        """Validate and register an adapter on a live engine.  ``source``
        is a ``save_adapter`` artifact directory or an ``adapter_spec``
        dict.  Raises `AdapterConfigError` for infeasible adapters."""
        if self.adapter_pool is None:
            raise AdapterConfigError(
                "engine has no adapter pool: construct it with "
                "ServingConfig(max_adapters=...) > 0")
        with self._lock:
            return self.adapter_pool.register(adapter_id, source)

    def loaded_adapters(self):
        """Adapter ids currently hot in pool slots."""
        if self.adapter_pool is None:
            return []
        with self._lock:
            return self.adapter_pool.loaded_ids()

    def _lora_ctx(self, idx=None):
        """Activation scope for model calls: hooked projections add the
        gathered low-rank delta.  A no-op without an adapter pool."""
        if self.adapter_pool is None:
            return contextlib.nullcontext()
        return self.adapter_pool.activate(idx)

    # ---------------- scheduler ----------------
    def _loop(self):
        """Restart wrapper: a crashed or stalled iteration fails every
        outstanding future (clients see the real error, never a silent
        hang) and the loop restarts with a fresh cache and a fresh tick,
        up to ``max_scheduler_restarts`` times."""
        self._sched_tid = threading.get_ident()
        try:
            while not self._run_loop():
                # the crash may have left slots and pages torn mid-write,
                # or a tick graph mid-replay: rebuild rather than trust
                # them.  The old cache, draft cache and tick (its graphs
                # and their pool) are dropped and collected before the new
                # ones are allocated, so a restart does not hold two of
                # each (on the card a dropped tick can sit in a reference
                # cycle until the next collection)
                self.cache = self.draft_cache = self._tick = None
                gc.collect()
                self.cache = self._new_cache()
                self._tick = self._make_tick()
        finally:
            self._iter_deadline = None
            self._fail_all(EngineShutdownError("engine shut down"))
            stats.set_value("active_slots", 0)
            stats.set_value("queue_depth", 0)
            if self._paged and self.cache is not None:
                self._publish_pool_stats(force=True)

    def _run_loop(self):
        """`_loop_once` until a clean shutdown (True) or a crash the
        engine may restart from (False); past ``max_scheduler_restarts``
        the error propagates and the engine stops accepting work."""
        try:
            with torch.no_grad():
                self._loop_once()
            return True
        except BaseException as exc:    # noqa: BLE001 - reported, re-raised
            with self._work:
                running = self._running
            if not running:
                return True                 # a shutdown racing a crash
            if self.mirror is not None:
                # the other ranks' caches and graphs cannot be rebuilt in
                # lockstep: the replica goes down before any future fails,
                # so the router sees a lost replica and fails over
                self.mirror.fatal(exc)
            # the futures keep the error and its traceback: its frames'
            # locals (the cache's views, a logits tensor) go, so the old
            # cache is free to go before the restart allocates a new one
            traceback.clear_frames(exc.__traceback__)
            # the stall monitor already failed the stalled batch: a request
            # submitted since is healthy work for the restarted loop
            swept, self._stall_swept = self._stall_swept, False
            if not (swept and isinstance(exc, SchedulerStallError)):
                self._fail_all(exc)
            stats.incr("scheduler_restarts")
            _fr.record("serving", "scheduler_restart",
                       error=type(exc).__name__, restarts=self._restarts + 1)
            if self._restarts >= self.scfg.max_scheduler_restarts:
                with self._work:
                    self._running = False
                raise
            self._restarts += 1
            return False

    def _loop_once(self):
        budget = self.scfg.step_timeout_s
        while True:
            with self._work:
                if not self._running:
                    if self._tick is not None:
                        self._tick.flush_to_host()
                    break
                self._process_migration_results_locked()
                self._process_cancels_locked()
                self._expire_queued_locked()
                admits = []
                while self._queue and self.cache.free_slots:
                    if self._paged:
                        slot = self._try_admit_paged(self._queue[0])
                        if slot is None:
                            break       # page backpressure: FIFO
                    else:
                        slot = self.cache.allocate()
                    admits.append((self._queue.popleft(), slot))
                stats.set_value("queue_depth", len(self._queue))
                if not admits and not self._active \
                        and not self._prefilling:
                    self._iter_deadline = None
                    self._work.wait(self.scfg.idle_wait_s)
                    continue
            if budget > 0:
                self._iter_deadline = time.monotonic() + budget
            t_tick = time.monotonic()
            if _fi.active("engine_slow") is not None:
                # gray-failure drill: a stall each iteration on this
                # replica while its heartbeats stay healthy
                _fi.check_rpc("engine_slow", self.fault_name or "")
            if self._paged and self._drain_migrate:
                # preemption recovery: the still-decoding slots' pages go
                # to survivors instead of racing the drain deadline
                self._migrate_out_active()
            if self._paged:
                for req, slot in admits:
                    if req.resume is not None:
                        self._activate_resumed(req, slot)
                    else:
                        self._start_prefill(req, slot)
                # ONE batched chunk call covers every prefilling request,
                # then the decode step runs: a long prompt never blocks
                # the in-flight streams for more than a chunk
                if self._prefilling:
                    self._prefill_round()
            else:
                for req, slot in admits:
                    self._prefill(req, slot)
            if self._active:
                if self._can_speculate():
                    self._spec_step()
                elif self._tick is None or not self._tick.step():
                    self._decode_step()
            if self._paged:
                self._publish_pool_stats()
            stats.observe("tick_ms",
                                (time.monotonic() - t_tick) * 1e3)
            self._iter_deadline = None

    def _stall_monitor(self):
        """The scheduler-iteration watchdog (``step_timeout_s > 0``): when
        one iteration blows its budget, fail every outstanding future at
        once (clients unblock even while the scheduler is wedged in a
        device call) and raise `SchedulerStallError` into the scheduler
        thread, so the restart wrapper rebuilds the loop."""
        budget = self.scfg.step_timeout_s
        poll = max(min(budget / 4.0, 0.25), 0.005)
        while not self._monitor_stop.wait(poll):
            deadline = self._iter_deadline
            if deadline is None or time.monotonic() < deadline:
                continue
            self._iter_deadline = None
            exc = SchedulerStallError(
                f"scheduler iteration exceeded its step_timeout_s="
                f"{budget:g}s budget; failing all outstanding requests and "
                "restarting the decode loop")
            stats.incr("scheduler_stalls")
            _fr.record("serving", "scheduler_stall", budget_s=budget)
            _fr.dump(reason="serving-stall", error=exc, once=True,
                     extra={"stall": {"op": "serving::step", "seq": None,
                                      "budget_s": budget,
                                      "threads": all_thread_stacks()}})
            self._stall_swept = True
            self._fail_all(exc)
            if self._sched_tid is not None:
                async_raise(self._sched_tid, SchedulerStallError)

    def _expire_queued_locked(self):
        if self.scfg.deadline_policy != "evict":
            return
        now = time.monotonic()
        keep = deque()
        for req in self._queue:
            if req.deadline is not None and now > req.deadline:
                self._fail(req, DeadlineExceededError(
                    f"request {req.id} expired after "
                    f"{now - req.submit_t:.3f}s in queue"))
                stats.incr("requests_evicted_deadline")
            else:
                keep.append(req)
        self._queue = keep

    def _prefill(self, req, slot):
        """The slot layout's batch-1 prompt pass into the slot's rows, and
        the request's first token."""
        tr = req.trace
        if tr is not None:
            if tr.queue is not None:
                tr.queue.end(slot=slot)
            tr.prefill = tracing.start_span(
                "engine.prefill", parent=tr.root, slot=slot,
                prompt_tokens=int(req.prompt.size))
        t0 = time.monotonic()
        caches = init_kv_caches(
            self.cfg.num_layers, 1, self.max_len, self._kv_heads,
            self.cfg.head_dim, dtype=self.scfg.cache_dtype,
            device=self.device)
        logits = self.model(torch.tensor(req.prompt[None, :],
                                         device=self.device), caches=caches)
        self.cache.write_prefill(slot, caches, req.prompt.size)
        if req.sampling.uses_penalty:
            seen = np.zeros(self.cfg.vocab_size, bool)
            seen[req.prompt] = True
            req.seen = seen
        tok = self._sample_row(logits[:, -1, :], req)
        now = time.monotonic()
        req.ttft_ms = (now - req.submit_t) * 1e3
        stats.observe("ttft_ms", req.ttft_ms)
        stats.observe("prefill_ms", (now - t0) * 1e3)
        stats.incr("prefill_steps")
        req.slot = slot
        self._active[slot] = req
        if tr is not None:
            tr.prefill.event("first_token", ttft_ms=round(req.ttft_ms, 3))
            tr.prefill.end()
            tr.decode = tracing.start_span(
                "engine.decode", parent=tr.root, slot=slot)
        self._append_token(req, tok)
        stats.set_value("active_slots", len(self._active))

    def _try_admit_paged(self, req):
        """Reserve a slot and the request's worst-case page budget (under
        the lock).  The prefix tree's shared pages shrink the
        reservation; LRU zero-ref tree pages are evicted under pressure.
        Returns the slot, or None (the request stays queued)."""
        psz = self._page_size
        # + speculation_k: a verify window writes past the last real token
        # before the rollback, so the reservation covers it
        total = min(req.prompt.size + req.max_new_tokens, self.max_len) \
            + self._spec_k
        if req.adapter_id is not None:
            # pin (hot-loading first if cold) the adapter's pool slot for
            # the request's lifetime; None = every slot is pinned by
            # in-flight requests, and the request stays queued
            pool_slot = self.adapter_pool.acquire(req.adapter_id)
            if pool_slot is None:
                return None
            req.adapter_slot = pool_slot
        if req.resume is not None:
            # a migrated request adopts its transferred pages (slot-
            # private) instead of reserving for a prefill it never runs;
            # the reservation covers the growth still ahead of the offset
            pay = req.resume
            n = int(pay["k_pages"].shape[1])
            reserve = max(0, -(-total // psz) - n)
            k, v = pay["k_pages"], pay["v_pages"]
            if self.mirror is not None:
                # the wire holds every head: this rank keeps its own
                k, v = self.mirror.local_heads(k), self.mirror.local_heads(v)
            slot = self.cache.adopt_pages(
                reserve, pay["offset"], k, v, pay["k_scales"],
                pay["v_scales"])
            if slot is None:
                return None         # pool backpressure: stays queued
            if self.mirror is not None:
                self.mirror.adopt(self.cache.table[slot, :n].copy(),
                                  pay["k_pages"], pay["v_pages"])
            if self._spec:
                dslot = self.draft_cache.allocate(
                    self.draft_cache.pages_per_slot)
                if dslot != slot:   # pragma: no cover - invariant
                    raise RuntimeError(
                        f"draft cache slot {dslot} diverged from "
                        f"target slot {slot}")
                # the draft never saw this prompt: teacher forcing
                # re-converges it from position 0
                self.draft_cache.set_offset(slot, 0)
            stats.incr("migration.pages_received", n)
            return slot
        nodes, pages = [], []
        if self.prefix_tree is not None:
            # scoped by adapter id: a prompt prefilled under one adapter
            # has other K/V than under another or under the base
            nodes, pages = self.prefix_tree.match(req.prompt,
                                                  scope=req.adapter_id)
        need = -(-total // psz) - len(pages)
        short = need - self.cache.available_pages
        if short > 0 and self.prefix_tree is not None:
            freed = self.prefix_tree.evict(short, self.cache.reclaim)
            if freed:
                stats.incr("prefix_cache_evictions", freed)
        slot = self.cache.allocate(need, pages)
        if slot is None:
            if nodes:
                self.prefix_tree.release(nodes)
            if req.adapter_id is not None:
                self.adapter_pool.release(req.adapter_id)
            return None
        if self._spec:
            # mirror the slot in the draft cache: the same free-slot stack
            # on both sides keeps the indices equal, and the draft pool is
            # fully preallocated, so this cannot fail
            dslot = self.draft_cache.allocate(
                self.draft_cache.pages_per_slot)
            if dslot != slot:       # pragma: no cover - invariant
                raise RuntimeError(
                    f"draft cache slot {dslot} diverged from target "
                    f"slot {slot}")
        if self.prefix_tree is not None:
            stats.incr("prefix_cache_hits" if pages
                             else "prefix_cache_misses")
            if pages:
                stats.incr("prefix_cache_hit_tokens", len(pages) * psz)
        req.prefix_nodes = nodes
        req.shared_len = len(pages) * psz
        return slot

    def _start_prefill(self, req, slot):
        """Arm chunked prefill: the slot's clock starts at the shared
        prefix length, whose pages came from the tree.  The draft model
        (speculation) always prefills from 0: shared pages belong to the
        target's cache."""
        req.slot = slot
        req.prefill_pos = req.shared_len
        req.first_tok = None
        tr = req.trace
        if tr is not None:
            if tr.queue is not None:
                tr.queue.end(slot=slot)
            tr.prefill = tracing.start_span(
                "engine.prefill", parent=tr.root, slot=slot,
                prompt_tokens=int(req.prompt.size),
                shared_len=req.shared_len)
            if req.adapter_id is not None:
                # the pool slot was pinned at admission (a cold adapter
                # paid its hot-load there)
                tr.prefill.event("adapter_acquire",
                                 adapter_id=req.adapter_id,
                                 pool_slot=req.adapter_slot)
        if self.adapter_pool is not None:
            # the slot's row of the persistent index vector now points at
            # the request's pool slot (0 for a base request)
            self.adapter_pool.set_row(slot, req.adapter_slot)
            if req.adapter_id is not None:
                stats.adapter_observe(req.adapter_id)
        self.cache.set_offset(slot, req.shared_len)
        if self._spec:
            req.draft_prefill_pos = 0
            self.draft_cache.set_offset(slot, 0)
        self._prefilling.append(req)

    def _prefill_round(self):
        """One chunk for EVERY prefilling request in one model call.  A
        final short chunk is left-shifted to start at ``min(offset,
        capacity - C)``: re-fed positions recompute the same K/V, and pad
        positions past the prompt land on the scratch page."""
        now = time.monotonic()
        if self.scfg.deadline_policy == "evict":
            for req in list(self._prefilling):
                if req.deadline is not None and now > req.deadline:
                    self._prefilling.remove(req)
                    self._fail(req, DeadlineExceededError(
                        f"request {req.id} exceeded its deadline "
                        f"mid-prefill at {req.prefill_pos}/"
                        f"{req.prompt.size} tokens"))
                    stats.incr("requests_evicted_deadline")
                    self._release(req)
        if not self._prefilling:
            return
        reqs = list(self._prefilling)       # each holds a slot: <= B
        chunk = self._chunk
        tgt = [r for r in reqs if r.prefill_pos < r.prompt.size]
        if tgt:
            logits, starts = self._prefill_chunk_call(
                self.model, self.cache, tgt, [r.prefill_pos for r in tgt])
            sampled = {}
            for row, req in enumerate(tgt):
                plen = req.prompt.size
                start = starts[row]
                req.prefill_pos = min(start + chunk, plen)
                self.cache.set_offset(req.slot, req.prefill_pos)
                if req.trace is not None and req.trace.prefill is not None:
                    req.trace.prefill.event("chunk", start=int(start),
                                            pos=int(req.prefill_pos))
                if req.prefill_pos < plen:
                    continue
                # prompt fully cached: sample the first token from the
                # last REAL position of this row's chunk
                if req.sampling.uses_penalty:
                    seen = np.zeros(self.cfg.vocab_size, bool)
                    seen[req.prompt] = True
                    req.seen = seen
                req.first_tok = self._sample_row(
                    logits[row:row + 1, plen - 1 - start, :], req)
                sampled[row] = req.first_tok
                req.ttft_ms = (time.monotonic() - req.submit_t) * 1e3
                stats.observe("ttft_ms", req.ttft_ms)
                stats.incr("prefill_steps")
                if req.trace is not None and req.trace.prefill is not None:
                    req.trace.prefill.event("first_token",
                                            ttft_ms=round(req.ttft_ms, 3))
                if self.prefix_tree is not None:
                    self.prefix_tree.insert(req.prompt, self.cache,
                                            req.slot, req.prefix_nodes,
                                            scope=req.adapter_id)
            if self.mirror is not None:
                self.mirror.sampled(sampled)
        if self._spec:
            # the draft's own chunked prefill, at the same cadence: its
            # cache must hold the whole prompt before the request can
            # decode speculatively (no shared pages on the draft side)
            dr = [r for r in reqs if r.draft_prefill_pos < r.prompt.size]
            if dr:
                _, dstarts = self._prefill_chunk_call(
                    self.scfg.draft_model, self.draft_cache, dr,
                    [r.draft_prefill_pos for r in dr])
                for row, req in enumerate(dr):
                    req.draft_prefill_pos = min(dstarts[row] + chunk,
                                                req.prompt.size)
                    self.draft_cache.set_offset(req.slot,
                                                req.draft_prefill_pos)
        # a request activates when every cache it decodes against holds
        # its prompt (the target's; the draft's too when speculating)
        for req in reqs:
            if req.prefill_pos < req.prompt.size or req.first_tok is None:
                continue
            if self._spec and req.draft_prefill_pos < req.prompt.size:
                continue
            try:
                self._prefilling.remove(req)
            except ValueError:
                continue    # a concurrent stall sweep already swept it
            tok, req.first_tok = req.first_tok, None
            if self._migrate_ready(req, tok):
                # disaggregation handoff: the prompt's pages are hot;
                # they go to the decode replica instead of joining this
                # replica's decode batch
                req.tokens = [tok]
                req.last_token = tok
                if req.seen is not None:
                    req.seen[tok] = True
                stats.incr("tokens_generated")
                self._begin_migration(req)
                continue
            self._active[req.slot] = req
            tr = req.trace
            if tr is not None:
                if tr.prefill is not None:
                    tr.prefill.end()
                tr.decode = tracing.start_span(
                    "engine.decode", parent=tr.root, slot=req.slot,
                    spec=self._spec)
            self._append_token(req, tok)
        stats.set_value("active_slots", len(self._active))

    def _prefill_chunk_call(self, model, cache, reqs, offs):
        """One batched ``[num_slots, chunk]`` prefill-chunk call of `model`
        against `cache` for `reqs` at per-request progress `offs`; returns
        (logits, starts)."""
        chunk = self._chunk
        cap = cache.capacity
        tokens = np.zeros((cache.num_slots, chunk), np.int32)
        starts = []
        for row, (req, off) in enumerate(zip(reqs, offs)):
            start = min(off, cap - chunk)
            seg = req.prompt[start:min(start + chunk, req.prompt.size)]
            tokens[row, :seg.size] = seg
            new_real = min(start + chunk, req.prompt.size) - off
            cache.ensure_capacity(req.slot, off + new_real - 1)
            starts.append(start)
        t0 = time.monotonic()
        # the call batches by ROW, not scheduler slot: its adapter index
        # is row-ordered (surplus rows ride the identity slot 0).  The
        # draft model's calls are never adapted
        lora = contextlib.nullcontext()
        if self.adapter_pool is not None and model is self.model:
            rows = np.zeros(cache.num_slots, np.int32)
            rows[:len(reqs)] = [r.adapter_slot for r in reqs]
            lora = self._lora_ctx(self.adapter_pool.row_tensor(rows))
        rows = cache.prefill_rows([r.slot for r in reqs], starts)
        if self.mirror is not None:
            self.mirror.prefill(tokens, rows, self._first_token_rows(
                reqs, starts))
        views = cache.rows_view(*rows)
        with lora:
            logits = model(torch.tensor(tokens, device=self.device),
                           caches=views)
        cache.absorb_view(views)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)   # time the device work
        dt_ms = (time.monotonic() - t0) * 1e3
        stats.observe("prefill_chunk_ms", dt_ms)
        stats.observe("prefill_ms", dt_ms)
        stats.incr("prefill_chunks", len(reqs))
        return logits, starts

    def _first_token_rows(self, reqs, starts):
        """{row: (position, knobs)} of the rows whose prompt this chunk
        call completes: where the first token is read and how it is drawn
        (`_sampling_knobs`, the prompt as the penalty's seen set; None for
        a request's own generator), for a tensor-parallel replica's other
        ranks to draw it too."""
        out = {}
        for row, (req, start) in enumerate(zip(reqs, starts)):
            plen = req.prompt.size
            if min(start + self._chunk, plen) < plen:
                continue
            knobs = None
            if sampling_hostable(req.sampling):
                knobs = self._sampling_knobs([req])
                if req.sampling.uses_penalty:
                    knobs["seen"][0, req.prompt] = True
            out[row] = (plen - 1 - start, knobs)
        return out

    # ---------------- live KV-page migration (disaggregation) ------------
    def _migrate_ready(self, req, tok):
        """Whether this just-prefilled request hands off: a target was
        assigned, a migrator is installed, and the request neither
        finishes on this very token nor has blown its deadline."""
        if req.handoff is None or self.migrator is None:
            return False
        if req.adapter_id is not None:
            # the resume path carries no adapter state, and the target
            # may not have the adapter hot: decode where it is pinned
            return False
        if req.max_new_tokens <= 1:
            return False
        if req.eos_token_id is not None and tok == req.eos_token_id:
            return False
        if req.prompt.size + 1 >= self.max_len:
            return False
        if self.scfg.deadline_policy == "evict" and \
                req.deadline is not None and \
                time.monotonic() > req.deadline:
            return False
        return True

    def _begin_migration(self, req):
        """Export the slot's pages (on the scheduler thread, the only
        cache writer; the copy to the host is complete when this returns)
        and ship them from a background thread, so the transfer never
        stalls the other slots' decode.  The slot and its pages stay held
        until the outcome lands: success releases them, failure
        re-activates the request here with nothing lost."""
        from . import migration
        if self.mirror is not None:
            # the ranks' head slices, gathered into the global pages
            header, blobs = self.mirror.export_slot(self.cache, req.slot)
        else:
            header, blobs = migration.export_slot(self.cache, req.slot)
        self._migrating_out[req.id] = req
        self._mut += 1          # the slot left the active set
        tr = req.trace
        if tr is not None:
            # close the request's phase (a prefill handoff, or a drain's
            # mid-decode) and open the transfer span BEFORE the migrator
            # runs: the fleet ships this span's context in the meta dict,
            # so the remote resumed decode is its child
            if tr.prefill is not None:
                tr.prefill.end()
            if tr.decode is not None:
                tr.decode.end(status="migrated", tokens=len(req.tokens))
                tr.decode = None
            tr.transfer = tracing.start_span(
                "engine.migrate", parent=tr.root,
                target=str((req.handoff or {}).get("name")),
                pages=int(header["num_pages"]), tokens=len(req.tokens))
        stats.incr("migration.pages_sent", header["num_pages"])
        threading.Thread(
            target=self._migrate_async,
            args=(req, header, blobs, req.handoff),
            name=f"migrate-{req.id}", daemon=True).start()

    def _migrate_async(self, req, header, blobs, target):
        """The transfer thread.  Phase 1 (`migrator`): ship the frames and
        the remote adoption, timed as ``migrate_ms``; a failure falls back
        (the local slot still holds everything).  Phase 2
        (`migration_awaiter`): wait for the remote decode holding nothing
        here; a failure (the target died mid-decode) fails the future
        with `EngineShutdownError`, which the router answers with an
        idempotent resubmission."""
        tr = req.trace
        t0 = time.monotonic()
        try:
            ack = self.migrator(req, header, blobs, target)
        except Exception as e:              # noqa: BLE001
            stats.observe("migration.migrate_ms",
                          (time.monotonic() - t0) * 1e3)
            if tr is not None and tr.transfer is not None:
                tr.transfer.end(status=type(e).__name__)
            self._post_migration(req, "fail", e)
            return
        stats.observe("migration.migrate_ms", (time.monotonic() - t0) * 1e3)
        if tr is not None and tr.transfer is not None:
            tr.transfer.end()
        if self.migration_awaiter is None:
            # a single-phase migrator: phase 1 returned the result
            self._post_migration(req, "done", ack)
            return
        self._post_migration(req, "sent", None)
        if tr is not None:
            tr.remote = tracing.start_span(
                "engine.remote_wait", parent=tr.root)
        try:
            payload = self.migration_awaiter(req, ack)
        except Exception as e:              # noqa: BLE001
            if tr is not None and tr.remote is not None:
                tr.remote.end(status=type(e).__name__)
            self._post_migration(req, "lost", e)
            return
        if tr is not None and tr.remote is not None:
            tr.remote.end()
        self._post_migration(req, "done", payload)

    def _post_migration(self, req, kind, val):
        with self._work:
            self._migration_results.append((req, kind, val))
            self._work.notify()

    def _process_migration_results_locked(self):
        """Land transfer outcomes (scheduler thread, under the lock):

        ``sent``  the target adopted the pages: release the local slot
        ``done``  the remote stream arrived: complete the future (and
                  free the slot if no ``sent`` preceded)
        ``fail``  phase 1 failed: re-activate the request here
        ``lost``  the target died after adopting: fail the future loudly
                  (the router resubmits under the same request id)
        """
        while self._migration_results:
            req, kind, val = self._migration_results.popleft()
            if req.id not in self._migrating_out:
                continue        # swept by _fail_all or shutdown already
            if kind == "sent":
                self._release(req)      # keeps riding _migrating_out
                continue
            del self._migrating_out[req.id]
            if kind == "fail":
                stats.incr("migration.fallbacks")
                _fr.record("serving", "migration_fallback",
                           request_id=req.id, error=type(val).__name__)
                self._migrate_failed.add(req.id)
                self._active[req.slot] = req
                self._mut += 1
                tr = req.trace
                if tr is not None:
                    # the failed transfer span closed with its error; the
                    # local decode resumes under the same trace
                    tr.root.event("migration_fallback",
                                  error=type(val).__name__)
                    tr.decode = tracing.start_span(
                        "engine.decode", parent=tr.root, slot=req.slot,
                        fallback=True)
                continue
            if kind == "lost":
                stats.incr("migration.remote_failures")
                self._fail(req, EngineShutdownError(
                    f"request {req.id}: migration target died after "
                    f"adopting its pages ({type(val).__name__}: {val}); "
                    "resubmit"))
                continue
            self._complete_migrated(req, val)
            self._release(req)

    def _complete_migrated(self, req, payload):
        """Resolve a handed-off request's future with the stream the
        decode replica produced (the prior tokens included)."""
        out = RequestOutput(
            request_id=req.id, prompt_ids=req.prompt,
            output_ids=np.asarray(payload["output_ids"], np.int32),
            finish_reason=payload["finish_reason"], ttft_ms=req.ttft_ms,
            latency_ms=(time.monotonic() - req.submit_t) * 1e3,
            decoded_by=payload.get("replica"))
        with self._lock:
            self._pending.pop(req.id, None)
        try:
            if not req.future.done():
                req.future.set_result(out)
        except Exception:       # noqa: BLE001 - lost a race to _fail
            return
        stats.incr("requests_completed")
        stats.incr("migration.migrations")
        if req.trace is not None:
            req.trace.finish("ok", out.latency_ms,
                             finish_reason=payload["finish_reason"],
                             migrated_to=payload.get("replica"))
        _fr.record("serving", "request_done", request_id=req.id,
                   reason=payload["finish_reason"],
                   tokens=int(np.asarray(payload["output_ids"]).size),
                   migrated_to=payload.get("replica"))

    def _activate_resumed(self, req, slot):
        """Receive side: the adopted request joins the decode batch where
        the sender stopped: its tokens, last token, penalty state, key
        stream position (the count of its tokens) and cache offset all
        continue, and the tick rebuilds its state from them."""
        req.slot = slot
        if req.sampling.uses_penalty:
            seen = np.zeros(self.cfg.vocab_size, bool)
            seen[req.prompt] = True
            seen[np.asarray(req.tokens, np.int32)] = True
            req.seen = seen
        req.resume = None
        self._active[slot] = req
        self._mut += 1
        tr = req.trace
        if tr is not None:
            if tr.queue is not None:
                tr.queue.end(slot=slot)
            tr.decode = tracing.start_span(
                "engine.decode", parent=tr.root, slot=slot,
                resumed=True, prior_tokens=len(req.tokens))
        stats.incr("migration.resumed_requests")
        stats.set_value("active_slots", len(self._active))

    def _migrate_out_active(self):
        """Drain-time recovery: every slot still decoding is exported and
        resumed on a survivor, its emitted tokens riding along, so a drain
        costs one page transfer instead of a prompt run elsewhere."""
        if self._tick is not None:
            # the tick keeps the tokens on the device; the export ships
            # req.tokens
            self._tick.flush_to_host()
        now = time.monotonic()
        for slot, req in list(self._active.items()):
            if req.id in self._migrate_failed:
                continue        # one failed transfer: decode it out here
            if self.scfg.deadline_policy == "evict" and \
                    req.deadline is not None and now > req.deadline:
                continue        # about to be evicted anyway
            if len(req.tokens) >= req.max_new_tokens:
                continue        # finishing this iteration regardless
            del self._active[slot]
            self._begin_migration(req)
        stats.set_value("active_slots", len(self._active))

    # the pool gauges' forced cadence: a decode stretch whose page counts
    # do not move publishes once in this many iterations, not every tick
    _POOL_PUBLISH_EVERY = 64

    def _publish_pool_stats(self, force=False):
        in_use = self.cache.pages_in_use
        self._pages_peak = max(self._pages_peak, in_use)
        snap = (in_use, self.cache.free_page_count, self._pages_peak)
        self._pool_iters += 1
        if not force and snap == self._pool_pub and \
                self._pool_iters % self._POOL_PUBLISH_EVERY:
            return
        self._pool_pub = snap
        stats.set_value("kv_pages_in_use", in_use)
        stats.set_value("kv_pages_free", self.cache.free_page_count)
        stats.set_value("kv_pages_peak", self._pages_peak)

    def _decode_step(self):
        """One batched step over ALL slots: the continuous batch."""
        t0 = time.monotonic()
        n_active = len(self._active)
        self._max_active = max(self._max_active, n_active)
        stats.set_value("max_active_slots", self._max_active)
        if self._paged:
            # page-by-page growth: a fresh page only when a row's write
            # position crosses a page boundary (reserved at admission)
            for slot in self._active:
                self.cache.ensure_capacity(slot,
                                           int(self.cache.offsets[slot]))
        tok_in = np.zeros((self.cache.num_slots, 1), np.int32)
        for slot, req in self._active.items():
            tok_in[slot, 0] = req.last_token
        caches = self.cache.layer_caches()
        if self.mirror is not None:
            self.mirror.decode(tok_in, self.cache, {
                slot: (0, self._sampling_knobs([req])
                       if sampling_hostable(req.sampling) else None)
                for slot, req in self._active.items()})
        with self._lora_ctx():
            logits = self.model(torch.tensor(tok_in, device=self.device),
                                caches=caches)
        self.cache.advance(self._active.keys())
        last = logits[:, -1, :]                      # [num_slots, V]
        toks = None
        if all(r.sampling.greedy and not r.sampling.uses_penalty
               for r in self._active.values()):
            toks = torch.argmax(last, dim=-1).cpu().numpy()  # one argmax
        elif self._fused_sampling_ok():
            toks = self._fused_sample(last)     # one call for every slot
        chosen = {}
        for slot, req in list(self._active.items()):
            tok = int(toks[slot]) if toks is not None else \
                self._sample_row(last[slot:slot + 1, :], req)
            chosen[slot] = tok
            self._append_token(req, tok)
        if self.mirror is not None:
            self.mirror.sampled(chosen)
        stats.observe("decode_ms", (time.monotonic() - t0) * 1e3)
        stats.incr("decode_steps")
        stats.incr("slot_steps", self.cache.num_slots)
        stats.incr("slot_steps_active", n_active)
        stats.set_value("active_slots", len(self._active))

    # ---------------- speculative decoding (speculation_k > 0) ----------
    def _can_speculate(self):
        """Speculation engages when every active request samples greedily
        without a repetition penalty (acceptance is an exact argmax match)
        and the verify window's K+1 writes fit every slot's table;
        otherwise the iteration takes the plain step, and the draft's
        teacher forcing (`_known_token`) absorbs the lag."""
        if not self._spec:
            return False
        if self.adapter_pool is not None and any(
                r.adapter_id is not None for r in self._active.values()):
            # the draft has no adapter pool: its proposals would come from
            # the base while the target verifies under the adapter
            return False
        K = self._spec_k
        for req in self._active.values():
            sp = req.sampling
            if not sp.greedy or sp.uses_penalty:
                return False
            if int(self.cache.offsets[req.slot]) + K >= self.cache.capacity:
                return False
        return True

    @staticmethod
    def _known_token(req, pos):
        """The true token at `pos` of a request's sequence (prompt, then
        the emitted tokens): the teacher-forced input of draft positions
        the engine has already committed."""
        if pos < req.prompt.size:
            return int(req.prompt[pos])
        return int(req.tokens[pos - req.prompt.size])

    def _spec_step(self):
        """One speculative window over the continuous batch:

        1. **draft**: K ``[num_slots, 1]`` steps of the draft model on its
           mirror cache propose K tokens a slot.  Positions the engine
           already knows (a draft lagging after a bonus token or a plain
           step) are teacher-forced, so the draft re-converges;
        2. **verify**: ONE ``[num_slots, K+1]`` target call scores
           ``[last_token, d_1..d_K]``; its K+1 argmaxes are the true next
           tokens at every window position;
        3. **accept + rollback**: per slot, the leading run of drafts
           matching the target is accepted, plus the bonus token after it
           (a+1 tokens a window).  Offsets move to the accept boundary
           and `PagedKVCache.rollback` returns the pages wholly past the
           new horizon; rejected K/V left below it stays behind the
           causal bound until overwritten.

        The host reads one argmax after each draft step and one after the
        verify call, and nothing else."""
        K = self._spec_k
        ns = self.cache.num_slots
        active = dict(self._active)
        n_active = len(active)
        self._max_active = max(self._max_active, n_active)
        stats.set_value("max_active_slots", self._max_active)
        tgt_off = {s: int(self.cache.offsets[s]) for s in active}
        d_off0 = {s: int(self.draft_cache.offsets[s]) for s in active}
        draft = self.scfg.draft_model

        # --- draft: K proposer steps on the mirror cache ---
        t0 = time.monotonic()
        prev_out = {s: 0 for s in active}
        draft_out = {s: [] for s in active}
        for j in range(K):
            tok_in = np.zeros((ns, 1), np.int32)
            for s, req in active.items():
                p = d_off0[s] + j
                tok_in[s, 0] = self._known_token(req, p) \
                    if p <= tgt_off[s] else prev_out[s]
                self.draft_cache.ensure_capacity(s, p)
            logits = draft(torch.tensor(tok_in, device=self.device),
                           caches=self.draft_cache.layer_caches())
            self.draft_cache.advance(active.keys())
            toks = torch.argmax(logits[:, -1, :], dim=-1).cpu().numpy()
            for s in active:
                prev_out[s] = int(toks[s])
                draft_out[s].append(int(toks[s]))
        stats.observe("spec_draft_ms", (time.monotonic() - t0) * 1e3)

        # --- verify: one batched K+1 target call ---
        t0 = time.monotonic()
        tok_in = np.zeros((ns, K + 1), np.int32)
        caps = {}
        proposed = 0
        for s, req in active.items():
            # a lagging draft yields fewer usable proposals this window;
            # the tail positions are padding the accept cap rejects
            lag = tgt_off[s] - d_off0[s]
            cap = max(0, K - lag)
            caps[s] = cap
            tok_in[s, 0] = req.last_token
            for i in range(1, K + 1):
                tok_in[s, i] = draft_out[s][lag + i - 1] \
                    if i <= cap else req.last_token
            proposed += cap
            self.cache.ensure_capacity(s, tgt_off[s] + K)
        logits = self.model(torch.tensor(tok_in, device=self.device),
                            caches=self.cache.layer_caches())
        t = torch.argmax(logits, dim=-1).cpu().numpy()      # [ns, K+1]
        stats.observe("spec_verify_ms", (time.monotonic() - t0) * 1e3)

        # --- accept mask + rollback ---
        t0 = time.monotonic()
        accepted = 0
        for s, req in active.items():
            a = 0
            while a < caps[s] and tok_in[s, a + 1] == t[s, a]:
                a += 1
            accepted += a
            for i in range(a + 1):
                self._append_token(req, int(t[s, i]))
                if req.slot is None:    # eos/length/deadline mid-window
                    break               # truncates the rest of it
            if req.slot is None:
                continue                # _release returned the pages
            new_off = tgt_off[s] + a + 1
            self.cache.set_offset(s, new_off)
            self.cache.rollback(s, new_off)
            # the draft cache is valid through the accepted prefix it
            # wrote itself (never past what IT cached this window)
            d_new = min(d_off0[s] + K, new_off)
            self.draft_cache.set_offset(s, d_new)
            self.draft_cache.rollback(s, d_new)
        stats.observe("spec_rollback_ms",
                            (time.monotonic() - t0) * 1e3)
        stats.incr("spec_windows")
        stats.incr("spec_proposed_tokens", proposed)
        stats.incr("spec_accepted_tokens", accepted)
        stats.incr("slot_steps", ns)
        stats.incr("slot_steps_active", n_active)
        stats.set_value("active_slots", len(self._active))

    def _fused_sampling_ok(self):
        """Whether ONE fused call can sample every active slot this
        iteration: the flag is on and each request is greedy or seeded."""
        return _flag("FLAGS_serving_fused_sampling", True) and all(
            sampling_hostable(r.sampling) for r in self._active.values())

    def _sampling_knobs(self, reqs):
        """Per-row knob arrays of `fused_sample_call` for ``reqs`` (row i:
        the i-th request, None for an empty row)."""
        n, vocab = len(reqs), self.cfg.vocab_size
        knobs = dict(temp=np.zeros(n, np.float32), top_k=np.zeros(n, np.int32),
                     top_p=np.ones(n, np.float32),
                     penalty=np.ones(n, np.float32),
                     seen=np.zeros((n, vocab), bool),
                     keys=np.zeros((n, 2), np.int64),
                     counts=np.zeros(n, np.int64))
        for row, req in enumerate(reqs):
            if req is None:
                continue
            sp = req.sampling
            knobs["temp"][row] = sp.temperature
            knobs["top_k"][row] = sp.top_k or 0
            if sp.top_p is not None:
                knobs["top_p"][row] = sp.top_p
            if sp.repetition_penalty is not None:
                knobs["penalty"][row] = sp.repetition_penalty
            knobs["counts"][row] = len(req.tokens)
            if not sp.greedy and sp.seed is not None:
                knobs["keys"][row] = request_key(sp)
            if req.seen is not None:
                knobs["seen"][row] = req.seen
        return knobs

    def _fused_sample(self, last):
        """One sampling call over all slots: exactly the vectorized chain
        the compiled tick runs in its program, so a request's tokens are
        the same whichever lane draws them.  Returns np [num_slots]."""
        reqs = [self._active.get(s) for s in range(self.cache.num_slots)]
        return fused_sample_call(last, **self._sampling_knobs(reqs)) \
            .cpu().numpy()

    def _sample_row(self, logits_row, req):
        """[1, V] logits → one token under the request's params.  A seeded
        non-greedy request draws from its key stream
        ``fold_in(PRNGKey(seed), n_generated)`` (the fused call's and the
        tick's, so its stream is the same in every lane and under every
        flag from token 0); an unseeded one from its own generator.
        (The JAX engine draws a seeded row from its global RNG when
        ``FLAGS_serving_fused_sampling`` is off; the port keeps the seed.)"""
        sp = req.sampling
        if not sp.greedy and sp.seed is not None:
            tok = fused_sample_call(logits_row, **self._sampling_knobs([req]))
            return int(tok.cpu()[0])
        seen = None
        if req.seen is not None:
            seen = torch.from_numpy(req.seen[None, :]).to(logits_row.device)
        nxt = sample_next_token(
            logits_row, temperature=sp.temperature, top_k=sp.top_k,
            top_p=sp.top_p, repetition_penalty=sp.repetition_penalty,
            seen=seen, generator=req.generator)
        return int(nxt.reshape(-1)[0].item())

    def _append_token(self, req, tok):
        """Account one generated token, then finish/evict the request on
        EOS, its token budget, slot capacity or its deadline."""
        self._mut += 1      # host-lane mutation: the tick's mirror is stale
        req.tokens.append(tok)
        req.last_token = tok
        if req.seen is not None:
            req.seen[tok] = True
        stats.incr("tokens_generated")
        now = time.monotonic()
        if self.scfg.deadline_policy == "evict" and \
                req.deadline is not None and now > req.deadline:
            self._fail(req, DeadlineExceededError(
                f"request {req.id} exceeded its deadline after "
                f"{len(req.tokens)} token(s)"))
            stats.incr("requests_evicted_deadline")
            self._release(req)
            return
        reason = None
        if req.eos_token_id is not None and tok == req.eos_token_id:
            reason = "eos"
        elif len(req.tokens) >= req.max_new_tokens:
            reason = "length"
        elif req.prompt.size + len(req.tokens) >= self.max_len:
            reason = "length"       # slot capacity: no room to decode
        if reason is not None:
            self._complete(req, reason, now)
            self._release(req)

    def _complete(self, req, reason, now):
        out = RequestOutput(
            request_id=req.id, prompt_ids=req.prompt,
            output_ids=np.asarray(req.tokens, np.int32),
            finish_reason=reason, ttft_ms=req.ttft_ms,
            latency_ms=(now - req.submit_t) * 1e3)
        with self._lock:
            self._pending.pop(req.id, None)
        if req.future.done():
            return
        try:
            req.future.set_result(out)
        except Exception:       # noqa: BLE001 - lost a race to _fail
            return
        stats.incr("requests_completed")
        if req.trace is not None:
            if req.trace.decode is not None:
                req.trace.decode.set(tokens=len(req.tokens))
            req.trace.finish("ok", out.latency_ms, finish_reason=reason,
                             tokens=len(req.tokens))
        # labelled by the id the request span carries (``rid``), so one
        # request's trace and metrics join
        stats.request_observe("request_tokens", req.id, len(req.tokens),
                              help="tokens generated per request")
        _fr.record("serving", "request_done", request_id=req.id,
                   reason=reason, tokens=len(req.tokens),
                   ttft_ms=round(req.ttft_ms, 3)
                   if req.ttft_ms is not None else None)

    def _fail(self, req, exc):
        with self._lock:
            self._pending.pop(req.id, None)
        if req.future.done():
            return
        try:
            req.future.set_exception(exc)
        except Exception:       # noqa: BLE001 - resolved concurrently
            return
        if req.trace is not None:
            req.trace.finish(type(exc).__name__,
                             (time.monotonic() - req.submit_t) * 1e3,
                             error=str(exc)[:200])
        _fr.record("serving", "request_failed", request_id=req.id,
                   error=type(exc).__name__)

    def _release(self, req):
        if req.slot is None:
            return
        if self._tick is not None:
            self._tick.flush_to_host()
        self._mut += 1          # slot membership changed: the tick rebuilds
        in_active = self._active.get(req.slot) is req
        if in_active:
            del self._active[req.slot]
        if in_active or self._paged:
            # paged requests hold pages from admission on (prefill
            # included); a slot-layout request owns its slot once active
            self.cache.release(req.slot)
            if self._spec:
                self.draft_cache.release(req.slot)
            if req.prefix_nodes and self.prefix_tree is not None:
                self.prefix_tree.release(req.prefix_nodes)
                req.prefix_nodes = []
        if self.adapter_pool is not None:
            self.adapter_pool.clear_row(req.slot)
            if req.adapter_id is not None:
                self.adapter_pool.release(req.adapter_id)
                req.adapter_id = None   # released exactly once
                req.adapter_slot = 0
        req.slot = None

    def _fail_all(self, exc):
        """Fail EVERY outstanding future: queued, mid-admission and
        slot-resident alike."""
        with self._lock:
            reqs = list(self._pending.values())
            self._pending.clear()
            self._queue.clear()
            self._active.clear()
            self._prefilling.clear()
            self._migrating_out.clear()
            self._migration_results.clear()
            self._cancels.clear()
        for req in reqs:
            if not req.future.done():
                self._fail(req, exc)
                stats.incr("requests_cancelled_shutdown")
