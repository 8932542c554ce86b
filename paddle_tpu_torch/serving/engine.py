"""Continuous-batching inference engine with a paged KV cache (port of
paddle_tpu/serving/engine.py, the ``kv_layout="paged"`` scheduler).

A background scheduler thread, in each iteration:

1. admits queued requests into free slots, matching each prompt against
   the prefix tree so shared prompt pages are reused, not recomputed;
2. runs ONE batched ``[num_slots, prefill_chunk_tokens]`` prefill-chunk
   call for every request still prefilling, sampling a request's first
   token when its prompt is fully cached;
3. runs ONE batched ``[num_slots, 1]`` decode step over every slot (free
   slots ride along on the scratch page), with one batched argmax when
   every active request is greedy and per-row sampling otherwise;
4. completes futures on EOS, max-tokens, slot capacity or deadline.

The JAX engine's compiled scheduler tick, fused sampling call,
speculation, LoRA, migration/drain, stall watchdog, scheduler restarts and
tracing are not ported yet (ROADMAP Queue A).  A crash of the scheduler
fails every outstanding future with the error and stops the engine.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from concurrent.futures import Future

import numpy as np
import torch

from ..models.generation import sample_next_token
from .api import (DeadlineExceededError, EngineShutdownError,
                  QueueFullError, RequestCancelledError, RequestOutput,
                  SamplingParams, ServingConfig)
from .paged_kv import PagedKVCache, PrefixTree
from .stats import ServingStats


class _Request:
    __slots__ = ("id", "prompt", "max_new_tokens", "sampling",
                 "eos_token_id", "deadline", "future", "submit_t",
                 "ttft_ms", "tokens", "seen", "last_token", "slot",
                 "prefill_pos", "shared_len", "prefix_nodes", "first_tok",
                 "generator")

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
        self.first_tok = None       # sampled first token, not yet appended
        self.generator = generator  # this request's sampling stream


class Engine:
    """``Engine(model, config).start()``; then `submit` (async, returns a
    ``Future[RequestOutput]``) or `generate` (sync).  `shutdown` stops the
    scheduler and fails every queued or in-flight future with
    `EngineShutdownError`.  The engine runs on the model's device."""

    def __init__(self, model, config: ServingConfig | None = None):
        self.model = model
        self.cfg = model.config
        self.scfg = (config or ServingConfig()).validate()
        model.eval()                # serving never wants dropout
        self.device = next(model.parameters()).device
        self.max_len = self.scfg.max_seq_len or self.cfg.max_seq_len
        self._kv_heads = self.cfg.num_kv_heads
        self._page_size = self.scfg.page_size
        self._stats = ServingStats()
        self._queue: deque[_Request] = deque()
        self._active: dict[int, _Request] = {}
        # requests holding a slot whose prompt is mid-(chunked-)prefill
        self._prefilling: deque[_Request] = deque()
        self.prefix_tree = None
        self._max_active = 0
        self._pages_peak = 0
        # EVERY unresolved request, from submit() until its future
        # resolves: the audit set _fail_all drains (a request popped for
        # admission is in neither _queue nor _active)
        self._pending: dict[int, _Request] = {}
        self._lock = threading.RLock()
        self._work = threading.Condition(self._lock)
        self._running = False
        self._thread = None
        self._ids = itertools.count()
        self._cancels: set[int] = set()
        self.cache = None

    # ---------------- lifecycle ----------------
    def start(self):
        with self._lock:
            if self._running:
                return self
            self._stats.reset()
            self.cache = self._new_cache()
            self._max_active = 0
            self._running = True
        self._thread = threading.Thread(
            target=self._loop, name="paddle-tpu-torch-serving", daemon=True)
        self._thread.start()
        return self

    def _new_cache(self):
        cache = PagedKVCache(
            self.cfg.num_layers, self.scfg.num_slots, self.max_len,
            self._kv_heads, self.cfg.head_dim, page_size=self._page_size,
            num_pages=self.scfg.kv_pool_pages,
            dtype=self.scfg.cache_dtype, device=self.device)
        self.prefix_tree = PrefixTree(self._page_size) \
            if self.scfg.enable_prefix_cache else None
        # every prefill chunk call is this wide
        self._chunk = min(self.scfg.prefill_chunk_tokens, cache.capacity)
        self._prefilling.clear()
        self._pages_peak = 0
        return cache

    def shutdown(self, wait_s=30.0):
        """Stop the scheduler; queued and in-flight futures resolve with
        `EngineShutdownError`, and the scheduler thread is joined."""
        with self._work:
            self._running = False
            self._work.notify_all()
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
        self._fail_all(EngineShutdownError("engine shut down"))

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.shutdown()

    # ---------------- client API ----------------
    def submit(self, prompt_ids, max_new_tokens=None, sampling=None,
               eos_token_id=None, deadline_s=None):
        """Enqueue one request; returns a ``Future[RequestOutput]``.
        Raises `QueueFullError` when the bounded queue is full and
        ``ValueError`` for prompts a slot cannot hold."""
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
        # infeasible requests are rejected up front: admission
        # backpressure only helps when the pool could EVER fit it
        psz = self._page_size
        pool = self.scfg.kv_pool_pages or \
            self.scfg.num_slots * (-(-self.max_len // psz))
        need = -(-min(prompt.size + max_new, self.max_len) // psz)
        if need > pool:
            raise ValueError(
                f"request needs {need} KV pages (prompt {prompt.size} + "
                f"max_new {max_new}) but the pool holds {pool}; raise "
                "ServingConfig.kv_pool_pages")
        gen = None
        if not sampling.greedy:
            gen = torch.Generator(device=self.device)
            if sampling.seed is not None:
                gen.manual_seed(int(sampling.seed))
            else:
                gen.seed()
        deadline = (time.monotonic() + deadline_s) \
            if deadline_s is not None else None
        req = _Request(next(self._ids), prompt, max_new, sampling,
                       eos_token_id, deadline, gen)
        with self._work:
            if not self._running:
                raise EngineShutdownError(
                    "engine is not running (call start())")
            if len(self._queue) >= self.scfg.max_queue:
                self._stats.incr("requests_rejected_queue_full")
                raise QueueFullError(
                    f"request queue is full ({self.scfg.max_queue} "
                    "waiting); retry later or raise "
                    "ServingConfig.max_queue")
            self._queue.append(req)
            self._pending[req.id] = req
            self._stats.incr("requests_submitted")
            self._stats.set_value("queue_depth", len(self._queue))
            self._work.notify()
        req.future.request_id = req.id       # cancel()'s handle
        return req.future

    def generate(self, prompt_ids, max_new_tokens=None, sampling=None,
                 eos_token_id=None, deadline_s=None, timeout=None):
        """Sync client: submit + wait.  Returns a `RequestOutput`."""
        fut = self.submit(prompt_ids, max_new_tokens=max_new_tokens,
                          sampling=sampling, eos_token_id=eos_token_id,
                          deadline_s=deadline_s)
        return fut.result(timeout or self.scfg.request_timeout_s)

    def cancel(self, request_id):
        """Cancel one pending request (``future.request_id``).  A queued
        request fails with `RequestCancelledError` here; a slot-resident
        one is unwound by the scheduler in its next iteration.  Returns
        False when the request is unknown or already resolved."""
        with self._work:
            req = self._pending.get(request_id)
            if req is None or req.future.done():
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
            self._stats.incr("requests_cancelled")
            self._stats.set_value("queue_depth", len(self._queue))
            return True

    def _process_cancels_locked(self):
        if not self._cancels:
            return
        cancels, self._cancels = self._cancels, set()
        for cid in cancels:
            req = self._pending.get(cid)
            if req is None:
                continue
            try:
                self._prefilling.remove(req)
            except ValueError:
                pass
            self._fail(req, RequestCancelledError(
                f"request {req.id} cancelled"))
            self._stats.incr("requests_cancelled")
            self._release(req)
        self._stats.set_value("active_slots", len(self._active))

    def stats(self):
        """A snapshot of the engine's counters (`ServingStats.snapshot`)."""
        return self._stats.snapshot()

    # ---------------- scheduler ----------------
    def _loop(self):
        try:
            with torch.no_grad():
                self._loop_once()
        except BaseException as exc:   # noqa: BLE001 - reported, re-raised
            with self._work:
                self._running = False
            self._fail_all(exc)
            raise
        finally:
            self._fail_all(EngineShutdownError("engine shut down"))
            self._stats.set_value("active_slots", 0)
            self._stats.set_value("queue_depth", 0)

    def _loop_once(self):
        while True:
            with self._work:
                if not self._running:
                    break
                self._process_cancels_locked()
                self._expire_queued_locked()
                admits = []
                while self._queue and self.cache.free_slots:
                    slot = self._try_admit_paged(self._queue[0])
                    if slot is None:
                        break           # page backpressure: FIFO
                    admits.append((self._queue.popleft(), slot))
                self._stats.set_value("queue_depth", len(self._queue))
                if not admits and not self._active \
                        and not self._prefilling:
                    self._work.wait(self.scfg.idle_wait_s)
                    continue
            t_tick = time.monotonic()
            for req, slot in admits:
                self._start_prefill(req, slot)
            # ONE batched chunk call covers every prefilling request,
            # then the decode step runs: a long prompt never blocks the
            # in-flight streams for more than a chunk
            if self._prefilling:
                self._prefill_round()
            if self._active:
                self._decode_step()
            self._publish_pool_stats()
            self._stats.observe("tick_ms",
                                (time.monotonic() - t_tick) * 1e3)

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
                self._stats.incr("requests_evicted_deadline")
            else:
                keep.append(req)
        self._queue = keep

    def _try_admit_paged(self, req):
        """Reserve a slot and the request's worst-case page budget (under
        the lock).  The prefix tree's shared pages shrink the
        reservation; LRU zero-ref tree pages are evicted under pressure.
        Returns the slot, or None (the request stays queued)."""
        psz = self._page_size
        total = min(req.prompt.size + req.max_new_tokens, self.max_len)
        nodes, pages = [], []
        if self.prefix_tree is not None:
            nodes, pages = self.prefix_tree.match(req.prompt)
        need = -(-total // psz) - len(pages)
        short = need - self.cache.available_pages
        if short > 0 and self.prefix_tree is not None:
            freed = self.prefix_tree.evict(short, self.cache.reclaim)
            if freed:
                self._stats.incr("prefix_cache_evictions", freed)
        slot = self.cache.allocate(need, pages)
        if slot is None:
            if nodes:
                self.prefix_tree.release(nodes)
            return None
        if self.prefix_tree is not None:
            self._stats.incr("prefix_cache_hits" if pages
                             else "prefix_cache_misses")
            if pages:
                self._stats.incr("prefix_cache_hit_tokens", len(pages) * psz)
        req.prefix_nodes = nodes
        req.shared_len = len(pages) * psz
        return slot

    def _start_prefill(self, req, slot):
        """Arm chunked prefill: the slot's clock starts at the shared
        prefix length, whose pages came from the tree."""
        req.slot = slot
        req.prefill_pos = req.shared_len
        req.first_tok = None
        self.cache.set_offset(slot, req.shared_len)
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
                    self._stats.incr("requests_evicted_deadline")
                    self._release(req)
        if not self._prefilling:
            return
        reqs = list(self._prefilling)       # each holds a slot: <= B
        chunk = self._chunk
        tgt = [r for r in reqs if r.prefill_pos < r.prompt.size]
        if tgt:
            logits, starts = self._prefill_chunk_call(
                tgt, [r.prefill_pos for r in tgt])
            for row, req in enumerate(tgt):
                plen = req.prompt.size
                start = starts[row]
                req.prefill_pos = min(start + chunk, plen)
                self.cache.set_offset(req.slot, req.prefill_pos)
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
                req.ttft_ms = (time.monotonic() - req.submit_t) * 1e3
                self._stats.observe("ttft_ms", req.ttft_ms)
                self._stats.incr("prefill_steps")
                if self.prefix_tree is not None:
                    self.prefix_tree.insert(req.prompt, self.cache,
                                            req.slot, req.prefix_nodes)
        for req in reqs:
            if req.prefill_pos < req.prompt.size or req.first_tok is None:
                continue
            self._prefilling.remove(req)
            tok, req.first_tok = req.first_tok, None
            self._active[req.slot] = req
            self._append_token(req, tok)
        self._stats.set_value("active_slots", len(self._active))

    def _prefill_chunk_call(self, reqs, offs):
        """One batched ``[num_slots, chunk]`` prefill-chunk call for
        `reqs` at per-request progress `offs`; returns (logits, starts)."""
        cache = self.cache
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
        views = cache.prefill_view([r.slot for r in reqs], starts)
        logits = self.model(torch.tensor(tokens, device=self.device),
                            caches=views)
        cache.absorb_view(views)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)   # time the device work
        dt_ms = (time.monotonic() - t0) * 1e3
        self._stats.observe("prefill_chunk_ms", dt_ms)
        self._stats.observe("prefill_ms", dt_ms)
        self._stats.incr("prefill_chunks", len(reqs))
        self._stats.incr("prefill_calls")
        return logits, starts

    def _publish_pool_stats(self):
        in_use = self.cache.pages_in_use
        self._pages_peak = max(self._pages_peak, in_use)
        self._stats.set_value("kv_pages_in_use", in_use)
        self._stats.set_value("kv_pages_free", self.cache.free_page_count)
        self._stats.set_value("kv_pages_peak", self._pages_peak)

    def _decode_step(self):
        """One batched step over ALL slots: the continuous batch."""
        t0 = time.monotonic()
        n_active = len(self._active)
        self._max_active = max(self._max_active, n_active)
        self._stats.set_value("max_active_slots", self._max_active)
        # page-by-page growth: a fresh page only when a row's write
        # position crosses a page boundary (reserved at admission)
        for slot in self._active:
            self.cache.ensure_capacity(slot, int(self.cache.offsets[slot]))
        tok_in = np.zeros((self.cache.num_slots, 1), np.int32)
        for slot, req in self._active.items():
            tok_in[slot, 0] = req.last_token
        logits = self.model(torch.tensor(tok_in, device=self.device),
                            caches=self.cache.layer_caches())
        self.cache.advance(self._active.keys())
        last = logits[:, -1, :]                      # [num_slots, V]
        toks = None
        if all(r.sampling.greedy and not r.sampling.uses_penalty
               for r in self._active.values()):
            toks = torch.argmax(last, dim=-1).cpu().numpy()  # one argmax
        for slot, req in list(self._active.items()):
            tok = int(toks[slot]) if toks is not None else \
                self._sample_row(last[slot:slot + 1, :], req)
            self._append_token(req, tok)
        self._stats.observe("decode_ms", (time.monotonic() - t0) * 1e3)
        self._stats.incr("decode_steps")
        self._stats.incr("slot_steps", self.cache.num_slots)
        self._stats.incr("slot_steps_active", n_active)
        self._stats.set_value("active_slots", len(self._active))

    def _sample_row(self, logits_row, req):
        """[1, V] logits → one token under the request's params, drawn
        from the request's own generator."""
        sp = req.sampling
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
        req.tokens.append(tok)
        req.last_token = tok
        if req.seen is not None:
            req.seen[tok] = True
        self._stats.incr("tokens_generated")
        now = time.monotonic()
        if self.scfg.deadline_policy == "evict" and \
                req.deadline is not None and now > req.deadline:
            self._fail(req, DeadlineExceededError(
                f"request {req.id} exceeded its deadline after "
                f"{len(req.tokens)} token(s)"))
            self._stats.incr("requests_evicted_deadline")
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
        self._stats.incr("requests_completed")

    def _fail(self, req, exc):
        with self._lock:
            self._pending.pop(req.id, None)
        if req.future.done():
            return
        try:
            req.future.set_exception(exc)
        except Exception:       # noqa: BLE001 - resolved concurrently
            return

    def _release(self, req):
        if req.slot is None:
            return
        if self._active.get(req.slot) is req:
            del self._active[req.slot]
        # paged requests hold pages from admission on, prefill included
        self.cache.release(req.slot)
        if req.prefix_nodes and self.prefix_tree is not None:
            self.prefix_tree.release(req.prefix_nodes)
            req.prefix_nodes = []
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
            self._cancels.clear()
        for req in reqs:
            if not req.future.done():
                self._fail(req, exc)
                self._stats.incr("requests_cancelled_shutdown")
