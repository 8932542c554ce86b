"""One captured program per scheduler tick (port of
paddle_tpu/serving/compiled_tick.py).

`CompiledServingTick` runs the paged engine's decode iteration over
device-resident scheduler state:

- **state**: last tokens, generated-token buffers, per-slot counts,
  limits and eos ids, alive masks, per-slot sampling knobs (temperature,
  top-k, top-p, repetition penalty, seen masks, per-request keys) and the
  finish codes are fixed-shape tensors allocated once; the page pools,
  the page table and the offsets are the `PagedKVCache`'s own persistent
  tensors.  Host mutations (admission, completion) write into them in
  place;
- **program**: the ``[num_slots, 1]`` model forward, the vectorized
  per-slot logit-processor chain and draw (`choose_tokens`; an all-greedy
  batch takes the plain argmax), the token append, the eos and length
  finish codes and the offset advance.  On the card each mode
  ("greedy", "mixed") is captured once into a CUDA graph
  (`framework.capture.CapturedStep`) and every later tick is one replay;
  on the CPU the same body runs eagerly, as the graph's plain version;
- **host boundary**: each tick reads back ONE ``[num_slots]`` finish-code
  vector, through a pinned buffer and an event.  Admission, completion
  and deadline eviction (a wall-clock decision) are the only times token
  buffers cross to the host.  A tensor-parallel replica's leader
  (``Engine.mirror``, `tp_replica`) also reads the ``[num_slots]`` last
  tokens after the finish codes, for its followers' desync check, and
  hands each tick's mode and a rebuild's host-staged arrays to its
  followers before the replay; each rank replays its own graph, the
  model's mp all-reduces and logits gather inside it.

Typed blockers send an iteration to the uncompiled lane with a
`TickFallbackWarning`, once per kind, and count ``tick.fallbacks`` each
iteration that consulted the tick:

- static ones, known when the tick is built, latch the fallback for the
  tick's life and warn at construction: ``kv_layout="slots"`` (the tick
  runs on the paged cache), speculation (a draft model with
  ``speculation_k > 0``; an all-greedy speculative engine never consults
  the tick, its iterations run `Engine._spec_step`), and on the card a
  tensor-parallel model whose mp group is not NCCL (gloo collectives
  cannot be captured, as `framework.train_step` refuses them);
- per iteration: forward hooks installed (the adapter pool's own LoRA
  hooks excepted), and non-greedy sampling without a per-request
  ``SamplingParams.seed`` (the in-program draw is keyed by
  ``fold_in(PRNGKey(seed), n_generated)``; an unseeded request's
  generator cannot be replayed);
- a mode's first call (`_first_call`), on every device: the body runs
  under `framework.capture.host_read_probe`.  A host read, or an
  exception from the warm-up or the capture, restores what the call
  wrote and latches the uncompiled lane for the tick's life, as the JAX
  tick does on a capture or trace failure: serving never dies on the
  capture.

A replay failure after a mode was captured raises, as JAX's
post-donation failure does, and the engine's restart wrapper rebuilds the
cache and the tick.  The tick publishes ``serving.tick.compiled_hits``,
``tick.fallbacks`` and the decode families through `stats`.
"""
from __future__ import annotations

import time
import warnings
import weakref

import numpy as np
import torch

from ..framework import prng
from ..framework.capture import CapturedStep, host_read_probe
from ..utils.flags import flag as _flag
from . import stats
from .api import DeadlineExceededError, SchedulerStallError


class TickFallbackWarning(UserWarning):
    """Warned once per reason when the compiled serving tick cannot host
    the current scheduler state and the engine runs the uncompiled
    iteration instead."""


# ---------------------------------------------------------------------------
# vectorized per-slot sampling chain (shared by the compiled tick and the
# uncompiled lane's fused sampling call)
# ---------------------------------------------------------------------------

def process_logits_rows(logits, temp, top_k, top_p, penalty, seen):
    """Per-row logit-processor chain over a whole batch at once, in the HF
    order of ``models.generation.apply_logit_processors``: repetition
    penalty, temperature, top-k, top-p, with per-slot knob vectors.

    ``logits`` [ns, V] float; ``temp`` [ns] (0.0 = greedy: the row skips
    temperature, top-k and top-p and keeps its penalized logits for the
    argmax); ``top_k`` [ns] integer (0 = off); ``top_p`` [ns] (>= 1.0 =
    off); ``penalty`` [ns] (1.0 = off); ``seen`` [ns, V] bool emitted
    mask.  Knobs are cast to the logits' dtype, as the JAX chain does."""
    neg_inf = float("-inf")
    vocab = logits.shape[-1]
    pen = penalty[:, None].to(logits.dtype)
    pen_on = (penalty != 1.0)[:, None]
    penalized = torch.where(logits > 0, logits / pen, logits * pen)
    logits = torch.where(pen_on & seen, penalized, logits)
    greedy = temp == 0.0
    safe_t = torch.where(greedy, torch.ones_like(temp), temp) \
        .to(logits.dtype)
    x = logits / safe_t[:, None]
    # top-k: threshold at the row's k-th largest value, k clamped to V
    k = top_k.to(torch.int64).clamp(0, vocab)
    sorted_desc = torch.sort(x, dim=-1, descending=True).values
    kth = sorted_desc.gather(-1, (k - 1).clamp(0, vocab - 1)[:, None])
    x = x.masked_fill((k > 0)[:, None] & (x < kth), neg_inf)
    # top-p: the smallest prefix of the sorted row whose EXCLUSIVE mass is
    # below top_p survives (the first token always does)
    p_on = (top_p < 1.0)[:, None]
    sorted_p = torch.sort(x, dim=-1, descending=True).values
    probs = torch.softmax(sorted_p, dim=-1)
    cum = probs.cumsum(dim=-1)
    keep = (cum - probs) < top_p[:, None].to(probs.dtype)
    minv = sorted_p.masked_fill(~keep, float("inf")).amin(dim=-1,
                                                          keepdim=True)
    x = x.masked_fill(p_on & (x < minv), neg_inf)
    return torch.where(greedy[:, None], logits, x)


def choose_tokens(logits, temp, top_k, top_p, penalty, seen, keys, counts):
    """[ns, V] logits → [ns] int32 next tokens under per-slot params.

    Greedy rows (temp == 0) take the argmax of their (penalized) logits.
    Sampled rows draw ``categorical(fold_in(keys[i], counts[i]), row)``
    (`framework.prng`, bit for bit JAX's stream) from the processed
    logits: the per-request seed makes the stream the same whichever lane
    draws it.  ``keys`` [ns, 2] int64 words, ``counts`` [ns] the tokens
    each row has generated."""
    processed = process_logits_rows(logits, temp, top_k, top_p, penalty,
                                    seen)
    greedy_tok = torch.argmax(processed, dim=-1)
    sampled_tok = prng.categorical(prng.fold_in(keys, counts), processed)
    return torch.where(temp == 0.0, greedy_tok, sampled_tok) \
        .to(torch.int32)


def fused_sample_call(logits, temp, top_k, top_p, penalty, seen, keys,
                      counts):
    """The uncompiled lane's ONE sampling call over every slot:
    `choose_tokens` with the knobs (numpy arrays or tensors) moved to the
    logits' device."""
    dev = logits.device

    def put(a, dtype):
        return torch.as_tensor(a).to(device=dev, dtype=dtype)
    return choose_tokens(logits, put(temp, torch.float32),
                         put(top_k, torch.int32), put(top_p, torch.float32),
                         put(penalty, torch.float32), put(seen, torch.bool),
                         put(keys, torch.int64), put(counts, torch.int64))


def sampling_hostable(sp):
    """Whether the vectorized chain can host this request's sampling:
    greedy always (penalty included); non-greedy only with a per-request
    ``seed`` (the in-program stream is key-derived)."""
    return sp.greedy or sp.seed is not None


def request_key(sp):
    """[2] int64 base key (uint32 words) of a seeded request's stream."""
    return prng.PRNGKey(int(sp.seed)).numpy()


# ---------------------------------------------------------------------------
# the compiled tick
# ---------------------------------------------------------------------------

class CompiledServingTick:
    """Owns the device-resident scheduler state and the per-mode captured
    tick programs of one `Engine` (and its cache: the engine builds a new
    tick with each new cache).

    ``step()`` runs one tick and returns True, or returns False after
    flushing device progress to the host so that the engine's uncompiled
    iteration runs instead.  The tick refers to its engine weakly: a
    dropped engine frees its model and cache at once, not at the next
    cyclic garbage collection."""

    def __init__(self, engine):
        self.eng = weakref.proxy(engine)
        self._warned = set()
        #: mode ("greedy", "mixed") -> its `CapturedStep`
        self.steps = {}
        #: mode -> ms of its first tick (on the card: warm-up and capture,
        #: which the live requests wait for, then the first replay)
        self.first_tick_ms = {}
        self._ahead = False            # device tokens not yet on the host
        #: the host arrays of the last rebuild, not yet sent to a tensor
        #: parallel replica's other ranks (None: nothing to send)
        self.staged = None
        #: why this tick latched the uncompiled lane for its life (a static
        #: blocker, or a mode's first call that failed), or None
        self.fallback_reason = None
        blk = self._static_blocker()
        if blk is not None:
            self._note_fallback(*blk, permanent=True)
            return
        cache = engine.cache
        ns, width = cache.num_slots, engine.max_len
        dev = engine.device
        self._rep = {}                 # slot -> request at the last rebuild
        self._mut_seen = -1            # engine mutation count synced
        self._h_counts = np.zeros(ns, np.int64)   # host mirror of counts
        self._stale = True             # device state must be rebuilt

        def zeros(*shape, dtype=torch.int32):
            return torch.zeros(shape, dtype=dtype, device=dev)
        self._state = {
            "last": zeros(ns), "counts": zeros(ns), "limits": zeros(ns),
            "eos": zeros(ns), "alive": zeros(ns, dtype=torch.bool),
            "temp": zeros(ns, dtype=torch.float32), "topk": zeros(ns),
            "topp": zeros(ns, dtype=torch.float32),
            "pen": zeros(ns, dtype=torch.float32),
            "keys": zeros(ns, 2, dtype=torch.int64),
            "seen": zeros(ns, engine.cfg.vocab_size, dtype=torch.bool),
            "out": zeros(ns, width), "fin": zeros(ns)}
        self._rows = torch.arange(ns, device=dev)
        self._pool = self._stream = None
        self._fin_host = self._event = None
        if dev.type == "cuda":
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = engine._tick_stream
            self._fin_host = torch.empty(ns, dtype=torch.int32,
                                         pin_memory=True)
            self._event = torch.cuda.Event()

    # ------------------------------------------------------------------
    # eligibility and fallback accounting
    # ------------------------------------------------------------------

    def _note_fallback(self, kind, reason, permanent=False):
        stats.incr("tick.fallbacks")
        if permanent:
            self.fallback_reason = reason
        if kind not in self._warned:
            self._warned.add(kind)
            warnings.warn(
                f"compiled serving tick disabled ({reason}); running the "
                "uncompiled scheduler iteration", TickFallbackWarning)

    def _static_blocker(self):
        """(kind, reason) for a configuration the tick can never host,
        known when it is built; None otherwise."""
        eng = self.eng
        if not eng._paged:
            return ("layout", "kv_layout='slots' — the compiled tick runs "
                    "on the paged cache")
        if eng._spec:
            return ("spec", "speculative decoding configured "
                    "(draft_model + speculation_k > 0)")
        if eng.device.type == "cuda":
            import torch.distributed as dist

            from ..distributed import topology
            mp = topology.mp_group()
            if mp is not None and mp.nranks > 1 and \
                    dist.get_backend(mp.process_group) != "nccl":
                return ("capture", f"the model's mp collectives run on "
                        f"{dist.get_backend(mp.process_group)}, which "
                        "cannot be captured in a CUDA graph (use nccl)")
        return None

    def _blocker(self):
        """(kind, reason) for the current scheduler state, or None when
        this tick can run compiled."""
        eng = self.eng
        for mod in eng.model.modules():
            own = getattr(mod, "_lora_serving_hook", None)
            if mod._forward_pre_hooks or \
                    any(h != own for h in mod._forward_hooks):
                return ("hooks", "module forward hooks installed")
        for req in eng._active.values():
            if not sampling_hostable(req.sampling):
                return ("sampling", "non-greedy sampling without a "
                        "per-request SamplingParams.seed — the vectorized "
                        "in-program chain cannot reproduce a generator's "
                        "draws")
        return None

    # ------------------------------------------------------------------
    # the tick body
    # ------------------------------------------------------------------

    def _body(self, mode):
        """One tick over the persistent state, every write in place.
        Dead and prefilling rows feed token 0 like the uncompiled step;
        their writes land at their offsets, which the scratch page or the
        next prefill chunk overwrites."""
        eng = self.eng
        cache = eng.cache
        st = self._state
        alive, last, counts, out = st["alive"], st["last"], st["counts"], \
            st["out"]
        tok_in = torch.where(alive, last, torch.zeros_like(last))[:, None]
        with eng._lora_ctx():
            logits = eng.model(tok_in, caches=cache.layers)[:, -1, :]
        if mode == "greedy":
            # the batched-argmax fast path: the uncompiled lane's argmax
            # over the raw last-position logits
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
        else:
            tok = choose_tokens(logits, st["temp"], st["topk"], st["topp"],
                                st["pen"], st["seen"], st["keys"], counts)
        tok = torch.where(alive, tok, last)
        rows = self._rows
        idx = counts.clamp(0, out.shape[1] - 1).long()
        out[rows, idx] = torch.where(alive, tok, out[rows, idx])
        tok_l = tok.long()
        st["seen"][rows, tok_l] = st["seen"][rows, tok_l] | alive
        new_counts = counts + alive.to(counts.dtype)
        eos = st["eos"]
        eos_hit = alive & (eos >= 0) & (tok == eos)
        len_hit = alive & (new_counts >= st["limits"])
        fin = torch.where(eos_hit, 1, torch.where(len_hit, 2, 0))
        st["fin"].copy_(fin)
        cache.device_offsets.add_(alive.to(torch.int32))
        last.copy_(tok)
        counts.copy_(new_counts)
        alive.logical_and_(fin == 0)

    def _step_for(self, mode):
        step = self.steps.get(mode)
        if step is None:
            st = self._state
            mutable = [st[k] for k in ("last", "counts", "alive", "seen",
                                       "out", "fin")]
            mutable.append(self.eng.cache.device_offsets)
            # the graph's body holds the tick weakly: no reference cycle
            # keeps a dropped tick and its graphs' pool alive (a restart
            # drops the tick before it captures a new one)
            ref = weakref.ref(self)
            step = self.steps[mode] = CapturedStep(
                lambda: ref()._body(mode), mutable, self.eng.device,
                pool=self._pool, stream=self._stream)
        return step

    def graph_stats(self):
        """{mode: (captures, replays, launches per replay)}; a mode is
        captured once, at its first tick on the card."""
        return {m: (int(s.graph is not None), s.replays, dict(s.launches))
                for m, s in self.steps.items()}

    def graph_collectives(self):
        """{mode: {op: (calls, bytes) per replay}}: a tensor-parallel
        model's collectives inside each mode's graph."""
        return {m: dict(s.collectives) for m, s in self.steps.items()}

    # ------------------------------------------------------------------
    # host <-> device state sync
    # ------------------------------------------------------------------

    def flush_to_host(self):
        """Materialize device-side token progress into the request
        objects (what the uncompiled lane, cancellation, release and
        shutdown need before they touch a request).  Token, seen and last
        bookkeeping only: stats were counted per tick."""
        if not self._ahead:
            return
        self._ahead = False
        self._stale = True
        eng = self.eng
        out_np = self._state["out"].cpu().numpy()
        for slot, req in self._rep.items():
            if eng._active.get(slot) is not req:
                continue
            have = len(req.tokens)
            for tok in out_np[slot, have:int(self._h_counts[slot])].tolist():
                req.tokens.append(tok)
                req.last_token = tok
                if req.seen is not None:
                    req.seen[tok] = True

    def _rebuild(self):
        """Write the scheduler state from the request objects into the
        persistent tensors, in place (the admission/completion host
        boundary)."""
        eng = self.eng
        ns = eng.cache.num_slots
        host = {
            "last": np.zeros(ns, np.int32), "counts": np.zeros(ns, np.int32),
            "limits": np.full(ns, np.iinfo(np.int32).max, np.int32),
            "eos": np.full(ns, -1, np.int32), "alive": np.zeros(ns, bool),
            "temp": np.zeros(ns, np.float32), "topk": np.zeros(ns, np.int32),
            "topp": np.ones(ns, np.float32), "pen": np.ones(ns, np.float32),
            "keys": np.zeros((ns, 2), np.int64),
            "seen": np.zeros(tuple(self._state["seen"].shape), bool),
            "out": np.zeros(tuple(self._state["out"].shape), np.int32)}
        for slot, req in eng._active.items():
            host["alive"][slot] = True
            host["last"][slot] = req.last_token
            n = len(req.tokens)
            host["counts"][slot] = n
            host["out"][slot, :n] = req.tokens
            host["limits"][slot] = min(req.max_new_tokens,
                                       eng.max_len - req.prompt.size)
            if req.eos_token_id is not None:
                host["eos"][slot] = req.eos_token_id
            sp = req.sampling
            host["temp"][slot] = sp.temperature
            host["topk"][slot] = sp.top_k or 0
            if sp.top_p is not None:
                host["topp"][slot] = sp.top_p
            if sp.repetition_penalty is not None:
                host["pen"][slot] = sp.repetition_penalty
            if not sp.greedy and sp.seed is not None:
                host["keys"][slot] = request_key(sp)
            if req.seen is not None:
                host["seen"][slot] = req.seen
        for name, arr in host.items():
            self._state[name].copy_(torch.from_numpy(arr))
        # a tensor-parallel replica's other ranks copy the same arrays
        # into their ticks' state (`tp_replica`)
        self.staged = host if eng.mirror is not None else None
        self._h_counts = host["counts"].astype(np.int64)
        self._rep = dict(eng._active)
        self._mut_seen = eng._mut
        self._stale = False

    # ------------------------------------------------------------------
    # a mode's first call and its fallback
    # ------------------------------------------------------------------

    def _first_call(self, mode):
        """A mode's first tick.  On the card the body's warm-up runs under
        the host-read probe, then the graph is captured and replayed; on
        the CPU the body itself, the tick, runs under the probe.  A host
        read, or an exception from the warm-up or the capture, abandons
        the tick (`_abandon`) and latches the uncompiled lane with one
        `TickFallbackWarning`.  Returns whether the tick ran."""
        step = self._step_for(mode)
        saved = self._snapshot()
        try:
            with host_read_probe(self.eng.device) as probe:
                if self._stream is None:
                    step()
                else:
                    step.warm_up()
            found = probe.found
            if found is None and self._stream is not None:
                step()                  # capture, then the first replay
        except SchedulerStallError:
            raise       # the watchdog's, for the restart wrapper
        except Exception as exc:  # noqa: BLE001 - latched and warned
            found = f"{type(exc).__name__}: {exc}"
        if found is None:
            return True
        self._abandon(saved)
        self._note_fallback("capture", f"tick capture failed ({mode}): "
                            f"{found}", permanent=True)
        return False

    def _snapshot(self):
        """Copies of what a tick writes: the tick's mutable state, the
        device offsets, and each slot's cache row at its offset (K, V and,
        quantized, their scales) in every layer."""
        st, cache = self._state, self.eng.cache
        tensors = [st[k] for k in ("last", "counts", "alive", "seen", "out",
                                   "fin")] + [cache.device_offsets]
        saved = [(t, None, t.clone()) for t in tensors]
        off = cache.device_offsets.long()
        page = cache.device_table.long().gather(
            1, (off // cache.page_size)[:, None])[:, 0]
        at = (page, off % cache.page_size)
        for lay in cache.layers:
            for name in ("k_pool", "v_pool", "k_scale", "v_scale"):
                t = lay.get(name)
                if t is not None:
                    # float8 rows through a byte view, as the cache stores
                    t = t.view(torch.uint8) if t.element_size() == 1 else t
                    saved.append((t, at, t[at].clone()))
        return saved

    def _abandon(self, saved):
        """Undo a failed first call: wait for the side stream, put back
        what `_snapshot` copied, bring earlier ticks' tokens to the host,
        and drop the tick's graphs, their memory pool and its state, so
        that the uncompiled lane reads the cache as the tick found it."""
        eng = self.eng
        if self._stream is not None:
            torch.cuda.current_stream(eng.device).wait_stream(self._stream)
            with torch.cuda.stream(self._stream):
                if torch.cuda.is_current_stream_capturing():
                    raise RuntimeError("the tick's side stream is still "
                                       "capturing after a failed capture")
        for t, at, copy in saved:
            if at is None:
                t.copy_(copy)
            else:
                t[at] = copy
        self.flush_to_host()
        self.steps = {}
        self._pool = None
        self._state = None
        self._rep = {}

    # ------------------------------------------------------------------
    # one tick
    # ------------------------------------------------------------------

    def step(self):
        eng = self.eng
        if not _flag("FLAGS_compiled_tick", True):
            self.flush_to_host()        # flag flipped mid-run
            return False
        if self.fallback_reason is not None:
            stats.incr("tick.fallbacks")
            return False
        blk = self._blocker()
        if blk is not None:
            self.flush_to_host()
            self._note_fallback(*blk)
            return False
        if eng._mut != self._mut_seen or self._stale:
            self.flush_to_host()
            self._rebuild()
        return self._run()

    def _run(self):
        eng = self.eng
        cache = eng.cache
        # decode_ms spans the replay and the fin read, as the JAX tick's
        # does; a flush and rebuild before it count in tick_ms only
        t0 = time.monotonic()
        active = dict(eng._active)
        slots = list(active)
        eng._max_active = max(eng._max_active, len(active))
        stats.set_value("max_active_slots", eng._max_active)
        # page-by-page growth exactly like the uncompiled step (reserved
        # at admission), then the table and offsets copied in place
        for slot in slots:
            cache.ensure_capacity(slot, int(cache.offsets[slot]))
        cache.layer_caches()
        mode = "greedy" if all(
            r.sampling.greedy and not r.sampling.uses_penalty
            for r in active.values()) else "mixed"
        first = mode not in self.steps
        mirror = eng.mirror
        if mirror is not None:
            mirror.tick(mode, self.staged, cache, slots)
            self.staged = None
        if first:
            if not self._first_call(mode):
                return False
        else:
            self.steps[mode]()
        fin = self._state["fin"]
        if self._fin_host is not None:
            # the tick's one device→host read, through pinned memory
            self._fin_host.copy_(fin, non_blocking=True)
            self._event.record()
            self._event.synchronize()
            fin_np = self._fin_host.numpy().copy()
        else:
            fin_np = fin.numpy().copy()
        if mirror is not None:
            last = self._state["last"].cpu().numpy()
            mirror.sampled({s: int(last[s]) for s in slots},
                           fin={s: int(fin_np[s]) for s in slots})
        # the device offsets advanced in place; the host mirror follows
        cache.absorb_tick(slots)
        self._h_counts[slots] += 1
        self._ahead = True
        ms = (time.monotonic() - t0) * 1e3
        stats.observe("decode_ms", ms)
        if first:
            self.first_tick_ms[mode] = ms
        stats.incr("decode_steps")
        stats.incr("tick.compiled_hits")
        stats.incr("slot_steps", cache.num_slots)
        stats.incr("slot_steps_active", len(active))
        stats.incr("tokens_generated", len(active))

        now = time.monotonic()
        evict = eng.scfg.deadline_policy == "evict"
        late = [evict and r.deadline is not None and now > r.deadline
                for r in active.values()]
        if any(late) or fin_np[slots].any():
            self.flush_to_host()
            for (slot, req), past in zip(active.items(), late):
                if past:
                    # the uncompiled lane's per-token deadline granularity,
                    # and its precedence over eos and length
                    eng._fail(req, DeadlineExceededError(
                        f"request {req.id} exceeded its deadline after "
                        f"{len(req.tokens)} token(s)"))
                    stats.incr("requests_evicted_deadline")
                    eng._release(req)
                elif fin_np[slot]:
                    eng._complete(req, "eos" if fin_np[slot] == 1
                                  else "length", now)
                    eng._release(req)
        stats.set_value("active_slots", len(eng._active))
        return True
