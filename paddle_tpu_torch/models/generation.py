"""Incremental decoding (port of paddle_tpu/models/generation.py): dense
KV caches and the generation loops shared by the model families, and the
logit processors and token sampling that the serving engine shares.

- `init_kv_caches`: per-layer ``{"k", "v", "offset"}`` dicts of ``[B,
  max_len, H_kv, D]`` caches (fp32 by default, as JAX keeps them for a
  bf16 model) with a host clock: the offset is a CPU int32 tensor, a
  scalar or one per row (``per_row_offsets``), so
  `incubate.nn.functional.masked_multihead_attention` checks every write
  against the capacity without reading the card;
- `generate`: greedy or sampled decoding, over the caches
  (``use_cache=True``: a prefill, then one ``[B, 1]`` step a token) or
  over the full forward a token (``use_cache=False``);
- `speculative_generate`: greedy draft-model speculation, every emitted
  token the target's argmax;
- `beam_search`: log-prob beams over the full forward.

The loops' bookkeeping (`_EosTracker`, the beams, the accept runs) is
host numpy, as in the JAX package: beam scores in float64 and ranked by
numpy's own ``np.argsort``, so ties break as they do there.  Draws come
from an explicit ``torch.Generator`` on the model's device (None: the
package's own, `nn.functional.default_generator`), never torch's global
RNG.  A seeded serving request draws from the key stream of
``serving.compiled_tick.choose_tokens`` instead.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device, to_torch_dtype
from ..nn.functional import default_generator


def apply_logit_processors(logits_last, temperature=1.0, top_k=None,
                           top_p=None, repetition_penalty=None, seen=None):
    """[B, V] → [B, V] processed logits, in HF order: repetition penalty
    (also for greedy) → temperature → top-k → top-p.  ``seen`` is the
    [B, V] bool mask of tokens already emitted."""
    if repetition_penalty is not None and repetition_penalty != 1.0 \
            and seen is not None:
        penalized = torch.where(logits_last > 0,
                                logits_last / repetition_penalty,
                                logits_last * repetition_penalty)
        logits_last = torch.where(seen, penalized, logits_last)
    if temperature == 0.0:
        return logits_last          # greedy: argmax is scale-invariant
    logits_last = logits_last / temperature
    if top_k is not None:
        k = min(int(top_k), logits_last.shape[-1])
        minv = torch.topk(logits_last, k, dim=-1).values[:, -1:]
        logits_last = logits_last.masked_fill(logits_last < minv,
                                              float("-inf"))
    if top_p is not None and top_p < 1.0:
        sorted_logits = torch.sort(logits_last, dim=-1,
                                   descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = probs.cumsum(dim=-1)
        # keep the smallest prefix whose mass reaches top_p (the first
        # token always survives: its exclusive prefix mass is 0)
        keep = (cum - probs) < top_p
        minv = sorted_logits.masked_fill(~keep, float("inf")) \
            .min(dim=-1, keepdim=True).values
        logits_last = logits_last.masked_fill(logits_last < minv,
                                              float("-inf"))
    return logits_last


def sample_next_token(logits_last, temperature=0.0, top_k=None, top_p=None,
                      repetition_penalty=None, seen=None, *, generator=None):
    """[B, V] → [B] next tokens: `apply_logit_processors`, then argmax
    (temperature 0) or a multinomial draw from ``generator``."""
    logits_last = apply_logit_processors(
        logits_last, temperature=temperature, top_k=top_k, top_p=top_p,
        repetition_penalty=repetition_penalty, seen=seen)
    if temperature == 0.0:
        return torch.argmax(logits_last, dim=-1)
    probs = torch.softmax(logits_last.float(), dim=-1)
    return torch.multinomial(probs, 1, generator=generator).reshape(-1)


def init_kv_caches(num_layers, batch, max_len, num_heads, head_dim,
                   dtype="float32", per_row_offsets=False, *, device=None):
    """Per-layer ``{"k", "v", "offset"}`` dicts: ``[B, max_len, H, D]``
    caches on ``device`` (None → the card) and one shared CPU int32
    offset, a scalar or, with ``per_row_offsets``, a ``[B]`` vector (one
    clock a row, for rows that advance unevenly)."""
    dev = resolve_device(device)
    dt = to_torch_dtype(dtype)
    offset = torch.zeros([batch] if per_row_offsets else [],
                         dtype=torch.int32)
    return [{"k": torch.zeros(batch, max_len, num_heads, head_dim,
                              dtype=dt, device=dev),
             "v": torch.zeros(batch, max_len, num_heads, head_dim,
                              dtype=dt, device=dev),
             "offset": offset} for _ in range(num_layers)]


def _advance(caches, n):
    off = caches[0]["offset"] + n
    for c in caches:
        c["offset"] = off


def _seen_mask(ids, vocab):
    """[B, S] ids → [B, V] bool mask of the tokens that appeared."""
    return torch.zeros(ids.shape[0], vocab, dtype=torch.bool,
                       device=ids.device).scatter_(1, ids.long(), True)


class _EosTracker:
    """Per-row finished flags accumulated across steps: row i is done once
    it has emitted eos at any step, not only when the whole batch emits
    it together."""

    def __init__(self, batch, eos_token_id):
        self.eos = eos_token_id
        self.done = np.zeros(batch, bool) if eos_token_id is not None \
            else None

    def update(self, nxt):
        if self.done is None:
            return False
        self.done |= nxt.cpu().numpy() == self.eos
        return bool(self.done.all())

    def force(self, nxt):
        """Rows finished before this step keep emitting eos (not live
        samples), so an unevenly finishing batch grows no suffix past a
        row's eos."""
        if self.done is None or not self.done.any():
            return nxt
        done = torch.from_numpy(self.done).to(nxt.device)
        return torch.where(done, torch.full_like(nxt, self.eos), nxt)


def _model_device(model):
    return next(model.parameters()).device


def _kv_heads(model):
    """The heads a cache of ``model`` holds: a tensor-parallel model's
    local ones (``cache_kv_heads``), else num_kv_heads (GQA) or, for GPT,
    every head."""
    local = getattr(model, "cache_kv_heads", None)
    if local is not None:
        return local
    cfg = model.config
    return getattr(cfg, "num_kv_heads", cfg.num_heads)


def init_paged_caches(num_layers, batch, max_len, num_heads, head_dim,
                      page_size=16, dtype="float32", device=None):
    """Per-layer paged caches in the serving engine's layout (`serving.
    PagedKVCache`'s layer dicts): ``[1 + B * N, page_size, H, D]`` pools
    (page 0 the scratch page), row b owning pages ``1 + b N .. (b + 1)
    N`` (``N = ceil(max_len / page_size)``), one int32 ``[B]`` offset on
    ``device`` shared by the layers (decode reads it there)."""
    dev = resolve_device(device)
    dt = to_torch_dtype(dtype)
    n = -(-max_len // page_size)
    table = (1 + torch.arange(batch * n, dtype=torch.int32,
                              device=dev)).reshape(batch, n)
    offset = torch.zeros(batch, dtype=torch.int32, device=dev)
    shape = (1 + batch * n, page_size, num_heads, head_dim)
    return [{"k_pool": torch.zeros(shape, dtype=dt, device=dev),
             "v_pool": torch.zeros(shape, dtype=dt, device=dev),
             "page_table": table, "offset": offset, "page_size": page_size}
            for _ in range(num_layers)]


def generate(model, input_ids, max_new_tokens=32, temperature=0.0,
             top_k=None, top_p=None, repetition_penalty=None,
             use_cache=True, eos_token_id=None, *, generator=None,
             page_size=None):
    """Autoregressive decoding → ``[B, S + n]`` token ids like
    ``input_ids``, at most ``max_seq_len`` long.

    ``use_cache=True`` prefills fp32 dense caches with the prompt, then
    runs one ``[B, 1]`` step a token through `masked_multihead_attention`;
    ``use_cache=False`` runs the full forward a token (the parity path).
    ``page_size`` (the port's) decodes over fp32 paged caches instead
    (`init_paged_caches`: a prefill through the gather route, then the
    paged-decode kernel a token).
    With ``eos_token_id`` a finished row pads with eos, and decoding stops
    once every row has emitted it.  Sampling (``temperature > 0``) draws
    from ``generator``."""
    if top_p is not None and not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    if repetition_penalty is not None and repetition_penalty <= 0.0:
        raise ValueError(
            f"repetition_penalty must be > 0, got {repetition_penalty}")
    cfg = model.config
    dev = _model_device(model)
    input_ids = torch.as_tensor(input_ids).to(dev)
    b, s = input_ids.shape
    max_len = min(cfg.max_seq_len, s + max_new_tokens)
    n_new = max_len - s
    if n_new <= 0:
        return input_ids
    gen = generator
    if gen is None and temperature != 0.0:
        gen = default_generator(dev)
    use_pen = repetition_penalty is not None and repetition_penalty != 1.0
    tracker = _EosTracker(b, eos_token_id)

    def sample(logits, seen):
        return sample_next_token(logits[:, -1, :], temperature, top_k,
                                 top_p, repetition_penalty, seen=seen,
                                 generator=gen).to(input_ids.dtype)

    with torch.no_grad():
        seen = _seen_mask(input_ids, cfg.vocab_size) if use_pen else None
        if not use_cache:
            ids = input_ids
            for _ in range(n_new):
                nxt = tracker.force(sample(model(ids), seen))
                if use_pen:
                    seen = seen | _seen_mask(nxt[:, None], cfg.vocab_size)
                ids = torch.cat([ids, nxt[:, None]], dim=1)
                if tracker.update(nxt):
                    break
            return ids

        if page_size:
            caches = init_paged_caches(cfg.num_layers, b, max_len,
                                       _kv_heads(model), cfg.head_dim,
                                       page_size, device=dev)
        else:
            caches = init_kv_caches(cfg.num_layers, b, max_len,
                                    _kv_heads(model), cfg.head_dim,
                                    dtype="float32", device=dev)
        logits = model(input_ids, caches=caches)           # prefill
        _advance(caches, s)
        pieces = [input_ids]
        nxt = sample(logits, seen)
        for _ in range(n_new - 1):
            tok = nxt[:, None]
            pieces.append(tok)
            if tracker.update(nxt):
                return torch.cat(pieces, dim=1)
            if use_pen:
                seen = seen | _seen_mask(tok, cfg.vocab_size)
            logits = model(tok, caches=caches)
            _advance(caches, 1)
            nxt = tracker.force(sample(logits, seen))
        pieces.append(nxt[:, None])
        return torch.cat(pieces, dim=1)


def speculative_generate(model, draft_model, input_ids, max_new_tokens=32,
                         speculation_k=4, eos_token_id=None):
    """Greedy draft-model speculative decoding (Leviathan et al.): the
    small ``draft_model`` proposes K tokens a window, ``model`` verifies
    all K + 1 positions in one batched call, and the leading run of
    proposals equal to the target's argmaxes is accepted with the bonus
    token after it.  Every emitted token is a target greedy argmax, so the
    output equals ``generate(..., temperature=0.0)``.

    Both models keep dense caches with per-row offsets (rows accept
    different amounts); a rejected tail needs no cache surgery: the offset
    moves back and the next window overwrites it.  The caches carry K
    positions of headroom for the verify window's overshoot, whose
    outputs are never used (GPT clamps their positions to its table).
    ``speculation_k=0`` is `generate`.  Returns ``[B, S + n]`` ids; with
    ``eos_token_id`` a finished row pads with eos."""
    K = int(speculation_k)
    if K <= 0:
        return generate(model, input_ids, max_new_tokens=max_new_tokens,
                        temperature=0.0, eos_token_id=eos_token_id)
    cfg, dcfg = model.config, draft_model.config
    dev = _model_device(model)
    input_ids = torch.as_tensor(input_ids).to(dev)
    b, s = input_ids.shape
    max_len = min(cfg.max_seq_len, s + max_new_tokens)
    n_new = max_len - s
    if n_new <= 0:
        return input_ids
    if dcfg.vocab_size != cfg.vocab_size:
        raise ValueError(f"draft vocab {dcfg.vocab_size} != target "
                         f"vocab {cfg.vocab_size}")
    cap = max_len + K

    def argmax_np(logits):
        return torch.argmax(logits, dim=-1).cpu().numpy()

    def tokens(arr):
        return torch.from_numpy(arr).to(device=dev, dtype=input_ids.dtype)

    def set_offsets(cs, off_np):
        off_t = torch.from_numpy(np.asarray(off_np, np.int32))
        for c in cs:
            c["offset"] = off_t

    with torch.no_grad():
        caches = init_kv_caches(cfg.num_layers, b, cap, _kv_heads(model),
                                cfg.head_dim, per_row_offsets=True,
                                device=dev)
        d_caches = init_kv_caches(dcfg.num_layers, b, cap,
                                  _kv_heads(draft_model),
                                  dcfg.head_dim, per_row_offsets=True,
                                  device=_model_device(draft_model))
        ids_np = input_ids.cpu().numpy().astype(np.int32)
        logits = model(input_ids, caches=caches)           # prefill
        draft_model(input_ids, caches=d_caches)
        off = np.full(b, s, np.int32)          # target rows' clocks
        d_off = np.full(b, s, np.int32)        # draft rows' clocks
        set_offsets(caches, off)
        set_offsets(d_caches, d_off)
        first = argmax_np(logits[:, -1, :])
        rows = [[int(first[r])] for r in range(b)]
        last = first.astype(np.int32)
        done = np.zeros(b, bool)
        if eos_token_id is not None:
            done |= first == eos_token_id

        def known(r, pos):
            return int(ids_np[r, pos]) if pos < s else rows[r][pos - s]

        while not done.all() and any(len(t) < n_new for t in rows):
            # the draft's K proposer steps (teacher-forced catch-up)
            prev = last.copy()
            d_out = [[] for _ in range(b)]
            d_start = d_off.copy()
            for j in range(K):
                tok_in = np.zeros((b, 1), np.int32)
                for r in range(b):
                    p = int(d_start[r]) + j
                    tok_in[r, 0] = known(r, p) if p <= off[r] else prev[r]
                set_offsets(d_caches, d_start + j)
                step = argmax_np(draft_model(tokens(tok_in),
                                             caches=d_caches)[:, -1, :])
                for r in range(b):
                    prev[r] = int(step[r])
                    d_out[r].append(int(step[r]))
            # one batched verify of [last, d_1 .. d_K]
            tok_in = np.zeros((b, K + 1), np.int32)
            caps_row = np.zeros(b, np.int32)
            for r in range(b):
                lag = int(off[r] - d_start[r])
                caps_row[r] = max(0, K - lag)
                tok_in[r, 0] = last[r]
                for i in range(1, K + 1):
                    tok_in[r, i] = d_out[r][lag + i - 1] \
                        if i <= caps_row[r] else last[r]
            set_offsets(caches, off)
            t = argmax_np(model(tokens(tok_in), caches=caches))
            # accept runs and the per-row offset rewind
            for r in range(b):
                if done[r]:
                    continue
                a = 0
                while a < caps_row[r] and tok_in[r, a + 1] == t[r, a]:
                    a += 1
                for i in range(a + 1):
                    if len(rows[r]) >= n_new or done[r]:
                        break
                    tok = int(t[r, i])
                    rows[r].append(tok)
                    last[r] = tok
                    off[r] += 1
                    d_off[r] = min(d_start[r] + K, off[r])
                    if eos_token_id is not None and tok == eos_token_id:
                        done[r] = True
            done |= np.array([len(t) >= n_new for t in rows])

    width = max(len(t) for t in rows)
    pad = eos_token_id if eos_token_id is not None else 0
    out = np.full((b, width), pad, np.int64)
    for r, toks in enumerate(rows):
        out[r, :len(toks)] = toks
        if eos_token_id is None and len(toks) < width:
            out[r, len(toks):] = toks[-1]      # unreachable without eos
    return torch.cat([input_ids, tokens(out)], dim=1)


def beam_search(model, input_ids, max_new_tokens=32, num_beams=4,
                eos_token_id=None, length_penalty=1.0):
    """Beam-search decoding over the full forward: each row expands to
    ``num_beams`` hypotheses scored by cumulative log-probabilities (host
    float64), the top beams a row kept each step; returns the best
    finished (or longest) hypothesis a row, its score divided by its own
    generated length ``** length_penalty``: ``[B, S + n]`` ids."""
    if num_beams < 1:
        raise ValueError(f"num_beams must be >= 1, got {num_beams}")
    cfg = model.config
    dev = _model_device(model)
    input_ids = torch.as_tensor(input_ids)
    b, s = input_ids.shape
    n_new = min(cfg.max_seq_len, s + max_new_tokens) - s
    if n_new <= 0:
        return input_ids.to(dev)
    k = int(num_beams)

    ids = input_ids.cpu().numpy()
    beams = np.repeat(ids, k, axis=0)                  # [B*K, S]
    scores = np.full((b, k), -np.inf, np.float64)
    scores[:, 0] = 0.0                                 # first beam only
    done = np.zeros((b, k), bool)
    lens = np.zeros((b, k), np.int64)   # each hypothesis's generated length

    with torch.no_grad():
        for _ in range(n_new):
            logits = model(torch.from_numpy(beams).to(dev))
            logp = torch.log_softmax(logits[:, -1, :], dim=-1) \
                .float().cpu().numpy().astype(np.float64)
            vocab = logp.shape[-1]
            logp = logp.reshape(b, k, vocab)
            # finished beams only extend with a frozen score
            cand = scores[:, :, None] + np.where(done[:, :, None], -np.inf,
                                                 logp)
            if eos_token_id is not None:
                # a finished beam keeps one continuation (eos at its
                # frozen score), so it stays selectable
                cand[:, :, eos_token_id] = np.where(
                    done, scores, cand[:, :, eos_token_id])
            flat = cand.reshape(b, k * vocab)
            top = np.argsort(-flat, axis=1)[:, :k]     # [B, K]
            new_scores = np.take_along_axis(flat, top, axis=1)
            src_beam = top // vocab
            tok = (top % vocab).astype(beams.dtype)
            picked = beams.reshape(b, k, -1)[np.arange(b)[:, None],
                                             src_beam]
            beams = np.concatenate([picked, tok[:, :, None]],
                                   axis=2).reshape(b * k, -1)
            done = np.take_along_axis(done, src_beam, axis=1)
            lens = np.take_along_axis(lens, src_beam, axis=1)
            lens = lens + (~done)       # finished beams stop growing
            if eos_token_id is not None:
                done = done | (tok == eos_token_id)
            scores = new_scores
            if done.all():
                break

    # the best beam a row, normalized by each hypothesis's own length
    norm = scores / np.maximum(lens, 1) ** length_penalty
    best = norm.argmax(axis=1)
    return torch.from_numpy(beams.reshape(b, k, -1)[np.arange(b), best]) \
        .to(dev)
