"""Logit processors and token sampling (port of
paddle_tpu/models/generation.py ``apply_logit_processors`` and
``sample_next_token``), shared by the serving engine's per-row sampling.

Draws come from an explicit ``torch.Generator`` (torch's default one when
None): the serving engine gives each unseeded sampled request its own.  A
seeded request's draws take the key stream of
``serving.compiled_tick.choose_tokens`` instead.
"""
from __future__ import annotations

import torch


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
                      repetition_penalty=None, seen=None, generator=None):
    """[B, V] → [B] next tokens: `apply_logit_processors`, then argmax
    (temperature 0) or a multinomial draw from ``generator``."""
    logits_last = apply_logit_processors(
        logits_last, temperature=temperature, top_k=top_k, top_p=top_p,
        repetition_penalty=repetition_penalty, seen=seen)
    if temperature == 0.0:
        return torch.argmax(logits_last, dim=-1)
    probs = torch.softmax(logits_last.float(), dim=-1)
    return torch.multinomial(probs, 1, generator=generator).reshape(-1)
