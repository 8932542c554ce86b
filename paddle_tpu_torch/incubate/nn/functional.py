"""Fused-op APIs of the serving path (port of
paddle_tpu/incubate/nn/functional/__init__.py): rotary position
embedding, cache attention, and paged multi-head attention.

Rope and the prefill chunk's attention are plain PyTorch here, as they are
plain jnp in the JAX package on this path.  The single-token decode read
goes through the paged-decode kernel (its plain version on the CPU).
"""
from __future__ import annotations

import math

import torch

from ...kernels.paged_decode import paged_decode_attention

NEG_INF = -1e30


def _rope_rotate_half(x):
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def _apply_rope(q, k, v, cos, sin, use_neox):
    def rot(t):
        if t is None:
            return None
        if use_neox:
            return t * cos + _rope_rotate_half(t) * sin
        # interleaved (GPT-J) layout
        t1, t2 = t[..., 0::2], t[..., 1::2]
        c, s = cos[..., 0::2], sin[..., 0::2]
        return torch.stack([t1 * c - t2 * s, t2 * c + t1 * s],
                           dim=-1).reshape(t.shape)
    return rot(q), rot(k), rot(v)


def fused_rotary_position_embedding(q, k=None, v=None, sin=None, cos=None,
                                    position_ids=None,
                                    use_neox_rotary_style=True,
                                    rotary_emb_base=10000.0):
    """Rotary embedding of ``[B, S, H, D]`` q/k/v.  Positions are
    ``position_ids`` (``[B, S]`` per-row, the serving path, or ``[S]``)
    or ``arange(S)``; sin/cos default to the standard rope table.
    Returns ``(q, k, v)`` with None where an input was None."""
    _, s, _, d = q.shape
    if sin is None or cos is None:
        inv = 1.0 / (rotary_emb_base ** (torch.arange(
            0, d, 2, dtype=torch.float32, device=q.device) / d))
        pos = position_ids if position_ids is not None else \
            torch.arange(s, device=q.device)
        pos = pos.to(torch.float32)
        if pos.dim() == 2:
            # [B, S] per-row positions: every serving row decodes at its
            # own age, so the tables broadcast per row
            freqs = pos[..., None] * inv                      # [B, S, d/2]
            emb = torch.cat([freqs, freqs], dim=-1)
            cos_a, sin_a = emb.cos()[:, :, None, :], emb.sin()[:, :, None, :]
        else:
            freqs = torch.outer(pos, inv)                     # [S, d/2]
            emb = torch.cat([freqs, freqs], dim=-1)
            cos_a, sin_a = emb.cos()[None, :, None, :], \
                emb.sin()[None, :, None, :]
    else:
        cos_a, sin_a = cos, sin
        if cos_a.dim() == 2:
            cos_a, sin_a = cos_a[None, :, None, :], sin_a[None, :, None, :]
    return _apply_rope(q, k, v, cos_a.to(q.dtype), sin_a.to(q.dtype),
                       use_neox_rotary_style)


def _cache_attend(qa, ck, cv, off, scale):
    """Causal attention of ``qa`` [B, S, Hq, D] against a full cache view
    ``ck``/``cv`` [B, S_max, Hkv, D] at per-row ([B]) or scalar offsets.
    Logits and softmax in fp32, probabilities cast to the cache dtype
    for the value product; GQA groups the query heads onto the kv heads."""
    b, s, h_q, d = qa.shape
    s_max, h_kv = ck.shape[1], ck.shape[2]
    sc = scale if scale is not None else 1.0 / math.sqrt(d)
    ar_s = torch.arange(s, device=qa.device)
    k_pos = torch.arange(s_max, device=qa.device)
    off = off.long()
    if off.dim() == 1:
        q_pos = off[:, None, None] + ar_s[None, :, None]
        mask = k_pos[None, None, :] <= q_pos                  # [b, s, s_max]
    else:
        q_pos = off + ar_s[:, None]
        mask = (k_pos[None, :] <= q_pos)[None]                # [1, s, s_max]
    qf = qa.float()
    kf = ck.float()
    if h_q == h_kv:
        logits = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * sc
        logits = logits.masked_fill(~mask[:, None], NEG_INF)
        probs = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", probs.to(cv.dtype), cv)
    else:
        rep = h_q // h_kv
        qg = qf.reshape(b, s, h_kv, rep, d)
        logits = torch.einsum("bqhrd,bkhd->bhrqk", qg, kf) * sc
        logits = logits.masked_fill(~mask[:, None, None], NEG_INF)
        probs = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhrqk,bkhd->bqhrd", probs.to(cv.dtype),
                           cv).reshape(b, s, h_q, d)
    return out.to(qa.dtype)


def paged_masked_multihead_attention(q, k, v, k_pool, v_pool, page_table,
                                     offset, page_size, scale=None):
    """Decode or chunked-prefill attention against a paged KV cache.

    q/k/v: [B, S, H, D] new tokens; k_pool/v_pool: [P, page_size, Hkv, D]
    page pools shared by every sequence; page_table: int32 [B, N];
    offset: int32 [B] tokens already cached per row.  Writes the new K/V
    through the page table at ``offset..offset+S`` (rows whose entries
    are 0 write into the reserved scratch page) and attends causally.
    With ``S == 1`` the read is the paged-decode kernel; a prefill chunk
    gathers each row's ``[N * page_size]`` view and runs `_cache_attend`.

    Unlike the JAX op, the pools are updated IN PLACE (an indexed store,
    no copy of the pool per call) and returned as the same tensors.
    """
    psz = int(page_size)
    b, s_new, _, d = q.shape
    n_pages = page_table.shape[1]
    s_cap = n_pages * psz
    if offset.device.type == "cpu" and \
            bool((offset.long() + s_new > s_cap).any()):
        # on the card this check would read the offsets back every
        # layer; PagedKVCache checks its host copy before each upload
        raise ValueError(
            f"paged KV cache overflow: offset {offset.tolist()} + {s_new} "
            f"new tokens > page-table capacity {s_cap}")
    off = offset.long()
    pos = off[:, None] + torch.arange(s_new, device=q.device)[None, :]
    page_ids = page_table.long().gather(1, pos // psz)        # [B, S]
    in_page = pos % psz
    k_pool[page_ids, in_page] = k.to(k_pool.dtype)
    v_pool[page_ids, in_page] = v.to(v_pool.dtype)
    if s_new == 1:
        out = paged_decode_attention(
            q[:, 0].contiguous(), k_pool, v_pool,
            page_table.to(torch.int32).contiguous(),
            offset.to(torch.int32).contiguous(), scale=scale)[:, None]
    else:
        h_kv = k_pool.shape[2]
        pt = page_table.long()
        kf = k_pool[pt].reshape(b, s_cap, h_kv, d)
        vf = v_pool[pt].reshape(b, s_cap, h_kv, d)
        out = _cache_attend(q, kf, vf, off, scale)
    return out, k_pool, v_pool


def paged_cache_attention(q, k, v, cache, scale=None):
    """Attention against one `PagedKVCache` layer dict; float pools only
    (int8/fp8 KV is not ported yet)."""
    if cache.get("k_scale") is not None:
        raise NotImplementedError(
            "quantized (int8/fp8) KV pools are not ported yet (ROADMAP "
            "Queue A: int8/fp8 KV)")
    out, kp, vp = paged_masked_multihead_attention(
        q, k, v, cache["k_pool"], cache["v_pool"], cache["page_table"],
        cache["offset"], cache["page_size"], scale=scale)
    cache["k_pool"], cache["v_pool"] = kp, vp
    return out
