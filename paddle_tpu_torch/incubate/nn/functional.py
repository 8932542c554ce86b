"""Fused-op APIs of the serving and training paths (port of
paddle_tpu/incubate/nn/functional/__init__.py): rotary position
embedding, cache attention, paged multi-head attention, and
variable-length (masked) attention through the flash kernels.

Rope with one ``[S, D]`` table (no positions, 1-D positions, or 2-D
sin/cos tables) goes through the rope kernel with fp32 tables, as the JAX
package takes its Pallas kernel when it has such a table; per-row ``[B, S]``
positions (the serving engine's slots) stay plain PyTorch, as they stay
jnp there.  The prefill chunk's attention is plain PyTorch too; the
single-token decode read goes through the paged-decode kernel (its plain
version on the CPU), over float pools or int8/fp8 pools with per-row
scales.  Attention against a dense cache (`masked_multihead_attention`,
the cache of `models.generation`) is plain PyTorch, as the JAX package
computes it outside any Pallas kernel.
"""
from __future__ import annotations

import math

import torch

from ...nn.functional import flash_attention
from ...ops.flops import counted
from ...kernels.graph_state import allow_host_reads
from ...kernels.paged_decode import gather_pages, paged_decode_attention
from ...kernels.rope import RopeFunction, rope
from ...quantization import (as_bytes, dequantize_kv, qmax_of,
                             quantize_kv_rows)

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


@counted("fused_rope")
def fused_rotary_position_embedding(q, k=None, v=None, sin=None, cos=None,
                                    position_ids=None,
                                    use_neox_rotary_style=True,
                                    time_major=False,
                                    rotary_emb_base=10000.0):
    """Rotary embedding of ``[B, S, H, D]`` q/k/v (``time_major`` is taken
    in JAX's place and, as in JAX, not read).  Positions are
    ``position_ids`` (``[B, S]`` per-row, the serving path, or ``[S]``)
    or ``arange(S)``; sin/cos default to the standard rope table.
    Returns ``(q, k, v)`` with None where an input was None."""
    _, s, _, d = q.shape
    cos2d = sin2d = None        # [S, D] tables: the kernel's route
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
            cos2d, sin2d = emb.cos(), emb.sin()
    else:
        cos_a, sin_a = cos, sin
        if cos_a.dim() == 2:
            if tuple(cos_a.shape) == (s, d):
                cos2d, sin2d = cos_a.float(), sin_a.float()
            cos_a, sin_a = cos_a[None, :, None, :], sin_a[None, :, None, :]
    if cos2d is not None:
        return tuple(None if t is None else _rope_2d(t, cos2d, sin2d,
                                                     use_neox_rotary_style)
                     for t in (q, k, v))
    return _apply_rope(q, k, v, cos_a.to(q.dtype), sin_a.to(q.dtype),
                       use_neox_rotary_style)


def _rope_2d(t, cos, sin, neox):
    """One tensor through the rope kernel (differentiable when needed)."""
    if torch.is_grad_enabled() and t.requires_grad:
        return RopeFunction.apply(t, cos, sin, bool(neox))
    return rope(t, cos, sin, neox)


def variable_length_memory_efficient_attention(query, key, value,
                                               seq_lens=None,
                                               kv_seq_lens=None, mask=None,
                                               scale=None, causal=False):
    """``[B, S, H, D]`` attention under an additive or boolean ``mask``
    (``[B|1, H|1, S, S]``) through the flash kernels, as the JAX package
    maps it to its flash op; like there, ``seq_lens`` and ``kv_seq_lens``
    are not read (the lengths live in the mask)."""
    return flash_attention(query, key, value, attn_mask=mask, causal=causal,
                           scale=scale)


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


def _overflows(offset, s_new, s_cap):
    """Whether a CPU offset leaves no room for ``s_new`` tokens: a host
    read of a host tensor, which the capture probe lets through."""
    with allow_host_reads():
        return bool((offset.long() + s_new > s_cap).any())


def masked_multihead_attention(q, k, v, cache_k, cache_v, offset,
                               scale=None, name=None):
    """Decode or prefill attention against a dense KV cache (the cache of
    `models.generation.generate`).

    q/k/v: [B, S, H, D] new tokens; cache_k/cache_v: [B, S_max, Hkv, D]
    (GQA: the cache holds the kv heads only); offset: the tokens already
    cached, an int scalar or an int32 ``[B]`` vector of per-row offsets.
    Writes the new K/V at ``offset..offset+S`` of each row and attends
    causally through `_cache_attend`, the computation of the paged
    prefill.  A host offset (a Python int or a CPU tensor) is checked
    against the capacity; an offset on the card is the caller's bound.

    Unlike the JAX op, which returns new cache arrays, the caches are
    written IN PLACE and returned as the same tensors ``(out, cache_k,
    cache_v)``: `generate` owns them and drops nothing it would need."""
    b, s_new = q.shape[:2]
    s_cap = cache_k.shape[1]
    off = torch.as_tensor(offset)
    if off.device.type == "cpu" and _overflows(off, s_new, s_cap):
        raise ValueError(
            f"KV cache overflow: offset {off.tolist()} + {s_new} new tokens"
            f" > cache capacity {s_cap}")
    off = off.to(device=q.device, dtype=torch.long)
    pos = torch.arange(s_new, device=q.device)
    if off.dim() == 1:
        rows = torch.arange(b, device=q.device)[:, None]
        idx = off[:, None] + pos[None, :]                     # [B, S]
        cache_k[rows, idx] = k.to(cache_k.dtype)
        cache_v[rows, idx] = v.to(cache_v.dtype)
    else:
        idx = off + pos
        cache_k.index_copy_(1, idx, k.to(cache_k.dtype))
        cache_v.index_copy_(1, idx, v.to(cache_v.dtype))
    return _cache_attend(q, cache_k, cache_v, off, scale), cache_k, cache_v


def paged_masked_multihead_attention(q, k, v, k_pool, v_pool, page_table,
                                     offset, page_size, scale=None,
                                     k_scale=None, v_scale=None, name=None):
    """Decode or chunked-prefill attention against a paged KV cache.

    q/k/v: [B, S, H, D] new tokens; k_pool/v_pool: [P, page_size, Hkv, D]
    page pools shared by every sequence; page_table: int32 [B, N];
    offset: int32 [B] tokens already cached per row.  Writes the new K/V
    through the page table at ``offset..offset+S`` (rows whose entries
    are 0 write into the reserved scratch page) and attends causally.
    With ``S == 1`` the read is the paged-decode kernel; a prefill chunk
    gathers each row's ``[N * page_size]`` view and runs `_cache_attend`.

    Quantized storage: with ``k_scale``/``v_scale`` ([P, page_size]
    float32) the pools hold int8 or float8 values.  Each new token's
    ``[Hkv, D]`` row is quantized with its own scale (`quantize_kv_rows`)
    and stored with it through the page table; a prefill chunk gathers,
    dequantizes to fp32 and runs the same `_cache_attend`.  Returns
    ``(out, k_pool, v_pool, k_scale, v_scale)`` in this mode.

    Unlike the JAX op, the pools (and scales) are updated IN PLACE (an
    indexed store, no copy of the pool per call) and returned as the same
    tensors.
    """
    psz = int(page_size)
    quant = k_scale is not None
    b, s_new, _, d = q.shape
    n_pages = page_table.shape[1]
    s_cap = n_pages * psz
    if offset.device.type == "cpu" and _overflows(offset, s_new, s_cap):
        # on the card this check would read the offsets back every
        # layer; PagedKVCache checks its host copy before each upload
        raise ValueError(
            f"paged KV cache overflow: offset {offset.tolist()} + {s_new} "
            f"new tokens > page-table capacity {s_cap}")
    off = offset.long()
    pos = off[:, None] + torch.arange(s_new, device=q.device)[None, :]
    page_ids = page_table.long().gather(1, pos // psz)        # [B, S]
    in_page = pos % psz
    if quant:
        qmax = qmax_of(k_pool.dtype)
        qk, sk = quantize_kv_rows(k, qmax, k_pool.dtype)
        qv, sv = quantize_kv_rows(v, qmax, v_pool.dtype)
        as_bytes(k_pool)[page_ids, in_page] = as_bytes(qk)
        as_bytes(v_pool)[page_ids, in_page] = as_bytes(qv)
        k_scale[page_ids, in_page] = sk
        v_scale[page_ids, in_page] = sv
    else:
        k_pool[page_ids, in_page] = k.to(k_pool.dtype)
        v_pool[page_ids, in_page] = v.to(v_pool.dtype)
    if s_new == 1:
        out = paged_decode_attention(
            q[:, 0].contiguous(), k_pool, v_pool,
            page_table.to(torch.int32).contiguous(),
            offset.to(torch.int32).contiguous(), scale=scale,
            k_scale=k_scale, v_scale=v_scale)[:, None]
    else:
        h_kv = k_pool.shape[2]
        pt = page_table.long()
        kf, vf = gather_pages(k_pool, pt), gather_pages(v_pool, pt)
        if quant:
            kf = dequantize_kv(kf, k_scale[pt])
            vf = dequantize_kv(vf, v_scale[pt])
        out = _cache_attend(q, kf.reshape(b, s_cap, h_kv, d),
                            vf.reshape(b, s_cap, h_kv, d), off, scale)
    if quant:
        return out, k_pool, v_pool, k_scale, v_scale
    return out, k_pool, v_pool


def paged_cache_attention(q, k, v, cache, scale=None):
    """Attention against one `PagedKVCache` layer dict: the plain or the
    quantized (int8/fp8, per-row scales) paged op, with the pools and
    scales written back into the dict (the same tensors, updated in
    place)."""
    if cache.get("k_scale") is not None:
        out, kp, vp, ks, vs = paged_masked_multihead_attention(
            q, k, v, cache["k_pool"], cache["v_pool"], cache["page_table"],
            cache["offset"], cache["page_size"], scale=scale,
            k_scale=cache["k_scale"], v_scale=cache["v_scale"])
        cache["k_scale"], cache["v_scale"] = ks, vs
    else:
        out, kp, vp = paged_masked_multihead_attention(
            q, k, v, cache["k_pool"], cache["v_pool"], cache["page_table"],
            cache["offset"], cache["page_size"], scale=scale)
    cache["k_pool"], cache["v_pool"] = kp, vp
    return out
