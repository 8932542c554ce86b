"""Flash attention: the CUDA kernels ``csrc/flash_attention_fwd.cu`` (forward)
and ``csrc/flash_attention_bwd.cu`` (dK/dV and dQ) with their plain
versions (port of paddle_tpu/pallas/flash_attention.py ``flash_attention``:
``_pallas_flash_fwd``, ``_pallas_flash_bwd`` and the custom VJP of
``_flash_core``).

Layouts are the JAX package's: q ``[B, S, H, D]``, or ``[B, H, S, D]`` with
``head_major=True``; k and v carry ``H_kv`` heads with ``H % H_kv == 0``
(GQA: q head ``i`` reads kv head ``i // (H / H_kv)``, never repeated in
memory by the kernels).  The forward also returns the fp32 log-sum-exp
``lse [B, H, S]``, which the backward uses to recompute the probabilities.
All versions keep the softmax and ``p @ v`` in fp32, as the Pallas kernel
does (it casts q, k and v to fp32 in its body).  The kernels take views
with any batch/head/sequence strides and a contiguous head dim, so the
head-major transpose of a ``[B, S, H, D]`` projection costs no copy.

Not ported: attention dropout, additive/boolean masks and segment ids
(ROADMAP Queue B); the public op raises for them.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build, dtype_code

NEG_INF = -1e30
SUPPORTED_HEAD_DIMS = (32, 64, 128)
_UNPORTED = ("is not ported yet (ROADMAP Queue B: flash attention dropout, "
             "masks and segment ids)")


def _head_major(t, head_major):
    return t if head_major else t.transpose(1, 2)


def _geometry(q, k, v, head_major):
    """(B, H, H_kv, S, D) of the call; raises on inconsistent shapes."""
    if q.dim() != 4 or k.dim() != 4 or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} must be 4-D "
                         "with k and v alike")
    if head_major:
        b, h, s, d = q.shape
        kb, h_kv, ks, kd = k.shape
    else:
        b, s, h, d = q.shape
        kb, ks, h_kv, kd = k.shape
    if (kb, ks, kd) != (b, s, d) or h_kv == 0 or h % h_kv:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} disagree (batch, sequence, head "
                         "dim; kv heads must divide q heads)")
    return b, h, h_kv, s, d


def _scale(scale, d):
    return float(scale) if scale is not None else 1.0 / math.sqrt(d)


def _causal_mask(s, device):
    return torch.ones(s, s, dtype=torch.bool, device=device).tril()


def flash_attention_ref(q, k, v, causal=False, scale=None, head_major=False):
    """Plain PyTorch forward → (out like q, fp32 lse [B, H, S]): logits,
    softmax and ``p @ v`` in fp32 (K/V heads repeated for GQA), one
    rounding to q's dtype.  Differentiable by autograd."""
    b, h, h_kv, s, d = _geometry(q, k, v, head_major)
    qh, kh, vh = (_head_major(t, head_major).float() for t in (q, k, v))
    if h != h_kv:
        kh = kh.repeat_interleave(h // h_kv, dim=1)
        vh = vh.repeat_interleave(h // h_kv, dim=1)
    logits = torch.matmul(qh, kh.transpose(-1, -2)) * _scale(scale, d)
    if causal:
        logits = logits.masked_fill(~_causal_mask(s, q.device), NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)  # noqa: E741
    out = torch.matmul(p, vh) / l
    lse = (m + torch.log(l)).squeeze(-1)
    return _head_major(out.to(q.dtype), head_major), lse


def _bwd_ref(q, k, v, dout, lse, delta, causal, scale, head_major, want_dq,
             want_dkv):
    """The Pallas backward kernels' math in plain PyTorch, fp32: p
    recomputed from ``lse``, ``dS = p (dP - delta) scale``; the GQA heads
    sharing a kv head are summed into its dK/dV.  ``lse`` and ``delta`` are
    fp32 ``[B, H, S]``.  → (dq or None, dk or None, dv or None)."""
    b, h, h_kv, s, d = _geometry(q, k, v, head_major)
    rep = h // h_kv
    sc = _scale(scale, d)
    qh, kh, vh, doh = (_head_major(t, head_major).float()
                       for t in (q, k, v, dout))
    if rep > 1:
        kh = kh.repeat_interleave(rep, dim=1)
        vh = vh.repeat_interleave(rep, dim=1)
    logits = torch.matmul(qh, kh.transpose(-1, -2)) * sc
    p = torch.exp(logits - lse[..., None])
    if causal:
        p = p.masked_fill(~_causal_mask(s, q.device), 0.0)
    dp = torch.matmul(doh, vh.transpose(-1, -2))
    ds = p * (dp - delta[..., None]) * sc
    dq = dk = dv = None
    if want_dq:
        dq = _head_major(torch.matmul(ds, kh).to(q.dtype), head_major)
    if want_dkv:
        dv = torch.matmul(p.transpose(-1, -2), doh)
        dk = torch.matmul(ds.transpose(-1, -2), qh)
        if rep > 1:
            dk = dk.reshape(b, h_kv, rep, s, d).sum(dim=2)
            dv = dv.reshape(b, h_kv, rep, s, d).sum(dim=2)
        dk = _head_major(dk.to(k.dtype), head_major)
        dv = _head_major(dv.to(v.dtype), head_major)
    return dq, dk, dv


def flash_bwd_dkv_ref(q, k, v, dout, lse, delta, causal=False, scale=None,
                      head_major=False):
    """Plain version of the dK/dV kernel → (dk like k, dv like v)."""
    return _bwd_ref(q, k, v, dout, lse, delta, causal, scale, head_major,
                    False, True)[1:]


def flash_bwd_dq_ref(q, k, v, dout, lse, delta, causal=False, scale=None,
                     head_major=False):
    """Plain version of the dQ kernel → dq like q."""
    return _bwd_ref(q, k, v, dout, lse, delta, causal, scale, head_major,
                    True, False)[0]


def _delta(out, dout, head_major):
    """``rowsum(dO * O)`` in fp32 as ``[B, H, S]``."""
    delta = (dout.float() * out.float()).sum(dim=-1)
    return (delta if head_major else delta.transpose(1, 2)).contiguous()


def flash_attention_bwd_ref(q, k, v, out, lse, dout, causal=False,
                            scale=None, head_major=False):
    """Plain PyTorch backward → (dq, dk, dv): ``delta = rowsum(dO * O)``,
    then the two kernels' plain versions in one pass."""
    return _bwd_ref(q, k, v, dout, lse, _delta(out, dout, head_major), causal,
                    scale, head_major, True, True)


def _prep(t):
    """A view the kernels can read: contiguous head dim; for 16-bit types
    also 16-byte aligned rows (cp.async); else a contiguous copy."""
    ok = t.stride(-1) == 1 and (t.element_size() == 4 or (
        t.data_ptr() % 16 == 0
        and all(st % 8 == 0 for st in t.stride()[:-1])))
    return t if ok else t.contiguous()


def _check_cuda_call(name, q, k, v, d):
    for t in (k, v):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{name}: q, k and v must share device and "
                             f"dtype ({q.device} {q.dtype} vs {t.device} "
                             f"{t.dtype})")
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {d} is not supported by the "
                         f"CUDA kernels; supported: {SUPPORTED_HEAD_DIMS}")
    dtype_code(q)


def _strides(tensors, head_major):
    vals = []
    for t in tensors:
        st = t.stride()
        vals += [st[0], st[1], st[2]] if head_major else [st[0], st[2], st[1]]
    return (ctypes.c_longlong * len(vals))(*vals)


def flash_attention_fwd(q, k, v, causal=False, scale=None, head_major=False):
    """→ (out like q, fp32 lse [B, H, S]).  CPU tensors take
    `flash_attention_ref`; CUDA tensors launch the forward kernel."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal, scale, head_major)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd: unsupported device "
                         f"{q.device}")
    b, h, h_kv, s, d = _geometry(q, k, v, head_major)
    _check_cuda_call("flash_attention_fwd", q, k, v, d)
    q, k, v = _prep(q), _prep(k), _prep(v)
    out = torch.empty_like(q)
    lse = torch.empty(b, h, s, dtype=torch.float32, device=q.device)
    if not q.numel():
        return out, lse
    fn = _build.function("ptt_flash_fwd", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_float,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    with torch.cuda.device(q.device):
        err = fn(_build.ptr(q), _build.ptr(k), _build.ptr(v),
                 _build.ptr(out), _build.ptr(lse), b, h, h_kv, s, d,
                 _strides((q, k, v, out), head_major), _scale(scale, d),
                 int(bool(causal)), dtype_code(q), _build.stream(q.device))
    _build.check(err, "ptt_flash_fwd")
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0

_BWD_ARGS = [ctypes.c_void_p] * 6


def flash_bwd_dkv(q, k, v, dout, lse, delta, causal, scale, head_major):
    """The dK/dV kernel → (dk like k, dv like v).  CPU tensors take
    `flash_bwd_dkv_ref`; CUDA tensors must come as `flash_attention_bwd`
    prepares them."""
    if q.device.type == "cpu":
        return flash_bwd_dkv_ref(q, k, v, dout, lse, delta, causal, scale,
                                 head_major)
    b, h, h_kv, s, d = _geometry(q, k, v, head_major)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    fn = _build.function("ptt_flash_bwd_dkv", _BWD_ARGS + [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    with torch.cuda.device(q.device):
        err = fn(_build.ptr(q), _build.ptr(k), _build.ptr(v),
                 _build.ptr(dout), _build.ptr(lse), _build.ptr(delta),
                 _build.ptr(dk), _build.ptr(dv), b, h, h_kv, s, d,
                 _strides((q, k, v, dout, dk, dv), head_major),
                 _scale(scale, d), int(bool(causal)), dtype_code(q),
                 _build.stream(q.device))
    _build.check(err, "ptt_flash_bwd_dkv")
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_bwd_dkv.launches = 0


def flash_bwd_dq(q, k, v, dout, lse, delta, causal, scale, head_major):
    """The dQ kernel → dq like q.  CPU tensors take `flash_bwd_dq_ref`."""
    if q.device.type == "cpu":
        return flash_bwd_dq_ref(q, k, v, dout, lse, delta, causal, scale,
                                head_major)
    b, h, h_kv, s, d = _geometry(q, k, v, head_major)
    dq = torch.empty_like(q)
    fn = _build.function("ptt_flash_bwd_dq", _BWD_ARGS + [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_float,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    with torch.cuda.device(q.device):
        err = fn(_build.ptr(q), _build.ptr(k), _build.ptr(v),
                 _build.ptr(dout), _build.ptr(lse), _build.ptr(delta),
                 _build.ptr(dq), b, h, h_kv, s, d,
                 _strides((q, k, v, dout, dq), head_major),
                 _scale(scale, d), int(bool(causal)), dtype_code(q),
                 _build.stream(q.device))
    _build.check(err, "ptt_flash_bwd_dq")
    flash_bwd_dq.launches += 1
    return dq


flash_bwd_dq.launches = 0


def flash_attention_bwd(q, k, v, out, lse, dout, causal=False, scale=None,
                        head_major=False):
    """→ (dq, dk, dv) like q, k, v.  CPU tensors take
    `flash_attention_bwd_ref`; CUDA tensors compute ``delta = rowsum(dO *
    O)`` with one torch op (as the JAX package does outside Pallas) and
    launch the dK/dV and dQ kernels."""
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, out, lse, dout, causal,
                                       scale, head_major)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd: unsupported device "
                         f"{q.device}")
    b, h, h_kv, s, d = _geometry(q, k, v, head_major)
    _check_cuda_call("flash_attention_bwd", q, k, v, d)
    if dout.shape != q.shape or dout.dtype != q.dtype \
            or lse.shape != (b, h, s) or lse.dtype != torch.float32:
        raise ValueError("flash_attention_bwd: dout must match q and lse be "
                         f"fp32 [{b}, {h}, {s}]")
    q, k, v, dout = _prep(q), _prep(k), _prep(v), _prep(dout)
    lse = lse.contiguous()
    delta = _delta(out, dout, head_major)
    if not q.numel():
        return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dk, dv = flash_bwd_dkv(q, k, v, dout, lse, delta, causal, scale,
                           head_major)
    dq = flash_bwd_dq(q, k, v, dout, lse, delta, causal, scale, head_major)
    return dq, dk, dv


class FlashAttentionFunction(torch.autograd.Function):
    """Flash attention under autograd (the custom VJP of the JAX package's
    ``_flash_core``): the forward saves out and lse, the backward runs the
    two backward kernels."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, head_major):
        out, lse = flash_attention_fwd(q, k, v, causal, scale, head_major)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.cfg = (causal, scale, head_major)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout, *ctx.cfg)
        return dq, dk, dv, None, None, None


def flash_attention(query, key, value, attn_mask=None, dropout=0.0,
                    causal=False, training=True, scale=None,
                    segment_ids=None, head_major=False):
    """Public op: ``[B, S, H, D]`` (or ``[B, H, S, D]`` with
    ``head_major``) → attention output like ``query``; GQA when k/v carry
    fewer heads.  Differentiable (`FlashAttentionFunction`) whenever an
    input requires grad under grad mode."""
    if training and dropout > 0.0:
        raise NotImplementedError(f"flash_attention: dropout {_UNPORTED}")
    if attn_mask is not None:
        raise NotImplementedError(f"flash_attention: attn_mask {_UNPORTED}")
    if segment_ids is not None:
        raise NotImplementedError(f"flash_attention: segment_ids {_UNPORTED}")
    d = query.shape[-1]
    sc = _scale(scale, d)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (query, key, value)):
        return FlashAttentionFunction.apply(query, key, value, bool(causal),
                                            sc, bool(head_major))
    return flash_attention_fwd(query, key, value, causal, sc, head_major)[0]
