"""Flash attention: the CUDA kernels ``csrc/flash_attention_fwd.cu`` (forward)
and ``csrc/flash_attention_bwd.cu`` (the delta pass, dK/dV and dQ) with
their plain versions (port of paddle_tpu/pallas/flash_attention.py
``flash_attention``: ``_pallas_flash_fwd``, ``_pallas_flash_bwd`` and the
custom VJP of ``_flash_core``).

The forward and the two backward kernels for 16-bit inputs at head dims
64 and 128 (GPT-2's and Llama's) are warp-specialised Hopper kernels
(wgmma products fed by TMA, see the sources); head dim 32 keeps
``mma.sync`` bodies and fp32 its FMA bodies, which no training path
takes.

Layouts are the JAX package's: q ``[B, S, H, D]``, or ``[B, H, S, D]`` with
``head_major=True``; k and v carry ``H_kv`` heads with ``H % H_kv == 0``
(GQA: q head ``i`` reads kv head ``i // (H / H_kv)``, never repeated in
memory by the kernels).  The forward also returns the fp32 log-sum-exp
``lse [B, H, S]``, which the backward uses to recompute the probabilities.
All versions keep the softmax and ``p @ v`` in fp32, as the Pallas kernel
does (it casts q, k and v to fp32 in its body): the 16-bit forward
kernels give the tensor cores p as a 16-bit head and remainder.  The
kernels take views with any batch/head/sequence strides and a contiguous
head dim, so the head-major transpose of a ``[B, S, H, D]`` projection
costs no copy.

The Pallas kernels' features, in all three kernels and their plain
versions (``_apply_masks`` and ``_dropout_uniform``):

- ``mask``: an fp32 additive mask ``[B|1, H|1, S, S]``, added after the
  causal and segment masks; read through its strides, so a broadcast
  ``[1, 1, S, S]`` mask is never expanded.  The public op turns a boolean
  mask into ``where(m, 0, NEG_INF)`` and a 16-bit one into fp32.
- ``segment_ids``: int32 ``[B, S]``; scores between segments that differ
  get ``NEG_INF`` (packed varlen).  With a mask or segments, a score at
  ``NEG_INF`` gets probability 0, so a fully masked row gives out 0, lse
  ~-1e30 and zero gradients.
- ``dropout`` with a uint32 ``seed``: the keep-mask of `dropout_uniform`,
  keyed by (seed, ``b * H + q head``, absolute q and key positions), the
  Pallas hash bit for bit; ``offsets = (b0, h0, heads)`` keys row b, head
  h as ``(b + b0) * heads + h0 + h`` instead, so a call over a dp rank's
  rows and an mp rank's heads draws the masks of their places in the
  global batch and heads (None: ``(0, 0, H)``, the local index); ``l``
  sums the undropped p, the survivors are divided by ``(float)(1 -
  p)``.  The kernels read the seed from device memory (a 0-dim int64
  tensor, its low 32 bits), so a captured
  launch takes whatever value the caller wrote before the replay; the
  wrappers also take a Python int, which they write into such a tensor.
  The public op draws the seed from an explicit CPU ``torch.Generator``
  (no device sync, the same seed on the CPU and the card) and writes it
  with `graph_state.device_seed`, which inside a captured train
  step hands out a persistent slot refilled with the same draw before
  every replay; the autograd function keeps the seed for the backward.

Like the Pallas kernels these give no mask gradient.  A mask that
requires grad (a learned bias) therefore takes the plain version under
autograd, which gives the mask its gradient: the reference's own
semantics, since the JAX op sends such a mask to its XLA attention
(``mask_trainable``).  That route launches no kernel, on the card too,
and counts in ``flash_attention.plain_routes``; every other call launches
the kernels or raises.  Each feature variant counts its own
launches (``VARIANT_LAUNCHES``): ``*_dropout`` (dropout alone) and
``*_masked`` (a mask or segment ids, with or without dropout).  The two
backward kernels sum the GQA heads of a kv head inside one block (no
atomics): two calls give the same bits.
"""
from __future__ import annotations

import ctypes
import math
from types import SimpleNamespace

import torch

from . import _build, dtype_code
from . import graph_state

NEG_INF = -1e30
SUPPORTED_HEAD_DIMS = (32, 64, 128)
#: launch counts of the feature variants, by name
VARIANT_LAUNCHES = {name: SimpleNamespace(launches=0) for name in (
    "flash_fwd_dropout", "flash_bwd_dkv_dropout", "flash_bwd_dq_dropout",
    "flash_fwd_masked", "flash_bwd_dkv_masked", "flash_bwd_dq_masked")}

#: the public op's seeds when the caller passes no generator (the JAX
#: package's ``next_rng_key`` state; never torch's global RNG)
_seed_generator = torch.Generator(device="cpu")
_seed_generator.manual_seed(0)


def draw_seed(generator=None) -> int:
    """One uint32 dropout seed from a CPU ``torch.Generator``."""
    gen = _seed_generator if generator is None else generator
    return int(torch.randint(0, 1 << 32, (), generator=gen,
                             dtype=torch.int64))


_M32 = 0xFFFFFFFF


def _mul32(x, c):
    """``x * c mod 2^32`` for int64 ``x`` in [0, 2^32) and a constant
    ``c``, with no product above 2^49 (no int64 overflow)."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def dropout_uniform(seed, head, q_pos, k_pos):
    """The Pallas counter hash (``_dropout_uniform``) in int64 arithmetic
    masked to 32 bits: fp32 uniforms on a 2^-24 grid for broadcasting
    int tensors ``head`` (``b * H + q head``), ``q_pos`` and ``k_pos``
    (absolute positions).  Bit for bit the kernels' and the JAX
    package's."""
    qp, kp, hd = (torch.as_tensor(t).long() for t in (q_pos, k_pos, head))
    x = (_mul32(qp, 0x9E3779B1) + _mul32(kp, 0x85EBCA77)) & _M32
    x = x ^ ((int(seed) + _mul32(hd, 0x27D4EB2F)) & _M32)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x2C1B3C6D)
    x = x ^ (x >> 12)
    x = _mul32(x, 0x297A2D39)
    x = x ^ (x >> 15)
    return (x >> 8).float() * (1.0 / (1 << 24))


def _offsets(offsets, h):
    """``(b0, h0, heads)`` of the hash's head index (None: local)."""
    if offsets is None:
        return 0, 0, h
    b0, h0, heads = (int(v) for v in offsets)
    if b0 < 0 or h0 < 0 or h0 + h > heads:
        raise ValueError(f"dropout offsets {offsets}: need b0 >= 0 and "
                         f"0 <= h0 <= heads - {h}")
    return b0, h0, heads


def _keep(seed, dropout, b, h, s, device, offsets=None):
    """The keep-mask ``[B, H, S, S]`` of a call: ``u >= (float)p``."""
    b0, h0, heads = _offsets(offsets, h)
    head = ((torch.arange(b, device=device) + b0) * heads)[:, None] + \
        h0 + torch.arange(h, device=device)[None, :]
    head = head.reshape(b, h, 1, 1)
    pos = torch.arange(s, device=device)
    u = dropout_uniform(seed, head, pos[:, None], pos[None, :])
    return u >= torch.full((), dropout, dtype=torch.float32, device=device)


def _zero(t):
    return torch.zeros((), dtype=t.dtype, device=t.device)


def _drop(t, keep, dropout):
    """``where(keep, t, 0) / (1 - p)``: a division by a 0-dim tensor on
    t's device, (float)(1.0 - p) rounded once, as JAX's weak-typed
    ``1.0 - dropout`` (a CUDA tensor divided by a Python number is
    multiplied by its reciprocal instead)."""
    div = torch.full((), 1.0 - dropout, dtype=torch.float32, device=t.device)
    return torch.where(keep, t, _zero(t)) / div


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


def _masked_logits(logits, causal, mask, segment_ids):
    """``_apply_masks`` on fp32 ``[B, H, S, S]`` logits: NEG_INF above the
    diagonal, then between segments that differ, then + the mask."""
    if causal:
        logits = logits.masked_fill(
            ~_causal_mask(logits.shape[-1], logits.device), NEG_INF)
    if segment_ids is not None:
        seg = segment_ids.long()
        logits = logits.masked_fill(seg[:, None, :, None]
                                    != seg[:, None, None, :], NEG_INF)
    if mask is not None:
        logits = logits + mask.float()
    return logits


def flash_attention_ref(q, k, v, causal=False, scale=None, head_major=False,
                        mask=None, segment_ids=None, dropout=0.0, seed=0,
                        offsets=None):
    """Plain PyTorch forward → (out like q, fp32 lse [B, H, S]): logits,
    softmax and ``p @ v`` in fp32 (K/V heads repeated for GQA), one
    rounding to q's dtype; the features as the Pallas forward applies
    them.  Differentiable by autograd in q, k and v."""
    b, h, h_kv, s, d = _geometry(q, k, v, head_major)
    qh, kh, vh = (_head_major(t, head_major).float() for t in (q, k, v))
    if h != h_kv:
        kh = kh.repeat_interleave(h // h_kv, dim=1)
        vh = vh.repeat_interleave(h // h_kv, dim=1)
    logits = _masked_logits(torch.matmul(qh, kh.transpose(-1, -2))
                            * _scale(scale, d), causal, mask, segment_ids)
    # the kernels' running max starts at NEG_INF
    m = logits.amax(dim=-1, keepdim=True).clamp_min(NEG_INF)
    p = torch.exp(logits - m)
    if mask is not None or segment_ids is not None:
        p = torch.where(logits > NEG_INF * 0.5, p, _zero(p))
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)  # noqa: E741
    if dropout > 0.0:
        p = _drop(p, _keep(seed, dropout, b, h, s, q.device, offsets),
                  dropout)
    out = torch.matmul(p, vh) / l
    lse = (m + torch.log(l)).squeeze(-1)
    return _head_major(out.to(q.dtype), head_major), lse


def _bwd_ref(q, k, v, dout, lse, delta, causal, scale, head_major, want_dq,
             want_dkv, mask=None, segment_ids=None, dropout=0.0, seed=0,
             offsets=None):
    """The Pallas backward kernels' math in plain PyTorch, fp32: p
    recomputed from ``lse``, ``dS = p (dP - delta) scale``; the GQA heads
    sharing a kv head are summed into its dK/dV.  With dropout, dV takes
    the dropped p and dS the undropped p with the dropped dP.  ``lse`` and
    ``delta`` are fp32 ``[B, H, S]``.  → (dq or None, dk or None, dv or
    None)."""
    b, h, h_kv, s, d = _geometry(q, k, v, head_major)
    rep = h // h_kv
    sc = _scale(scale, d)
    qh, kh, vh, doh = (_head_major(t, head_major).float()
                       for t in (q, k, v, dout))
    if rep > 1:
        kh = kh.repeat_interleave(rep, dim=1)
        vh = vh.repeat_interleave(rep, dim=1)
    logits = _masked_logits(torch.matmul(qh, kh.transpose(-1, -2)) * sc,
                            causal, mask, segment_ids)
    p = torch.exp(logits - lse[..., None])
    if mask is not None or segment_ids is not None:
        p = torch.where(logits > NEG_INF * 0.5, p, _zero(p))
    elif causal:
        p = p.masked_fill(~_causal_mask(s, q.device), 0.0)
    dp = torch.matmul(doh, vh.transpose(-1, -2))
    p_v = p
    if dropout > 0.0:
        keep = _keep(seed, dropout, b, h, s, q.device, offsets)
        p_v, dp = _drop(p, keep, dropout), _drop(dp, keep, dropout)
    ds = p * (dp - delta[..., None]) * sc
    dq = dk = dv = None
    if want_dq:
        dq = _head_major(torch.matmul(ds, kh).to(q.dtype), head_major)
    if want_dkv:
        dv = torch.matmul(p_v.transpose(-1, -2), doh)
        dk = torch.matmul(ds.transpose(-1, -2), qh)
        if rep > 1:
            dk = dk.reshape(b, h_kv, rep, s, d).sum(dim=2)
            dv = dv.reshape(b, h_kv, rep, s, d).sum(dim=2)
        dk = _head_major(dk.to(k.dtype), head_major)
        dv = _head_major(dv.to(v.dtype), head_major)
    return dq, dk, dv


def flash_bwd_dkv_ref(q, k, v, dout, lse, delta, causal=False, scale=None,
                      head_major=False, mask=None, segment_ids=None,
                      dropout=0.0, seed=0, offsets=None):
    """Plain version of the dK/dV kernel → (dk like k, dv like v)."""
    return _bwd_ref(q, k, v, dout, lse, delta, causal, scale, head_major,
                    False, True, mask, segment_ids, dropout, seed,
                    offsets)[1:]


def flash_bwd_dq_ref(q, k, v, dout, lse, delta, causal=False, scale=None,
                     head_major=False, mask=None, segment_ids=None,
                     dropout=0.0, seed=0, offsets=None):
    """Plain version of the dQ kernel → dq like q."""
    return _bwd_ref(q, k, v, dout, lse, delta, causal, scale, head_major,
                    True, False, mask, segment_ids, dropout, seed,
                    offsets)[0]


def _delta(out, dout, head_major):
    """``rowsum(dO * O)`` in fp32 as ``[B, H, S]`` (the plain version of
    `flash_bwd_delta`)."""
    delta = (dout.float() * out.float()).sum(dim=-1)
    return (delta if head_major else delta.transpose(1, 2)).contiguous()


def flash_attention_bwd_ref(q, k, v, out, lse, dout, causal=False,
                            scale=None, head_major=False, mask=None,
                            segment_ids=None, dropout=0.0, seed=0,
                            offsets=None):
    """Plain PyTorch backward → (dq, dk, dv): ``delta = rowsum(dO * O)``,
    then the two kernels' plain versions in one pass."""
    return _bwd_ref(q, k, v, dout, lse, _delta(out, dout, head_major), causal,
                    scale, head_major, True, True, mask, segment_ids, dropout,
                    seed, offsets)


def _prep(t, rows16=False):
    """A view the kernels can read: contiguous head dim; for 16-bit types
    (or with ``rows16``) also 16-byte aligned base and strides (TMA,
    16-byte loads); else a contiguous copy."""
    per = 16 // t.element_size()
    ok = t.stride(-1) == 1 and ((t.element_size() == 4 and not rows16) or (
        t.data_ptr() % 16 == 0
        and all(st % per == 0 for st in t.stride()[:-1])))
    return t if ok else t.contiguous()


def _tma_mask(mask):
    """The mask as the flash kernels' TMA reads it: keys contiguous, a
    16-byte aligned base and every stride of a dim longer than 1 a
    positive multiple of 4 elements; else a copy into rows padded to a
    multiple of 4 keys, seen through a view of the same shape."""
    if mask is None:
        return None
    ok = mask.stride(-1) == 1 and mask.data_ptr() % 16 == 0 and all(
        mask.stride(i) > 0 and mask.stride(i) % 4 == 0
        for i in range(3) if mask.shape[i] > 1)
    if ok:
        return mask
    keys = mask.shape[-1]
    padded = torch.empty(*mask.shape[:-1], -(-keys // 4) * 4,
                         dtype=mask.dtype, device=mask.device)
    padded[..., :keys].copy_(mask)
    return padded[..., :keys]


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


#: the C entry points' trailing feature arguments: mask, its strides,
#: segment ids, dropout, keep divisor, the seed's device address, the
#: hash's batch offset, head offset and head count
_FEATURE_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                 ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
                 ctypes.c_int, ctypes.c_int, ctypes.c_int]


def seed_tensor(seed, device):
    """The seed as the kernels read it: a 0-dim int64 tensor on ``device``
    (returned as it is), or a Python int written into a new one (a fill
    in stream order)."""
    if torch.is_tensor(seed):
        if seed.dim() != 0 or seed.dtype != torch.int64 \
                or seed.device != device:
            raise ValueError(f"seed must be a 0-dim int64 on {device} "
                             f"({seed.dtype} {tuple(seed.shape)} "
                             f"{seed.device})")
        return seed
    return torch.full((), int(seed) & _M32, dtype=torch.int64, device=device)


def _features(name, q, b, h, s, mask, segment_ids, dropout, seed,
              offsets=None):
    """Checks the features of a CUDA call → (mask, segment_ids, the seed
    tensor or None, the C arguments); the mask keeps its shape, read with
    stride 0 on a broadcast batch or head dim."""
    if not 0.0 <= dropout < 1.0:
        raise ValueError(f"{name}: dropout {dropout} outside [0, 1)")
    seed_t = seed_tensor(seed, q.device) if dropout > 0.0 else None
    mask_ptr = seg_ptr = None
    mask_st = (ctypes.c_longlong * 3)(0, 0, 0)
    if mask is not None:
        if mask.dim() != 4 or tuple(mask.shape[2:]) != (s, s) \
                or mask.shape[0] not in (1, b) or mask.shape[1] not in (1, h) \
                or mask.dtype != torch.float32 or mask.device != q.device:
            raise ValueError(f"{name}: mask {tuple(mask.shape)} "
                             f"{mask.dtype} must be fp32 [B|1, H|1, S, S] "
                             f"with B {b}, H {h}, S {s} on {q.device}")
        if mask.stride(-1) != 1:
            mask = mask.contiguous()
        mask_st = (ctypes.c_longlong * 3)(
            *(0 if mask.shape[i] == 1 else mask.stride(i) for i in range(3)))
        mask_ptr = _build.ptr(mask)
    if segment_ids is not None:
        if tuple(segment_ids.shape) != (b, s) \
                or segment_ids.dtype != torch.int32 \
                or segment_ids.device != q.device:
            raise ValueError(f"{name}: segment_ids {tuple(segment_ids.shape)}"
                             f" {segment_ids.dtype} must be int32 [{b}, {s}]"
                             f" on {q.device}")
        segment_ids = segment_ids.contiguous()
        seg_ptr = _build.ptr(segment_ids)
    args = [mask_ptr, mask_st, seg_ptr, float(dropout), float(1.0 - dropout),
            None if seed_t is None else _build.ptr(seed_t),
            *_offsets(offsets, h)]
    return mask, segment_ids, seed_t, args


def _count(fn, variant, mask, segment_ids, dropout):
    if mask is not None or segment_ids is not None:
        VARIANT_LAUNCHES[variant + "_masked"].launches += 1
    elif dropout > 0.0:
        VARIANT_LAUNCHES[variant + "_dropout"].launches += 1
    else:
        fn.launches += 1


def flash_attention_fwd(q, k, v, causal=False, scale=None, head_major=False,
                        mask=None, segment_ids=None, dropout=0.0, seed=0,
                        offsets=None):
    """→ (out like q, fp32 lse [B, H, S]).  CPU tensors take
    `flash_attention_ref`; CUDA tensors launch the forward kernel."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal, scale, head_major, mask,
                                   segment_ids, dropout, seed, offsets)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd: unsupported device "
                         f"{q.device}")
    b, h, h_kv, s, d = _geometry(q, k, v, head_major)
    _check_cuda_call("flash_attention_fwd", q, k, v, d)
    mask, segment_ids, _seed, feats = _features("flash_attention_fwd", q, b,
                                                h, s,
                                         _tma_mask(mask), segment_ids,
                                         dropout, seed, offsets)
    q, k, v = _prep(q), _prep(k), _prep(v)
    out = torch.empty_like(q)
    lse = torch.empty(b, h, s, dtype=torch.float32, device=q.device)
    if not q.numel():
        return out, lse
    fn = _build.function("ptt_flash_fwd", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_float,
        ctypes.c_int, ctypes.c_int] + _FEATURE_ARGS + [ctypes.c_void_p])
    with torch.cuda.device(q.device):
        err = fn(_build.ptr(q), _build.ptr(k), _build.ptr(v),
                 _build.ptr(out), _build.ptr(lse), b, h, h_kv, s, d,
                 _strides((q, k, v, out), head_major), _scale(scale, d),
                 int(bool(causal)), dtype_code(q), *feats,
                 _build.stream(q.device))
    _build.check(err, "ptt_flash_fwd")
    _count(flash_attention_fwd, "flash_fwd", mask, segment_ids, dropout)
    return out, lse


flash_attention_fwd.launches = 0

_BWD_ARGS = [ctypes.c_void_p] * 6


def flash_bwd_dkv(q, k, v, dout, lse, delta, causal, scale, head_major,
                  mask=None, segment_ids=None, dropout=0.0, seed=0,
                  offsets=None):
    """The dK/dV kernel → (dk like k, dv like v).  CPU tensors take
    `flash_bwd_dkv_ref`; CUDA tensors must come as `flash_attention_bwd`
    prepares them."""
    if q.device.type == "cpu":
        return flash_bwd_dkv_ref(q, k, v, dout, lse, delta, causal, scale,
                                 head_major, mask, segment_ids, dropout, seed,
                                 offsets)
    b, h, h_kv, s, d = _geometry(q, k, v, head_major)
    mask, segment_ids, _seed, feats = _features("flash_bwd_dkv", q, b, h, s,
                                         _tma_mask(mask), segment_ids,
                                         dropout, seed, offsets)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    fn = _build.function("ptt_flash_bwd_dkv", _BWD_ARGS + [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_float, ctypes.c_int, ctypes.c_int] + _FEATURE_ARGS
        + [ctypes.c_void_p])
    with torch.cuda.device(q.device):
        err = fn(_build.ptr(q), _build.ptr(k), _build.ptr(v),
                 _build.ptr(dout), _build.ptr(lse), _build.ptr(delta),
                 _build.ptr(dk), _build.ptr(dv), b, h, h_kv, s, d,
                 _strides((q, k, v, dout, dk, dv), head_major),
                 _scale(scale, d), int(bool(causal)), dtype_code(q), *feats,
                 _build.stream(q.device))
    _build.check(err, "ptt_flash_bwd_dkv")
    _count(flash_bwd_dkv, "flash_bwd_dkv", mask, segment_ids, dropout)
    return dk, dv


flash_bwd_dkv.launches = 0


def flash_bwd_dq(q, k, v, dout, lse, delta, causal, scale, head_major,
                 mask=None, segment_ids=None, dropout=0.0, seed=0,
                 offsets=None):
    """The dQ kernel → dq like q.  CPU tensors take `flash_bwd_dq_ref`."""
    if q.device.type == "cpu":
        return flash_bwd_dq_ref(q, k, v, dout, lse, delta, causal, scale,
                                head_major, mask, segment_ids, dropout, seed,
                                offsets)
    b, h, h_kv, s, d = _geometry(q, k, v, head_major)
    mask, segment_ids, _seed, feats = _features("flash_bwd_dq", q, b, h, s,
                                         _tma_mask(mask), segment_ids,
                                         dropout, seed, offsets)
    dq = torch.empty_like(q)
    fn = _build.function("ptt_flash_bwd_dq", _BWD_ARGS + [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_float,
        ctypes.c_int, ctypes.c_int] + _FEATURE_ARGS + [ctypes.c_void_p])
    with torch.cuda.device(q.device):
        err = fn(_build.ptr(q), _build.ptr(k), _build.ptr(v),
                 _build.ptr(dout), _build.ptr(lse), _build.ptr(delta),
                 _build.ptr(dq), b, h, h_kv, s, d,
                 _strides((q, k, v, dout, dq), head_major),
                 _scale(scale, d), int(bool(causal)), dtype_code(q), *feats,
                 _build.stream(q.device))
    _build.check(err, "ptt_flash_bwd_dq")
    _count(flash_bwd_dq, "flash_bwd_dq", mask, segment_ids, dropout)
    return dq


flash_bwd_dq.launches = 0


def flash_bwd_delta(out, dout, head_major):
    """The delta pass → ``rowsum(dO * O)``, fp32 ``[B, H, S]``.  CPU tensors
    take `_delta`; CUDA tensors launch the one-pass kernel (O and dO read
    once)."""
    if out.device.type == "cpu":
        return _delta(out, dout, head_major)
    if out.shape != dout.shape or out.dtype != dout.dtype \
            or out.device != dout.device or out.dim() != 4:
        raise ValueError(f"flash_bwd_delta: out {tuple(out.shape)} "
                         f"{out.dtype} and dout {tuple(dout.shape)} "
                         f"{dout.dtype} must match, 4-D, on one device")
    if head_major:
        b, h, s, d = out.shape
    else:
        b, s, h, d = out.shape
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"flash_bwd_delta: head_dim {d} is not supported; "
                         f"supported: {SUPPORTED_HEAD_DIMS}")
    out, dout = _prep(out, rows16=True), _prep(dout, rows16=True)
    delta = torch.empty(b, h, s, dtype=torch.float32, device=out.device)
    if not delta.numel():
        return delta
    fn = _build.function("ptt_flash_bwd_delta", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p])
    with torch.cuda.device(out.device):
        err = fn(_build.ptr(out), _build.ptr(dout), _build.ptr(delta), b, h,
                 s, d, _strides((out, dout), head_major), dtype_code(out),
                 _build.stream(out.device))
    _build.check(err, "ptt_flash_bwd_delta")
    flash_bwd_delta.launches += 1
    return delta


flash_bwd_delta.launches = 0


def dropout_rescale(x, dropout):
    """``x / (float)(1 - dropout)`` rounded once, for fp32 ``x``: the
    rescale the flash kernels apply to kept values.  CPU tensors take the
    plain division (`_drop` with every value kept); CUDA tensors launch
    the kernels' own rescale (`survivor`, csrc/flash_common.cuh), so a
    test can hold it against IEEE division bit for bit."""
    if x.dtype != torch.float32:
        raise TypeError(f"dropout_rescale: x is {x.dtype}, not float32")
    if not 0.0 <= dropout < 1.0:
        raise ValueError(f"dropout_rescale: dropout {dropout} not in [0, 1)")
    if x.device.type == "cpu":
        return _drop(x, torch.ones((), dtype=torch.bool), dropout)
    x = x.contiguous()
    out = torch.empty_like(x)
    if not x.numel():
        return out
    fn = _build.function("ptt_flash_dropout_rescale", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float,
        ctypes.c_float, ctypes.c_void_p])
    with torch.cuda.device(x.device):
        err = fn(_build.ptr(x), _build.ptr(out), x.numel(), dropout,
                 float(1.0 - dropout), _build.stream(x.device))
    _build.check(err, "ptt_flash_dropout_rescale")
    dropout_rescale.launches += 1
    return out


dropout_rescale.launches = 0


def flash_attention_bwd(q, k, v, out, lse, dout, causal=False, scale=None,
                        head_major=False, mask=None, segment_ids=None,
                        dropout=0.0, seed=0, offsets=None):
    """→ (dq, dk, dv) like q, k, v.  CPU tensors take
    `flash_attention_bwd_ref`; CUDA tensors launch the delta pass
    (`flash_bwd_delta`), then the dK/dV and dQ kernels with the forward's
    features and seed."""
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, out, lse, dout, causal,
                                       scale, head_major, mask, segment_ids,
                                       dropout, seed, offsets)
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
    if not q.numel():
        return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = flash_bwd_delta(out, dout, head_major)
    if dropout > 0.0:                    # one seed tensor for both kernels
        seed = seed_tensor(seed, q.device)
    feats = (_tma_mask(mask), segment_ids, dropout, seed, offsets)
    dk, dv = flash_bwd_dkv(q, k, v, dout, lse, delta, causal, scale,
                           head_major, *feats)
    dq = flash_bwd_dq(q, k, v, dout, lse, delta, causal, scale, head_major,
                      *feats)
    return dq, dk, dv


class FlashAttentionFunction(torch.autograd.Function):
    """Flash attention under autograd (the custom VJP of the JAX package's
    ``_flash_core``): the forward saves out, lse, the mask, the segment ids
    and the seed; the backward runs the two backward kernels with them.
    No gradient for the mask (as in the JAX kernels' VJP)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, head_major, mask, segment_ids,
                dropout, seed, offsets):
        out, lse = flash_attention_fwd(q, k, v, causal, scale, head_major,
                                       mask, segment_ids, dropout, seed,
                                       offsets)
        ctx.save_for_backward(q, k, v, out, lse, mask, segment_ids)
        ctx.cfg = (causal, scale, head_major)
        ctx.drop = (dropout, seed, offsets)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, mask, seg = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout, *ctx.cfg,
                                         mask, seg, *ctx.drop)
        return dq, dk, dv, None, None, None, None, None, None, None, None


def additive_mask(attn_mask):
    """The public op's mask as the kernels take it: a boolean mask becomes
    ``where(m, 0, NEG_INF)`` in fp32, any other is cast to fp32; the shape
    is kept (no expansion)."""
    if attn_mask is None:
        return None
    if attn_mask.dtype == torch.bool:
        return torch.zeros(attn_mask.shape, dtype=torch.float32,
                           device=attn_mask.device).masked_fill_(
                               ~attn_mask, NEG_INF)
    return attn_mask.float()


def flash_attention(query, key, value, attn_mask=None, dropout=0.0,
                    causal=False, training=True, scale=None,
                    segment_ids=None, head_major=False, generator=None,
                    dropout_offsets=None):
    """Public op: ``[B, S, H, D]`` (or ``[B, H, S, D]`` with
    ``head_major``) → attention output like ``query``; GQA when k/v carry
    fewer heads.  ``attn_mask`` (bool or additive, ``[B|1, H|1, S, S]``),
    ``segment_ids`` (``[B, S]``) and ``dropout`` (when ``training``) run
    inside the kernels; the dropout seed comes from ``generator``, a CPU
    ``torch.Generator`` (None: this module's own, never torch's global
    RNG).  Differentiable (`FlashAttentionFunction`) whenever an input
    requires grad under grad mode.  A mask that requires grad takes
    `flash_attention_ref` under autograd (the mask gets its gradient; no
    kernel runs) and adds one to ``flash_attention.plain_routes``.
    ``dropout_offsets`` ``(b0, h0, heads)``: the dropout hash keys batch
    row b and head h as ``(b + b0) * heads + h0 + h`` (a dp rank's rows
    and an mp rank's heads draw their global masks; None: local)."""
    dropout = float(dropout) if training else 0.0
    mask = additive_mask(attn_mask)
    seg = None if segment_ids is None else segment_ids.to(torch.int32)
    # a recomputed region (activation recompute) takes its first run's
    # seed back instead of drawing one
    seed = graph_state.logged_draw(lambda: graph_state.device_seed(
        lambda: draw_seed(generator), query.device)) if dropout > 0.0 else 0
    d = query.shape[-1]
    sc = _scale(scale, d)
    if attn_mask is not None and attn_mask.requires_grad:
        flash_attention.plain_routes += 1
        return flash_attention_ref(query, key, value, bool(causal), sc,
                                   bool(head_major), mask, seg, dropout,
                                   seed, dropout_offsets)[0]
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (query, key, value)):
        return FlashAttentionFunction.apply(query, key, value, bool(causal),
                                            sc, bool(head_major), mask, seg,
                                            dropout, seed, dropout_offsets)
    return flash_attention_fwd(query, key, value, causal, sc, head_major,
                               mask, seg, dropout, seed, dropout_offsets)[0]


#: calls routed to the plain version because their mask requires grad
flash_attention.plain_routes = 0
