"""Context parallelism for long sequences (port of
paddle_tpu/distributed/context_parallel.py): ring attention and Ulysses.

JAX wraps each body in ``shard_map`` over the mesh and lets GSPMD shard
the sequence over ``sep``.  Here a rank is a process holding its own
chunk: the ops take this rank's ``[B, S / sep, H, D]`` (its contiguous
rows ``r·S/sep … (r+1)·S/sep`` of the global sequence) and return its
chunk of the output.  The exchanges are `distributed.functional`'s
autograd functions, so the backward is the transpose JAX's ``shard_map``
gives (a rank's loss its own; the gradients of K and V travel the ring
back).

1. **Ring attention** (`ring_flash_attention`, body `_ring_attention_local`):
   K and V rotate around the sep group by `functional.ppermute` while
   each tick folds one block into a running fp32 log-sum-exp.  The body
   is plain torch in fp32, as JAX's is jnp (no Pallas kernel is
   involved); the causal mask is on global positions.  JAX rotates on
   every tick, the last too; nothing reads the last rotation, so the
   port skips it, and rotates K and V together (one exchange a tick).
2. **Ulysses** (`ulysses_attention`, body `_ulysses_local`): an
   all-to-all moves the sequence split to the heads, plain fp32
   attention runs on the whole sequence, and an all-to-all moves it
   back.

At sep 1, or without a topology holding the axis, both fall back to the
port's `nn.functional.flash_attention` (the CUDA kernels on the card), as
JAX falls back to its Pallas kernel.  JAX's ``_inside_manual_region``
(a sep region inside the pp pipeline's manual one) has no counterpart:
the parallel models refuse sep > 1 with pp > 1 (`check_sep_pp`).
"""
from __future__ import annotations

import math

import torch

from . import functional as Fn
from . import topology

_SEP_PP = ("sep_degree > 1 together with pp_degree > 1: context "
           "parallelism inside the pipeline's stages is not ported "
           "(ROADMAP A8)")


def check_sep_pp(hcg=None):
    """Raise `NotImplementedError` when the topology has both a sep and a
    pp axis above 1."""
    hcg = hcg or topology.get_hybrid_communicate_group()
    if hcg is not None and hcg.get_sep_parallel_world_size() > 1 and \
            hcg.get_pipe_parallel_world_size() > 1:
        raise NotImplementedError(_SEP_PP)


def _sep_group(axis, mesh):
    """The process group of ``axis`` (None: no such axis above 1)."""
    if mesh is not None:
        if axis not in mesh.dim_names or mesh.get_dim_size(axis) <= 1:
            return None
        return mesh.get_group(axis)
    hcg = topology.get_hybrid_communicate_group()
    if hcg is None or axis not in hcg.mesh.dim_names or \
            hcg.mesh.get_dim_size(axis) <= 1:
        return None
    check_sep_pp(hcg)
    return Fn._group(axis)


def _fallback(query, key, value, causal, scale):
    from ..nn.functional import flash_attention
    return flash_attention(query, key, value, causal=causal, scale=scale)


def _scale(scale, query):
    return scale if scale is not None else 1.0 / math.sqrt(
        int(query.shape[-1]))


def merge_block(state, qt, kb, vb, scale, rows=None, cols=None):
    """Fold one K/V block into the running fp32 softmax ``state`` = (m, l,
    acc) (JAX's scan step): ``qt`` ``[B, H, Sq, D]`` fp32, ``kb``, ``vb``
    ``[B, Sk, H, D]``; with ``rows`` and ``cols`` (the global positions
    of q's rows ``[Sq, 1]`` and the block's columns ``[1, Sk]``) causal.
    Rows that stay fully masked keep zero weight."""
    m, l, acc = state
    kt = kb.float().transpose(1, 2)                      # [B,H,Sk,D]
    vt = vb.float().transpose(1, 2)
    scores = torch.einsum("bhqd,bhkd->bhqk", qt, kt) * scale
    if rows is not None:
        scores = torch.where(cols <= rows, scores, -math.inf)
    new_m = torch.maximum(m, scores.amax(dim=-1))
    safe_m = torch.where(torch.isfinite(new_m), new_m, 0.0)
    p = torch.exp(scores - safe_m[..., None])
    p = torch.where(torch.isfinite(scores), p, 0.0)
    corr = torch.where(torch.isfinite(m), torch.exp(m - safe_m), 0.0)
    l = l * corr + p.sum(dim=-1)
    acc = acc * corr[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, vt)
    return new_m, l, acc


def start_state(q):
    """The empty running softmax of ``q`` ``[B, S, H, D]``: (m = -inf,
    l = 0, acc = 0) in fp32."""
    b, s, h, d = q.shape
    return (torch.full((b, h, s), -math.inf, device=q.device),
            torch.zeros((b, h, s), device=q.device),
            torch.zeros((b, h, s, d), device=q.device))


def finish_state(state, dtype):
    """The attention output ``[B, S, H, D]`` of a running softmax."""
    _, l, acc = state
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.transpose(1, 2).to(dtype)


def _ring_attention_local(q, k, v, group, causal, scale):
    """This rank's ring attention (JAX ``_ring_attention_local``): q, k,
    v ``[B, S_local, H, D]``, the rank's chunk of the sequence."""
    size, me = group.nranks, group.rank
    s = q.shape[1]
    qt = q.float().transpose(1, 2)                       # [B,H,Sq,D]
    state = start_state(q)
    kv = torch.stack([k, v])
    pos = torch.arange(s, device=q.device)
    perm = [(i, (i + 1) % size) for i in range(size)]
    for t in range(size):
        # blocks move to rank + 1 each tick: at tick t this rank holds
        # the block of rank (me - t) mod size; causal on global positions
        # (q row me·s + i, k column j·s + i)
        j = (me - t) % size
        rows, cols = (me * s + pos[:, None], j * s + pos[None, :]) \
            if causal else (None, None)
        state = merge_block(state, qt, kv[0], kv[1], scale, rows, cols)
        if t + 1 < size:
            kv = Fn.ppermute(kv, group, perm)
    return finish_state(state, q.dtype)


def ring_flash_attention(query, key, value, axis="sep", mesh=None,
                         causal=True, scale=None):
    """Ring attention over ``axis``: ``query``, ``key``, ``value`` are
    this rank's ``[B, S / sep, H, D]`` chunk; returns its chunk of the
    output (JAX's: the output sharded as the input)."""
    group = _sep_group(axis, mesh)
    if group is None:
        return _fallback(query, key, value, causal, scale)
    return _ring_attention_local(query, key, value, group, bool(causal),
                                 _scale(scale, query))


def _ulysses_local(q, k, v, group, causal, scale):
    """all-to-all seq → heads, plain fp32 attention, heads → seq (JAX
    ``_ulysses_local``): ``[B, S/sep, H, D]`` → ``[B, S, H/sep, D]`` →
    back."""
    def seq2head(t):
        return Fn.all_to_all(t, group, split_axis=2, concat_axis=1)

    qh, kh, vh = seq2head(q), seq2head(k), seq2head(v)
    s = qh.shape[1]
    qt, kt, vt = (t.float().transpose(1, 2) for t in (qh, kh, vh))
    scores = torch.einsum("bhqd,bhkd->bhqk", qt, kt) * scale
    if causal:
        keep = torch.ones(s, s, dtype=torch.bool,
                          device=q.device).tril()
        scores = scores.masked_fill(~keep, -math.inf)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, vt).transpose(1, 2)
    return Fn.all_to_all(out.to(q.dtype), group, split_axis=1,
                         concat_axis=2)


def ulysses_attention(query, key, value, axis="sep", mesh=None, causal=True,
                      scale=None):
    """DeepSpeed-Ulysses sequence parallelism over ``axis`` (this rank's
    ``[B, S / sep, H, D]`` chunk in, its chunk out); needs
    ``num_heads % sep_degree == 0``."""
    group = _sep_group(axis, mesh)
    if group is None:
        return _fallback(query, key, value, causal, scale)
    deg = group.nranks
    h = int(query.shape[2])
    if h % deg != 0:
        raise ValueError(
            f"ulysses needs num_heads ({h}) divisible by {axis} degree "
            f"({deg}); use ring_flash_attention instead")
    return _ulysses_local(query, key, value, group, bool(causal),
                          _scale(scale, query))


def split_sequence(x, axis="sep", mesh=None, seq_dim=1):
    """This rank's contiguous chunk of a ``[B, S, ...]`` tensor along
    ``seq_dim`` over ``axis`` (JAX commits the tensor seq-sharded over
    the axis; here the rank keeps its part); the tensor as it is without
    the axis.  The backward all-gathers the chunks' gradients."""
    from ..distributed.fleet.mp_layers import split_to_mp
    group = _sep_group(axis, mesh)
    if group is None:
        return x
    return split_to_mp(x, group, seq_dim)

