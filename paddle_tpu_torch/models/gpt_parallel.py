"""Hybrid-parallel GPT (port of paddle_tpu/models/gpt_parallel.py): the
GPT of `models.gpt` with its projections split over the model-parallel
group (Megatron) and its batch over the data-parallel one.

- The fused ``qkv_proj`` is a `ColumnParallelLinear` over 3 chunks (a
  rank's columns are its heads' q, k and v), ``out_proj`` a
  `RowParallelLinear`; the MLP's ``fc_in`` column, ``fc_out`` row.
- ``wte`` and ``wpe`` are `VocabParallelEmbedding` (JAX splits the
  position table too); the head is tied to ``wte``, so the logits are
  the rank's vocabulary slice.
- Attention runs on the rank's heads through the flash kernels; its
  dropout hash keys each row and head by its place in the global batch
  and heads (``dropout_offsets``), so a dp × mp run draws the masks one
  rank draws for the global batch.  The residual and embedding dropout
  draw from a device generator seeded by (``seed``, dp rank): the ranks
  of one mp group draw the same masks (their hidden states are copies),
  the dp ranks others.
- With ``labels`` no logits are gathered: the loss comes from the local
  slice (`_masked_parallel_ce` over `ParallelCrossEntropy`), and the
  logits returned are the rank's slice.  A process here holds its own
  rows and shards; unlike JAX's single controller, it has no global
  array to return.  Without labels (`generate`) the logits are gathered
  over mp, so every rank picks the same token.
- ``sequence_parallel`` splits the activations between blocks on the
  sequence over mp (the sequence-parallel linears; the layer norms'
  gradients summed over mp).
- At a sep degree above 1 (context parallel) the model takes the global
  ``[B, S]`` ids and labels, as JAX's does, and from the embedding on a
  rank works on its contiguous chunk of the sequence, rows ``r·S/sep …
  (r+1)·S/sep`` (JAX's GSPMD shards the sequence; a process here holds
  only its chunk): the positions are the chunk's global ones, the loss
  is the masked mean over the chunk, and the logits returned with
  ``labels`` are the rank's chunk and vocabulary slice.  Attention is
  `distributed.context_parallel.ring_flash_attention` with
  ``use_ring_attention`` (K and V rotate around the sep group; no
  attention dropout, as in JAX's ring); without it K, V and q are
  gathered over sep and the flash kernels run on the whole sequence,
  the rank keeping its rows (JAX's SDPA over the sequence GSPMD gathers;
  the dropout masks are one rank's).  `fleet.distributed_model` wraps
  the model in `SegmentParallel`, which averages the gradients over dp ×
  sep.  sep > 1 with pp > 1 raises `NotImplementedError` (ROADMAP A8).
- ``moe_every`` > 0 makes every ``moe_every``-th block's FFN an
  expert-parallel `MoELayer` (``num_experts`` experts split over mp, a
  GShard top-2 gate with ``moe_capacity``'s factors), as JAX's; its
  gates' aux losses are set on the gates and not added to the loss (JAX
  adds them nowhere).  With ``sequence_parallel`` or at sep > 1 it
  raises `NotImplementedError` (ROADMAP A8).

Build the model after `fleet.init` (its layers then hold their shards and
it binds its dp and mp ranks), or before and pass it to
`fleet.distributed_model`.  The loss of a rank is the mean over its rows;
the dp average of the gradients then equals the global batch's when the
ranks hold equal counts of labelled tokens.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..device import resolve_device, to_torch_dtype
from ..distributed import topology
from ..distributed.fleet.mp_layers import (ColumnParallelLinear,
                                           ColumnSequenceParallelLinear,
                                           ParallelCrossEntropy,
                                           RowParallelLinear,
                                           RowSequenceParallelLinear,
                                           VocabParallelEmbedding,
                                           copy_to_mp, gather_from_mp,
                                           mark_as_sequence_parallel_parameter,
                                           split_to_mp)
from ..distributed.fleet.utils import recompute
from ..incubate.nn import functional as IF
from ..nn import functional as F
from ..nn.functional import flash_attention
from ..nn.layers import Dropout, LayerNorm, deferred_init
from .gpt import GPTConfig, GPTModel, gpt_config  # noqa: F401

_MOE_SP = ("ParallelGPTForCausalLM(moe_every > 0) with sequence_parallel: "
           "the MoE layer takes the tokens whole on every mp rank "
           "(ROADMAP A8)")
_MOE_SEP = ("ParallelGPTForCausalLM(moe_every > 0) at sep > 1: the gates "
            "route over the dp ranks' batch, not a sequence's chunks "
            "(ROADMAP A8)")


def _mp():
    return topology.mp_group()


def _sep():
    """The topology's sep group when its degree is above 1, else None."""
    g = topology.sep_group()
    return g if g is not None and g.nranks > 1 else None


def _chunk(t, group, dim=1):
    """This rank's contiguous chunk of ``t`` along ``dim`` over
    ``group`` (ids, labels, positions: no gradient)."""
    n = t.shape[dim]
    if n % group.nranks:
        raise ValueError(f"a sequence of {n} does not split over the "
                         f"{group.nranks} ranks of the sep axis")
    c = n // group.nranks
    return t.narrow(dim, group.rank * c, c)


def _sep_attention(q, k, v, group, ring, **flash_kw):
    """Causal attention of this rank's chunk over the sep ``group``:
    ``q`` ``[b, h, c, d]``, ``k``, ``v`` ``[b, h_kv, c, d]`` (head-major)
    → its ``[b, h, c, d]``.  ``ring``: `context_parallel.
    ring_flash_attention` (kv heads repeated to the query heads, as JAX's
    Llama repeats them); else q, k and v gathered over sep (k and v's
    gradients reduce-scattered back) and the flash kernels over the whole
    sequence, the rank keeping its rows."""
    if ring:
        from ..distributed.context_parallel import ring_flash_attention
        n_rep = q.shape[1] // k.shape[1]
        if n_rep > 1:
            k, v = (t.repeat_interleave(n_rep, dim=1) for t in (k, v))
        out = ring_flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2), causal=True)
        return out.transpose(1, 2)
    c, r = q.shape[2], group.rank
    qf = gather_from_mp(q.contiguous(), group, 2)
    kf, vf = (gather_from_mp(t.contiguous(), group, 2, reduce_back=True)
              for t in (k, v))
    out = flash_attention(qf, kf, vf, causal=True, head_major=True,
                          **flash_kw)
    return out[:, :, r * c:(r + 1) * c]


def _masked_parallel_ce(loss_fn, logits, labels, vocab_size=None):
    """The mean of `ParallelCrossEntropy`'s per-token losses over the
    labels that are not ignored (JAX ``_masked_parallel_ce``); ``logits``
    ``[..., V / mp]`` (the local slice)."""
    flat = labels.reshape(-1)
    per_token = loss_fn(logits.reshape(-1, logits.shape[-1]), flat)
    valid = (flat != loss_fn.ignore_index).to(torch.float32)
    return per_token.sum() / valid.sum().clamp_min(1.0)


def _global_count(module):
    """Parameters of the global model: a split parameter counts for every
    rank of its group (mp, and the groups a ZeRO-3 part is gathered
    over)."""
    n = 0
    for p in module.parameters():
        k = p.numel() * (_mp().nranks if getattr(p, "mp_split",
                                                 False) else 1)
        slot = getattr(p, "_gather_slot", None)
        for group, _ in (slot.steps if slot is not None else ()):
            k *= group.nranks
        n += k
    return n


def _ranks(hcg):
    """(dp rank, mp rank) of this process in ``hcg`` ((0, 0) without)."""
    if hcg is None:
        return 0, 0
    return hcg.get_data_parallel_rank(), hcg.get_model_parallel_rank()


_SP_CACHE = ("a sequence-parallel model decodes no cache: build one with "
             "sequence_parallel=False from the same weights")
_SEP_CACHE = ("a model at sep > 1 decodes no cache: decode under a topology "
              "without a sep axis, from the same weights")


def _column(sp):
    return ColumnSequenceParallelLinear if sp else ColumnParallelLinear


def _row(sp):
    return RowSequenceParallelLinear if sp else RowParallelLinear


class ParallelGPTAttention(nn.Module):
    def __init__(self, config: GPTConfig, use_ring_attention=False,
                 *, sequence_parallel=False, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.config = config
        self.use_ring_attention = use_ring_attention
        h = config.hidden_size
        std = config.initializer_range
        out_std = std / math.sqrt(2 * config.num_layers)
        self.qkv_proj = _column(sequence_parallel)(
            h, 3 * h, gather_output=False, std=std, chunks=3, device=device,
            dtype=dtype)
        self.out_proj = _row(sequence_parallel)(
            h, h, input_is_parallel=True, std=out_std, device=device,
            dtype=dtype)
        self.local_heads = config.num_heads // self.qkv_proj.world_size
        self.generator = None         # CPU generator of the flash seeds
        self.dp_rank = self.mp_rank = 0   # bound by the model

    def forward(self, x, cache=None):
        cfg = self.config
        b = x.shape[0]
        hl, d = self.local_heads, cfg.head_dim
        qkv = self.qkv_proj(x)
        s = qkv.shape[1]
        qkv = qkv.reshape(b, s, 3, hl, d)
        if cache is not None:
            q, k, v = qkv.unbind(dim=2)
            if "page_table" in cache:
                out = IF.paged_cache_attention(q, k, v, cache)
            else:
                out, cache["k"], cache["v"] = IF.masked_multihead_attention(
                    q, k, v, cache["k"], cache["v"], cache["offset"])
            return self.out_proj(out.reshape(b, s, hl * d))
        q, k, v = (t.transpose(1, 2) for t in qkv.unbind(dim=2))
        kw = dict(dropout=cfg.attn_dropout, training=self.training,
                  generator=self.generator,
                  dropout_offsets=(self.dp_rank * b, self.mp_rank * hl,
                                   cfg.num_heads))
        sep = _sep()
        if sep is not None:
            out = _sep_attention(q, k, v, sep, self.use_ring_attention, **kw)
        else:
            out = flash_attention(q, k, v, causal=True, head_major=True,
                                  **kw)
        return self.out_proj(out.transpose(1, 2).reshape(b, s, hl * d))


class ParallelGPTMLP(nn.Module):
    def __init__(self, config: GPTConfig, *, sequence_parallel=False,
                 device=None, dtype=torch.float32):
        super().__init__()
        h, m = config.hidden_size, config.intermediate_size
        std = config.initializer_range
        out_std = std / math.sqrt(2 * config.num_layers)
        self.fc_in = _column(sequence_parallel)(
            h, m, gather_output=False, std=std, device=device, dtype=dtype)
        self.fc_out = _row(sequence_parallel)(
            m, h, input_is_parallel=True, std=out_std, device=device,
            dtype=dtype)

    def forward(self, x):
        return self.fc_out(F.gelu(self.fc_in(x), approximate=True))


class ParallelGPTBlock(nn.Module):
    def __init__(self, config: GPTConfig, sequence_parallel=False,
                 use_ring_attention=False, use_moe=False, num_experts=8,
                 moe_capacity=None, *, device=None, dtype=torch.float32):
        super().__init__()
        if use_moe and sequence_parallel:
            raise NotImplementedError(_MOE_SP)
        self.sequence_parallel = sequence_parallel
        self.use_recompute = config.use_recompute
        kw = dict(epsilon=config.layer_norm_eps, device=device, dtype=dtype)
        self.ln_1 = LayerNorm(config.hidden_size, **kw)
        self.attn = ParallelGPTAttention(
            config, use_ring_attention, sequence_parallel=sequence_parallel,
            device=device, dtype=dtype)
        self.ln_2 = LayerNorm(config.hidden_size, **kw)
        if use_moe:
            # the expert-parallel FFN: experts split over mp
            from ..incubate.distributed.models.moe import MoELayer
            gate = {"type": "gshard", "top_k": 2}
            if moe_capacity is not None:
                # (train, eval) capacity factors; small ones drop tokens
                gate["capacity"] = moe_capacity
            self.mlp = MoELayer(d_model=config.hidden_size,
                                num_expert=num_experts,
                                d_hidden=config.intermediate_size,
                                gate=gate, device=device, dtype=dtype)
        else:
            self.mlp = ParallelGPTMLP(config,
                                      sequence_parallel=sequence_parallel,
                                      device=device, dtype=dtype)
        self.dropout = Dropout(config.dropout)
        if sequence_parallel:
            for ln in (self.ln_1, self.ln_2):
                for p in ln.parameters():
                    mark_as_sequence_parallel_parameter(p)

    def forward(self, x, cache=None):
        if self.use_recompute and cache is None and x.requires_grad:
            return recompute(self._block_fwd, x)
        return self._block_fwd(x, cache=cache)

    def _block_fwd(self, x, cache=None):
        x = x + self.dropout(self.attn(self.ln_1(x), cache=cache))
        return x + self.dropout(self.mlp(self.ln_2(x)))


class ParallelGPTModel(nn.Module):
    def __init__(self, config: GPTConfig, sequence_parallel=False,
                 use_ring_attention=False, moe_every=0, num_experts=8,
                 moe_capacity=None, *, device=None, dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        dtype = to_torch_dtype(dtype)
        self.config = config
        self.sequence_parallel = sequence_parallel
        std = config.initializer_range
        self.wte = VocabParallelEmbedding(config.vocab_size,
                                          config.hidden_size, std=std,
                                          device=device, dtype=dtype)
        self.wpe = VocabParallelEmbedding(config.max_seq_len,
                                          config.hidden_size, std=std,
                                          device=device, dtype=dtype)
        self.drop = Dropout(config.dropout)
        self.moe_every = moe_every
        self.h = nn.ModuleList([
            ParallelGPTBlock(
                config, sequence_parallel, use_ring_attention,
                use_moe=moe_every > 0 and (i + 1) % moe_every == 0,
                num_experts=num_experts, moe_capacity=moe_capacity,
                device=device, dtype=dtype)
            for i in range(config.num_layers)])
        self.ln_f = LayerNorm(config.hidden_size,
                              epsilon=config.layer_norm_eps, device=device,
                              dtype=dtype)
        if sequence_parallel:
            for p in self.ln_f.parameters():
                mark_as_sequence_parallel_parameter(p)

    def forward(self, input_ids, position_ids=None, caches=None):
        b, s = input_ids.shape
        if self.sequence_parallel and caches is not None:
            raise ValueError(_SP_CACHE)
        sep = _sep()
        if sep is not None:
            if caches is not None:
                raise ValueError(_SEP_CACHE)
            if self.moe_every > 0:
                raise NotImplementedError(_MOE_SEP)
            if position_ids is None:
                position_ids = GPTModel._positions(self, b, s,
                                                   input_ids.device, None)
            input_ids = _chunk(input_ids, sep)
            position_ids = _chunk(position_ids, sep, -1)
        if position_ids is None:
            position_ids = GPTModel._positions(self, b, s, input_ids.device,
                                               caches)
        x = self.drop(self.wte(input_ids) + self.wpe(position_ids))
        if self.sequence_parallel:
            x = split_to_mp(x, _mp(), 1)
        for i, block in enumerate(self.h):
            x = block(x, cache=None if caches is None else caches[i])
        x = self.ln_f(x)
        return gather_from_mp(x, _mp(), 1) if self.sequence_parallel else x


def _lm_output(loss_fn, logits, labels):
    """The parallel models' output: with ``labels`` ``(local logits,
    loss)`` over the rank's chunk (its labels cut from the global ones at
    sep > 1); without, the logits gathered over mp and sep."""
    sep = _sep()
    if labels is not None:
        if sep is not None:
            labels = _chunk(labels, sep)
        return logits, _masked_parallel_ce(loss_fn, logits, labels)
    logits = gather_from_mp(logits, _mp(), -1)
    return logits if sep is None else gather_from_mp(logits, sep, 1)


class ParallelGPTForCausalLM(nn.Module):
    """GPT for the hybrid mesh::

        fleet.init(is_collective=True, strategy=strategy)
        model = fleet.distributed_model(ParallelGPTForCausalLM(cfg))

    ``ParallelGPTForCausalLM(cfg, sequence_parallel=False,
    use_ring_attention=False, moe_every=0, num_experts=8,
    moe_capacity=None, *, device=None, dtype=torch.float32, seed=0)``:
    the parameters are drawn as `GPTForCausalLM`'s (the same generator,
    the same order: each rank keeps its part of the global draw, so the
    global model equals the one-rank model of that seed)."""

    def __init__(self, config: GPTConfig, sequence_parallel=False,
                 use_ring_attention=False, moe_every=0, num_experts=8,
                 moe_capacity=None, *, device=None, dtype=torch.float32,
                 seed=0):
        super().__init__()
        dev = resolve_device(device)
        self.config = config
        self.seed = int(seed)
        with deferred_init():
            self.gpt = ParallelGPTModel(config, sequence_parallel,
                                        use_ring_attention, moe_every,
                                        num_experts, moe_capacity,
                                        device=dev, dtype=dtype)
        gen = torch.Generator(device=dev)
        gen.manual_seed(self.seed)
        with torch.no_grad():
            for mod in self.modules():
                if hasattr(mod, "reset_parameters"):
                    mod.reset_parameters(gen)
        self.loss_fn = ParallelCrossEntropy()
        self.flash_generator = torch.Generator(device="cpu")
        self.flash_generator.manual_seed(self.seed)
        self.dropout_generator = torch.Generator(device=dev)
        for mod in self.modules():
            if isinstance(mod, ParallelGPTAttention):
                mod.generator = self.flash_generator
            elif isinstance(mod, Dropout):
                mod.generator = self.dropout_generator
        self._bind_topology(topology.get_hybrid_communicate_group())

    def _bind_topology(self, hcg):
        """Take this rank's place: its dp and mp ranks, the dropout
        generator seeded by (seed, dp rank, sep rank: the chunks of a
        sequence draw their own masks), the loss's mp group."""
        dp_rank, mp_rank = _ranks(hcg)
        sep_rank, sep_n = 0, 1
        if hcg is not None:
            from ..distributed.context_parallel import check_sep_pp
            check_sep_pp(hcg)
            sep_rank = hcg.get_sep_parallel_rank()
            sep_n = hcg.get_sep_parallel_world_size()
        for mod in self.modules():
            if isinstance(mod, ParallelGPTAttention):
                mod.dp_rank, mod.mp_rank = dp_rank, mp_rank
        self.dropout_generator.manual_seed(
            (self.seed + 0x9E3779B97F4A7C15 * (dp_rank * sep_n + sep_rank))
            % (1 << 63))
        self.loss_fn.mp_group = _mp()

    @property
    def cache_kv_heads(self):
        """The heads a KV cache of this rank holds (its own)."""
        return self.gpt.h[0].attn.local_heads

    @property
    def position_rows(self):
        return self.config.max_seq_len

    def forward(self, input_ids, labels=None, position_ids=None,
                caches=None):
        """With ``labels``: ``(local logits [B, S / sep, V / mp], loss)``
        (the rank's chunk and vocabulary slice); without: the logits
        gathered over mp and sep, ``[B, S, V]``."""
        hidden = self.gpt(input_ids, position_ids, caches=caches)
        logits = F.linear(copy_to_mp(hidden, _mp()), self.gpt.wte.weight.T)
        return _lm_output(self.loss_fn, logits, labels)

    def generate(self, input_ids, max_new_tokens=32, temperature=0.0,
                 top_k=None, top_p=None, repetition_penalty=None,
                 use_cache=True, eos_token_id=None, *, generator=None,
                 page_size=None):
        """Incremental decoding (`models.generation.generate`) on the
        rank's heads; every rank of the mp group returns the same ids."""
        from .generation import generate
        return generate(self, input_ids, max_new_tokens=max_new_tokens,
                        temperature=temperature, top_k=top_k, top_p=top_p,
                        repetition_penalty=repetition_penalty,
                        use_cache=use_cache, eos_token_id=eos_token_id,
                        generator=generator, page_size=page_size)

    def num_params(self, non_embedding=True):
        """The global model's parameters, less ``wpe`` when
        ``non_embedding``."""
        n = _global_count(self)
        if non_embedding:
            n -= self.config.max_seq_len * self.config.hidden_size
        return n

    def flops_per_token(self, seq_len=None):
        cfg = self.config
        s = seq_len or cfg.max_seq_len
        return 6 * self.num_params() + \
            12 * cfg.num_layers * cfg.hidden_size * s
