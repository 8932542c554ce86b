"""Hybrid-parallel Llama (port of paddle_tpu/models/llama_parallel.py):
the Llama of `models.llama` with its projections split over the
model-parallel group and its batch over the data-parallel one, laid out
as `models.gpt_parallel` lays GPT out.

- q, k, v are `ColumnParallelLinear` (a rank's heads), ``o_proj`` a
  `RowParallelLinear`; the SwiGLU MLP's gate and up column, down row;
  ``embed_tokens`` a `VocabParallelEmbedding`, the untied ``lm_head`` a
  column layer over the vocabulary (the logits' slice feeds
  `ParallelCrossEntropy` ungathered).  The RMS norms are copies on every
  rank (the RMS-norm kernels run on each).
- Attention runs on the rank's heads through the rope and flash kernels.
  With ``num_kv_heads % mp == 0`` each rank holds its kv heads and the
  kernel indexes the shared ones natively (GQA); otherwise (JAX's
  ``_constrain_heads`` replicates such kv heads) k and v are gathered
  over mp and repeated to the rank's query heads (`_repeat_kv`).
- With ``caches=`` attention reads a KV cache of the rank's kv heads
  (``cache_kv_heads``): the dense one of `generate` or a paged one, whose
  decode step is the paged-decode kernel on the local heads.
- With ``labels`` no logits are gathered: the loss comes from the local
  vocabulary slice and the logits returned are the rank's slice (a
  process holds no global array, unlike JAX's single controller);
  without labels the logits are gathered over mp, so every rank of a
  `generate` picks the same token.
- At a sep degree above 1 a rank works on its contiguous chunk of the
  global ``[B, S]`` sequence as `models.gpt_parallel` lays it out; rope
  takes the chunk's global positions (JAX passes none: GSPMD keeps the
  global ones), attention is the ring (``use_ring_attention``, the kv
  heads repeated to the query heads as JAX repeats them) or the
  gathered lane.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..device import resolve_device, to_torch_dtype
from ..distributed import topology
from ..distributed.fleet.mp_layers import (ParallelCrossEntropy,
                                           VocabParallelEmbedding,
                                           copy_to_mp, gather_from_mp,
                                           mark_as_sequence_parallel_parameter,
                                           split_to_mp)
from ..incubate.nn import functional as IF
from ..nn import functional as F
from ..nn.functional import flash_attention
from ..nn.layers import RMSNorm, deferred_init
from .gpt_parallel import (_SEP_CACHE, _SP_CACHE, _chunk, _column,
                           _global_count, _lm_output, _mp, _row, _sep,
                           _sep_attention)
from .llama import LlamaConfig, llama_config  # noqa: F401


def _repeat_kv(x, n_rep):
    """``[b, s, kv, d]`` → ``[b, s, kv * n_rep, d]``, each kv head repeated
    for the query heads of its group."""
    if n_rep == 1:
        return x
    return x.repeat_interleave(n_rep, dim=2)


class ParallelLlamaAttention(nn.Module):
    def __init__(self, config: LlamaConfig, use_ring_attention=False,
                 *, sequence_parallel=False, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.config = config
        self.use_ring_attention = use_ring_attention
        h, d = config.hidden_size, config.head_dim
        kv = config.num_kv_heads * d
        std = config.initializer_range
        out_std = std / math.sqrt(2 * config.num_layers)
        col, row = _column(sequence_parallel), _row(sequence_parallel)
        kw = dict(has_bias=False, std=std, device=device, dtype=dtype)
        self.q_proj = col(h, h, gather_output=False, **kw)
        n = self.q_proj.world_size
        #: kv heads split over mp (native GQA) or gathered and repeated
        self.kv_split = config.num_kv_heads % n == 0
        self.k_proj = col(h, kv, gather_output=not self.kv_split, **kw)
        self.v_proj = col(h, kv, gather_output=not self.kv_split, **kw)
        self.o_proj = row(h, h, has_bias=False, input_is_parallel=True,
                          std=out_std, device=device, dtype=dtype)
        self.local_heads = config.num_heads // n
        self.kv_heads = config.num_kv_heads // n if self.kv_split \
            else self.local_heads

    def _local_kv(self, t):
        """The kv heads this rank's query heads read: its own split, or
        the gathered ones repeated and cut to its query heads."""
        if self.kv_split:
            return t
        cfg = self.config
        hl, r = self.local_heads, self.q_proj.rank
        full = _repeat_kv(t, cfg.num_heads // cfg.num_kv_heads)
        return full[:, :, r * hl:(r + 1) * hl]

    def forward(self, x, cache=None):
        cfg = self.config
        b = x.shape[0]
        d = cfg.head_dim
        xc = self.q_proj.region_input(x)      # one input for q, k and v
        q = self.q_proj.local_forward(xc)
        s = q.shape[1]
        q = q.reshape(b, s, self.local_heads, d)
        kv_in = cfg.num_kv_heads // (1 if not self.kv_split
                                     else self.q_proj.world_size)
        k = self.k_proj.local_forward(xc).reshape(b, s, kv_in, d)
        v = self.v_proj.local_forward(xc).reshape(b, s, kv_in, d)
        if cache is None:
            sep = _sep()
            pos = None if sep is None else _chunk(
                torch.arange(s * sep.nranks, dtype=torch.int32,
                             device=x.device), sep, 0)
            q, k, _ = IF.fused_rotary_position_embedding(
                q, k, position_ids=pos, rotary_emb_base=cfg.rope_theta)
            k, v = self._local_kv(k), self._local_kv(v)
            q, k, v = (t.transpose(1, 2) for t in (q, k, v))
            if sep is not None:
                out = _sep_attention(q, k, v, sep, self.use_ring_attention,
                                     training=self.training)
            else:
                out = flash_attention(q, k, v, causal=True,
                                      training=self.training,
                                      head_major=True)
            return self.o_proj(out.transpose(1, 2).reshape(b, s, -1))
        off = torch.as_tensor(cache["offset"]).to(x.device)
        pos = torch.arange(s, dtype=torch.int32, device=x.device)
        pos = off.reshape(b, 1) + pos.reshape(1, s) if off.dim() == 1 \
            else pos + off
        q, k, _ = IF.fused_rotary_position_embedding(
            q, k, position_ids=pos, rotary_emb_base=cfg.rope_theta)
        k, v = self._local_kv(k), self._local_kv(v)
        if "page_table" in cache:
            out = IF.paged_cache_attention(q, k, v, cache)
        else:
            out, cache["k"], cache["v"] = IF.masked_multihead_attention(
                q, k, v, cache["k"], cache["v"], cache["offset"])
        return self.o_proj(out.reshape(b, s, -1))


class ParallelLlamaMLP(nn.Module):
    def __init__(self, config: LlamaConfig, *, sequence_parallel=False,
                 device=None, dtype=torch.float32):
        super().__init__()
        h, m = config.hidden_size, config.intermediate_size
        std = config.initializer_range
        out_std = std / math.sqrt(2 * config.num_layers)
        col, row = _column(sequence_parallel), _row(sequence_parallel)
        kw = dict(has_bias=False, device=device, dtype=dtype)
        self.gate_proj = col(h, m, gather_output=False, std=std, **kw)
        self.up_proj = col(h, m, gather_output=False, std=std, **kw)
        self.down_proj = row(m, h, input_is_parallel=True, std=out_std,
                             **kw)

    def forward(self, x):
        xc = self.gate_proj.region_input(x)   # one input for gate and up
        return self.down_proj(F.silu(self.gate_proj.local_forward(xc))
                              * self.up_proj.local_forward(xc))


class ParallelLlamaBlock(nn.Module):
    def __init__(self, config: LlamaConfig, sequence_parallel=False,
                 use_ring_attention=False, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.sequence_parallel = sequence_parallel
        kw = dict(epsilon=config.rms_norm_eps, device=device, dtype=dtype)
        self.input_layernorm = RMSNorm(config.hidden_size, **kw)
        self.self_attn = ParallelLlamaAttention(
            config, use_ring_attention, sequence_parallel=sequence_parallel,
            device=device, dtype=dtype)
        self.post_attention_layernorm = RMSNorm(config.hidden_size, **kw)
        self.mlp = ParallelLlamaMLP(config,
                                    sequence_parallel=sequence_parallel,
                                    device=device, dtype=dtype)
        if sequence_parallel:
            for norm in (self.input_layernorm,
                         self.post_attention_layernorm):
                mark_as_sequence_parallel_parameter(norm.weight)

    def forward(self, x, cache=None):
        x = x + self.self_attn(self.input_layernorm(x), cache=cache)
        return x + self.mlp(self.post_attention_layernorm(x))


class ParallelLlamaModel(nn.Module):
    def __init__(self, config: LlamaConfig, sequence_parallel=False,
                 use_ring_attention=False, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        dtype = to_torch_dtype(dtype)
        self.config = config
        self.sequence_parallel = sequence_parallel
        self.embed_tokens = VocabParallelEmbedding(
            config.vocab_size, config.hidden_size,
            std=config.initializer_range, device=device, dtype=dtype)
        self.layers = nn.ModuleList([
            ParallelLlamaBlock(config, sequence_parallel, use_ring_attention,
                               device=device, dtype=dtype)
            for _ in range(config.num_layers)])
        self.norm = RMSNorm(config.hidden_size, epsilon=config.rms_norm_eps,
                            device=device, dtype=dtype)
        if sequence_parallel:
            mark_as_sequence_parallel_parameter(self.norm.weight)

    def forward(self, input_ids, caches=None):
        if self.sequence_parallel and caches is not None:
            raise ValueError(_SP_CACHE)
        sep = _sep()
        if sep is not None:
            if caches is not None:
                raise ValueError(_SEP_CACHE)
            input_ids = _chunk(input_ids, sep)
        x = self.embed_tokens(input_ids)
        if self.sequence_parallel:
            x = split_to_mp(x, _mp(), 1)
        for i, blk in enumerate(self.layers):
            x = blk(x, cache=None if caches is None else caches[i])
        x = self.norm(x)
        return gather_from_mp(x, _mp(), 1) if self.sequence_parallel else x


class ParallelLlamaForCausalLM(nn.Module):
    """Llama for the hybrid mesh::

        fleet.init(is_collective=True, strategy=strategy)
        model = fleet.distributed_model(ParallelLlamaForCausalLM(cfg))

    ``ParallelLlamaForCausalLM(cfg, sequence_parallel=False,
    use_ring_attention=False, *, device=None, dtype=torch.float32,
    seed=0)``: the parameters are drawn as `LlamaForCausalLM`'s (the same
    generator and order, each rank keeping its part of the global draw),
    so the global model equals the one-rank model of that seed."""

    def __init__(self, config: LlamaConfig, sequence_parallel=False,
                 use_ring_attention=False, *, device=None,
                 dtype=torch.float32, seed=0):
        super().__init__()
        dev = resolve_device(device)
        self.config = config
        with deferred_init():
            self.llama = ParallelLlamaModel(config, sequence_parallel,
                                            use_ring_attention, device=dev,
                                            dtype=dtype)
            self.lm_head = None if config.tie_word_embeddings else \
                _column(False)(config.hidden_size, config.vocab_size,
                               has_bias=False, gather_output=False,
                               device=dev, dtype=dtype)
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        with torch.no_grad():
            for mod in self.modules():
                if hasattr(mod, "reset_parameters"):
                    mod.reset_parameters(gen)
        self.loss_fn = ParallelCrossEntropy()

    def _bind_topology(self, hcg):
        if hcg is not None:
            from ..distributed.context_parallel import check_sep_pp
            check_sep_pp(hcg)
        self.loss_fn.mp_group = _mp()

    @property
    def cache_kv_heads(self):
        """The kv heads a KV cache of this rank holds."""
        return self.llama.layers[0].self_attn.kv_heads

    def forward(self, input_ids, labels=None, caches=None):
        """With ``labels``: ``(local logits [B, S / sep, V / mp], loss)``
        (the rank's chunk and vocabulary slice); without: the logits
        gathered over mp and sep, ``[B, S, V]``."""
        hidden = self.llama(input_ids, caches=caches)
        if self.lm_head is not None:
            logits = self.lm_head(hidden)
        else:
            logits = F.linear(copy_to_mp(hidden, _mp()),
                              self.llama.embed_tokens.weight.T)
        return _lm_output(self.loss_fn, logits, labels)

    def generate(self, input_ids, max_new_tokens=32, temperature=0.0,
                 top_k=None, top_p=None, repetition_penalty=None,
                 use_cache=True, eos_token_id=None, *, generator=None,
                 page_size=None):
        """Incremental decoding (`models.generation.generate`) on the
        rank's heads, dense or paged (``page_size``) caches; every rank of
        the mp group returns the same ids."""
        from .generation import generate
        return generate(self, input_ids, max_new_tokens=max_new_tokens,
                        temperature=temperature, top_k=top_k, top_p=top_p,
                        repetition_penalty=repetition_penalty,
                        use_cache=use_cache, eos_token_id=eos_token_id,
                        generator=generator, page_size=page_size)

    def num_params(self):
        """The global model's parameters."""
        return _global_count(self)

    def flops_per_token(self, seq_len=None):
        cfg = self.config
        s = seq_len or cfg.max_seq_len
        return 6 * self.num_params() + \
            12 * cfg.num_layers * cfg.hidden_size * s
