"""Llama model family (port of paddle_tpu/models/llama.py): RMSNorm
pre-norm, rotary position embeddings, SwiGLU MLP, grouped-query
attention, with the JAX package's parameter names and ``[in, out]``
Linear layout so its state dicts load unchanged (``convert.py``).

This slice ports the cache path only (``caches=`` given), the path the
serving engine drives.  The full forward without a cache is the flash
attention kernel's path and raises until that kernel is ported.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn

from ..device import resolve_device, to_torch_dtype
from ..incubate.nn import functional as IF
from ..nn import functional as F
from ..nn.layers import Embedding, Linear, RMSNorm


@dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 0             # 0 -> num_heads (MHA); < heads = GQA
    intermediate_size: int = 0        # 0 -> llama default (8h/3 rounded)
    max_seq_len: int = 4096
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-5
    initializer_range: float = 0.02
    use_flash_attention: bool = True
    tie_word_embeddings: bool = False

    def __post_init__(self):
        if self.num_kv_heads == 0:
            self.num_kv_heads = self.num_heads
        if self.intermediate_size == 0:
            # llama: 2/3 * 4h rounded up to a multiple of 256
            m = int(8 * self.hidden_size / 3)
            self.intermediate_size = 256 * ((m + 255) // 256)
        if self.num_heads % self.num_kv_heads:
            raise ValueError("num_heads must be divisible by num_kv_heads")

    @property
    def head_dim(self):
        return self.hidden_size // self.num_heads


LLAMA2_7B = dict(hidden_size=4096, num_layers=32, num_heads=32,
                 intermediate_size=11008)
LLAMA2_13B = dict(hidden_size=5120, num_layers=40, num_heads=40,
                  intermediate_size=13824)
LLAMA2_70B = dict(hidden_size=8192, num_layers=80, num_heads=64,
                  num_kv_heads=8, intermediate_size=28672)
TINY_LLAMA = dict(hidden_size=128, num_layers=2, num_heads=4,
                  num_kv_heads=2, intermediate_size=384, vocab_size=512,
                  max_seq_len=256)


def llama_config(name: str, **overrides) -> LlamaConfig:
    presets = {"llama2-7b": LLAMA2_7B, "llama2-13b": LLAMA2_13B,
               "llama2-70b": LLAMA2_70B, "tiny": TINY_LLAMA}
    cfg = dict(presets[name])
    cfg.update(overrides)
    return LlamaConfig(**cfg)


class LlamaAttention(nn.Module):
    def __init__(self, config: LlamaConfig, device, dtype):
        super().__init__()
        self.config = config
        h, d = config.hidden_size, config.head_dim
        kv = config.num_kv_heads * d
        std = config.initializer_range
        out_std = std / math.sqrt(2 * config.num_layers)
        kw = dict(bias=False, device=device, dtype=dtype)
        self.q_proj = Linear(h, h, std=std, **kw)
        self.k_proj = Linear(h, kv, std=std, **kw)
        self.v_proj = Linear(h, kv, std=std, **kw)
        self.o_proj = Linear(h, h, std=out_std, **kw)

    def forward(self, x, cache=None):
        if cache is None:
            raise NotImplementedError(
                "LlamaAttention without a KV cache runs the flash attention "
                "kernel, which is not ported yet (ROADMAP Queue A: training "
                "for Llama, flash fwd/bwd)")
        cfg = self.config
        b, s, h = x.shape
        d = cfg.head_dim
        q = self.q_proj(x).reshape(b, s, cfg.num_heads, d)
        k = self.k_proj(x).reshape(b, s, cfg.num_kv_heads, d)
        v = self.v_proj(x).reshape(b, s, cfg.num_kv_heads, d)
        off = cache["offset"]
        pos = torch.arange(s, dtype=torch.int32, device=x.device)
        if off.dim() == 1:
            # per-slot offsets (serving): [B, S] rope positions
            pos = off.reshape(b, 1) + pos.reshape(1, s)
        else:
            pos = pos + off
        q, k, _ = IF.fused_rotary_position_embedding(
            q, k, position_ids=pos, rotary_emb_base=cfg.rope_theta)
        # the cache stores PRE-repeat K/V (num_kv_heads): the attention
        # groups the query heads natively
        if "page_table" not in cache:
            raise NotImplementedError(
                "only the paged KV cache is ported; the dense slot cache "
                "(kv_layout='slots') is not")
        out = IF.paged_cache_attention(q, k, v, cache)
        return self.o_proj(out.reshape(b, s, h))


class LlamaMLP(nn.Module):
    """SwiGLU: down(silu(gate(x)) * up(x))."""

    def __init__(self, config: LlamaConfig, device, dtype):
        super().__init__()
        h, m = config.hidden_size, config.intermediate_size
        std = config.initializer_range
        out_std = std / math.sqrt(2 * config.num_layers)
        kw = dict(bias=False, device=device, dtype=dtype)
        self.gate_proj = Linear(h, m, std=std, **kw)
        self.up_proj = Linear(h, m, std=std, **kw)
        self.down_proj = Linear(m, h, std=out_std, **kw)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaBlock(nn.Module):
    def __init__(self, config: LlamaConfig, device, dtype):
        super().__init__()
        kw = dict(epsilon=config.rms_norm_eps, device=device, dtype=dtype)
        self.input_layernorm = RMSNorm(config.hidden_size, **kw)
        self.self_attn = LlamaAttention(config, device, dtype)
        self.post_attention_layernorm = RMSNorm(config.hidden_size, **kw)
        self.mlp = LlamaMLP(config, device, dtype)

    def forward(self, x, cache=None):
        x = x + self.self_attn(self.input_layernorm(x), cache=cache)
        x = x + self.mlp(self.post_attention_layernorm(x))
        return x


class LlamaModel(nn.Module):
    def __init__(self, config: LlamaConfig, device, dtype):
        super().__init__()
        self.config = config
        self.embed_tokens = Embedding(config.vocab_size, config.hidden_size,
                                      std=config.initializer_range,
                                      device=device, dtype=dtype)
        self.layers = nn.ModuleList([LlamaBlock(config, device, dtype)
                                     for _ in range(config.num_layers)])
        self.norm = RMSNorm(config.hidden_size, epsilon=config.rms_norm_eps,
                            device=device, dtype=dtype)

    def forward(self, input_ids, caches=None):
        x = self.embed_tokens(input_ids)
        for i, blk in enumerate(self.layers):
            x = blk(x, cache=None if caches is None else caches[i])
        return self.norm(x)


class LlamaForCausalLM(nn.Module):
    """``LlamaForCausalLM(cfg, device=None, dtype=torch.float32, seed=0)``:
    parameters are made on ``device`` (None → the card) and drawn from a
    ``torch.Generator`` seeded with ``seed``."""

    def __init__(self, config: LlamaConfig, device=None, dtype=torch.float32,
                 seed=0):
        super().__init__()
        dev = resolve_device(device)
        dtype = to_torch_dtype(dtype)
        self.config = config
        self.llama = LlamaModel(config, dev, dtype)
        self.lm_head = None if config.tie_word_embeddings else Linear(
            config.hidden_size, config.vocab_size, bias=False, device=dev,
            dtype=dtype)
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        with torch.no_grad():
            for mod in self.modules():
                if hasattr(mod, "reset_parameters"):
                    mod.reset_parameters(gen)

    def forward(self, input_ids, caches=None):
        hidden = self.llama(input_ids, caches=caches)
        if self.lm_head is not None:
            return self.lm_head(hidden)
        return F.linear(hidden, self.llama.embed_tokens.weight.T)

    def num_params(self):
        return sum(p.numel() for p in self.parameters())
