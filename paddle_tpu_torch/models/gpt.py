"""GPT model family (port of paddle_tpu/models/gpt.py): pre-LN decoder
with learned positions, a fused QKV projection, tanh-GELU MLP and the LM
head tied to the token embedding, with the JAX package's parameter names
and ``[in, out]`` Linear layout so its state dicts load unchanged
(``convert.py``).

The forward is the training path: causal head-major flash attention
with in-kernel attention dropout (``attn_dropout``), residual and
embedding dropout (``dropout``), and ``labels=`` giving ``(logits,
loss)``.  The model owns its random streams, both seeded from the
constructor's ``seed``: a CPU generator for the flash kernels' dropout
seeds and one on its device for the `Dropout` layers.  Both are
capturable: a seed reaches the kernels through device memory
(`kernels.graph_state.device_seed`: under a captured train step a
persistent slot per attention call, refilled with this generator's next
draw before every replay, in the eager order), and the device generator
is registered with the step's graph, so replays draw what eager steps
draw.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn

from ..device import resolve_device, to_torch_dtype
from ..nn import functional as F
from ..nn.functional import flash_attention
from ..nn.layers import Dropout, Embedding, LayerNorm, Linear

_NO_CACHE = ("GPT with caches= (GPT serving) is not ported (ROADMAP Queue "
             "A: GPT serving)")
_NO_RECOMPUTE = ("GPTConfig.use_recompute is not ported (ROADMAP Queue A: "
                 "activation recompute)")


@dataclass
class GPTConfig:
    vocab_size: int = 50304           # 50257 padded to a multiple of 128
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    max_seq_len: int = 1024
    intermediate_size: int = 0        # 0 -> 4*hidden
    dropout: float = 0.0
    attn_dropout: float = 0.0
    layer_norm_eps: float = 1e-5
    initializer_range: float = 0.02
    tie_word_embeddings: bool = True
    use_flash_attention: bool = True
    use_recompute: bool = False

    def __post_init__(self):
        if self.intermediate_size == 0:
            self.intermediate_size = 4 * self.hidden_size

    @property
    def head_dim(self):
        return self.hidden_size // self.num_heads


GPT2_124M = dict(hidden_size=768, num_layers=12, num_heads=12)
GPT2_350M = dict(hidden_size=1024, num_layers=24, num_heads=16)
GPT3_1_3B = dict(hidden_size=2048, num_layers=24, num_heads=16)
GPT3_6_7B = dict(hidden_size=4096, num_layers=32, num_heads=32)
GPT3_13B = dict(hidden_size=5120, num_layers=40, num_heads=40)


def gpt_config(name: str, **overrides) -> GPTConfig:
    presets = {"gpt2-124m": GPT2_124M, "gpt2-350m": GPT2_350M,
               "gpt3-1.3b": GPT3_1_3B, "gpt3-6.7b": GPT3_6_7B,
               "gpt3-13b": GPT3_13B}
    cfg = dict(presets[name])
    cfg.update(overrides)
    return GPTConfig(**cfg)


class GPTAttention(nn.Module):
    def __init__(self, config: GPTConfig, device, dtype):
        super().__init__()
        self.config = config
        h = config.hidden_size
        std = config.initializer_range
        out_std = std / math.sqrt(2 * config.num_layers)
        self.qkv_proj = Linear(h, 3 * h, std=std, device=device, dtype=dtype)
        self.out_proj = Linear(h, h, std=out_std, device=device, dtype=dtype)
        #: CPU generator of the flash dropout seeds (set by the model)
        self.generator = None

    def forward(self, x, cache=None):
        if cache is not None:
            raise NotImplementedError(_NO_CACHE)
        cfg = self.config
        b, s, h = x.shape
        qkv = self.qkv_proj(x).reshape(b, s, 3, cfg.num_heads, cfg.head_dim)
        # head-major strided views of the [B, S, 3, H, D] projection: the
        # kernels read them through their strides, no copy
        q, k, v = (t.transpose(1, 2) for t in qkv.unbind(dim=2))
        out = flash_attention(q, k, v, dropout=cfg.attn_dropout, causal=True,
                              training=self.training, head_major=True,
                              generator=self.generator)
        return self.out_proj(out.transpose(1, 2).reshape(b, s, h))


class GPTMLP(nn.Module):
    def __init__(self, config: GPTConfig, device, dtype):
        super().__init__()
        h, m = config.hidden_size, config.intermediate_size
        std = config.initializer_range
        out_std = std / math.sqrt(2 * config.num_layers)
        self.fc_in = Linear(h, m, std=std, device=device, dtype=dtype)
        self.fc_out = Linear(m, h, std=out_std, device=device, dtype=dtype)

    def forward(self, x):
        return self.fc_out(F.gelu(self.fc_in(x), approximate=True))


class GPTBlock(nn.Module):
    def __init__(self, config: GPTConfig, device, dtype):
        super().__init__()
        kw = dict(epsilon=config.layer_norm_eps, device=device, dtype=dtype)
        self.ln_1 = LayerNorm(config.hidden_size, **kw)
        self.attn = GPTAttention(config, device, dtype)
        self.ln_2 = LayerNorm(config.hidden_size, **kw)
        self.mlp = GPTMLP(config, device, dtype)
        self.dropout = Dropout(config.dropout)

    def forward(self, x, cache=None):
        x = x + self.dropout(self.attn(self.ln_1(x), cache=cache))
        x = x + self.dropout(self.mlp(self.ln_2(x)))
        return x


class GPTModel(nn.Module):
    def __init__(self, config: GPTConfig, device, dtype):
        super().__init__()
        self.config = config
        std = config.initializer_range
        self.wte = Embedding(config.vocab_size, config.hidden_size, std=std,
                             device=device, dtype=dtype)
        self.wpe = Embedding(config.max_seq_len, config.hidden_size, std=std,
                             device=device, dtype=dtype)
        self.drop = Dropout(config.dropout)
        self.h = nn.ModuleList([GPTBlock(config, device, dtype)
                                for _ in range(config.num_layers)])
        self.ln_f = LayerNorm(config.hidden_size,
                              epsilon=config.layer_norm_eps, device=device,
                              dtype=dtype)

    def forward(self, input_ids, position_ids=None, caches=None):
        if caches is not None:
            raise NotImplementedError(_NO_CACHE)
        if self.config.use_recompute:
            raise NotImplementedError(_NO_RECOMPUTE)
        s = input_ids.shape[1]
        if position_ids is None:
            position_ids = torch.arange(s, device=input_ids.device)
        x = self.drop(self.wte(input_ids) + self.wpe(position_ids))
        for block in self.h:
            x = block(x)
        return self.ln_f(x)


class GPTForCausalLM(nn.Module):
    """``GPTForCausalLM(cfg, device=None, dtype=torch.float32, seed=0)``:
    parameters are made on ``device`` (None → the card) and drawn from a
    ``torch.Generator`` seeded with ``seed``, the JAX init (normal 0.02,
    ``out_proj``/``fc_out`` at 0.02 / sqrt(2 L), zero biases, layer norms
    at 1 and 0).  ``flash_generator`` (CPU) and ``dropout_generator`` (on
    the device) are seeded with ``seed`` too."""

    def __init__(self, config: GPTConfig, device=None, dtype=torch.float32,
                 seed=0):
        super().__init__()
        dev = resolve_device(device)
        dtype = to_torch_dtype(dtype)
        self.config = config
        self.gpt = GPTModel(config, dev, dtype)
        self.lm_head = None if config.tie_word_embeddings else Linear(
            config.hidden_size, config.vocab_size, bias=False, device=dev,
            dtype=dtype)
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        with torch.no_grad():
            for mod in self.modules():
                if hasattr(mod, "reset_parameters"):
                    mod.reset_parameters(gen)
        self.flash_generator = torch.Generator(device="cpu")
        self.flash_generator.manual_seed(int(seed))
        self.dropout_generator = torch.Generator(device=dev)
        self.dropout_generator.manual_seed(int(seed))
        for mod in self.modules():
            if isinstance(mod, GPTAttention):
                mod.generator = self.flash_generator
            elif isinstance(mod, Dropout):
                mod.generator = self.dropout_generator

    def forward(self, input_ids, labels=None, position_ids=None,
                caches=None):
        """Logits ``[B, S, vocab]``; with ``labels`` (``[B, S]``, -100
        ignored) ``(logits, loss)``, the mean cross-entropy over the
        labelled positions (no shift: the caller aligns labels)."""
        hidden = self.gpt(input_ids, position_ids, caches=caches)
        if self.lm_head is not None:
            logits = self.lm_head(hidden)
        else:
            logits = F.linear(hidden, self.gpt.wte.weight.T)
        if labels is not None:
            loss = F.cross_entropy(logits.reshape(-1, self.config.vocab_size),
                                   labels.reshape(-1))
            return logits, loss
        return logits

    def num_params(self, non_embedding=True):
        """Every parameter, less the position table ``wpe`` when
        ``non_embedding`` (the tied ``wte`` stays: it does the head's
        product)."""
        n = sum(p.numel() for p in self.parameters())
        if non_embedding:
            n -= self.gpt.wpe.weight.numel()
        return n

    def flops_per_token(self, seq_len=None):
        """Train-step FLOPs a token (forward and backward), the PaLM
        appendix formula 6 N + 12 L H S."""
        cfg = self.config
        s = seq_len or cfg.max_seq_len
        return 6 * self.num_params() + \
            12 * cfg.num_layers * cfg.hidden_size * s
