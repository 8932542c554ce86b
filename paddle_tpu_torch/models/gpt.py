"""GPT model family (port of paddle_tpu/models/gpt.py): pre-LN decoder
with learned positions, a fused QKV projection, tanh-GELU MLP and the LM
head tied to the token embedding, with the JAX package's parameter names
and ``[in, out]`` Linear layout so its state dicts load unchanged
(``convert.py``).

Two paths, as in the JAX package.  Without caches the forward is the
training path: causal head-major flash attention with in-kernel attention
dropout (``attn_dropout``), residual and embedding dropout (``dropout``),
``labels=`` giving ``(logits, loss)``, and with ``use_recompute`` each
block under activation recompute (`distributed.fleet.utils.recompute`).
With ``caches=`` attention reads a KV cache: a paged one (the serving
engine, ``"page_table"`` in the dict) or a dense one (`generate`), and
the positions start at the cache's offset, a scalar or one per row.

Positions are looked up in the learned table ``wpe`` (``max_seq_len``
rows).  Without caches a longer input raises.  With caches a position
past the table is clamped to its last row: such rows are ones whose
output is thrown away (the overshoot of `speculative_generate`'s verify
window), where JAX's ``jnp.take`` would read a NaN fill and torch's
``embedding`` on the card would fail a device assert.  The serving engine
refuses at construction a KV capacity past the table
(``position_rows``), so no row it uses is clamped.  The model owns its random streams, both seeded from the
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
from ..distributed.fleet.utils import recompute
from ..incubate.nn import functional as IF
from ..nn import functional as F
from ..nn.functional import flash_attention
from ..nn.layers import (Dropout, Embedding, LayerNorm, Linear,
                         deferred_init)


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
    def __init__(self, config: GPTConfig, *, device, dtype):
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
        cfg = self.config
        b, s, h = x.shape
        qkv = self.qkv_proj(x).reshape(b, s, 3, cfg.num_heads, cfg.head_dim)
        if cache is not None:
            q, k, v = qkv.unbind(dim=2)
            if "page_table" in cache:
                # the serving engine's paged pools (float or int8/fp8)
                out = IF.paged_cache_attention(q, k, v, cache)
            else:
                out, cache["k"], cache["v"] = IF.masked_multihead_attention(
                    q, k, v, cache["k"], cache["v"], cache["offset"])
            return self.out_proj(out.reshape(b, s, h))
        # head-major strided views of the [B, S, 3, H, D] projection: the
        # kernels read them through their strides, no copy
        q, k, v = (t.transpose(1, 2) for t in qkv.unbind(dim=2))
        out = flash_attention(q, k, v, dropout=cfg.attn_dropout, causal=True,
                              training=self.training, head_major=True,
                              generator=self.generator)
        return self.out_proj(out.transpose(1, 2).reshape(b, s, h))


class GPTMLP(nn.Module):
    def __init__(self, config: GPTConfig, *, device, dtype):
        super().__init__()
        h, m = config.hidden_size, config.intermediate_size
        std = config.initializer_range
        out_std = std / math.sqrt(2 * config.num_layers)
        self.fc_in = Linear(h, m, std=std, device=device, dtype=dtype)
        self.fc_out = Linear(m, h, std=out_std, device=device, dtype=dtype)

    def forward(self, x):
        return self.fc_out(F.gelu(self.fc_in(x), approximate=True))


class GPTBlock(nn.Module):
    def __init__(self, config: GPTConfig, *, device, dtype):
        super().__init__()
        kw = dict(epsilon=config.layer_norm_eps, device=device, dtype=dtype)
        self.ln_1 = LayerNorm(config.hidden_size, **kw)
        self.attn = GPTAttention(config, device=device, dtype=dtype)
        self.ln_2 = LayerNorm(config.hidden_size, **kw)
        self.mlp = GPTMLP(config, device=device, dtype=dtype)
        self.dropout = Dropout(config.dropout)

    def forward(self, x, cache=None):
        x = x + self.dropout(self.attn(self.ln_1(x), cache=cache))
        x = x + self.dropout(self.mlp(self.ln_2(x)))
        return x


class GPTModel(nn.Module):
    """``GPTModel(config)``, as JAX's; ``device`` (None: the card) and
    ``dtype`` as the causal-LM wrapper takes them.  Built alone, its layers
    draw the model init (each layer gets its ``std``) from
    `nn.layers.init_generator`; the causal-LM wrapper draws the same
    distributions from its own seeded generator."""

    def __init__(self, config: GPTConfig, *, device=None, dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        dtype = to_torch_dtype(dtype)
        self.config = config
        std = config.initializer_range
        self.wte = Embedding(config.vocab_size, config.hidden_size, std=std,
                             device=device, dtype=dtype)
        self.wpe = Embedding(config.max_seq_len, config.hidden_size, std=std,
                             device=device, dtype=dtype)
        self.drop = Dropout(config.dropout)
        self.h = nn.ModuleList([GPTBlock(config, device=device, dtype=dtype)
                                for _ in range(config.num_layers)])
        self.ln_f = LayerNorm(config.hidden_size,
                              epsilon=config.layer_norm_eps, device=device,
                              dtype=dtype)

    def forward(self, input_ids, position_ids=None, caches=None):
        cfg = self.config
        b, s = input_ids.shape
        if position_ids is None:
            position_ids = self._positions(b, s, input_ids.device, caches)
        x = self.drop(self.wte(input_ids) + self.wpe(position_ids))
        for i, block in enumerate(self.h):
            if cfg.use_recompute and caches is None and x.requires_grad:
                x = recompute(block, x)
            else:
                x = block(x, cache=None if caches is None else caches[i])
        return self.ln_f(x)

    def _positions(self, b, s, device, caches):
        """``arange(S)``; with caches from the offset: ``[B, S]`` from a
        ``[B]`` offset (each serving row at its own age), ``arange(S) +
        offset`` from a scalar one.  The offset is read where it lies (the
        compiled tick's device offsets: no host read); with caches a
        position past the table is clamped (see the module's note)."""
        rows = self.config.max_seq_len
        pos = torch.arange(s, device=device)
        if caches is None:
            if s > rows:
                raise ValueError(f"GPT: {s} positions > the {rows} rows of "
                                 "the learned position table (max_seq_len)")
            return pos
        off = torch.as_tensor(caches[0]["offset"]).to(device=device,
                                                     dtype=torch.long)
        pos = off.reshape(b, 1) + pos.reshape(1, s) if off.dim() == 1 \
            else pos + off
        return pos.clamp(max=rows - 1)


class GPTForCausalLM(nn.Module):
    """``GPTForCausalLM(cfg, device=None, dtype=torch.float32, seed=0)``:
    parameters are made on ``device`` (None → the card) and drawn from a
    ``torch.Generator`` seeded with ``seed``, the JAX init (normal 0.02,
    ``out_proj``/``fc_out`` at 0.02 / sqrt(2 L), zero biases, layer norms
    at 1 and 0).  ``flash_generator`` (CPU) and ``dropout_generator`` (on
    the device) are seeded with ``seed`` too."""

    def __init__(self, config: GPTConfig, *, device=None, dtype=torch.float32,
                 seed=0):
        super().__init__()
        dev = resolve_device(device)
        dtype = to_torch_dtype(dtype)
        self.config = config
        with deferred_init():       # every parameter drawn below
            self.gpt = GPTModel(config, device=dev, dtype=dtype)
            self.lm_head = None if config.tie_word_embeddings else Linear(
                config.hidden_size, config.vocab_size, bias_attr=False,
                device=dev, dtype=dtype)
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

    @property
    def position_rows(self):
        """Rows of the learned position table ``wpe``: the longest context
        a cache may hold (the serving engine checks its capacity)."""
        return self.config.max_seq_len

    def generate(self, input_ids, max_new_tokens=32, temperature=0.0,
                 top_k=None, top_p=None, repetition_penalty=None,
                 use_cache=True, eos_token_id=None, *, generator=None,
                 page_size=None):
        """Incremental decoding over dense KV caches, or paged ones with
        ``page_size`` (`models.generation.generate`)."""
        from .generation import generate
        return generate(self, input_ids, max_new_tokens=max_new_tokens,
                        temperature=temperature, top_k=top_k, top_p=top_p,
                        repetition_penalty=repetition_penalty,
                        use_cache=use_cache, eos_token_id=eos_token_id,
                        generator=generator, page_size=page_size)

    @staticmethod
    def generate_step(model, input_ids, temperature=1.0, top_k=None,
                      *, generator=None):
        """One greedy or sampled step over the full forward: ``[B]`` next
        tokens (JAX ``GPTForCausalLM.generate_step``).  Sampling draws
        from ``generator`` (a ``torch.Generator`` on the model's device;
        None: the package's own, never torch's global RNG)."""
        next_logits = model(input_ids)[:, -1, :]
        if temperature == 0.0:
            return torch.argmax(next_logits, dim=-1)
        next_logits = next_logits / temperature
        if top_k is not None:
            minv = torch.topk(next_logits, top_k, dim=-1).values[:, -1:]
            next_logits = next_logits.masked_fill(next_logits < minv,
                                                  float("-inf"))
        probs = torch.softmax(next_logits, dim=-1)
        gen = generator if generator is not None else \
            F.default_generator(probs.device)
        return torch.multinomial(probs, 1, generator=gen)

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
