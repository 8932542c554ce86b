"""GPT as a PipelineLayer (port of paddle_tpu/models/gpt_pipeline.py):
`EmbeddingPipe`, `LayerNormPipe`, `_lm_head_fwd` and
`GPTForCausalLMPipe`, a pp × mp hybrid for deep configs.

The descriptors are JAX's: the embedding (a `SharedLayerDesc` keyed
``"embed"``), ``num_layers`` `ParallelGPTBlock` s, the final norm, and
the embedding again as the tied head (``forward_func=_lm_head_fwd``),
segmented by blocks (``seg_method="layer:ParallelGPTBlock"``).  A rank
builds its stage's parts only (`PipelineLayer`); the first and the last
stage each hold a copy of the embedding.

Each layer draws its weights from a generator of its own, seeded by
(``seed``, the layer's index in JAX's ``run_function``; the embedding by
its first index), and a tensor-parallel layer keeps its part of the
global draw: the ranks of any pp × mp layout hold the parts of the one
model a single process builds from that seed.

The head leaves the logits split over mp (the rank's vocabulary slice,
as `ParallelGPTForCausalLM` does with labels), and the default loss is
the vocab-parallel cross entropy's mean over the labels that are not
ignored: JAX's ``F.cross_entropy`` of the logits GSPMD splits over mp.
The global-view forward (`PipelineLayer.forward`) gathers the logits, so
it returns JAX's ``[B, S, V]``.
"""
from __future__ import annotations

import torch
from torch import nn

from ..device import resolve_device, to_torch_dtype
from ..distributed import topology
from ..distributed.fleet.meta_parallel.pp_layers import (LayerDesc,
                                                         PipelineLayer,
                                                         SharedLayerDesc)
from ..distributed.fleet.mp_layers import (ParallelCrossEntropy,
                                           VocabParallelEmbedding,
                                           copy_to_mp, gather_from_mp)
from ..nn import functional as F
from ..nn.layers import Dropout, LayerNorm, deferred_init
from .gpt import GPTConfig
from .gpt_parallel import (ParallelGPTAttention, ParallelGPTBlock,
                           _masked_parallel_ce, _ranks)


class EmbeddingPipe(nn.Module):
    """wte+wpe; reused as the LM head through SharedLayerDesc."""

    def __init__(self, config: GPTConfig, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.config = config
        std = config.initializer_range
        self.wte = VocabParallelEmbedding(config.vocab_size,
                                          config.hidden_size, std=std,
                                          device=device, dtype=dtype)
        self.wpe = VocabParallelEmbedding(config.max_seq_len,
                                          config.hidden_size, std=std,
                                          device=device, dtype=dtype)

    @property
    def weight(self):
        return self.wte.weight

    def forward(self, input_ids):
        b, s = input_ids.shape
        pos = torch.arange(s, device=input_ids.device)
        return self.wte(input_ids) + self.wpe(pos)


def _lm_head_fwd(embed: EmbeddingPipe, hidden):
    """Tied head: hidden @ wte.T (SharedLayerDesc forward_func); the
    rank's vocabulary slice of the logits."""
    group = embed.wte.mp_group
    return F.linear(copy_to_mp(hidden, group), embed.wte.weight.T)


class LayerNormPipe(nn.Module):
    def __init__(self, config: GPTConfig, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.ln = LayerNorm(config.hidden_size,
                            epsilon=config.layer_norm_eps, device=device,
                            dtype=dtype)

    def forward(self, x):
        return self.ln(x)


def _layer_seed(seed, idx):
    return (seed + 0x9E3779B97F4A7C15 * (idx + 1)) % (1 << 63)


class GPTForCausalLMPipe(PipelineLayer):
    """Construct after `fleet.init` (the pp degree from the strategy)::

        fleet.init(is_collective=True, strategy=strategy)
        model = GPTForCausalLMPipe(cfg)
        model = fleet.distributed_model(model)   # → PipelineParallel
        model.train_batch((x, y), opt)

    ``device`` (None: the card), ``dtype`` and ``seed`` are the port's."""

    def __init__(self, config: GPTConfig, num_stages=None, loss_fn=None,
                 num_virtual_pipeline_stages=1, *, device=None,
                 dtype=torch.float32, seed=0, **block_kwargs):
        dev = resolve_device(device)
        dt = to_torch_dtype(dtype)
        kw = dict(device=dev, dtype=dt)
        descs = [SharedLayerDesc("embed", EmbeddingPipe, config, **kw)]
        for _ in range(config.num_layers):
            descs.append(LayerDesc(ParallelGPTBlock, config, **kw,
                                   **block_kwargs))
        descs.append(LayerDesc(LayerNormPipe, config, **kw))
        descs.append(SharedLayerDesc("embed", EmbeddingPipe, config,
                                     forward_func=_lm_head_fwd, **kw))
        with deferred_init():
            super().__init__(
                descs, num_stages=num_stages,
                seg_method="layer:ParallelGPTBlock", loss_fn=loss_fn,
                num_virtual_pipeline_stages=num_virtual_pipeline_stages)
        self.config = config
        self.seed = int(seed)
        if loss_fn is None:
            self._loss_fn = self._default_loss
        with torch.no_grad():
            for idx, layer in self.run_function.items():
                gen = torch.Generator(device=dev)
                gen.manual_seed(_layer_seed(self.seed, int(idx)))
                for mod in layer.modules():
                    if hasattr(mod, "reset_parameters"):
                        mod.reset_parameters(gen)
        self.xent = ParallelCrossEntropy()
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
        """This rank's dp and mp ranks (the flash dropout hash's offsets),
        the dropout generator seeded by (seed, dp rank), the loss's mp
        group."""
        dp_rank, mp_rank = _ranks(hcg)
        for mod in self.modules():
            if isinstance(mod, ParallelGPTAttention):
                mod.dp_rank, mod.mp_rank = dp_rank, mp_rank
        self.dropout_generator.manual_seed(
            (self.seed + 0x9E3779B97F4A7C15 * dp_rank) % (1 << 63))
        self.xent.mp_group = topology.mp_group()

    def _default_loss(self, logits, labels):
        return _masked_parallel_ce(self.xent, logits, labels)

    def global_output(self, out):
        """The logits gathered over mp: ``[..., V]``."""
        return gather_from_mp(out, topology.mp_group(), -1)
