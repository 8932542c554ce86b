"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu for NVIDIA Hopper.

Ported, in plain PyTorch around hand-written CUDA kernels (``kernels/``,
sources in ``csrc/``):

- serving: ``serving.Engine`` over ``models.LlamaForCausalLM`` or
  ``models.GPTForCausalLM`` with a paged KV cache and a compiled
  scheduler tick; ``models.generation`` (``generate``, ``beam_search``,
  ``speculative_generate``);
- training by hand: ``model(ids, labels=...)`` under ``amp.decorate``
  with any of paddle_tpu's optimizers, one step at a time or through
  ``framework.CompiledTrainStep`` (one CUDA graph replay a step);
- the training runtime: ``hapi.Model(net).prepare(...).fit(...)`` with
  ``hapi.callbacks``, `save` / `load` (which read the JAX package's
  files too), ``framework.checkpoint_manager.CheckpointManager``
  (atomic, retained, resumable checkpoints), ``io.DataLoader`` and the
  checkpointable ``data.pipeline`` with device prefetch;
- the training sentinel (``framework.sentinel``, under ``FLAGS_sentinel``),
  the telemetry fit runs under (``observability``: the metrics registry,
  ``StepMetrics``, the exporter, the flight recorder; ``ops.flops``) and
  LoRA training (``nn.attach_lora``, ``nn.save_adapter``);
- telemetry under every slice: the serving, checkpoint, input and
  compiled-step families on the metrics registry
  (``serving.serving_stats``), and request tracing
  (``observability.tracing``, under ``FLAGS_trace_dir``).

The kernels: RMS norm forward and backward, rope, flash attention
forward, dK/dV and dQ, the fused Adam update, paged decode attention and
the gathered LoRA delta.  Every entry point runs on the card unless the
caller passes ``device="cpu"`` (``map_location="cpu"`` for `load`); on
the CPU each kernel wrapper takes its plain PyTorch version.
"""
from .device import resolve_device, to_torch_dtype
from . import (amp, data, device, distributed, framework,  # noqa: E402
               hapi, incubate, io, metric, models, nn, observability,
               optimizer, profiler, quantization, regularizer, serving,
               utils)
from .framework.io import load, save  # noqa: E402
from .hapi import Model  # noqa: E402
from .utils.flags import get_flags, set_flags  # noqa: E402

__all__ = ["Model", "amp", "data", "device", "distributed", "framework",
           "get_flags", "hapi", "incubate", "io", "load", "metric", "models",
           "nn", "observability", "optimizer", "profiler", "quantization",
           "regularizer", "resolve_device", "save", "serving", "set_flags",
           "to_torch_dtype", "utils"]
