"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu for NVIDIA Hopper.

Two paths are ported, in plain PyTorch around hand-written CUDA kernels
(``kernels/``, sources in ``csrc/``): serving (``serving.Engine`` over
``models.LlamaForCausalLM`` with a paged KV cache; RMS norm and paged
decode attention) and training (``LlamaForCausalLM(ids, labels=...)``
under ``amp.decorate`` with ``optimizer.AdamW`` or any other of
paddle_tpu's optimizers; RMS norm forward and backward, rope, flash
attention forward, dK/dV and dQ, the fused Adam update).  Every entry
point runs on the card unless the caller passes ``device="cpu"``; on the
CPU each kernel wrapper takes its plain PyTorch version.
"""
from .device import resolve_device, to_torch_dtype
from . import optimizer, regularizer  # noqa: E402

__all__ = ["resolve_device", "to_torch_dtype", "optimizer", "regularizer"]
