"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu for NVIDIA Hopper.

The serving path (``serving.Engine`` over ``models.LlamaForCausalLM``
with a paged KV cache) runs in plain PyTorch around two hand-written CUDA
kernels (``kernels.rms_norm``, ``kernels.paged_decode``).  Every entry
point runs on the card unless the caller passes ``device="cpu"``; on the
CPU each kernel wrapper takes its plain PyTorch version.
"""
from .device import resolve_device, to_torch_dtype

__all__ = ["resolve_device", "to_torch_dtype"]
