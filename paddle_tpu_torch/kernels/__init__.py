"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Each wrapper takes the plain version for a tensor on the CPU and launches
its kernel for a tensor on the card; there is no other route.  Each keeps
an integer ``launches`` count, raised by one where it launches its kernel
and nowhere else, so a run can show which kernels its path went through.
"""
from __future__ import annotations

import torch

#: dtype codes of the C interface (csrc/common.cuh ``ptt::DType``)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def dtype_code(t: torch.Tensor) -> int:
    try:
        return DTYPE_CODES[t.dtype]
    except KeyError:
        raise TypeError(f"unsupported dtype {t.dtype}; the kernels take "
                        "float32, bfloat16 and float16") from None


def check_cuda(name, *tensors):
    """Every tensor on the same CUDA device and contiguous."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expects contiguous tensors")


def _wrappers():
    from . import adam, flash_attention, lora, paged_decode, rms_norm, rope
    return {"rms_norm": rms_norm.rms_norm,
            "paged_decode": paged_decode.paged_decode_attention,
            "rms_norm_bwd": rms_norm.rms_norm_bwd,
            "rope": rope.rope,
            "flash_fwd": flash_attention.flash_attention_fwd,
            "flash_bwd_dkv": flash_attention.flash_bwd_dkv,
            "flash_bwd_dq": flash_attention.flash_bwd_dq,
            "flash_bwd_delta": flash_attention.flash_bwd_delta,
            "adam": adam.adam_update,
            # the quantized pools' launches of the paged-decode kernel
            "paged_decode_int8": paged_decode.QUANT_LAUNCHES[torch.int8],
            "paged_decode_fp8":
                paged_decode.QUANT_LAUNCHES[torch.float8_e4m3fn],
            "lora_delta": lora.lora_delta,
            # the flash kernels' launches with dropout alone, and with a
            # mask or segment ids (with or without dropout)
            **flash_attention.VARIANT_LAUNCHES}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in _wrappers().items()}


def reset_launch_counts():
    from .adam import adam_update
    for fn in _wrappers().values():
        fn.launches = 0
    adam_update.scalar_launches = 0


def add_launch_counts(delta: dict):
    """Add ``{name: n}`` to the wrappers' counts: a CUDA graph replay's
    launches, which run no wrapper (`framework.capture.CapturedStep`)."""
    wrappers = _wrappers()
    for name, n in delta.items():
        wrappers[name].launches += n
