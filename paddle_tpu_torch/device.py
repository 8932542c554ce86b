"""Device and dtype resolution shared by every entry point of the port.

``device=None`` means the card (``"cuda"``).  An entry point never falls
back to the CPU on its own: without CUDA it raises unless the caller asked
for ``"cpu"`` explicitly, as the CPU tests do.
"""
from __future__ import annotations

import torch

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "int32": torch.int32,
    "int64": torch.int64,
}


def resolve_device(device=None) -> torch.device:
    """``None`` → ``cuda``; a CUDA device without CUDA raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the port's "
            "plain PyTorch versions on the CPU")
    return dev


def to_torch_dtype(dtype) -> torch.dtype:
    """A dtype name (``"bfloat16"``) or a ``torch.dtype`` → ``torch.dtype``."""
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return _DTYPES[str(dtype)]
    except KeyError:
        raise ValueError(f"unsupported dtype {dtype!r}; expected one of "
                         f"{sorted(_DTYPES)}") from None
