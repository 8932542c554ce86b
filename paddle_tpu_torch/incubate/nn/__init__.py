"""Fused ops of the port (paddle_tpu.incubate.nn counterpart)."""
from . import functional

__all__ = ["functional"]
