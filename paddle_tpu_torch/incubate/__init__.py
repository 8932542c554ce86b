"""Fused ops of the port (paddle_tpu.incubate counterpart)."""
from . import nn

__all__ = ["nn"]
