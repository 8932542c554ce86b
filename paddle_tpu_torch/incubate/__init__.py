"""Fused ops and incubating models of the port (paddle_tpu.incubate
counterpart)."""
from . import nn
from . import distributed

__all__ = ["distributed", "nn"]
