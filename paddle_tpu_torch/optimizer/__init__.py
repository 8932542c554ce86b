"""Optimizers of the port (paddle_tpu.optimizer counterpart)."""
from .optimizer import Adam, AdamW, Optimizer

__all__ = ["Adam", "AdamW", "Optimizer"]
