"""Optimizers of the port (paddle_tpu.optimizer counterpart) and their
learning-rate schedulers (`lr`)."""
from . import lr
from .optimizer import Adam, AdamW, Optimizer

__all__ = ["lr", "Adam", "AdamW", "Optimizer"]
