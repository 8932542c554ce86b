"""Weight-decay regularizers (port of paddle_tpu/regularizer.py), read by
an optimizer's ``weight_decay``."""
from .optimizer.optimizer import L1Decay, L2Decay  # noqa: F401

__all__ = ["L1Decay", "L2Decay"]
