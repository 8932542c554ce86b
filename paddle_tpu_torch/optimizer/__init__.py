"""Optimizers of the port (paddle_tpu.optimizer counterpart) and their
learning-rate schedulers (`lr`)."""
from . import lr
from .optimizer import (LBFGS, SGD, Adadelta, Adagrad, Adam, Adamax, AdamW,
                        L1Decay, L2Decay, Lamb, Momentum, Optimizer, RMSProp)

__all__ = ["lr", "Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adagrad",
           "RMSProp", "Lamb", "Adadelta", "Adamax", "LBFGS", "L1Decay",
           "L2Decay"]
