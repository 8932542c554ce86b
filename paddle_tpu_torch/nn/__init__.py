"""Layers, functional ops, losses and gradient clips of the port's
serving and training paths."""
from . import functional
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
                   clip_grad_norm_)
from .layers import Dropout, Embedding, LayerNorm, Linear, RMSNorm
from .losses import CrossEntropyLoss, MSELoss

__all__ = ["functional", "ClipGradByGlobalNorm", "ClipGradByNorm",
           "ClipGradByValue", "clip_grad_norm_", "Dropout", "Embedding",
           "LayerNorm", "Linear", "RMSNorm", "CrossEntropyLoss", "MSELoss"]
