"""Layers and functional ops of the port's serving and training paths."""
from . import functional
from .layers import Dropout, Embedding, LayerNorm, Linear, RMSNorm

__all__ = ["functional", "Dropout", "Embedding", "LayerNorm", "Linear",
           "RMSNorm"]
