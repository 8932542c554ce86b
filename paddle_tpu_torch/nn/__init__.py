"""Layers, functional ops, losses, gradient clips and LoRA of the port's
serving and training paths."""
from . import functional
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
                   clip_grad_norm_)
from .layers import Dropout, Embedding, LayerNorm, Linear, RMSNorm
from .losses import CrossEntropyLoss, MSELoss
from .lora import (LoRALinear, adapter_spec, attach_lora, load_adapter,
                   load_adapter_state, lora_layers, mark_only_lora_trainable,
                   save_adapter)

__all__ = ["functional", "ClipGradByGlobalNorm", "ClipGradByNorm",
           "ClipGradByValue", "clip_grad_norm_", "Dropout", "Embedding",
           "LayerNorm", "Linear", "RMSNorm", "CrossEntropyLoss", "MSELoss",
           "LoRALinear", "adapter_spec", "attach_lora", "load_adapter",
           "load_adapter_state", "lora_layers", "mark_only_lora_trainable",
           "save_adapter"]
