"""Model families of the port."""
from .llama import LlamaConfig, LlamaForCausalLM, llama_config

__all__ = ["LlamaConfig", "LlamaForCausalLM", "llama_config"]
