"""Model families of the port."""
from .gpt import GPTConfig, GPTForCausalLM, gpt_config
from .llama import LlamaConfig, LlamaForCausalLM, llama_config

__all__ = ["GPTConfig", "GPTForCausalLM", "gpt_config", "LlamaConfig",
           "LlamaForCausalLM", "llama_config"]
