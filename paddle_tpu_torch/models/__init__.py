"""Model families of the port."""
from .gpt import (GPT2_124M, GPT2_350M, GPT3_1_3B, GPT3_6_7B, GPT3_13B,
                  GPTConfig, GPTForCausalLM, GPTModel, gpt_config)
from .gpt_parallel import (ParallelGPTBlock, ParallelGPTForCausalLM,
                           ParallelGPTModel)
from .gpt_pipeline import EmbeddingPipe, GPTForCausalLMPipe, LayerNormPipe
from .llama import LlamaConfig, LlamaForCausalLM, LlamaModel, llama_config
from .llama_parallel import ParallelLlamaForCausalLM, ParallelLlamaModel

__all__ = ["EmbeddingPipe", "GPT2_124M", "GPT2_350M", "GPT3_1_3B",
           "GPT3_6_7B", "GPT3_13B", "GPTConfig", "GPTForCausalLM",
           "GPTForCausalLMPipe", "GPTModel", "LayerNormPipe", "LlamaConfig",
           "LlamaForCausalLM", "LlamaModel", "ParallelGPTBlock",
           "ParallelGPTForCausalLM", "ParallelGPTModel",
           "ParallelLlamaForCausalLM", "ParallelLlamaModel", "gpt_config",
           "llama_config"]
