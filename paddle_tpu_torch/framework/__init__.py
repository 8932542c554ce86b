"""Framework services of the port: the checkpoint manifest protocol
(`checkpoint_manager`), the JAX key stream (`prng`), CUDA graph capture
of one step (`capture`) and the compiled train step (`train_step`)."""
from .train_step import CompiledTrainStep

__all__ = ["CompiledTrainStep"]
