"""Framework services of the port: `save` / `load` (`io`), atomic
step-numbered checkpoints with retention and auto-resume
(`checkpoint_manager`), the JAX key stream (`prng`), CUDA graph capture
of one step (`capture`) and the compiled train step (`train_step`) that
``hapi.Model.fit`` runs every step through."""
from .io import load, save
from .train_step import CompiledTrainStep

__all__ = ["CompiledTrainStep", "load", "save"]
