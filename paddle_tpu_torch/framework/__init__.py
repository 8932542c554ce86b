"""Framework services of the port: `save` / `load` (`io`), atomic
step-numbered checkpoints with retention and auto-resume
(`checkpoint_manager`), the training sentinel (`sentinel`), the JAX key
stream (`prng`), CUDA graph capture of one step (`capture`) and the
compiled train step (`train_step`) that ``hapi.Model.fit`` runs every
step through."""
from .checkpoint_manager import (CheckpointError, CheckpointManager,
                                 NonFiniteCheckpointError, verify_checkpoint)
from .io import load, save
from .sentinel import (RollbackDirective, SentinelError, TrainingSentinel,
                       sentinel_enabled)
from .train_step import CompiledTrainStep

__all__ = ["CheckpointError", "CheckpointManager", "CompiledTrainStep",
           "NonFiniteCheckpointError", "RollbackDirective", "SentinelError",
           "TrainingSentinel", "load", "save", "sentinel_enabled",
           "verify_checkpoint"]
