"""Deterministic, checkpointable input pipeline with device prefetch
(port of paddle_tpu/data)::

    pipeline(ds).shard(rank, dp_degree).shuffle(seed).map(fn)
                .pack(seq_len).batch(B).device_prefetch(depth)

Every stage's ``state_dict()`` holds only seeds and counters (the JAX
package's keys), so ``Model.fit(resume=True)`` restarts mid-epoch
exactly, from a checkpoint either package wrote; `GoodputMeter` says
whether a run waits on its input.
"""
from .goodput import GoodputMeter  # noqa: F401
from .pipeline import (CorruptRecordError, Pipeline,  # noqa: F401
                       PipelineConfigError, pipeline)

__all__ = ["CorruptRecordError", "GoodputMeter", "Pipeline",
           "PipelineConfigError", "pipeline"]
