"""Activation recompute (port of paddle_tpu/distributed/fleet/utils
``recompute``, there ``jax.checkpoint`` over the op funnel).

`recompute` runs a region through ``torch.utils.checkpoint`` (the
non-reentrant variant): the forward keeps none of the region's
intermediates, and the backward runs the region again to rebuild them.
Gradients reach the tensor arguments and every parameter the region
reads, as in the JAX package.

The random draws are the part JAX gets for free (its keys are traced
values inside ``jax.checkpoint``).  The port's ops draw from explicit
generators: flash attention's dropout seeds from a CPU generator, the
``Dropout`` masks from a device one.  With ``preserve_rng_state`` the
first run records each such draw (`kernels.graph_state.draw_log`) and the
recompute takes them back in order, drawing nothing: the recomputed
region sees the first run's seeds and masks, and each generator moves
once, so a step with recompute draws what a step without it draws.
Under a captured train step the first run's seed slots are reused, and
the recompute takes no new slot.  torch's own global generators, which
the port's ops never read, are preserved by ``torch.utils.checkpoint``
outside a CUDA graph capture (it cannot read a generator's state inside
one).
"""
from __future__ import annotations

import torch
from torch.utils import checkpoint as _checkpoint

from ...kernels import graph_state


def _capturing():
    return torch.cuda.is_available() and \
        torch.cuda.is_current_stream_capturing()


def recompute(function, *args, use_reentrant=True, preserve_rng_state=True,
              **kwargs):
    """``function(*args, **kwargs)`` with activation checkpointing: the
    same outputs, its intermediates rebuilt in the backward instead of
    kept.  ``use_reentrant`` is accepted as JAX accepts it and changes
    nothing: the region always runs under torch's non-reentrant
    checkpoint, which gives the same gradients and takes keyword
    arguments.  ``preserve_rng_state=False`` lets the recompute draw anew
    (torch's semantics), so dropout inside the region then disagrees
    between the two runs."""
    if not preserve_rng_state:
        return _checkpoint.checkpoint(function, *args, use_reentrant=False,
                                      preserve_rng_state=False, **kwargs)
    log = graph_state.DrawLog()
    runs = []

    def region(*a, **kw):
        with graph_state.draw_log(log, replay=bool(runs)):
            runs.append(None)
            return function(*a, **kw)
    return _checkpoint.checkpoint(region, *args, use_reentrant=False,
                                  preserve_rng_state=not _capturing(),
                                  **kwargs)


__all__ = ["recompute"]
