"""Capture and replay of one step as a CUDA graph (the PyTorch counterpart
of paddle_tpu/framework/capture.py's two-phase discovery/bind core).

The JAX package turns a step into one XLA program: discovery runs the
body once eagerly and rolls its side effects back, then the body is
traced with the state bound as arguments.  Here the program is a
``torch.cuda.CUDAGraph`` and the state is a set of persistent tensors the
body reads and writes in place.  `CapturedStep`:

1. warms the body up on a side stream (kernels load, cuBLAS sets up its
   workspace on that stream, the caching allocator sees the sizes);
2. snapshots the tensors the warm-up mutates and restores them after it,
   so warm-up leaves no trace in the state;
3. captures the body into a graph on the same side stream, with a memory
   pool of its own (one pool per owner, shared by its graphs);
4. replays the graph on the current stream.

A body is capturable when every tensor it reads or writes keeps its
address between replays and it makes no host read: the caller writes new
values into those tensors in place between replays.

**Launch accounting.**  A replay does not run the kernel wrappers'
Python, so it would not raise their ``launches`` counts.  The capture
records each wrapper's count delta (the wrappers ran while the graph was
recorded, which launched nothing, so the counts are put back) and every
replay adds that delta: the counts stay the number of launches the card
ran.  Warm-up launches ran, and stay counted.

On the CPU there is no graph: calling the step runs the body, which is
the plain version of the graph.  A capture or replay error on the card
raises; nothing falls back to the eager body.
"""
from __future__ import annotations

import torch

from .. import kernels


class CapturedStep:
    """``CapturedStep(fn, mutable, device, pool, stream)``: ``fn()`` takes
    no arguments and returns nothing; it reads and writes persistent
    tensors.  ``mutable`` lists the tensors its warm-up may change
    (restored after it).  On the card, ``pool`` (a
    `torch.cuda.graph_pool_handle`) and ``stream`` (the side stream of
    warm-up and capture) may be shared by the steps of one owner.
    ``replays`` counts; ``launches`` is the per-replay launch delta by
    kernel name."""

    def __init__(self, fn, mutable, device, pool=None, stream=None):
        self.fn = fn
        self.mutable = list(mutable)
        self.device = torch.device(device)
        self.pool = pool
        self.stream = stream
        self.graph = None
        self.launches = {}
        self.replays = 0

    def __call__(self):
        if self.device.type != "cuda":
            self.fn()
            return
        if self.graph is None:
            self.capture()
        self.graph.replay()
        self.replays += 1
        kernels.add_launch_counts(self.launches)

    def capture(self):
        saved = [t.clone() for t in self.mutable]
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            self.fn()                               # warm-up
        current.wait_stream(self.stream)
        for t, s in zip(self.mutable, saved):
            t.copy_(s)
        graph = torch.cuda.CUDAGraph()
        before = kernels.launch_counts()
        with torch.cuda.graph(graph, pool=self.pool, stream=self.stream,
                              capture_error_mode="thread_local"):
            self.fn()
        after = kernels.launch_counts()
        self.launches = {k: after[k] - before[k] for k in after
                         if after[k] != before[k]}
        # recording launched nothing: the replays add the delta
        kernels.add_launch_counts({k: -n for k, n in self.launches.items()})
        self.graph = graph
