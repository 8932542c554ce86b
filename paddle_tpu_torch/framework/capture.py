"""Capture and replay of one step as a CUDA graph (the PyTorch counterpart
of paddle_tpu/framework/capture.py's two-phase discovery/bind core).

The JAX package turns a step into one XLA program: discovery runs the
body once eagerly and rolls its side effects back, then the body is
traced with the state bound as arguments.  Here the program is a
``torch.cuda.CUDAGraph`` and the state is a set of persistent tensors the
body reads and writes in place.  `CapturedStep`:

1. warms the body up on a side stream (kernels load, cuBLAS sets up its
   workspace on that stream, the caching allocator sees the sizes) and
   restores the tensors the warm-up mutates, so warm-up leaves no trace
   in the state; or, with ``warmup=False``, leaves the warm-up to its
   owner (the compiled train step runs its real first step eagerly on
   the side stream instead, as JAX's call 1 is);
2. captures the body into a graph on the side stream, with a memory
   pool of its own (one pool per owner, shared by its graphs), and with
   the device generators its owner lists registered, so a replay draws
   the random numbers an eager run would draw at that point; Python's
   garbage collector is off during the capture (a collection there can
   destroy an unreachable graph, which invalidates the capture);
3. replays the graph on the current stream.

A body is capturable when every tensor it reads or writes keeps its
address between replays and it makes no host read: the caller writes new
values into those tensors in place between replays, in stream order (a
``fill_`` or a copy, never a pinned buffer a queued replay reads later).

**Host draws.**  A value drawn on the host each step (the flash kernels'
dropout seed, from a CPU generator) goes through `device_seed` (in
`kernels.graph_state`, the leaf module the ops read, re-exported here): outside a
capture it is written into a new device tensor; inside one it takes a
persistent slot that the step refills with a fresh draw before every
replay, in the order the body drew them, so a replay takes the draws an
eager step would.  The slots are allocated before the capture (as many
as the owner's eager warm-up drew, `recording`): memory allocated inside
a capture belongs to the graph's pool, and a kernel the graph runs
earlier may use that block for a tensor of its own, overwriting a value
written before the replay.

**Host reads.**  `host_read_probe` watches a body run eagerly for reads
of tensor values on the host (``item``, ``bool``, ``tolist``, ... by a
``TorchFunctionMode``, and on the card every synchronising operation by
``torch.cuda.set_sync_debug_mode("warn")``): the counterpart of JAX's
discovery ``TraceEscape``.

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

import contextlib
import gc
import warnings

import torch
from torch.overrides import TorchFunctionMode

from .. import kernels
from ..kernels.graph_state import (M32, Recording, allow_host_reads,
                                   capturing, device_seed,
                                   host_reads_allowed, note_generator,
                                   recording)

__all__ = ["CapturedStep", "Recording", "allow_host_reads", "device_seed",
           "host_read_probe", "note_generator", "recording"]

_HOST_READS = frozenset(("item", "tolist", "numpy", "__bool__", "__int__",
                         "__float__", "__index__", "__complex__", "cpu"))


class _HostReadMode(TorchFunctionMode):
    def __init__(self):
        super().__init__()
        self.found = None

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if self.found is None and not host_reads_allowed():
            name = getattr(func, "__name__", "")
            if name in _HOST_READS:
                self.found = f"host read: Tensor.{name}() in the forward"
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def host_read_probe(device):
    """Run a body under the probe; yields an object whose ``found`` is
    None, or after the scope the first host read seen, described."""
    mode = _HostReadMode()
    cuda = torch.device(device).type == "cuda"
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        old = torch.cuda.get_sync_debug_mode() if cuda else None
        if cuda:
            torch.cuda.set_sync_debug_mode("warn")
        try:
            with mode:
                yield mode
        finally:
            if cuda:
                torch.cuda.set_sync_debug_mode(old)
    for w in caught:
        if "debug mode is a prototype" in str(w.message):
            continue                   # torch's notice on arming the mode
        if "called a synchronizing CUDA operation" in str(w.message):
            if mode.found is None:
                mode.found = f"host read: {str(w.message).strip()[:120]}"
        else:                          # the body's own warnings go on
            warnings.warn_explicit(w.message, w.category, w.filename,
                                   w.lineno)


class CapturedStep:
    """``CapturedStep(fn, mutable, device, pool, stream, warmup=True,
    recorded=None)``: ``fn()`` takes no arguments and returns nothing; it
    reads and writes persistent tensors.  ``mutable`` lists the tensors
    its warm-up may change (restored after it); with ``warmup=False`` the
    owner has warmed the body's work up on ``stream`` already and nothing
    is restored, and ``recorded`` is the `Recording` of that warm-up (the
    generators to register, the seed slots to allocate).  On the card,
    ``pool`` (a `torch.cuda.graph_pool_handle`) and ``stream`` (the side
    stream of warm-up and capture) may be shared by the steps of one
    owner.  ``replays`` counts; ``launches`` is the per-replay launch delta
    by kernel name; ``collectives`` the per-replay ``{op: (calls,
    bytes)}`` of `distributed.collective` (counted once, at the capture:
    the replays run them without Python); ``refills`` the `device_seed`
    slots and their draws."""

    def __init__(self, fn, mutable, device, pool=None, stream=None,
                 warmup=True, recorded=None):
        self.fn = fn
        self.mutable = list(mutable)
        self.device = torch.device(device)
        self.pool = pool
        self.stream = stream
        self.warmup = warmup
        self.recorded = recorded or Recording()
        self.graph = None
        self.launches = {}
        self.collectives = {}
        self.refills = []
        self._free_slots = []
        self.replays = 0
        self._warmed = False

    def take_slot(self, draw):
        """The next seed slot (allocated before the capture) for a draw the
        body makes while it is recorded."""
        if not self._free_slots:
            raise RuntimeError(
                "CapturedStep: the body drew more host seeds while it was "
                f"captured than its warm-up drew ({self.recorded.seeds})")
        slot = self._free_slots.pop(0)
        self.refills.append((slot, draw))
        return slot

    def __call__(self):
        if self.device.type != "cuda":
            self.fn()
            return
        if self.graph is None:
            self.capture()
        with allow_host_reads():
            for slot, draw in self.refills:      # stream-ordered fills
                slot.fill_(draw() & M32)
        self.graph.replay()
        self.replays += 1
        kernels.add_launch_counts(self.launches)

    def warm_up(self):
        """Run the body once on the side stream and restore the tensors it
        mutated (the first half of `capture`; an owner may run it alone,
        under a probe, before it captures)."""
        current = torch.cuda.current_stream(self.device)
        saved = [t.clone() for t in self.mutable]
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream), recording() as rec:
            self.fn()
        current.wait_stream(self.stream)
        for t, s in zip(self.mutable, saved):
            t.copy_(s)
        self.recorded = rec
        self._warmed = True

    def capture(self):
        if self.warmup and not self._warmed:
            self.warm_up()
        graph = torch.cuda.CUDAGraph()
        for gen in self.recorded.generators:
            graph.register_generator_state(gen)
        self.refills = []
        self._free_slots = [torch.zeros((), dtype=torch.int64,
                                        device=self.device)
                            for _ in range(self.recorded.seeds)]
        before = kernels.launch_counts()
        from ..distributed import collective
        coll_before = collective.counts()
        # no garbage collection inside the capture: a collection there can
        # destroy another CUDA graph that sat in unreachable objects
        # (cudaGraphExecDestroy), which a capture forbids in its thread; the
        # capture is then invalidated and its next launch fails.  What is
        # unreachable now is collected after the capture.
        gc_was_on = gc.isenabled()
        gc.disable()
        try:
            with capturing(self), torch.cuda.graph(
                    graph, pool=self.pool, stream=self.stream,
                    capture_error_mode="thread_local"):
                self.fn()
        finally:
            if gc_was_on:
                gc.enable()
        after = kernels.launch_counts()
        self.launches = {k: after[k] - before[k] for k in after
                         if after[k] != before[k]}
        # the collectives the graph replays (counted once, at the capture)
        self.collectives = {
            op: (c - coll_before.get(op, (0, 0))[0],
                 b - coll_before.get(op, (0, 0))[1])
            for op, (c, b) in collective.counts().items()
            if c != coll_before.get(op, (0, 0))[0]}
        # recording launched nothing: the replays add the delta
        kernels.add_launch_counts({k: -n for k, n in self.launches.items()})
        self.graph = graph
