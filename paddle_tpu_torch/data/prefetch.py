"""Device prefetch (port of paddle_tpu/data/prefetch.py): the next
batches' host-to-device copies overlap the current step.

A producer thread pulls host batches from the pipeline and parks up to
``depth`` of them, already on the device, in a bounded queue.  On the
card the producer first calls ``torch.cuda.set_device`` for the device,
makes one side stream for the whole `DevicePrefetch.iterate`, and for
each batch copies every array into pinned memory, then to the device
with ``non_blocking=True`` on that stream, and records an event after the
copies.  The consumer (the fit loop) makes its current stream wait on
that event and calls ``record_stream`` on each tensor before it yields
the batch: the current stream is the one ``CompiledTrainStep`` stages a
batch on (a copy into its persistent inputs, in stream order), so no
replay reads a batch that is half copied, and the caching allocator does
not hand a batch's memory to the side stream while the step still reads
it.  Every pop records its wait and the buffer's fill into the goodput
meter.

Checkpoint consistency: each queued batch travels with the pipeline
state taken right after it was produced; the pipeline commits a state
only when its batch is yielded to the caller, so prefetched batches that
were never consumed are produced again on resume.

The JAX package places a batch with a ``NamedSharding`` over the dp mesh
axis.  Here a rank holds its own rows: with a mesh whose dp axis is
above 1 (`distributed.get_mesh`, `fleet.init` sets it), each array whose
rows divide by dp is cut to this rank's dp rows before its copy, and the
others (as JAX replicates them) go whole (`_dp_rows`).
"""
from __future__ import annotations

import queue
import threading
import time

import numpy as np
import torch

from ..device import resolve_device


def _dp_batch_sharding():
    """``(dp rank, dp size)`` of the active mesh's dp axis, or None when
    no mesh with a dp axis above 1 is live."""
    from ..distributed import mesh as _mesh
    m = _mesh.get_mesh()
    if m is None or "dp" not in m.dim_names or m.get_dim_size("dp") <= 1:
        return None
    return m.get_coord("dp"), m.get_dim_size("dp")


def _dp_rows(batch, sharding):
    """This dp rank's rows of each array of ``batch`` whose leading dim
    divides by dp (the others whole), the structure kept.  Whole, as JAX's
    ``_put_leaf`` replicates such an array rather than refusing it: a
    side input that is not batch-shaped, or a short last batch, which
    every dp rank then trains on whole.  `CompiledTrainStep._rows` raises
    on a global batch that does not split, as JAX's compiled step does
    (its batch is placed over dp)."""
    if sharding is None:
        return batch
    if isinstance(batch, (list, tuple)):
        return type(batch)(_dp_rows(b, sharding) for b in batch)
    if isinstance(batch, dict):
        return {k: _dp_rows(v, sharding) for k, v in batch.items()}
    rank, dp = sharding
    n = batch.shape[0] if getattr(batch, "ndim", 0) >= 1 else 0
    if not n or n % dp:
        return batch
    per = n // dp
    return batch[rank * per:(rank + 1) * per]


def _leaf_tensor(x):
    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(x))
    if isinstance(x, (np.integer, np.floating)):
        return torch.from_numpy(np.asarray(x))
    return x


def to_host_tensors(batch):
    """A host batch (nested tuple, list or dict of numpy arrays) as CPU
    tensors, the structure kept."""
    if isinstance(batch, (list, tuple)):
        return type(batch)(to_host_tensors(b) for b in batch)
    if isinstance(batch, dict):
        return {k: to_host_tensors(v) for k, v in batch.items()}
    return _leaf_tensor(batch)


def _tensors(batch):
    if torch.is_tensor(batch):
        yield batch
    elif isinstance(batch, (list, tuple)):
        for b in batch:
            yield from _tensors(b)
    elif isinstance(batch, dict):
        for b in batch.values():
            yield from _tensors(b)


def to_device_batch(batch, device=None, non_blocking=False):
    """A host batch on ``device`` (None: the card, under the Devices rule;
    tensors already there are kept), the structure kept.  With
    ``non_blocking`` each array goes through pinned memory first, so the
    copy is asynchronous on the current stream."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if isinstance(batch, (list, tuple)):
        return type(batch)(to_device_batch(b, device, non_blocking)
                           for b in batch)
    if isinstance(batch, dict):
        return {k: to_device_batch(v, device, non_blocking)
                for k, v in batch.items()}
    t = _leaf_tensor(batch)
    if not torch.is_tensor(t) or t.device == device:
        return t
    if non_blocking and t.device.type == "cpu":
        t = t.pin_memory()
    return t.to(device, non_blocking=non_blocking)


class DevicePrefetch:
    name = "device_prefetch"

    def __init__(self, depth=2, *, device=None):
        if int(depth) < 1:
            raise ValueError(f"device_prefetch(depth={depth}): need >= 1")
        self.depth = int(depth)
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            # the producer thread sets this device: it needs the index
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev

    def state_dict(self):
        return {}

    def load_state_dict(self, sd):
        pass

    def iterate(self, pipe):
        """Yield ``(device_batch, state_after)`` for the rest of the
        pipeline's current epoch, the copies overlapped."""
        q = queue.Queue(maxsize=self.depth)
        stop = threading.Event()
        dev = self.device
        cuda = dev.type == "cuda"
        sharding = _dp_batch_sharding()

        def _put(item):
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                stream = None
                if cuda:
                    torch.cuda.set_device(dev)
                    stream = torch.cuda.Stream(dev)
                for host_batch, state in pipe._host_batches():
                    host_batch = _dp_rows(host_batch, sharding)
                    event = None
                    if cuda:
                        with torch.cuda.stream(stream):
                            batch = to_device_batch(host_batch, dev, True)
                            event = torch.cuda.Event()
                            event.record(stream)
                    else:
                        batch = to_device_batch(host_batch, dev)
                    if not _put(("batch", batch, state, event)):
                        return
                _put(("end", None, None, None))
            except BaseException as e:  # noqa: BLE001 — relayed
                _put(("error", e, None, None))

        t = threading.Thread(target=producer, daemon=True,
                             name="paddle-data-prefetch")
        t.start()
        try:
            while True:
                occupancy = q.qsize() / self.depth
                t0 = time.perf_counter()
                kind, payload, state, event = q.get()
                wait_ms = (time.perf_counter() - t0) * 1e3
                if kind == "end":
                    return
                if kind == "error":
                    raise payload
                if event is not None:
                    current = torch.cuda.current_stream(dev)
                    current.wait_event(event)
                    for x in _tensors(payload):
                        x.record_stream(current)
                pipe.goodput.record_consume(wait_ms, occupancy)
                yield payload, state
        finally:
            stop.set()
            while True:  # unblock a producer parked on a full queue
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            t.join(timeout=5)
