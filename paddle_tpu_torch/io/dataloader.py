"""DataLoader (port of paddle_tpu/io/dataloader.py).

`default_collate_fn` stacks samples into CPU torch tensors; putting a
batch on the card is the consumer's job (``hapi.Model`` moves ``x`` and
``y`` to the network's device, ``data.Pipeline.device_prefetch`` copies
ahead on a side stream), as in the JAX package's pipeline.

With ``num_workers > 0`` the batches come from a pool of worker threads
(`DataLoader._iter_threaded`, JAX's threaded lane): the batch sampler is
read lazily through a bounded queue, batches are delivered in order
through a reorder buffer, a worker's exception is raised at its batch's
position, ``timeout`` bounds the wait for each batch
(`DataLoaderTimeoutError`), and `get_worker_info` describes the worker
inside it.  The JAX package's worker processes over a shared-memory ring
queue (a host C++ extension) are not ported (ROADMAP A8):
``use_shared_memory=True`` takes the threaded lane and raises a
`DataLoaderWarning` once, as the JAX loader takes it when the queue
cannot be built.  Each fetched batch counts ``io.batches_fetched`` and
observes its cost in the ``io.fetch_ms`` histogram (`utils.monitor`).
"""
from __future__ import annotations

import queue
import threading
import time
import warnings

import numpy as np
import torch

from ..utils import monitor as _monitor
from . import worker_info as _wi
from .dataset import IterableDataset
from .sampler import BatchSampler


class DataLoaderTimeoutError(TimeoutError):
    """``DataLoader(timeout=T)`` expired while waiting for a batch; names
    the batch."""

    def __init__(self, batch_index, timeout):
        self.batch_index = int(batch_index)
        self.timeout = float(timeout)
        super().__init__(
            f"DataLoader timed out after {timeout:g}s waiting for "
            f"batch {batch_index}")


class DataLoaderWarning(UserWarning):
    """An argument the loader accepts for compatibility but does not
    honour."""


_WARNED_ARGS = set()


def _warn_unsupported(name, why):
    if name in _WARNED_ARGS:
        return
    _WARNED_ARGS.add(name)
    warnings.warn(f"DataLoader({name}=...) is not supported by the port's "
                  f"loader and is ignored: {why}", DataLoaderWarning,
                  stacklevel=3)


class _WorkerFailure:
    """In-queue wrapper telling a worker's exception from a batch that
    happens to be an Exception instance."""

    __slots__ = ("exc",)

    def __init__(self, exc):
        self.exc = exc


def default_collate_fn(batch):
    """Stack samples into batched CPU tensors, keeping tuples, lists and
    dicts."""
    sample = batch[0]
    if torch.is_tensor(sample):
        return torch.stack([s.cpu() for s in batch])
    if isinstance(sample, np.ndarray):
        return torch.from_numpy(np.stack(batch))
    if isinstance(sample, (int, float, np.integer, np.floating)):
        return torch.from_numpy(np.asarray(batch))
    if isinstance(sample, (list, tuple)):
        transposed = list(zip(*batch))
        return type(sample)(default_collate_fn(list(group))
                            for group in transposed)
    if isinstance(sample, dict):
        return {k: default_collate_fn([d[k] for d in batch]) for k in sample}
    return batch


class DataLoader:
    def __init__(self, dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 persistent_workers=False):
        self.dataset = dataset
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = num_workers
        self.use_shared_memory = use_shared_memory
        self.worker_init_fn = worker_init_fn
        self.prefetch_factor = max(prefetch_factor, 2)
        self.timeout = float(timeout or 0)
        if self.timeout < 0:
            raise ValueError(f"DataLoader(timeout={timeout}): must be >= 0")
        if persistent_workers:
            _warn_unsupported(
                "persistent_workers",
                "workers are per-epoch threads")
        self._iterable_mode = isinstance(dataset, IterableDataset)
        if self._iterable_mode:
            self.batch_sampler = None
            self.batch_size = batch_size
            self.drop_last = drop_last
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
        else:
            self.batch_sampler = BatchSampler(
                dataset, shuffle=shuffle, batch_size=batch_size,
                drop_last=drop_last)

    def __len__(self):
        if self._iterable_mode:
            raise TypeError("IterableDataset has no len()")
        return len(self.batch_sampler)

    def _fetch(self, indices):
        _monitor.incr("io.batches_fetched")
        t0 = time.perf_counter()
        batch = self.collate_fn([self.dataset[i] for i in indices])
        # the reader's cost, a registry histogram: it says whether the
        # input pipeline or the card bounds a training run
        _monitor.observe("io.fetch_ms", (time.perf_counter() - t0) * 1e3)
        return batch

    def _iter_iterable(self):
        batch = []
        for sample in self.dataset:
            batch.append(sample)
            if len(batch) == self.batch_size:
                yield self.collate_fn(batch)
                batch = []
        if batch and not self.drop_last:
            yield self.collate_fn(batch)

    def __iter__(self):
        if self._iterable_mode:
            yield from self._iter_iterable()
            return
        if self.num_workers == 0:
            for indices in self.batch_sampler:
                yield self._fetch(indices)
            return
        if self.use_shared_memory:
            _warn_unsupported(
                "use_shared_memory",
                "worker processes over a shared-memory queue are not "
                "ported (ROADMAP A8); the workers are threads")
        yield from self._iter_threaded()

    def _iter_threaded(self):
        """Worker threads streaming through bounded queues: a feeder
        reads the batch sampler lazily (at most ``num_workers *
        prefetch_factor`` batches ahead), delivery stays in order through
        a reorder buffer, a worker's exception is raised at its batch's
        position, ``timeout`` bounds each wait."""
        nw = self.num_workers
        window = nw * self.prefetch_factor
        index_q = queue.Queue(maxsize=window)
        out_q = queue.Queue(maxsize=window)
        stop = threading.Event()

        def _put(q, item):
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def feeder():
            try:
                for item in enumerate(self.batch_sampler):
                    if not _put(index_q, item):
                        return
            except Exception as e:  # sampler failure → consumer
                _put(out_q, ("sampler_error", None, _WorkerFailure(e)))
                return
            for _ in range(nw):     # one end marker per worker
                if not _put(index_q, None):
                    return

        def worker(worker_id):
            _wi._set_worker_info(_wi.WorkerInfo(
                id=worker_id, num_workers=nw, dataset=self.dataset))
            try:
                if self.worker_init_fn is not None:
                    self.worker_init_fn(worker_id)
            except Exception as e:
                _put(out_q, ("sampler_error", None, _WorkerFailure(e)))
                return
            while not stop.is_set():
                try:
                    item = index_q.get(timeout=0.1)
                except queue.Empty:
                    continue
                if item is None:
                    _put(out_q, ("done", None, None))
                    return
                i, indices = item
                try:
                    _put(out_q, ("batch", i, self._fetch(indices)))
                except Exception as e:  # raised again at position i
                    _put(out_q, ("batch", i, _WorkerFailure(e)))

        threads = [threading.Thread(target=feeder, daemon=True)]
        threads += [threading.Thread(target=worker, args=(w,), daemon=True)
                    for w in range(nw)]
        for t in threads:
            t.start()
        pending = {}
        want = 0
        done_workers = 0
        waited = 0.0
        poll = 0.2
        try:
            while True:
                if want in pending:
                    item = pending.pop(want)
                    if isinstance(item, _WorkerFailure):
                        raise item.exc
                    yield item
                    want += 1
                    waited = 0.0
                    continue
                if done_workers == nw:
                    # each worker's batches precede its end marker
                    return
                try:
                    kind, i, payload = out_q.get(timeout=poll)
                except queue.Empty:
                    waited += poll
                    if self.timeout and waited >= self.timeout:
                        raise DataLoaderTimeoutError(want, self.timeout)
                    continue
                if kind == "done":
                    done_workers += 1
                elif kind == "sampler_error":
                    raise payload.exc
                else:
                    pending[i] = payload
        finally:
            stop.set()
