"""DataLoader (port of paddle_tpu/io/dataloader.py).

`default_collate_fn` stacks samples into CPU torch tensors; putting a
batch on the card is the consumer's job (``hapi.Model`` moves ``x`` and
``y`` to the network's device, ``data.Pipeline.device_prefetch`` copies
ahead on a side stream), as in the JAX package's pipeline.

With ``num_workers > 0`` and ``use_shared_memory`` (the default) the
batches come from worker processes (`DataLoader._iter_multiprocess`,
JAX's lane): forked workers fetch batch ``i`` when ``i % num_workers`` is
their id, as numpy (``_fetch_numpy``: no collation and no CUDA in a
worker, which calls ``torch.set_num_threads(1)``), after stamping
`get_worker_info` and running ``worker_init_fn``; the samples cross the
shared-memory ring queue (`io.shm_queue`, ``csrc/shm_queue.cpp``) and
the trainer collates them in order through a reorder buffer.  A worker's
exception is raised in the trainer naming it (a sample holding a CUDA
tensor is one), the owner of the awaited batch found dead fails the
iteration at once, ``timeout`` bounds each wait, and the workers are
reaped (terminated and joined) when the iteration ends.  ``batch_pids``
holds the process id each batch of the last iteration came from; a
batch counts ``io.batches_fetched`` and observes the worker's fetch and
the trainer's collation in ``io.fetch_ms``.
When the queue cannot be built or the workers not started (an
``ImportError`` or ``OSError``, e.g. no g++), the loader takes the
threaded lane, as JAX's does, but not silently: it warns a
`DataLoaderWarning` naming the cause and counts
``io.worker_fallbacks``.  With ``use_shared_memory=False`` the batches
come from worker threads (`DataLoader._iter_threaded`): the batch
sampler read lazily through a bounded queue, the same order, errors and
``timeout``.  Each fetched batch counts ``io.batches_fetched`` and
observes its cost in the ``io.fetch_ms`` histogram (`utils.monitor`).
"""
from __future__ import annotations

import os
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


def _check_host(obj):
    """Raise when a fetched sample holds a tensor off the host: a worker
    forked from a process with a live CUDA context must not touch it."""
    if torch.is_tensor(obj):
        if obj.device.type != "cpu":
            raise TypeError(
                f"a sample holds a tensor on {obj.device}: DataLoader "
                "worker processes fetch host data (numpy or CPU tensors); "
                "move it to the card after the loader")
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            _check_host(o)
    elif isinstance(obj, dict):
        for o in obj.values():
            _check_host(o)


def _reap(procs, out_q):
    """Close the queue, end the workers (terminate the ones left after a
    grace) and join them, so none stays a zombie; release the queue."""
    out_q.close()
    for p in procs:
        if p.pid is None:
            continue
        p.join(timeout=2)
        if p.exitcode is None:
            p.terminate()
            p.join(timeout=2)
    out_q.release()


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
        self.shm_slot_size = 16 << 20  # 16 MiB a batch slot
        self.batch_pids = []
        self.prefetch_factor = max(prefetch_factor, 2)
        self.timeout = float(timeout or 0)
        if self.timeout < 0:
            raise ValueError(f"DataLoader(timeout={timeout}): must be >= 0")
        if persistent_workers:
            _warn_unsupported(
                "persistent_workers",
                "workers are started for each epoch")
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
            try:
                lane = self._start_workers()
            except (ImportError, OSError) as e:
                _monitor.incr("io.worker_fallbacks")
                warnings.warn(
                    "DataLoader(use_shared_memory=True): the worker "
                    f"processes could not start ({type(e).__name__}: {e}); "
                    "the workers are threads", DataLoaderWarning,
                    stacklevel=2)
            else:
                yield from self._iter_multiprocess(*lane)
                return
        yield from self._iter_threaded()

    def _fetch_numpy(self, indices):
        """A worker's fetch: the samples as the dataset gives them
        (picklable host data); the trainer collates."""
        samples = [self.dataset[i] for i in indices]
        _check_host(samples)
        return samples

    def _start_workers(self):
        """The queue and the forked workers of an epoch: ``(queue,
        processes, batches)``; raises ``OSError`` when the queue cannot
        be built (its g++ build failed) or a worker cannot start."""
        import multiprocessing as mp
        from ..utils.cpp_extension import BuildError
        from .shm_queue import ShmQueue
        batches = list(enumerate(self.batch_sampler))
        nw = self.num_workers
        try:
            out_q = ShmQueue(capacity=max(2 * nw, 4),
                             slot_size=self.shm_slot_size)
        except BuildError as e:
            raise OSError(str(e)) from e
        ctx = mp.get_context("fork")
        procs = [ctx.Process(target=self._worker_main,
                             args=(w, out_q, batches[w::nw]), daemon=True)
                 for w in range(nw)]
        try:
            for p in procs:
                p.start()
        except BaseException:
            _reap(procs, out_q)
            raise
        return out_q, procs, len(batches)

    def _worker_main(self, worker_id, out_q, batches):
        """A worker process: its batches into the queue, or its error
        (truncated to fit a slot) for the trainer."""
        from .shm_queue import QueueClosed
        try:
            torch.set_num_threads(1)
            _wi._set_worker_info(_wi.WorkerInfo(
                id=worker_id, num_workers=self.num_workers,
                dataset=self.dataset))
            if self.worker_init_fn is not None:
                self.worker_init_fn(worker_id)
            for i, indices in batches:
                t0 = time.perf_counter()
                samples = self._fetch_numpy(indices)
                ms = (time.perf_counter() - t0) * 1e3
                out_q.put((i, (os.getpid(), ms), samples))
        except (QueueClosed, KeyboardInterrupt):
            pass
        except Exception as e:  # noqa: BLE001 — reported to the trainer
            msg = f"worker {worker_id}: {type(e).__name__}: {e}"
            try:
                out_q.put(("__worker_error__", None, msg[:4096]),
                          timeout=5.0)
            except Exception:  # noqa: BLE001 — the queue is gone
                pass
            os._exit(1)
        os._exit(0)

    def _iter_multiprocess(self, out_q, procs, n_batches):
        """The trainer's side of the worker processes: batches in order
        (a reorder buffer), collated here."""
        nw = len(procs)
        pending = {}
        self.batch_pids = []
        try:
            for want in range(n_batches):
                waited = 0.0
                while want not in pending:
                    poll = 1.0
                    if self.timeout:
                        poll = max(min(poll, self.timeout - waited), 0.01)
                    try:
                        i, source, batch = out_q.get(timeout=poll)
                    except TimeoutError:
                        waited += poll
                        # fail fast only when the awaited batch's owner
                        # (worker want % nw) has died; a slow live worker
                        # waits for the timeout
                        owner = procs[want % nw]
                        if owner.exitcode not in (None, 0):
                            raise RuntimeError(
                                f"DataLoader worker {want % nw} exited "
                                f"unexpectedly (code {owner.exitcode}) "
                                f"before delivering batch {want}")
                        if self.timeout and waited >= self.timeout:
                            raise DataLoaderTimeoutError(want, self.timeout)
                        continue
                    if i == "__worker_error__":
                        raise RuntimeError(
                            f"DataLoader worker failed: {batch}")
                    pending[i] = (source, batch)
                (pid, ms), samples = pending.pop(want)
                self.batch_pids.append(pid)
                t0 = time.perf_counter()
                batch = self.collate_fn(samples)
                # the worker's fetch and the trainer's collation
                _monitor.incr("io.batches_fetched")
                _monitor.observe("io.fetch_ms", ms + (
                    time.perf_counter() - t0) * 1e3)
                yield batch
        finally:
            _reap(procs, out_q)

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
