"""Samplers (port of paddle_tpu/io/sampler.py, as it is): the same index
order as the JAX package for the same seed.  `RandomSampler` with a seed
permutes each epoch under ``default_rng([seed, epoch])``;
`DistributedBatchSampler` shards by data-parallel rank (the rank and
world size of `paddle_tpu_torch.distributed` when not given)."""
from __future__ import annotations

import numpy as np


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        return len(self.data_source)


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))


class RandomSampler(Sampler):
    """``seed=None`` (default) draws from the global numpy RNG exactly
    as before; with a seed, each epoch permutes under the epoch-folded
    key ``(seed, epoch)`` — deterministic across runs AND different per
    epoch (``set_epoch`` is what a resumed fit uses to land on the same
    epoch order the uninterrupted run had)."""

    def __init__(self, data_source, replacement=False, num_samples=None,
                 generator=None, seed=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch):
        self.epoch = int(epoch)

    @property
    def num_samples(self):
        return self._num_samples or len(self.data_source)

    def _rng(self):
        if self.seed is None:
            return np.random  # legacy path: byte-identical to before
        return np.random.default_rng([int(self.seed), int(self.epoch)])

    def __iter__(self):
        n = len(self.data_source)
        rng = self._rng()
        if self.replacement:
            idx = rng.integers(0, n, self.num_samples) \
                if rng is not np.random \
                else np.random.randint(0, n, self.num_samples)
            return iter(idx.tolist())
        return iter(rng.permutation(n)[:self.num_samples].tolist())

    def __len__(self):
        return self.num_samples


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True):
        self.weights = np.asarray(weights, dtype=np.float64)
        self.num_samples = num_samples
        self.replacement = replacement

    def __iter__(self):
        p = self.weights / self.weights.sum()
        idx = np.random.choice(len(self.weights), self.num_samples,
                               replace=self.replacement, p=p)
        return iter(idx.tolist())

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler=None, shuffle=False,
                 batch_size=1, drop_last=False, seed=None):
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.epoch = 0
        if sampler is not None:
            self.sampler = sampler
        elif shuffle:
            self.sampler = RandomSampler(dataset, seed=seed)
        else:
            self.sampler = SequenceSampler(dataset)

    def set_epoch(self, epoch):
        """Epoch-folded reshuffle key: hapi fit calls this at each
        epoch begin so (a) multi-epoch training does not replay one
        fixed order and (b) a resumed fit reproduces the order the
        uninterrupted run used for that epoch.  A plain unseeded
        sampler is unaffected (it already draws fresh global-RNG
        permutations)."""
        self.epoch = int(epoch)
        inner = getattr(self.sampler, "set_epoch", None)
        if inner is not None:
            inner(epoch)

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


class DistributedBatchSampler(BatchSampler):
    """Shards the dataset across data-parallel ranks (reference:
    python/paddle/io/dataloader/batch_sampler.py DistributedBatchSampler)."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False, seed=0):
        from .. import distributed as dist_env
        self.dataset = dataset
        self.batch_size = batch_size
        self.nranks = num_replicas if num_replicas is not None \
            else dist_env.get_world_size()
        self.local_rank = rank if rank is not None else dist_env.get_rank()
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = int(seed)
        self.epoch = 0
        self.num_samples = int(np.ceil(len(dataset) / self.nranks))
        self.total_size = self.num_samples * self.nranks

    def __iter__(self):
        n = len(self.dataset)
        if self.shuffle:
            # epoch-folded key: identical on every rank (the shard
            # split below needs one global order), pinned per epoch by
            # set_epoch — standalone use keeps the legacy auto-advance
            rng = np.random.RandomState(self.seed + self.epoch)
            indices = rng.permutation(n).tolist()
            self.epoch += 1
        else:
            indices = list(range(n))
        # pad to make divisible
        indices += indices[:(self.total_size - len(indices))]
        local = indices[self.local_rank::self.nranks]
        batch = []
        for idx in local:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch):
        self.epoch = epoch
