"""Datasets, samplers and the DataLoader (port of paddle_tpu/io)."""
from .dataset import (ChainDataset, ComposeDataset, ConcatDataset,  # noqa: F401
                      Dataset, IterableDataset, Subset, TensorDataset,
                      random_split)
from .sampler import (BatchSampler, DistributedBatchSampler,  # noqa: F401
                      RandomSampler, Sampler, SequenceSampler,
                      WeightedRandomSampler)
from .dataloader import (DataLoader, DataLoaderTimeoutError,  # noqa: F401
                         DataLoaderWarning, default_collate_fn)
from .worker_info import WorkerInfo, get_worker_info  # noqa: F401
