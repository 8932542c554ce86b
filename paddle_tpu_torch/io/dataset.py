"""Datasets (port of paddle_tpu/io/dataset.py, which is the reference's
python/paddle/io/dataloader/dataset.py): map-style and iterable
datasets over host data."""
from __future__ import annotations

import bisect

import numpy as np


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset does not support indexing")

    def __len__(self):
        # TypeError (not RuntimeError): operator.length_hint — which
        # list()/tuple() call — treats TypeError as "no length"
        raise TypeError("IterableDataset has no len()")


class TensorDataset(Dataset):
    def __init__(self, tensors):
        lens = {len(t) for t in tensors}
        if len(lens) != 1:
            raise ValueError("tensors must have the same first dim")
        self.tensors = tensors

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return len(self.tensors[0])


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


class ConcatDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.cumulative_sizes = np.cumsum([len(d) for d in self.datasets]).tolist()

    def __len__(self):
        return self.cumulative_sizes[-1]

    def __getitem__(self, idx):
        if idx < 0:
            idx += len(self)
        ds_idx = bisect.bisect_right(self.cumulative_sizes, idx)
        prev = 0 if ds_idx == 0 else self.cumulative_sizes[ds_idx - 1]
        return self.datasets[ds_idx][idx - prev]


def random_split(dataset, lengths, generator=None):
    total = len(dataset)
    if sum(lengths) != total:
        # fraction mode
        if all(0 < l < 1 for l in lengths):
            lengths = [int(l * total) for l in lengths]
            lengths[-1] = total - sum(lengths[:-1])
        else:
            raise ValueError("lengths must sum to dataset size")
    perm = np.random.permutation(total)
    out, offset = [], 0
    for l in lengths:  # noqa: E741
        out.append(Subset(dataset, perm[offset:offset + l].tolist()))
        offset += l
    return out


class ChainDataset(IterableDataset):
    """Chain IterableDatasets end-to-end (reference:
    io/dataloader/dataset.py ChainDataset)."""

    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __iter__(self):
        for ds in self.datasets:
            yield from ds


class ComposeDataset(Dataset):
    """Zip map-style datasets field-wise (reference: ComposeDataset)."""

    def __init__(self, datasets):
        self.datasets = list(datasets)
        assert self.datasets, "ComposeDataset needs at least one dataset"
        n = len(self.datasets[0])
        for ds in self.datasets:
            assert len(ds) == n, "datasets must share length"

    def __len__(self):
        return len(self.datasets[0])

    def __getitem__(self, idx):
        out = []
        for ds in self.datasets:
            item = ds[idx]
            if isinstance(item, (list, tuple)):
                out.extend(item)
            else:
                out.append(item)
        return tuple(out)
