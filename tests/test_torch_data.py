"""The port's samplers, DataLoader and input pipeline
(paddle_tpu_torch/io, paddle_tpu_torch/data) against the JAX package's
on the CPU.  Everything here is integer indices and token ids: the two
packages must agree exactly.

- Samplers and the DataLoader: the same indices and batches as JAX's
  for the same seed (sequence, seeded random with the epoch folded in,
  distributed shards with padding, the threaded lane); the threaded
  lane's order, error position, timeout, warn-once and worker info.
- The pipeline, stage by stage (shard, windowed shuffle across epochs,
  map, pack's tokens / segment ids / positions, batch with and without
  drop_last), against JAX's; a state dict the JAX pipeline took in the
  middle of an epoch loads into the port's and gives JAX's remaining
  batches, and the reverse; the port's own mid-epoch resume, with a pack
  carry; a resize from 4 ranks to 2; corrupt records; the goodput meter
  under ``data_slow``; ``device_prefetch(device="cpu")`` against no
  prefetch."""
import os
import threading
import time
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import data as JD
from paddle_tpu import io as jio
from paddle_tpu_torch import data as D
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.data import CorruptRecordError, PipelineConfigError
from paddle_tpu_torch.data.pipeline import PipelineStateError
from paddle_tpu_torch.utils import flags


@pytest.fixture(autouse=True)
def _clean_fault_flags():
    yield
    flags.set_flags({"FLAGS_fault_inject": ""})
    paddle.set_flags({"FLAGS_fault_inject": ""})


class _IdDataset:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return np.int64(i)


class _Docs:
    """Token documents of random lengths (some longer than a row)."""

    def __init__(self, n=14, seed=1, longest=11):
        rng = np.random.default_rng(seed)
        self.docs = [rng.integers(1, 50, (int(k),)).astype(np.int64)
                     for k in rng.integers(1, longest, n)]

    def __len__(self):
        return len(self.docs)

    def __getitem__(self, i):
        return self.docs[i]


def _np(x):
    if torch.is_tensor(x):
        return x.numpy()
    if hasattr(x, "_data_"):
        return np.asarray(x._data_)
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_np(v) for v in x)
    return np.asarray(x)


def _same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a).astype(np.int64),
                                      np.asarray(b).astype(np.int64))


def _drain(pipe, n=None):
    out, it = [], iter(pipe)
    while n is None or len(out) < n:
        try:
            out.append(_np(next(it)))
        except StopIteration:
            break
    return out


# ---------------------------------------------------------------------------
# samplers and the DataLoader
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,epoch", [(0, 0), (13, 2), (7, 5)])
def test_random_and_batch_samplers_match_jax(seed, epoch):
    ds = _IdDataset(37)
    for mk in (lambda m: m.RandomSampler(ds, seed=seed),
               lambda m: m.BatchSampler(ds, shuffle=True, batch_size=4,
                                        seed=seed),
               lambda m: m.BatchSampler(ds, shuffle=True, batch_size=4,
                                        seed=seed, drop_last=True),
               lambda m: m.BatchSampler(ds, batch_size=5),
               lambda m: m.SequenceSampler(ds)):
        a, b = mk(tio), mk(jio)
        if hasattr(a, "set_epoch"):
            a.set_epoch(epoch)
            b.set_epoch(epoch)
        assert list(a) == list(b) and len(a) == len(b)


@pytest.mark.parametrize("ranks,shuffle,drop_last",
                         [(1, False, False), (3, True, False),
                          (4, True, True)])
def test_distributed_batch_sampler_matches_jax(ranks, shuffle, drop_last):
    ds = _IdDataset(30)
    for rank in range(ranks):
        a = tio.DistributedBatchSampler(ds, 4, num_replicas=ranks,
                                        rank=rank, shuffle=shuffle,
                                        drop_last=drop_last, seed=3)
        b = jio.DistributedBatchSampler(ds, 4, num_replicas=ranks,
                                        rank=rank, shuffle=shuffle,
                                        drop_last=drop_last, seed=3)
        for epoch in (0, 4):
            a.set_epoch(epoch)
            b.set_epoch(epoch)
            assert list(a) == list(b) and len(a) == len(b)


@pytest.mark.parametrize("workers", [0, 2])
def test_dataloader_batches_match_jax(workers):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((22, 3)).astype(np.float32)
    y = rng.integers(0, 9, (22,)).astype(np.int32)
    mk = lambda m: m.DataLoader(  # noqa: E731
        m.TensorDataset([x, y]), num_workers=workers,
        use_shared_memory=False,
        batch_sampler=m.BatchSampler(m.TensorDataset([x, y]), shuffle=True,
                                     batch_size=4, seed=11))
    a, b = mk(tio), mk(jio)
    a.batch_sampler.set_epoch(1)
    b.batch_sampler.set_epoch(1)
    got, want = [_np(t) for t in a], [_np(t) for t in b]
    assert len(got) == len(want) == 6
    for (gx, gy), (wx, wy) in zip(got, want):
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)
    batch = next(iter(a))
    assert all(t.device.type == "cpu" for t in batch)   # host batches


def test_default_collate_keeps_structure():
    out = tio.default_collate_fn([
        {"a": np.ones(2, np.float32), "b": (1, torch.tensor([2, 3]))},
        {"a": np.zeros(2, np.float32), "b": (4, torch.tensor([5, 6]))}])
    assert torch.equal(out["a"], torch.tensor([[1.0, 1.0], [0.0, 0.0]]))
    assert torch.equal(out["b"][0], torch.tensor([1, 4]))
    assert torch.equal(out["b"][1], torch.tensor([[2, 3], [5, 6]]))


class _CountingDS:
    def __init__(self, n, raise_at=None, sleep_from=None, sleep_s=0.0):
        self.n, self.raise_at = n, raise_at
        self.sleep_from, self.sleep_s = sleep_from, sleep_s
        self.calls = 0
        self.workers = set()

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        self.calls += 1
        info = tio.get_worker_info()
        if info is not None:
            self.workers.add((info.id, info.num_workers))
        if i == self.raise_at:
            raise ValueError(f"poisoned sample {i}")
        if self.sleep_from is not None and i >= self.sleep_from:
            time.sleep(self.sleep_s)
        return np.float32(i)


def test_threaded_loader_streams_lazily_and_in_order():
    ds = _CountingDS(256)
    dl = tio.DataLoader(ds, batch_size=4, shuffle=False, num_workers=2,
                        use_shared_memory=False, prefetch_factor=2)
    it = iter(dl)
    np.testing.assert_array_equal(next(it).numpy(), [0, 1, 2, 3])
    assert ds.calls < 256 // 2                 # bounded prefetch
    got = np.concatenate([[0, 1, 2, 3]] + [b.numpy() for b in it])
    np.testing.assert_array_equal(got, np.arange(256))
    assert {w for w, _ in ds.workers} <= {0, 1} and \
        {n for _, n in ds.workers} == {2}
    assert tio.get_worker_info() is None       # not inside a worker


def test_threaded_loader_propagates_worker_exception_at_position():
    ds = _CountingDS(64, raise_at=21)          # poisons batch 5
    dl = tio.DataLoader(ds, batch_size=4, shuffle=False, num_workers=2,
                        use_shared_memory=False)
    seen = []
    with pytest.raises(ValueError, match="poisoned sample 21"):
        for b in dl:
            seen.append(b)
    assert len(seen) == 5


def test_loader_timeout_is_typed_and_names_the_batch():
    ds = _CountingDS(16, sleep_from=4, sleep_s=2.0)
    dl = tio.DataLoader(ds, batch_size=4, shuffle=False, num_workers=1,
                        use_shared_memory=False, timeout=0.4)
    it = iter(dl)
    next(it)
    with pytest.raises(tio.DataLoaderTimeoutError) as ei:
        next(it)
    assert ei.value.batch_index == 1 and "batch 1" in str(ei.value)
    with pytest.raises(ValueError):
        tio.DataLoader(ds, timeout=-1)


def test_shared_memory_takes_the_threaded_lane_and_warns_once():
    """The default lane (``use_shared_memory=True``) runs worker
    processes over the shared-memory queue and warns nothing: each batch
    comes from a worker process, in order, on two epochs."""
    ds = _CountingDS(8)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        for _ in range(2):
            dl = tio.DataLoader(ds, batch_size=4, num_workers=2)
            out = list(dl)
            assert len(dl.batch_pids) == 2 and \
                os.getpid() not in dl.batch_pids
    typed = [x for x in w if issubclass(x.category, tio.DataLoaderWarning)]
    assert typed == []
    np.testing.assert_array_equal(torch.cat(out).numpy(), np.arange(8))


# ---------------------------------------------------------------------------
# the pipeline against JAX's
# ---------------------------------------------------------------------------

def _double(x):
    return x * 2 + 1


PIPES = {
    "shard": lambda m, ds: m.pipeline(ds).shard(1, 3).batch(3),
    "shuffle": lambda m, ds: m.pipeline(ds).shard(0, 1).shuffle(seed=7)
    .batch(4, drop_last=False),
    "window": lambda m, ds: m.pipeline(ds).shard(0, 2).shuffle(
        seed=2, window=5).map(_double).batch(2),
    "pack": lambda m, ds: m.pipeline(ds).shard(0, 1).shuffle(seed=4)
    .pack(9).batch(2, drop_last=False),
    "pack-shard": lambda m, ds: m.pipeline(ds).shard(1, 2).pack(7).batch(1),
}


def _dataset(kind):
    return _Docs() if kind.startswith("pack") else _IdDataset(29)


@pytest.mark.parametrize("kind", sorted(PIPES))
def test_pipeline_stages_match_jax_over_epochs(kind):
    ds = _dataset(kind)
    a, b = PIPES[kind](D, ds), PIPES[kind](JD, ds)
    for _epoch in range(2):                    # the shuffle reseeds
        got, want = _drain(a), _drain(b)
        assert len(got) == len(want) > 0
        _same(got, want)
    assert a.state_dict() == b.state_dict()
    if kind.startswith("pack"):
        row = got[0]
        assert set(row) == {"tokens", "segment_ids", "positions"}
        assert row["segment_ids"].dtype == np.int32


@pytest.mark.parametrize("kind", ["shuffle", "window", "pack"])
@pytest.mark.parametrize("first", ["jax", "port"])
def test_state_dict_crosses_packages_mid_epoch(kind, first):
    """A state taken by one package's pipeline after two batches loads
    into the other's, which yields the first's remaining batches."""
    ds = _dataset(kind)
    mods = (JD, D) if first == "jax" else (D, JD)
    src = PIPES[kind](mods[0], ds)
    _drain(src)                                # epoch 0 whole
    it = iter(src)
    next(it)
    next(it)
    sd = src.state_dict()
    rest = [_np(b) for b in it]
    assert rest
    dst = PIPES[kind](mods[1], ds).load_state_dict(sd)
    _same(_drain(dst), rest)
    assert sd["stages"]["shard"]["epoch"] == 1


def test_pipeline_state_roundtrip_mid_epoch_with_pack_carry():
    ds = _Docs(n=20, seed=5)
    mk = lambda: (D.pipeline(ds).shard(0, 1).shuffle(seed=4)  # noqa: E731
                  .pack(6).batch(1))
    ref = _drain(mk())
    for cut in range(1, 6):
        p1 = mk()
        head = _drain(p1, cut)
        sd = p1.state_dict()
        carry = sd["stages"]["pack"]["carry"]
        assert carry is None or (len(carry) == 2 and
                                 all(isinstance(c, int) for c in carry))
        _same(head + _drain(mk().load_state_dict(sd)), ref)


def test_pipeline_state_rejects_bad_payloads():
    p = D.pipeline(_IdDataset(8)).shard(0, 1).shuffle(seed=1).batch(2)
    with pytest.raises(PipelineStateError):
        p.load_state_dict({"version": 99, "stages": {}})
    with pytest.raises(PipelineStateError):
        p.load_state_dict({"version": 1, "stages": {
            "shuffle": {"seed": 2}}})
    with pytest.raises(PipelineStateError):
        p.load_state_dict({"version": 1, "stages": {
            "shard": {"epoch": -1, "global_position": 0}}})


def test_pipeline_stage_order_enforced():
    with pytest.raises(PipelineConfigError):
        D.pipeline(_IdDataset(8)).batch(2).shuffle(seed=0)
    with pytest.raises(PipelineConfigError):
        D.pipeline(_IdDataset(8)).device_prefetch(2, device="cpu")
    with pytest.raises(PipelineConfigError):
        D.pipeline(_IdDataset(8)).shard(3, 2)
    with pytest.raises(TypeError):
        len(D.pipeline(_IdDataset(8)).pack(4))
    assert len(D.pipeline(_IdDataset(10)).shard(0, 3).batch(2)) == \
        len(JD.pipeline(_IdDataset(10)).shard(0, 3).batch(2))


def test_resize_4_to_2_no_lost_no_duplicated_ids():
    n = 48
    mk = lambda r, d: (D.pipeline(_IdDataset(n))  # noqa: E731
                       .shard(r, d).shuffle(seed=5).batch(2))
    consumed, state = [], None
    for r in range(4):
        p = mk(r, 4)
        consumed += [int(v) for b in _drain(p, 3) for v in b]
        state = p.state_dict()
    assert state["stages"]["shard"]["global_position"] == 24
    for r in range(2):
        p = mk(r, 2).load_state_dict(state)
        consumed += [int(v) for b in _drain(p) for v in b]
    assert sorted(consumed) == list(range(n))


def test_prefetch_on_cpu_yields_the_same_batches_and_commits_late():
    mk = lambda: D.pipeline(_IdDataset(40)).shard(0, 1).shuffle(  # noqa
        seed=2).batch(5)
    pf = mk().device_prefetch(3, device="cpu")
    _same(_drain(pf), _drain(mk()))
    pf2 = mk().device_prefetch(3, device="cpu")
    it = iter(pf2)
    next(it)
    time.sleep(0.05)                           # the producer runs ahead
    assert pf2.state_dict()["stages"]["shard"]["global_position"] == 5
    assert pf2.goodput.batches == 1


def test_corrupt_records_skipped_then_typed_error_past_threshold():
    flags.set_flags({"FLAGS_fault_inject": "data_corrupt:at_sample=3"})
    pipe = D.pipeline(_IdDataset(16), corrupt_threshold=4).shard(0, 1) \
        .batch(4)
    ids = [int(v) for b in _drain(pipe) for v in b]
    assert 3 not in ids and len(ids) == 12
    assert pipe.records_skipped == 1
    flags.set_flags({"FLAGS_fault_inject": "data_corrupt:every=2"})
    pipe = D.pipeline(_IdDataset(64), corrupt_threshold=4).shard(0, 1) \
        .batch(4)
    with pytest.raises(CorruptRecordError) as ei:
        _drain(pipe)
    assert ei.value.skipped == 5 and ei.value.threshold == 4


def test_data_slow_injection_moves_starvation_telemetry():
    flags.set_flags({"FLAGS_fault_inject": "data_slow:delay_s=0.003"})
    pipe = (D.pipeline(_IdDataset(48)).shard(0, 1).batch(8)
            .device_prefetch(2, device="cpu"))
    for _ in pipe:
        pass
    snap = pipe.goodput.snapshot()
    assert snap["starved_steps"] > 0
    assert 0.0 < snap["input_bound"] <= 1.0
    assert snap["batches"] == 6


def test_prefetch_producer_error_reaches_the_consumer():
    class Bad(_IdDataset):
        def __getitem__(self, i):
            if i == 9:
                raise KeyError("boom")
            return np.int64(i)
    flags.set_flags({"FLAGS_fault_inject": ""})
    pipe = D.pipeline(Bad(16), corrupt_threshold=0).batch(4) \
        .device_prefetch(2, device="cpu")
    with pytest.raises(CorruptRecordError):
        _drain(pipe)
    assert not [t for t in threading.enumerate()
                if t.name == "paddle-data-prefetch" and t.is_alive()]
