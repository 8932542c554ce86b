"""The pull-based input pipeline (port of paddle_tpu/data/pipeline.py):
stage objects and the ``Pipeline`` that drives them.

    source -> shard(rank, dp_degree) -> shuffle(seeded, windowed)
           -> map -> pack([B,S] with segment ids) -> batch
           -> device_prefetch

Checkpoint contract: stage state is derivational, not material: a seed,
an epoch number, a global sample position, a carry pointer.  Restoring
it re-derives every buffer from the dataset; nothing that flows through
the pipeline is serialised.  The state dict is the JAX package's, key
for key, so a state taken by either pipeline loads into the other and
continues with the same batches.

Sharding model: one epoch is ``total = ceil(n / dp_degree) * dp_degree``
global sample slots (the tail wraps into the head of the shuffled
order).  Slot ``g`` belongs to rank ``g % dp_degree``; every rank
advances the shared ``global_position`` by ``dp_degree`` a local sample,
so a checkpoint re-shards to any dp degree.

Batches are host data: without ``device_prefetch`` a batch is CPU
tensors (``hapi.Model`` moves them to the network's device); with it,
tensors on the card, copied ahead on a side stream (`data.prefetch`).
Records skipped as corrupt and documents truncated by packing count
``data.records_skipped`` and ``data.docs_truncated`` (`utils.monitor`), as
in JAX; the pipeline's `GoodputMeter` publishes the ``data.*`` input
families.
"""
from __future__ import annotations

import copy
import math
import time

import numpy as np

from ..utils import fault_injection as _fi
from ..utils import monitor as _monitor
from .goodput import GoodputMeter

_SKIP = object()
_EPOCH_END = object()

_STATE_VERSION = 1


class PipelineConfigError(TypeError):
    """Mis-ordered or mis-typed stage composition (e.g. ``.shuffle()``
    after ``.batch()``, or ``.device_prefetch()`` without ``.batch()``)."""


class CorruptRecordError(RuntimeError):
    """More corrupt records than ``corrupt_threshold`` were skipped.

    Individual corrupt records are skipped and counted
    (``data.records_skipped``) so one bad shard does not kill a fleet
    run; past the threshold the pipeline refuses to keep silently
    thinning the sample stream."""

    def __init__(self, skipped, threshold, last_error):
        self.skipped = int(skipped)
        self.threshold = int(threshold)
        self.last_error = str(last_error)
        super().__init__(
            f"data pipeline skipped {skipped} corrupt records "
            f"(threshold {threshold}); last error: {last_error}")


class PipelineStateError(ValueError):
    """A ``load_state_dict`` payload that cannot be applied (wrong
    version, missing stage, negative counters)."""


# ---------------------------------------------------------------------------
# stages
# ---------------------------------------------------------------------------


class _SourceStage:
    """Record fetch + corrupt-record policy over an indexable dataset."""

    name = "source"

    def __init__(self, dataset, corrupt_threshold=8):
        self.dataset = dataset
        self.corrupt_threshold = int(corrupt_threshold)
        self.records_skipped = 0
        self._last_error = ""

    def __len__(self):
        return len(self.dataset)

    def fetch(self, sample_id):
        _fi.data_fetch_delay()
        try:
            if _fi.data_record_corrupt(sample_id):
                raise ValueError(
                    f"injected corrupt record (sample {sample_id})")
            return self.dataset[sample_id]
        except Exception as e:  # noqa: BLE001 — corrupt-record policy
            self.records_skipped += 1
            self._last_error = f"sample {sample_id}: {type(e).__name__}: {e}"
            _monitor.incr("data.records_skipped")
            if self.records_skipped > self.corrupt_threshold:
                raise CorruptRecordError(
                    self.records_skipped, self.corrupt_threshold,
                    self._last_error) from e
            return _SKIP

    def state_dict(self):
        return {"records_skipped": int(self.records_skipped)}

    def load_state_dict(self, sd):
        skipped = int(sd.get("records_skipped", 0))
        if skipped < 0:
            raise PipelineStateError(
                f"source.records_skipped must be >= 0, got {skipped}")
        self.records_skipped = skipped


class _ShardStage:
    """Owns the epoch counter and the single global sample position."""

    name = "shard"

    def __init__(self, rank=0, dp_degree=1):
        rank, dp_degree = int(rank), int(dp_degree)
        if dp_degree < 1 or not (0 <= rank < dp_degree):
            raise PipelineConfigError(
                f"shard(rank={rank}, dp_degree={dp_degree}): need "
                f"0 <= rank < dp_degree")
        self.rank = rank
        self.dp_degree = dp_degree
        self.epoch = 0
        self.global_position = 0

    def positions_total(self, n):
        return int(math.ceil(n / self.dp_degree)) * self.dp_degree

    def next_position(self, n):
        """This rank's next global slot, advancing the lockstep
        position — or None at epoch end."""
        g = self.global_position + self.rank
        if g >= self.positions_total(n):
            return None
        self.global_position += self.dp_degree
        return g

    def advance_epoch(self):
        self.epoch += 1
        self.global_position = 0

    def state_dict(self):
        # dp_degree is recorded for observability only: the position is
        # global, so a resumed world applies its OWN rank/dp_degree.
        return {"epoch": int(self.epoch),
                "global_position": int(self.global_position),
                "dp_degree": int(self.dp_degree)}

    def load_state_dict(self, sd):
        epoch = int(sd.get("epoch", 0))
        pos = int(sd.get("global_position", 0))
        if epoch < 0 or pos < 0:
            raise PipelineStateError(
                f"shard state must be non-negative (epoch={epoch}, "
                f"global_position={pos})")
        self.epoch = epoch
        self.global_position = pos


class _ShuffleStage:
    """Windowed, seeded, per-epoch-reseeded permutation — computed, not
    buffered.  Slot ``g`` maps through a permutation of its window
    block, keyed by ``(seed, epoch, block)``, so random access (the
    pack carry refetch) and sequential access share one code path and
    the only state is the seed."""

    name = "shuffle"

    def __init__(self, seed=0, window=None):
        self.seed = int(seed)
        if window is not None and int(window) < 2:
            raise PipelineConfigError(
                f"shuffle(window={window}): window must be >= 2 "
                f"(or None for a full-epoch permutation)")
        self.window = None if window is None else int(window)
        self._cache_key = None
        self._cache_perm = None

    def permute(self, epoch, n, pos):
        w = self.window or n
        block = pos // w
        key = (self.seed, int(epoch), block, n)
        if self._cache_key != key:
            block_n = min(w, n - block * w)
            rng = np.random.default_rng(list(key))
            self._cache_perm = rng.permutation(block_n)
            self._cache_key = key
        return int(block * w + self._cache_perm[pos - block * w])

    def state_dict(self):
        return {"seed": int(self.seed),
                "window": self.window}

    def load_state_dict(self, sd):
        if "seed" in sd and int(sd["seed"]) != self.seed:
            # a silently different stream is the worst failure mode a
            # deterministic loader can have — refuse loudly
            raise PipelineStateError(
                f"shuffle seed mismatch: checkpoint has {sd['seed']}, "
                f"pipeline was built with {self.seed}")


class _MapStage:
    name = "map"

    def __init__(self, fn):
        if not callable(fn):
            raise PipelineConfigError(f"map(fn): {fn!r} is not callable")
        self.fn = fn

    def state_dict(self):
        return {}

    def load_state_dict(self, sd):
        pass


class _PackStage:
    """Fixed-length sequence packing: whole documents are placed
    back-to-back into rows of ``seq_len`` tokens with 1-based segment
    ids and per-document position reset (pad = segment 0).  A document
    that does not fit the remaining row opens the next row; the pending
    document is checkpointed as its *(epoch, global slot)* pointer and
    re-fetched on restore — never as tokens."""

    name = "pack"

    def __init__(self, seq_len):
        if int(seq_len) < 1:
            raise PipelineConfigError(f"pack(seq_len={seq_len}): need >= 1")
        self.seq_len = int(seq_len)
        self._carry_tokens = None   # np.ndarray — runtime only
        self._carry_slot = None     # (epoch, global_position) — the state

    def state_dict(self):
        slot = self._carry_slot
        return {"carry": None if slot is None
                else [int(slot[0]), int(slot[1])]}

    def load_state_dict(self, sd, refetch=None):
        slot = sd.get("carry")
        if slot is None:
            self._carry_tokens = None
            self._carry_slot = None
            return
        epoch, g = int(slot[0]), int(slot[1])
        if refetch is None:
            raise PipelineStateError(
                "pack carry present but no refetch path available")
        self._carry_tokens = _as_tokens(refetch(epoch, g))
        self._carry_slot = (epoch, g)


class _BatchStage:
    name = "batch"

    def __init__(self, batch_size, drop_last=True):
        if int(batch_size) < 1:
            raise PipelineConfigError(
                f"batch(batch_size={batch_size}): need >= 1")
        self.batch_size = int(batch_size)
        self.drop_last = bool(drop_last)

    def state_dict(self):
        return {}

    def load_state_dict(self, sd):
        pass


def _as_tokens(sample):
    tokens = np.asarray(sample)
    if tokens.ndim != 1:
        raise PipelineConfigError(
            f"pack() expects 1-D token sequences upstream, got shape "
            f"{tokens.shape}")
    return tokens


def _collate_host(items):
    """Stack samples into host-side numpy batches (device placement is
    the prefetch/iterator's job, so workers and producers stay
    device-free)."""
    first = items[0]
    if isinstance(first, np.ndarray):
        return np.stack(items)
    if isinstance(first, (int, float, np.integer, np.floating)):
        return np.asarray(items)
    if isinstance(first, (list, tuple)):
        return type(first)(_collate_host(list(group))
                           for group in zip(*items))
    if isinstance(first, dict):
        return {k: _collate_host([d[k] for d in items]) for k in first}
    return np.asarray(items)


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------

#: builder ordering — a stage may only be appended after stages of
#: strictly lower rank (map may repeat).
_STAGE_RANK = {"shard": 1, "shuffle": 2, "map": 3, "pack": 4, "batch": 5,
               "device_prefetch": 6}


class Pipeline:
    """Composable input pipeline; build with :func:`pipeline`.

    ``iter(p)`` yields one epoch of batches from the current position
    (so a freshly-restored pipeline resumes mid-epoch), then advances
    the epoch counter.  ``state_dict()`` between any two batches is a
    consistent resume point.
    """

    def __init__(self, dataset, corrupt_threshold=8):
        if not hasattr(dataset, "__getitem__") or not hasattr(
                dataset, "__len__"):
            raise PipelineConfigError(
                "pipeline(dataset): dataset must be indexable with a "
                "len() (map-style); IterableDataset is not resumable")
        self._source = _SourceStage(dataset, corrupt_threshold)
        self._shard = _ShardStage(0, 1)
        self._shuffle = None
        self._maps = []
        self._pack = None
        self._batch = None
        self._prefetch = None
        self._max_rank = 0
        self.goodput = GoodputMeter()
        self._committed = None  # filled lazily: state after last batch

    # -- builders ----------------------------------------------------------

    def _admit(self, kind):
        rank = _STAGE_RANK[kind]
        if rank < self._max_rank or (rank == self._max_rank
                                     and kind != "map"):
            raise PipelineConfigError(
                f".{kind}() must come before any "
                f"{[k for k, r in _STAGE_RANK.items() if r > rank]} "
                f"stage already added (canonical order: source -> shard "
                f"-> shuffle -> map -> pack -> batch -> device_prefetch)")
        self._max_rank = rank

    def shard(self, rank=None, dp_degree=None):
        self._admit("shard")
        if rank is None or dp_degree is None:
            from .. import distributed as dist_env
            rank = dist_env.get_rank() if rank is None else rank
            dp_degree = (dist_env.get_world_size()
                         if dp_degree is None else dp_degree)
        self._shard = _ShardStage(rank, dp_degree)
        return self

    def shuffle(self, seed=0, window=None):
        self._admit("shuffle")
        self._shuffle = _ShuffleStage(seed, window)
        return self

    def map(self, fn):
        self._admit("map")
        self._maps.append(_MapStage(fn))
        return self

    def pack(self, seq_len):
        self._admit("pack")
        self._pack = _PackStage(seq_len)
        return self

    def batch(self, batch_size, drop_last=True):
        self._admit("batch")
        self._batch = _BatchStage(batch_size, drop_last)
        return self

    def device_prefetch(self, depth=2, *, device=None):
        """Copy each batch to ``device`` (None: the card; ``"cpu"`` must
        be asked for) up to ``depth`` batches ahead (`data.prefetch`)."""
        self._admit("device_prefetch")
        if self._batch is None:
            raise PipelineConfigError(
                ".device_prefetch() requires a .batch() stage (device "
                "transfer is per-batch)")
        from .prefetch import DevicePrefetch
        self._prefetch = DevicePrefetch(depth, device=device)
        return self

    # -- introspection -----------------------------------------------------

    @property
    def epoch(self):
        # as-of-last-yielded-batch, NOT the live stage counter: an
        # abandoned prefetch producer may have run ahead (even into the
        # next epoch) past what the caller ever consumed
        if self._committed is not None:
            return int(self._committed["stages"]["shard"]["epoch"])
        return self._shard.epoch

    @property
    def records_skipped(self):
        return self._source.records_skipped

    def __len__(self):
        if self._pack is not None:
            raise TypeError(
                "len() is undefined with a pack() stage (rows per epoch "
                "depend on document lengths)")
        n_local = self._shard.positions_total(
            len(self._source)) // self._shard.dp_degree
        if self._batch is None:
            return n_local
        if self._batch.drop_last:
            return n_local // self._batch.batch_size
        return -(-n_local // self._batch.batch_size)

    # -- checkpoint contract ----------------------------------------------

    def state_dict(self):
        """Resume state as of the last batch *yielded to the caller*
        (prefetched-but-unconsumed batches are not counted)."""
        if self._committed is None:
            self._committed = self._host_state()
        return copy.deepcopy(self._committed)

    def load_state_dict(self, sd):
        if not isinstance(sd, dict):
            raise PipelineStateError(
                f"pipeline state must be a dict, got {type(sd).__name__}")
        if int(sd.get("version", -1)) != _STATE_VERSION:
            raise PipelineStateError(
                f"pipeline state version {sd.get('version')!r} "
                f"(this build reads version {_STATE_VERSION})")
        stages = sd.get("stages", {})
        self._source.load_state_dict(stages.get("source", {}))
        self._shard.load_state_dict(stages.get("shard", {}))
        if self._shuffle is not None:
            self._shuffle.load_state_dict(stages.get("shuffle", {}))
        if self._pack is not None:
            self._pack.load_state_dict(stages.get("pack", {}),
                                       refetch=self._refetch)
        self._committed = self._host_state()
        return self

    def _host_state(self):
        stages = {"source": self._source.state_dict(),
                  "shard": self._shard.state_dict()}
        if self._shuffle is not None:
            stages["shuffle"] = self._shuffle.state_dict()
        if self._pack is not None:
            stages["pack"] = self._pack.state_dict()
        return {"version": _STATE_VERSION, "stages": stages}

    # -- sample resolution -------------------------------------------------

    def _resolve_sample_id(self, epoch, g):
        n = len(self._source)
        pos = g % n  # padded tail wraps into the head of the order
        if self._shuffle is not None:
            return self._shuffle.permute(epoch, n, pos)
        return pos

    def _apply_maps(self, sample):
        for m in self._maps:
            sample = m.fn(sample)
        return sample

    def _refetch(self, epoch, g):
        """Random-access re-derivation of the sample at global slot
        ``g`` of ``epoch`` — the pack-carry restore path."""
        sample = self._source.fetch(self._resolve_sample_id(epoch, g))
        if sample is _SKIP:
            raise PipelineStateError(
                f"pack carry points at slot {g} of epoch {epoch}, but "
                f"that record is no longer fetchable")
        return self._apply_maps(sample)

    def _next_sample(self):
        """Next mapped sample for this rank, or ``_EPOCH_END``.
        Returns ``(sample, epoch, g)`` so pack can record carry slots."""
        n = len(self._source)
        while True:
            epoch = self._shard.epoch
            g = self._shard.next_position(n)
            if g is None:
                return _EPOCH_END
            sample = self._source.fetch(self._resolve_sample_id(epoch, g))
            if sample is _SKIP:
                continue
            return self._apply_maps(sample), epoch, g

    def _next_item(self):
        """Next row (with pack) or sample (without), or ``_EPOCH_END``."""
        if self._pack is None:
            nxt = self._next_sample()
            return nxt if nxt is _EPOCH_END else nxt[0]
        return self._next_packed_row()

    def _next_packed_row(self):
        p = self._pack
        S = p.seq_len
        tokens = np.zeros(S, dtype=np.int32)
        segments = np.zeros(S, dtype=np.int32)
        positions = np.zeros(S, dtype=np.int32)
        used = 0
        seg = 0

        def place(doc):
            nonlocal used, seg
            take = min(len(doc), S - used)
            seg += 1
            tokens[used:used + take] = doc[:take]
            segments[used:used + take] = seg
            positions[used:used + take] = np.arange(take)
            used += take

        if p._carry_tokens is not None:
            doc = p._carry_tokens
            p._carry_tokens = None
            p._carry_slot = None
            if len(doc) > S:
                _monitor.incr("data.docs_truncated")
            place(doc)
        while used < S:
            nxt = self._next_sample()
            if nxt is _EPOCH_END:
                if seg == 0:
                    return _EPOCH_END
                break
            sample, epoch, g = nxt
            doc = _as_tokens(sample)
            if len(doc) == 0:
                continue
            if len(doc) > S - used:
                if used == 0:
                    # longer than a whole row: truncate in place
                    _monitor.incr("data.docs_truncated")
                    place(doc)
                else:
                    p._carry_tokens = doc
                    p._carry_slot = (epoch, g)
                    break
            else:
                place(doc)
        return {"tokens": tokens, "segment_ids": segments,
                "positions": positions}

    # -- iteration ---------------------------------------------------------

    def _host_batches(self):
        """Yield ``(host_batch, state_after)`` for the remainder of the
        current epoch, advancing the epoch counter at the end.  States
        are deep-copied at production time so prefetch buffering cannot
        alias them."""
        target = self._batch.batch_size if self._batch else 1
        while True:
            t0 = time.perf_counter()
            items = []
            ended = False
            while len(items) < target:
                item = self._next_item()
                if item is _EPOCH_END:
                    ended = True
                    break
                items.append(item)
            keep = items and (len(items) == target
                              or self._batch is None
                              or not self._batch.drop_last)
            if ended:
                self._shard.advance_epoch()
            if keep:
                batch = (_collate_host(items) if self._batch is not None
                         else items[0])
                self.goodput.record_fetch(
                    (time.perf_counter() - t0) * 1e3)
                yield batch, copy.deepcopy(self._host_state())
            if ended:
                return

    def __iter__(self):
        if self._committed is None:
            self._committed = self._host_state()
        else:
            # re-arm from the committed point: a previous iteration
            # abandoned mid-epoch (num_iters, preemption) leaves the
            # live stages wherever its prefetch producer ran ahead to
            self.load_state_dict(self._committed)
        if self._prefetch is not None:
            src = self._prefetch.iterate(self)
        else:
            src = ((self._to_tensors(b), s) for b, s in self._host_batches())
        for batch, state in src:
            self._committed = state
            yield batch
        # tail-drop / epoch advance commit even when the final partial
        # batch was dropped and never yielded
        self._committed = self._host_state()

    def _to_tensors(self, batch):
        from .prefetch import to_host_tensors
        return to_host_tensors(batch)


def pipeline(dataset, corrupt_threshold=8):
    """Entry point: ``pipeline(ds).shard(r, d).shuffle(seed).map(fn)
    .batch(B).device_prefetch()`` — stages compose in canonical order;
    see :class:`Pipeline`."""
    return Pipeline(dataset, corrupt_threshold=corrupt_threshold)
