"""Multi-tenant LoRA serving: a fixed adapter pool and one gathered
low-rank delta per projection over ONE base model (port of
paddle_tpu/serving/adapters.py; S-LoRA / Punica).

Every target projection gets preallocated device stacks ``A [P, in,
rank_pool]``, ``B [P, rank_pool, out]`` and ``scale [P]`` in the base
weight's dtype, with ``P = max_adapters + 1``.  Pool slot 0 stays zero, so
index 0 is the exact identity and base requests ride the same batch as
adapter requests.  An adapter of rank r <= rank_pool is zero-padded into
its slot (the padding multiplies into exact zeros).  A per-row int32
index vector picks each batch row's slot, and the projection's output
becomes JAX's

    lora_delta(y, x, A, B, scale, idx)
        =  y + (x @ A[idx]) @ B[idx] * scale[idx]

whose delta is the kernel of ``kernels/lora.py``.  Hot-loading writes a slot of
the stacks in place; no tensor is ever rebound, so the index vector and
the stacks keep their device addresses.

LRU: adapters hot-load into free slots; when the pool is full, the least
recently used slot with no in-flight request is evicted.  Pinned slots
are never evicted: admission backpressures instead.

The delta applies only inside `AdapterPool.activate` on the thread that
entered it (the engine's scheduler).  Everywhere else, a hooked
projection is an exact pass-through: ``generate`` on another thread,
training, another engine sharing the model.
"""
from __future__ import annotations

import contextlib
import threading
import time

import numpy as np
import torch

from ..kernels import lora as _lora_kernel
from ..nn.layers import Linear
from ..nn.lora import DEFAULT_TARGETS, load_adapter_state
from . import stats
from .api import AdapterConfigError

def lora_delta(y, x, a_stack, b_stack, scale, idx):
    """``y + (x @ A[idx]) @ B[idx] * scale[idx]`` per batch row (JAX's
    contract): the delta from the CUDA kernel on the card (its plain
    version on the CPU), rounded once to x's dtype, then added to the
    projection's output ``y``."""
    return y + _lora_kernel.lora_delta(x, a_stack, b_stack, scale, idx)


# .value: the (pool, idx) of the calling thread's active scope, or absent
_ACTIVE = threading.local()


class _Activation:
    __slots__ = ("pool", "idx")

    def __init__(self, pool, idx):
        self.pool = pool
        self.idx = idx


class _LayerStacks:
    __slots__ = ("A", "B", "scale", "in_features", "out_features")

    def __init__(self, weight, pool_size, rank_pool):
        self.in_features, self.out_features = (int(n) for n in weight.shape)
        kw = dict(dtype=weight.dtype, device=weight.device)
        self.A = torch.zeros(pool_size, self.in_features, rank_pool, **kw)
        self.B = torch.zeros(pool_size, rank_pool, self.out_features, **kw)
        self.scale = torch.zeros(pool_size, **kw)


def _patch_linear(layer, qual_name):
    """A forward hook on the layer (idempotent): the state-dict names stay
    those of the plain Linear, no reference cycle ties the layer to its
    patch, and the hook passes the output through unless a scope is
    active on this thread AND its pool has stacks for this layer."""
    if getattr(layer, "_lora_serving_name", None) is not None:
        return

    def hook(_layer, args, y, _name=qual_name):
        act = getattr(_ACTIVE, "value", None)
        if act is None:
            return y
        ent = act.pool._stacks.get(_name)
        if ent is None:
            return y
        return lora_delta(y, args[0], ent.A, ent.B, ent.scale, act.idx)

    # the hook's id lets the compiled tick tell the pool's hooks from
    # others (which block it)
    layer._lora_serving_hook = layer.register_forward_hook(hook).id
    layer._lora_serving_name = qual_name


class AdapterPool:
    """Fixed device pool of hot-loaded adapters for one base model.

    ``max_adapters`` concurrent adapters (pool slot 0 is the reserved
    identity), each padded to ``rank_pool``; ``num_rows`` is the decode
    batch (the engine's slots).  `register` validates an adapter against
    the base model's projection shapes; `acquire`/`release` pin slots
    around in-flight requests; LRU eviction recycles only unpinned slots.
    Hot-loads and evictions publish ``serving.adapter.adapters_loaded``,
    ``adapter_evictions`` and the ``adapter_load_ms`` histogram
    (`stats`), as JAX's pool does.
    """

    def __init__(self, model, max_adapters, rank_pool, num_rows,
                 targets=None):
        max_adapters = int(max_adapters)
        rank_pool = int(rank_pool)
        if max_adapters < 1:
            raise AdapterConfigError(
                f"max_adapters must be >= 1 to build an AdapterPool, "
                f"got {max_adapters}")
        if rank_pool < 1:
            raise AdapterConfigError(
                f"adapter_rank_pool must be >= 1, got {rank_pool}")
        self.max_adapters = max_adapters
        self.rank_pool = rank_pool
        self.pool_size = max_adapters + 1
        targets = tuple(targets) if targets is not None else DEFAULT_TARGETS
        self._stacks = {}
        device = None
        for name, layer in model.named_modules():
            leaf = name.rsplit(".", 1)[-1]
            if leaf not in targets or not isinstance(layer, Linear):
                continue
            self._stacks[name] = _LayerStacks(layer.weight, self.pool_size,
                                              rank_pool)
            device = layer.weight.device
            _patch_linear(layer, name)
        if not self._stacks:
            raise AdapterConfigError(
                f"AdapterPool found no Linear projections matching "
                f"targets {targets} on {type(model).__name__}")
        self.device = device
        # adapter id -> {layer name: (A, B, alpha / rank)}
        self._registry = {}
        # slot 0 = identity, never assigned or evicted
        self._slot_ids = [None] * self.pool_size
        self._slot_of = {}
        self._refs = [0] * self.pool_size
        self._last_use = [0] * self.pool_size
        self._use_tick = 0
        # per-row pool slot: the ONE persistent index vector of the decode
        # step, updated in place
        self.idx = torch.zeros(int(num_rows), dtype=torch.int32,
                               device=device)

    # ---------------- registry ----------------
    def register(self, adapter_id, source):
        """Validate and register an adapter (a ``save_adapter`` artifact
        directory, or an in-memory ``adapter_spec`` dict).  Raises
        `AdapterConfigError` on rank over the pool's budget, an unknown
        projection name or factor shapes that do not match the base
        model's projections."""
        adapter_id = str(adapter_id)
        if not adapter_id:
            raise AdapterConfigError("adapter_id must be a non-empty "
                                     "string")
        spec = load_adapter_state(source) if isinstance(source, str) \
            else source
        if not isinstance(spec, dict) or not spec:
            raise AdapterConfigError(
                f"adapter {adapter_id!r}: spec must be a non-empty dict "
                f"of layer_name -> factors (got {type(spec).__name__})")
        layers = {}
        for name, st in spec.items():
            if name not in self._stacks:
                raise AdapterConfigError(
                    f"adapter {adapter_id!r} targets projection "
                    f"{name!r} which the base model does not have "
                    f"(pool projections: {sorted(self._stacks)})")
            ent = self._stacks[name]
            A = np.asarray(st["A"])
            B = np.asarray(st["B"])
            r = int(st.get("rank", A.shape[-1]))
            if r > self.rank_pool:
                raise AdapterConfigError(
                    f"adapter {adapter_id!r} layer {name!r} has rank "
                    f"{r} > adapter_rank_pool {self.rank_pool}")
            if A.shape != (ent.in_features, r):
                raise AdapterConfigError(
                    f"adapter {adapter_id!r} layer {name!r}: lora_A "
                    f"shape {A.shape} does not match base projection "
                    f"[{ent.in_features}, rank={r}]: width mismatch vs "
                    "the base model")
            if B.shape != (r, ent.out_features):
                raise AdapterConfigError(
                    f"adapter {adapter_id!r} layer {name!r}: lora_B "
                    f"shape {B.shape} does not match "
                    f"[rank={r}, {ent.out_features}]: width mismatch vs "
                    "the base model")
            layers[name] = (A, B, float(st.get("alpha", r)) / float(r))
        self._registry[adapter_id] = layers
        return adapter_id

    def known_ids(self):
        return sorted(self._registry)

    def loaded_ids(self):
        """Adapter ids resident in pool slots."""
        return sorted(self._slot_of)

    # ---------------- slot lifecycle ----------------
    def acquire(self, adapter_id):
        """Pin ``adapter_id``'s pool slot for one in-flight request,
        hot-loading it first if absent.  Returns the slot, or None when
        every slot is pinned (the caller backpressures admission)."""
        slot = self._slot_of.get(adapter_id)
        if slot is None:
            slot = self._load(adapter_id)
            if slot is None:
                return None
        self._refs[slot] += 1
        self._use_tick += 1
        self._last_use[slot] = self._use_tick
        return slot

    def release(self, adapter_id):
        slot = self._slot_of.get(adapter_id)
        if slot is not None and self._refs[slot] > 0:
            self._refs[slot] -= 1

    def _load(self, adapter_id):
        layers = self._registry.get(adapter_id)
        if layers is None:
            raise KeyError(adapter_id)
        slot = next((s for s in range(1, self.pool_size)
                     if self._slot_ids[s] is None), None)
        if slot is None:
            # LRU among unpinned slots only
            victims = [s for s in range(1, self.pool_size)
                       if self._refs[s] == 0]
            if not victims:
                return None
            slot = min(victims, key=lambda s: self._last_use[s])
            del self._slot_of[self._slot_ids[slot]]
            self._slot_ids[slot] = None
            stats.incr("adapter.adapter_evictions")
        t0 = time.perf_counter()
        for name, stk in self._stacks.items():
            # in place: the slot's rows are zeroed (an adapter that leaves
            # this projection alone is the exact identity there) and the
            # factors copied into the leading rank columns
            stk.A[slot].zero_()
            stk.B[slot].zero_()
            fac = layers.get(name)
            sc = 0.0
            if fac is not None:
                A, B, sc = fac
                r = A.shape[-1]
                stk.A[slot, :, :r].copy_(torch.tensor(A))
                stk.B[slot, :r, :].copy_(torch.tensor(B))
            stk.scale[slot] = sc
        stats.observe("adapter.adapter_load_ms",
                      (time.perf_counter() - t0) * 1e3)
        stats.incr("adapter.adapters_loaded")
        self._slot_ids[slot] = adapter_id
        self._slot_of[adapter_id] = slot
        self._refs[slot] = 0
        return slot

    # ---------------- per-row index ----------------
    def set_row(self, row, pool_slot):
        self.idx[row] = int(pool_slot)

    def clear_row(self, row):
        self.set_row(row, 0)

    def row_tensor(self, rows):
        """A fresh int32 index tensor for call-ordered batches (chunked
        prefill batches requests by call row, not scheduler slot)."""
        return torch.tensor(np.asarray(rows, np.int32), device=self.device)

    # ---------------- activation ----------------
    @contextlib.contextmanager
    def activate(self, idx=None):
        """Adapt model calls made on this thread inside the scope: hooked
        projections add the gathered delta with ``idx`` (default: the
        persistent per-row index vector)."""
        prev = getattr(_ACTIVE, "value", None)
        _ACTIVE.value = _Activation(self, idx if idx is not None
                                    else self.idx)
        try:
            yield
        finally:
            _ACTIVE.value = prev
