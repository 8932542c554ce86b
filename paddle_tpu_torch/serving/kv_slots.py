"""Slot KV caches for continuous batching (port of
paddle_tpu/serving/kv_slots.py), the engine's ``kv_layout="slots"``.

One ``[num_slots, max_len, H_kv, D]`` K and V tensor a layer on the
device, and one int32 offset a slot: sequences of different ages share
one ``[num_slots, 1]`` decode step, and a finished slot is refilled by a
new request without draining the batch.  The per-slot offsets are ONE
persistent ``[num_slots]`` int32 tensor on the device, shared by every
layer and written in place at `_flush` (host bookkeeping is numpy), as
the paged cache's are.

A free slot still rides along in the batched decode step: it writes
dummy K/V at position 0 each step, which the next `write_prefill`
overwrites and the per-row causal bound never shows a live row.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device, to_torch_dtype


class SlotKVCache:
    """Per-layer ``{"k", "v", "offset"}`` dicts shaped for the model's
    cached path (`incubate.nn.functional.masked_multihead_attention` takes
    the ``[num_slots]`` offset vector) plus host-side slot bookkeeping.
    The tensors live on ``device`` (None → the card; it raises without
    CUDA unless the caller passes ``"cpu"``).

    Slot lifecycle::

        free --allocate()--> reserved --write_prefill()--> active
          ^                                                  |
          +---------------- release() <-- (eos/length/deadline/shutdown)
    """

    def __init__(self, num_layers, num_slots, max_len, num_kv_heads,
                 head_dim, dtype="float32", *, device=None):
        self.device = resolve_device(device)
        self.num_slots = int(num_slots)
        self.max_len = int(max_len)
        self.offsets = np.zeros(self.num_slots, np.int32)
        self._free = list(range(self.num_slots - 1, -1, -1))
        self._dirty = False
        shape = (self.num_slots, self.max_len, num_kv_heads, head_dim)
        dt = to_torch_dtype(dtype)
        #: the decode step's persistent offsets, shared by every layer
        self.device_offsets = torch.zeros(self.num_slots, dtype=torch.int32,
                                          device=self.device)
        self.layers = [
            {"k": torch.zeros(shape, dtype=dt, device=self.device),
             "v": torch.zeros(shape, dtype=dt, device=self.device),
             "offset": self.device_offsets}
            for _ in range(num_layers)]

    # ---------------- slot bookkeeping ----------------
    @property
    def free_slots(self):
        return len(self._free)

    def allocate(self):
        """Reserve a free slot index, or None when fully occupied."""
        return self._free.pop() if self._free else None

    def release(self, slot):
        """Return a slot to the free pool (offset pinned back to 0; the
        stale K/V rows stay until the next prefill overwrites them)."""
        if slot in self._free:
            raise ValueError(f"slot {slot} is already free")
        self.offsets[slot] = 0
        self._free.append(slot)
        self._dirty = True

    # ---------------- cache data ----------------
    def write_prefill(self, slot, prefill_caches, prompt_len):
        """Copy a batch-1 prefill's per-layer caches (the dicts of
        ``init_kv_caches(..., batch=1, max_len=self.max_len)`` the model
        filled) into `slot`'s rows, and start the slot's clock at
        `prompt_len`."""
        if prompt_len > self.max_len:
            raise ValueError(
                f"prompt of {prompt_len} tokens exceeds slot capacity "
                f"{self.max_len}")
        for lay, src in zip(self.layers, prefill_caches):
            lay["k"][slot].copy_(src["k"][0])
            lay["v"][slot].copy_(src["v"][0])
        self.offsets[slot] = prompt_len
        self._dirty = True

    def advance(self, slots):
        """Bump the offsets of `slots` by one decoded token."""
        idx = list(slots)
        if idx:
            self.offsets[idx] += 1
        self._dirty = True

    def layer_caches(self):
        """The per-layer cache dicts for ``model(tokens, caches=...)``'s
        batched decode step, the offsets copied in first when the host
        changed them."""
        self._flush()
        return self.layers

    def _flush(self):
        if not self._dirty:
            return
        if (self.offsets >= self.max_len).any():
            raise ValueError(
                f"slot KV cache overflow: offsets {self.offsets.tolist()} "
                f"reach the slot capacity {self.max_len}")
        self.device_offsets.copy_(torch.from_numpy(self.offsets))
        self._dirty = False
