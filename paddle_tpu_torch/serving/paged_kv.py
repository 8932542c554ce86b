"""Paged KV cache + prefix tree for the serving engine (port of
paddle_tpu/serving/paged_kv.py, float pools only).

- **A fixed page pool per layer** ``[num_pages, page_size, H_kv, D]`` on
  the device, an int32 page table ``[num_slots, pages_per_slot]`` and
  per-slot offsets.  Physical pages are assigned to a slot lazily as its
  sequence grows.
- **Scratch page 0** is never allocated.  Free slots, and table entries
  not grown into yet, point at it, so the static batch's dummy writes land
  there and the causal bound keeps every live row blind to it.
- **Prefix tree** (`PrefixTree`): a refcounted, page-granular radix tree
  over prompt tokens.  Requests that share a prompt prefix attach its
  pages to their table instead of recomputing prefill.

Admission-time reservations make growth safe: `allocate` records how many
pages the request may still claim, and `available_pages` subtracts them,
so `ensure_capacity` can never fail mid-decode.

The model writes K/V into the pools in place (``incubate.nn.functional``),
so a prefill view shares the pool tensors and `absorb_view` has nothing to
copy back.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch

from ..device import to_torch_dtype


class PagedKVCache:
    """Host bookkeeping is numpy; `layer_caches` uploads the offsets and
    the page table once per scheduler iteration, and only after a
    host-side change."""

    def __init__(self, num_layers, num_slots, max_len, num_kv_heads,
                 head_dim, page_size=16, num_pages=None, dtype="float32",
                 device="cpu"):
        self.device = torch.device(device)
        self.num_slots = int(num_slots)
        self.page_size = int(page_size)
        self.max_len = int(max_len)
        self.pages_per_slot = -(-self.max_len // self.page_size)
        #: attention capacity per slot: max_len rounded up to pages
        self.capacity = self.pages_per_slot * self.page_size
        #: pages a request can hold K/V in (scratch page excluded)
        self.usable_pages = int(num_pages) if num_pages else \
            self.num_slots * self.pages_per_slot
        if self.usable_pages < 1:
            raise ValueError(
                f"kv_pool_pages must be >= 1, got {self.usable_pages}")
        total = self.usable_pages + 1          # + scratch page 0
        self.offsets = np.zeros(self.num_slots, np.int32)
        self.table = np.zeros((self.num_slots, self.pages_per_slot),
                              np.int32)
        self._free_pages = list(range(total - 1, 0, -1))
        self._free_slots = list(range(self.num_slots - 1, -1, -1))
        self._private = {}       # slot -> [page ids owned by the slot]
        self._shared = {}        # slot -> leading tree-owned page count
        self._reserved = {}      # slot -> pages it may still claim
        self._dirty = True
        store = to_torch_dtype(dtype)
        shape = (total, self.page_size, num_kv_heads, head_dim)
        self.layers = [
            {"k_pool": torch.zeros(shape, dtype=store, device=self.device),
             "v_pool": torch.zeros(shape, dtype=store, device=self.device),
             "page_table": None, "offset": None,
             "page_size": self.page_size}
            for _ in range(num_layers)]
        self._flush()

    # ---------------- pool accounting ----------------
    @property
    def free_slots(self):
        return len(self._free_slots)

    @property
    def free_page_count(self):
        return len(self._free_pages)

    @property
    def pages_in_use(self):
        return self.usable_pages - len(self._free_pages)

    @property
    def available_pages(self):
        """Pages admission may promise to a NEW request: the free list
        minus what admitted requests may still claim."""
        return len(self._free_pages) - sum(self._reserved.values())

    # ---------------- slot lifecycle ----------------
    def allocate(self, reserve_pages, shared_pages=()):
        """Reserve a slot that may grow into `reserve_pages` fresh pages,
        with `shared_pages` (tree-owned, full) leading its page table.
        Returns the slot, or None when no slot or not enough uncommitted
        pages remain (the caller keeps the request queued)."""
        if not self._free_slots or reserve_pages > self.available_pages:
            return None
        slot = self._free_slots.pop()
        for i, page in enumerate(shared_pages):
            self.table[slot, i] = page
        self._shared[slot] = len(shared_pages)
        self._private[slot] = []
        self._reserved[slot] = int(reserve_pages)
        self.offsets[slot] = 0
        self._dirty = True
        return slot

    def release(self, slot):
        """Free the slot: its private pages return to the pool and its
        table row falls back to the scratch page.  Shared pages stay with
        the prefix tree."""
        if slot in self._free_slots:
            raise ValueError(f"slot {slot} is already free")
        self._free_pages.extend(self._private.pop(slot, ()))
        self._shared.pop(slot, None)
        self._reserved.pop(slot, None)
        self.table[slot, :] = 0
        self.offsets[slot] = 0
        self._free_slots.append(slot)
        self._dirty = True

    def ensure_capacity(self, slot, pos):
        """Assign physical pages so position `pos` is writable."""
        need_idx = int(pos) // self.page_size
        assigned = self._shared.get(slot, 0) + len(self._private[slot])
        while assigned <= need_idx:
            if not self._free_pages:      # pragma: no cover - reserved
                raise RuntimeError(
                    "KV page pool exhausted past its reservations — "
                    "admission accounting bug")
            if self._reserved[slot] <= 0:  # pragma: no cover - reserved
                raise RuntimeError(
                    f"slot {slot} grew past its page reservation")
            page = self._free_pages.pop()
            self._reserved[slot] -= 1
            self._private[slot].append(page)
            self.table[slot, assigned] = page
            assigned += 1
            self._dirty = True

    def set_offset(self, slot, off):
        self.offsets[slot] = int(off)
        self._dirty = True

    def advance(self, slots):
        """Bump the offsets of `slots` by one decoded token."""
        idx = list(slots)
        if idx:
            self.offsets[idx] += 1
        self._dirty = True

    # ---------------- prefix-tree ownership transfer ----------------
    def make_shared(self, slot, table_index):
        """Move the page at `table_index` of the slot's table from slot
        ownership to the tree's; returns its id."""
        shared = self._shared.get(slot, 0)
        if table_index != shared:
            raise ValueError(
                f"non-contiguous share: index {table_index} with "
                f"shared boundary {shared}")
        page = int(self.table[slot, table_index])
        self._private[slot].remove(page)
        self._shared[slot] = shared + 1
        return page

    def reclaim(self, page):
        """Return a tree-owned page to the free pool (LRU eviction)."""
        self._free_pages.append(int(page))

    # ---------------- device views ----------------
    def layer_caches(self):
        """Per-layer cache dicts for the batched decode step."""
        self._flush()
        return self.layers

    def prefill_view(self, slots, starts):
        """Per-layer cache dicts for one batched prefill-chunk call of
        ``[num_slots]`` rows: row i carries `slots[i]`'s table row at
        write offset `starts[i]`; surplus rows point at the scratch page."""
        table = np.zeros_like(self.table)
        off = np.zeros(self.num_slots, np.int32)
        for row, (slot, start) in enumerate(zip(slots, starts)):
            table[row] = self.table[slot]
            off[row] = start
        pt = torch.tensor(table, device=self.device)
        offt = torch.tensor(off, device=self.device)
        return [{"k_pool": lay["k_pool"], "v_pool": lay["v_pool"],
                 "page_table": pt, "offset": offt,
                 "page_size": self.page_size} for lay in self.layers]

    def absorb_view(self, views):
        """Adopt the pools of a `prefill_view` call (the same tensors,
        written in place)."""
        for lay, view in zip(self.layers, views):
            lay["k_pool"] = view["k_pool"]
            lay["v_pool"] = view["v_pool"]

    def _flush(self):
        if not self._dirty:
            return
        if (self.offsets >= self.capacity).any():
            raise ValueError(
                f"paged KV cache overflow: offsets {self.offsets.tolist()} "
                f"reach the page-table capacity {self.capacity}")
        off = torch.tensor(self.offsets, device=self.device)
        pt = torch.tensor(self.table, device=self.device)
        for lay in self.layers:
            lay["offset"] = off
            lay["page_table"] = pt
        self._dirty = False


class _PrefixNode:
    __slots__ = ("key", "page", "children", "refs", "tick", "parent")

    def __init__(self, key, page, parent):
        self.key = key
        self.page = page
        self.children = {}
        self.refs = 0
        self.tick = 0
        self.parent = parent


class PrefixTree:
    """Page-granular radix tree over prompt tokens: a node is one FULL
    page of ``page_size`` prompt tokens and holds the physical page that
    stores its K/V.  Refcounts count the active requests using a page;
    pages at refcount zero stay cached until `evict` reclaims them LRU.
    `match` never returns the whole prompt: the final token is always
    recomputed, so the engine has last-token logits to sample from."""

    def __init__(self, page_size):
        self.page_size = int(page_size)
        self.root = _PrefixNode(None, None, None)
        self._ticks = itertools.count(1)

    def _page_key(self, prompt, i):
        p = self.page_size
        return tuple(np.asarray(prompt[i * p:(i + 1) * p]).tolist())

    def match(self, prompt):
        """Longest cached page-aligned prefix of `prompt`, capped at
        ``(len-1)//page_size`` pages.  Takes a reference on every matched
        node; returns (nodes, page_ids)."""
        limit = (len(prompt) - 1) // self.page_size
        node, nodes, pages = self.root, [], []
        for i in range(limit):
            child = node.children.get(self._page_key(prompt, i))
            if child is None:
                break
            child.refs += 1
            child.tick = next(self._ticks)
            nodes.append(child)
            pages.append(child.page)
            node = child
        return nodes, pages

    def insert(self, prompt, cache, slot, held_nodes):
        """Register the prompt's fully covered pages after its prefill,
        moving the slot's pages to the tree (refcount 1 for the inserting
        request).  Nodes in `held_nodes` (this request's match) are
        walked through; a node a twin request inserted first stops the
        walk, and our duplicate pages stay slot-private.  Appends the new
        nodes to `held_nodes`; returns how many were inserted."""
        full = len(prompt) // self.page_size
        held = set(id(n) for n in held_nodes)
        node, inserted = self.root, 0
        for i in range(full):
            key = self._page_key(prompt, i)
            child = node.children.get(key)
            if child is not None:
                if id(child) not in held:
                    break               # a twin got here first
                node = child
                continue
            page = cache.make_shared(slot, i)
            child = _PrefixNode(key, page, node)
            child.refs = 1
            child.tick = next(self._ticks)
            node.children[key] = child
            held_nodes.append(child)
            inserted += 1
            node = child
        return inserted

    def release(self, nodes):
        for node in nodes:
            node.refs -= 1

    def evict(self, n_pages, reclaim):
        """Free up to `n_pages` pages by pruning LRU zero-ref leaves; each
        victim's page goes through `reclaim`.  Returns pages freed."""
        freed = 0
        while freed < n_pages:
            victim, best = None, None
            stack = list(self.root.children.values())
            while stack:
                node = stack.pop()
                if node.children:
                    stack.extend(node.children.values())
                elif node.refs == 0 and (best is None or node.tick < best):
                    victim, best = node, node.tick
            if victim is None:
                break
            del victim.parent.children[victim.key]
            reclaim(victim.page)
            freed += 1
        return freed

    def cached_pages(self):
        """Pages the tree owns (any refcount)."""
        count, stack = 0, list(self.root.children.values())
        while stack:
            node = stack.pop()
            count += 1
            stack.extend(node.children.values())
        return count
