"""Paged KV cache + prefix tree for the serving engine (port of
paddle_tpu/serving/paged_kv.py).

- **A fixed page pool per layer** ``[num_pages, page_size, H_kv, D]`` on
  the device, an int32 page table ``[num_slots, pages_per_slot]`` and
  per-slot offsets.  Physical pages are assigned to a slot lazily as its
  sequence grows.
- **Scratch page 0** is never allocated.  Free slots, and table entries
  not grown into yet, point at it, so the static batch's dummy writes land
  there and the causal bound keeps every live row blind to it.
- **Quantized pools** (``dtype`` ``"int8"`` or ``"fp8"``): the pools hold
  int8 or float8 (e4m3) codes, and each layer carries ``k_scale`` /
  ``v_scale``, float32 ``[num_pages, page_size]`` initialised to ones: one
  scale per cached token row (``paddle_tpu_torch.quantization``).
- **Prefix tree** (`PrefixTree`): a refcounted, page-granular radix tree
  over prompt tokens.  Requests that share a prompt prefix attach its
  pages to their table instead of recomputing prefill.  Entries are
  scoped (by LoRA adapter id): each scope has a private root.

Admission-time reservations make growth safe: `allocate` records how many
pages the request may still claim, and `available_pages` subtracts them,
so `ensure_capacity` can never fail mid-decode; `rollback` (speculative
decoding) returns the pages of a rejected tail and re-credits them.

The model writes K/V into the pools in place (``incubate.nn.functional``),
so a prefill view shares the pool tensors and `absorb_view` has nothing to
copy back.  The decode step's page table ``[num_slots, N]`` and offsets
``[num_slots]`` are persistent int32 tensors too, allocated once: host
mutations are copied into them in place, so a captured decode step (the
compiled tick's CUDA graph) reads them at the same addresses every replay.

Live KV-page migration (prefill/decode disaggregation, `migration`):
`export_pages` gathers a slot's pages of every layer on the device and
copies each pool's gather to the host in one transfer; `adopt_pages`
installs received pages into free pages of the existing pools in place
(``index_copy_`` over the adopted ids), so the tick's graphs keep reading
the same tensors.  Adopted pages are slot-private: a shared prefix
migrates as a copy, and the sender's tree keeps its pages.
"""
from __future__ import annotations

import itertools
import warnings

import numpy as np
import torch

from ..device import resolve_device, to_torch_dtype
from ..quantization import as_bytes, kv_quant_params

#: the wire's dtype names (the JAX package's numpy names) of pool dtypes
_DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
                torch.float16: "float16", torch.int8: "int8",
                torch.float8_e4m3fn: "float8_e4m3fn"}
#: numpy has no bfloat16 or float8: such arrays (ml_dtypes') come in
#: through an integer view of their bytes
_NP_VIEWS = {"bfloat16": (np.int16, torch.bfloat16),
             "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn)}


def dtype_name(dtype):
    """The wire name of a pool dtype (``"bfloat16"``, ``"int8"``, ...)."""
    return _DTYPE_NAMES[dtype]


def dtype_of(name):
    """The torch dtype of a wire dtype name."""
    for dt, nm in _DTYPE_NAMES.items():
        if nm == name:
            return dt
    raise ValueError(f"unknown KV pool dtype {name!r}")


def _host_tensor(a):
    """A torch tensor of a page payload given as a tensor or an array."""
    if isinstance(a, torch.Tensor):
        return a
    a = np.ascontiguousarray(a)
    view = _NP_VIEWS.get(a.dtype.name)
    with warnings.catch_warnings():
        # a payload over a received frame is read-only; it is only read
        warnings.filterwarnings("ignore", message=".*not writable")
        if view is not None:
            return torch.from_numpy(a.view(view[0])).view(view[1])
        return torch.from_numpy(a)


class PagedKVCache:
    """Host bookkeeping is numpy; `layer_caches` copies the offsets and
    the page table into their persistent device tensors once per scheduler
    iteration, and only after a host-side change.  The pools live on
    ``device`` (None → the card; it raises without CUDA unless the caller
    passes ``"cpu"``)."""

    def __init__(self, num_layers, num_slots, max_len, num_kv_heads,
                 head_dim, page_size=16, num_pages=None, dtype="float32",
                 *, device=None):
        self.device = resolve_device(device)
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
        quant = kv_quant_params(dtype)
        #: "int8"/"fp8" when K/V are stored quantized with per-row scales;
        #: None for float storage
        self.quant_dtype = dtype if quant else None
        store = quant[0] if quant else to_torch_dtype(dtype)
        shape = (total, self.page_size, num_kv_heads, head_dim)
        #: the decode step's persistent page table and offsets
        self.device_table = torch.zeros(self.table.shape, dtype=torch.int32,
                                        device=self.device)
        self.device_offsets = torch.zeros(self.num_slots, dtype=torch.int32,
                                          device=self.device)

        def pool():
            # zero bytes through uint8: float8 fills are not in every
            # build's CUDA kernels
            return torch.zeros(shape, dtype=torch.uint8,
                               device=self.device).view(store) \
                if store.itemsize == 1 else \
                torch.zeros(shape, dtype=store, device=self.device)
        self.layers = []
        for _ in range(num_layers):
            lay = {"k_pool": pool(), "v_pool": pool(),
                   "page_table": self.device_table,
                   "offset": self.device_offsets, "page_size": self.page_size}
            if quant:
                for name in ("k_scale", "v_scale"):
                    lay[name] = torch.ones(total, self.page_size,
                                           dtype=torch.float32,
                                           device=self.device)
            self.layers.append(lay)
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

    def rollback(self, slot, new_off):
        """Speculative decoding's accept-mask rollback: after a verify
        window wrote K/V past the accepted tokens, private pages lying
        wholly past the new write horizon (`new_off` is where the next
        token lands, so its page stays) return to the free list and the
        slot's reservation is re-credited, one for one, so
        ``available_pages`` is unchanged and `ensure_capacity` still
        cannot fail.  The rejected tokens' K/V in the pages that remain
        stay behind the causal bound until overwritten.  Tree-owned
        (shared) pages are never touched: they hold prompt tokens, always
        behind the horizon.  The host table row is zeroed past the kept
        pages and the cache marked dirty, so the persistent
        ``device_table`` is rewritten at the next `_flush`."""
        shared = self._shared.get(slot, 0)
        keep = max(int(new_off) // self.page_size + 1, shared)
        priv = self._private[slot]
        while shared + len(priv) > keep:
            idx = shared + len(priv) - 1
            page = priv.pop()
            if page != self.table[slot, idx]:   # pragma: no cover
                raise RuntimeError(
                    f"slot {slot} page-table tail {self.table[slot, idx]}"
                    f" does not match private ownership {page}")
            self.table[slot, idx] = 0
            self._free_pages.append(page)
            self._reserved[slot] += 1
            self._dirty = True

    def advance(self, slots):
        """Bump the offsets of `slots` by one decoded token."""
        idx = list(slots)
        if idx:
            self.offsets[idx] += 1
        self._dirty = True

    def absorb_tick(self, slots):
        """A compiled tick advanced the device offsets of `slots` in place:
        advance the host mirror in lockstep.  The dirty flag is NOT set:
        device and host agree after this call."""
        idx = list(slots)
        if idx:
            self.offsets[idx] += 1

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

    # ---------------- live page migration (serving/migration.py) --------
    def adopt_pages(self, reserve_pages, offset, k_pages, v_pages,
                    k_scales=None, v_scales=None):
        """Install migrated KV pages into free pool pages: the receive side
        of prefill/decode disaggregation.  ``k_pages`` / ``v_pages`` are
        ``[num_layers, n, page_size, H, D]`` host tensors or arrays (the
        sender's pool rows, bit for bit), ``offset`` the migrated
        sequence's cached-token count, ``reserve_pages`` how many more
        pages the resumed request may claim while it decodes.

        The pages are written into the existing pool tensors (one copy of
        each frame to the device, then ``index_copy_`` a layer), never a
        new pool.  They are slot-private.  Returns the slot, or None when
        no slot or too few uncommitted pages remain (admission
        backpressure, as `allocate`).  A geometry or dtype mismatch raises
        `PageMigrationError`: the sender then decodes locally."""
        from .api import PageMigrationError
        k_pages, v_pages = _host_tensor(k_pages), _host_tensor(v_pages)
        pool = self.layers[0]["k_pool"]
        want = (len(self.layers),) + tuple(pool.shape[1:])
        if k_pages.dim() != 5 or k_pages.shape[0] != want[0] or \
                tuple(k_pages.shape[2:]) != want[1:] or \
                v_pages.shape != k_pages.shape:
            raise PageMigrationError(
                f"page payload {tuple(k_pages.shape)}/"
                f"{tuple(v_pages.shape)} does not fit a [{want[0]}, n, "
                f"{want[1]}, {want[2]}, {want[3]}] pool (layers/page_size/"
                "heads/head_dim mismatch)")
        if k_pages.dtype != pool.dtype or v_pages.dtype != pool.dtype:
            raise PageMigrationError(
                f"page payload dtype {dtype_name(k_pages.dtype)} != pool "
                f"dtype {dtype_name(pool.dtype)} (sender and receiver must "
                "share ServingConfig.cache_dtype)")
        quant = self.quant_dtype is not None
        if quant != (k_scales is not None):
            raise PageMigrationError(
                "per-page scales "
                + ("missing for a quantized pool"
                   if quant else "sent to an unquantized pool"))
        n = int(k_pages.shape[1])
        if n < 1 or n > self.pages_per_slot:
            raise PageMigrationError(
                f"{n} pages do not fit a {self.pages_per_slot}-page "
                "table row")
        if -(-int(offset) // self.page_size) > n:
            raise PageMigrationError(
                f"offset {offset} claims more cached tokens than the "
                f"{n} migrated pages hold")
        if not self._free_slots or \
                n + int(reserve_pages) > self.available_pages:
            return None                     # backpressure, never a crash
        slot = self._free_slots.pop()
        pages = [self._free_pages.pop() for _ in range(n)]
        self.table[slot, :] = 0
        self.table[slot, :n] = pages
        self._private[slot] = list(pages)
        self._shared[slot] = 0
        self._reserved[slot] = int(reserve_pages)
        self.offsets[slot] = int(offset)
        frames = {"k_pool": k_pages, "v_pool": v_pages}
        if quant:
            frames["k_scale"] = k_scales
            frames["v_scale"] = v_scales
        self.write_pages(pages, frames)
        self._dirty = True
        return slot

    def export_pages(self, slot):
        """Host copy of the slot's cached pages, layer-pooled: the send
        side of live migration.  Returns ``(offset, k, v, k_scales,
        v_scales)``, ``k`` / ``v`` contiguous CPU tensors ``[num_layers,
        n, page_size, H, D]`` covering every page the offset has written
        (shared tree pages included: the copy migrates, the tree keeps its
        pages), the scales ``[num_layers, n, page_size]`` float32 or None
        for float pools.  Each pool is gathered on the device into one
        tensor and copied to the host in one synchronous transfer, so the
        slot's pages may be released as soon as this returns."""
        off = int(self.offsets[slot])
        n = max(1, -(-off // self.page_size))
        got = self.read_pages(self.table[slot, :n].astype(np.int64))
        return (off, got["k_pool"], got["v_pool"], got.get("k_scale"),
                got.get("v_scale"))

    # ---------------- device views ----------------
    def layer_caches(self):
        """Per-layer cache dicts for the batched decode step."""
        self._flush()
        return self.layers

    def prefill_rows(self, slots, starts):
        """The host page table and offsets of one batched prefill-chunk
        call of ``[num_slots]`` rows: row i carries `slots[i]`'s table row
        at write offset `starts[i]`; surplus rows point at the scratch
        page."""
        table = np.zeros_like(self.table)
        off = np.zeros(self.num_slots, np.int32)
        for row, (slot, start) in enumerate(zip(slots, starts)):
            table[row] = self.table[slot]
            off[row] = start
        return table, off

    def prefill_view(self, slots, starts):
        """Per-layer cache dicts for one batched prefill-chunk call (the
        pools, the `prefill_rows` table and offsets)."""
        return self.rows_view(*self.prefill_rows(slots, starts))

    def rows_view(self, table, offsets):
        """Per-layer cache dicts over the pools with a host page table
        ``[num_slots, N]`` and offsets ``[num_slots]`` of the caller's."""
        pt = torch.tensor(table, device=self.device)
        offt = torch.tensor(offsets, device=self.device)
        return [dict(lay, page_table=pt, offset=offt) for lay in self.layers]

    def write_pages(self, ids, frames):
        """Write page frames into the pools at page ``ids``, in place:
        ``frames`` maps a pool name (``k_pool``, ``v_pool``, ``k_scale``,
        ``v_scale``) to a host tensor ``[num_layers, len(ids), ...]``."""
        ids = torch.as_tensor(ids, dtype=torch.long).to(self.device)
        for name, frame in frames.items():
            dev = as_bytes(_host_tensor(frame).to(self.device))
            for li, lay in enumerate(self.layers):
                as_bytes(lay[name]).index_copy_(0, ids, dev[li])

    def read_pages(self, ids):
        """Host copies ``[num_layers, len(ids), ...]`` of every pool at page
        ``ids`` (the K and V pools, and the scales of a quantized one),
        each gathered on the device and copied in one transfer."""
        ids = torch.as_tensor(ids, dtype=torch.long).to(self.device)
        out = {}
        for name in ("k_pool", "v_pool", "k_scale", "v_scale"):
            if name not in self.layers[0]:
                continue
            pool = as_bytes(self.layers[0][name])
            buf = torch.empty((len(self.layers), len(ids))
                              + tuple(pool.shape[1:]), dtype=pool.dtype,
                              device=self.device)
            for li, lay in enumerate(self.layers):
                torch.index_select(as_bytes(lay[name]), 0, ids, out=buf[li])
            out[name] = buf.cpu().view(self.layers[0][name].dtype)
        return out

    def absorb_view(self, views):
        """Adopt the pools (and scales) of a `prefill_view` call (the same
        tensors, written in place)."""
        for lay, view in zip(self.layers, views):
            for name in ("k_pool", "v_pool", "k_scale", "v_scale"):
                if name in lay:
                    lay[name] = view[name]

    def _flush(self):
        if not self._dirty:
            return
        if (self.offsets >= self.capacity).any():
            raise ValueError(
                f"paged KV cache overflow: offsets {self.offsets.tolist()} "
                f"reach the page-table capacity {self.capacity}")
        self.device_offsets.copy_(torch.from_numpy(self.offsets))
        self.device_table.copy_(torch.from_numpy(self.table))
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
    recomputed, so the engine has last-token logits to sample from.

    Entries are keyed by ``scope`` (the request's LoRA adapter id; None is
    the base model): the same prompt prefilled under two adapters gives
    different K/V, so each scope owns a private root and scopes never
    share pages.  Eviction and accounting walk every scope's root."""

    def __init__(self, page_size):
        self.page_size = int(page_size)
        self.root = _PrefixNode(None, None, None)
        # scope -> root; the base scope is self.root
        self._roots = {None: self.root}
        self._ticks = itertools.count(1)

    def _scope_root(self, scope):
        root = self._roots.get(scope)
        if root is None:
            root = self._roots[scope] = _PrefixNode(None, None, None)
        return root

    def _top_nodes(self):
        return [n for root in self._roots.values()
                for n in root.children.values()]

    def _page_key(self, prompt, i):
        p = self.page_size
        return tuple(np.asarray(prompt[i * p:(i + 1) * p]).tolist())

    def match(self, prompt, scope=None):
        """Longest cached page-aligned prefix of `prompt` within ``scope``,
        capped at ``(len-1)//page_size`` pages.  Takes a reference on every
        matched node; returns (nodes, page_ids)."""
        limit = (len(prompt) - 1) // self.page_size
        node, nodes, pages = self._scope_root(scope), [], []
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

    def insert(self, prompt, cache, slot, held_nodes, scope=None):
        """Register the prompt's fully covered pages after its prefill,
        moving the slot's pages to the tree (refcount 1 for the inserting
        request).  Nodes in `held_nodes` (this request's match) are
        walked through; a node a twin request inserted first stops the
        walk, and our duplicate pages stay slot-private.  Appends the new
        nodes to `held_nodes`; returns how many were inserted."""
        full = len(prompt) // self.page_size
        held = set(id(n) for n in held_nodes)
        node, inserted = self._scope_root(scope), 0
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
            stack = self._top_nodes()
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
        count, stack = 0, self._top_nodes()
        while stack:
            node = stack.pop()
            count += 1
            stack.extend(node.children.values())
        return count
