"""A serving replica sharded over a tensor-parallel ("mp") group of ranks.

JAX serves such a replica as one SPMD process: `_init_tp_mesh` installs
an ``"mp"`` mesh before the model factory runs and GSPMD shards every
engine call.  A torch process holds no global array, so the port's
replica is N processes, one a rank, that run each engine call together:

- **The leader schedules, the followers execute.**  Rank 0 hosts the
  `fleet.ReplicaServer` (its rpc endpoint, lease, gossip) and the
  `Engine`'s scheduler.  Before each model call and each write to the
  cache's device state, the engine hands the call to its `StepMirror`
  (``Engine.mirror``), which broadcasts a *step descriptor* to the
  followers: the call's kind, its token ids, the page table and offsets
  it runs on, how the rows' tokens are drawn (`compiled_tick`'s knob
  arrays), the compiled tick's host-staged state, or the page ids and
  frames of a migration.  Each `StepFollower` runs the same call on its
  shard: its own `PagedKVCache` of the rank's kv heads
  (``[P, page_size, H_kv / mp, D]``, the same page ids), its own compiled
  tick captured at the same shapes with the model's mp all-reduces and
  the logits gather inside the graph.
- **Host-time decisions stay on the leader**: admission, queue deadlines,
  the stall watchdog, prefix-tree eviction, migration readiness and
  drain reach the followers only as descriptor content; no follower reads
  its own clock.
- **Sampling.**  Every rank draws from the logits gathered over mp with
  the same key stream (`framework.prng`): inside the tick's graph, or by
  `compiled_tick.fused_sample_call` with the descriptor's knobs.
- **The desync check.**  The next descriptor carries the tokens (and the
  tick's finish codes) the leader drew in the previous call; a follower
  whose own differ raises `DesyncError`, which takes the replica down.
  A row drawn from a request's own generator (unseeded sampling) cannot
  be drawn again elsewhere and is not compared.
- **The channel.**  Descriptors travel by
  `distributed.compat.broadcast_object_list` over a gloo group of the
  replica's ranks, so host metadata never queues behind the card's NCCL
  work; a migration's pages go the same way (`all_gather_object` of the
  ranks' head slices on export; the global frames on adoption, each rank
  keeping its heads).  The wire format between replicas stays the global
  page of every head, so replicas of any degree exchange requests.

**Failure of one rank** (a divergence from JAX, whose replica is one
process): every rank stamps a beat into the fleet's store (`RankBeat`)
and watches the others'.  A follower that dies makes the leader's next
descriptor broadcast raise `PeerFailureError`, or its beat goes stale;
either way the leader deletes its lease and gossip record and exits, as
a SIGKILLed replica would: its in-flight requests fail at the router,
which resubmits them elsewhere.  A leader that dies closes the channel
under its followers, or its beat goes stale, and they exit.  A tensor
parallel replica never restarts its scheduler loop: a crash takes it
down.

What a tensor-parallel replica cannot mirror yet raises
`NotImplementedError` naming ROADMAP A8: the dense slot layout, engine
speculation, quantized pools (a row's scale would differ from rank to
rank) and kv heads that do not split evenly over mp.  The adapter pool
finds no plain projection in a parallel model and refuses it itself
(`AdapterConfigError`).
"""
from __future__ import annotations

import datetime
import json
import os
import sys
import threading
import time
from collections import deque

import numpy as np
import torch

from ..distributed import compat
from ..distributed.watchdog import (ELASTIC_EXIT_CODE, DesyncError,
                                    GuardianError, PeerFailureError)
from .compiled_tick import fused_sample_call

#: the channel group's timeout: a follower waits for the next descriptor
#: as long as its leader idles (liveness is `RankBeat`'s and the
#: channel's closed sockets)
CHANNEL_TIMEOUT = datetime.timedelta(days=7)


def _exit_now(exc):
    sys.stderr.write(f"[tp-replica] {type(exc).__name__}: {exc}\n")
    sys.stderr.flush()
    os._exit(ELASTIC_EXIT_CODE)


def _refuse(what):
    raise NotImplementedError(
        f"a tensor-parallel serving replica cannot mirror {what} yet "
        "(ROADMAP A8)")


def check_engine(engine):
    """Refuse what the followers cannot mirror (ROADMAP A8)."""
    scfg = engine.scfg
    if not engine._paged:
        _refuse("the dense slot layout (kv_layout='slots')")
    if engine._spec:
        _refuse("engine speculation (a draft model)")
    if scfg.cache_dtype in ("int8", "fp8"):
        _refuse(f"quantized pools (cache_dtype={scfg.cache_dtype!r}: a "
                "row's scale differs from rank to rank)")
    if any(getattr(m, "kv_split", True) is False
           for m in engine.model.modules()):
        _refuse("kv heads that do not split evenly over mp")


def _pack_knobs(knobs):
    """A row's `Engine._sampling_knobs` for the wire: the seen mask as
    the indices it holds, and only under a repetition penalty."""
    if knobs is None:
        return None
    out = {k: v for k, v in knobs.items() if k != "seen"}
    out["seen"] = np.flatnonzero(knobs["seen"][0]) \
        if float(knobs["penalty"][0]) != 1.0 else None
    return out


def _unpack_knobs(packed, vocab):
    knobs = {k: v for k, v in packed.items() if k != "seen"}
    seen = np.zeros((1, vocab), bool)
    if packed["seen"] is not None:
        seen[0, packed["seen"]] = True
    knobs["seen"] = seen
    return knobs


class RankBeat:
    """Each rank of a replica stamps ``tpbeat/{key}/{rank}`` in the
    fleet's store every ``interval`` s and watches its peers: a peer
    whose stamp is older than ``ttl`` s calls ``on_dead(rank, age)``
    (once).  A peer is watched from its first stamp on; one that dies
    before it ever stamps shows through the channel instead.  The stamp
    carries ``stats()`` (a follower's calls, launches and collectives,
    which `peer_stats` reads: the follower has no rpc endpoint)."""

    def __init__(self, store, key, rank, nranks, interval, ttl, on_dead,
                 stats=None):
        self.store, self.key, self.rank = store, key, rank
        self.nranks, self.interval, self.ttl = nranks, interval, ttl
        self.on_dead, self.stats = on_dead, stats
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"tp-beat-{rank}")
        self._thread.start()

    def _k(self, rank):
        return f"tpbeat/{self.key}/{rank}"

    def _run(self):
        while not self._stop.is_set():
            try:
                now = time.time()
                self.store.set(self._k(self.rank), json.dumps({
                    "t": now, "stats": self._stats()}))
                for r in range(self.nranks):
                    if r == self.rank:
                        continue
                    val = self.store.get(self._k(r))
                    if val is None:
                        continue
                    age = now - json.loads(val)["t"]
                    if age > self.ttl:
                        self._stop.set()
                        self.on_dead(r, age)
                        return
            except Exception:       # noqa: BLE001 - a flaky store read
                pass
            self._stop.wait(self.interval)

    def _stats(self):
        try:
            return None if self.stats is None else self.stats()
        except Exception:           # noqa: BLE001 - read mid-update
            return None

    def stop(self):
        self._stop.set()


class TPContext:
    """One rank's membership of a replica: its rank and the replica's
    size, the gloo channel group and its beat key."""

    def __init__(self, rank, nranks, group, key):
        self.rank, self.nranks = rank, nranks
        self.group, self.key = group, key
        self.beat = None

    @property
    def leader(self):
        return self.group.ranks[0]


def init_ranks(degree, rank, init_method, key, device=None):
    """Join the replica's own process group (``degree`` ranks through
    ``init_method``), install the hybrid topology with mp = ``degree`` and
    dp = 1 (before the model factory runs, as JAX installs its mesh) and
    make the gloo channel group.  ``device`` None is the card: NCCL, each
    rank on its own card, or on card 0 through NCCL's socket transport
    when the ranks outnumber the cards (`env.init_parallel_env`); a CPU
    ``device`` is gloo.  Returns a `TPContext`."""
    import torch.distributed as dist

    from ..distributed import collective, fleet
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        backend = "nccl"
        dev = torch.device("cuda", rank if torch.cuda.device_count()
                           >= degree else 0)
    else:
        backend = "gloo"
    os.environ["LOCAL_WORLD_SIZE"] = str(degree)
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 1, "mp_degree": degree,
                               "pp_degree": 1}
    from ..distributed import env
    env.init_parallel_env(backend=backend, device=dev,
                          init_method=init_method, world_size=degree,
                          rank=rank)
    fleet.init(is_collective=True, strategy=strategy, backend=backend,
               device=dev)
    pg = dist.new_group(list(range(degree)), backend="gloo",
                        timeout=CHANNEL_TIMEOUT)
    group = collective.Group(list(range(degree)), process_group=pg)
    return TPContext(rank, degree, group, key)


def start_beat(ctx, store, interval, ttl, on_dead, stats=None):
    """Start the rank's `RankBeat` on its own store client."""
    ctx.beat = RankBeat(store, ctx.key, ctx.rank, ctx.nranks, interval,
                        ttl, on_dead, stats)
    return ctx.beat


def peer_stats(store, key, rank):
    """What rank ``rank`` of the replica beating under ``key`` last
    stamped: ``{"t", "stats"}`` (None before its first beat)."""
    val = store.get(f"tpbeat/{key}/{rank}")
    return None if val is None else json.loads(val)


def follower_stats(follower):
    """A follower's numbers for its beat: the calls it ran, its kernels'
    launch counts, its collectives (``{op: (calls, bytes)}``) and its
    tick's graphs and their collectives a replay."""
    from .. import kernels
    from ..distributed import collective
    if follower is None:
        return None
    tick = follower.engine._tick
    graphs = {} if tick is None or tick.fallback_reason is not None \
        else tick.graph_stats()
    return {"calls": follower.calls, "launches": kernels.launch_counts(),
            "collectives": collective.counts(), "graphs": graphs,
            "graph_collectives": {} if not graphs
            else tick.graph_collectives()}


class StepMirror:
    """The leader's side of the lockstep, installed as ``Engine.mirror``
    by `attach`.  ``fatal(exc)`` is what the replica does when a rank is
    lost or a descriptor cannot be sent: ``fatal_hook``, which the
    fleet's replica sets to delete its lease and exit (until then the
    process exits)."""

    def __init__(self, ctx):
        self.ctx = ctx
        self.fatal_hook = _exit_now
        self.seq = 0
        #: host ms of each recent descriptor's broadcast (the lockstep's
        #: own cost a call)
        self.send_ms = deque(maxlen=4096)
        self.heads = None            # this rank's kv heads in a page
        self._check = None

    def attach(self, engine):
        check_engine(engine)
        self.heads = engine._kv_heads
        engine.mirror = self
        return self

    def fatal(self, exc):
        self.fatal_hook(exc)

    # ---- the channel ----
    def _send(self, kind, **payload):
        desc = dict(payload, kind=kind, seq=self.seq, check=self._check)
        self._check = None
        self.seq += 1
        t0 = time.perf_counter()
        try:
            compat.broadcast_object_list([desc], src=self.ctx.leader,
                                         group=self.ctx.group)
        except GuardianError:
            raise
        except Exception as e:      # noqa: BLE001 - a rank is gone
            raise PeerFailureError(
                f"tensor-parallel replica: descriptor {self.seq - 1} "
                f"({kind}) could not reach the followers: "
                f"{type(e).__name__}: {e}") from e
        self.send_ms.append((time.perf_counter() - t0) * 1e3)

    # ---- the engine's calls ----
    def prefill(self, tokens, rows, first):
        """One batched prefill-chunk call: its tokens, the table rows and
        offsets it writes at, and ``first`` ({row: (position, knobs)}) the
        rows whose first token it yields."""
        self._send("prefill", tokens=tokens, table=rows[0],
                   offsets=rows[1], sample={
                       row: (pos, _pack_knobs(k))
                       for row, (pos, k) in first.items()})

    def decode(self, tokens, cache, sample):
        """One uncompiled decode step over every slot."""
        self._send("decode", tokens=tokens, table=cache.table.copy(),
                   offsets=cache.offsets.copy(), sample={
                       row: (pos, _pack_knobs(k))
                       for row, (pos, k) in sample.items()})

    def tick(self, mode, staged, cache, slots):
        """One compiled tick of ``mode``; ``staged`` the host arrays of a
        rebuild since the last tick (None: none)."""
        self._send("tick", mode=mode, state=staged,
                   table=cache.table.copy(), offsets=cache.offsets.copy(),
                   slots=list(slots))

    def sampled(self, tokens, fin=None):
        """The tokens the last call drew ({row or slot: token}; -1 where a
        request's own generator drew it) and the tick's finish codes: the
        next descriptor carries them for the followers' desync check."""
        self._check = (self.seq - 1, dict(tokens), fin)

    def local_heads(self, pages):
        """This rank's kv heads of global ``[L, n, psz, H, D]`` pages."""
        h = self.heads
        return pages[:, :, :, self.ctx.rank * h:(self.ctx.rank + 1) * h]

    def adopt(self, ids, k, v):
        """Adopted global pages at page ``ids``: each follower writes its
        heads into its pools."""
        self._send("adopt", ids=np.asarray(ids), k=k.contiguous(),
                   v=v.contiguous())

    def export_slot(self, cache, slot):
        """``(header, blobs)`` of ``slot``'s pages with every rank's
        heads: the followers' slices gathered over the channel."""
        from . import migration
        off = int(cache.offsets[slot])
        n = max(1, -(-off // cache.page_size))
        ids = cache.table[slot, :n].astype(np.int64)
        self._send("export", ids=ids)
        mine = cache.read_pages(ids)
        parts = compat.all_gather_object([], mine, group=self.ctx.group)
        k = torch.cat([p["k_pool"] for p in parts], dim=3)
        v = torch.cat([p["v_pool"] for p in parts], dim=3)
        return migration.pack(cache, off, k, v)

    def stop(self):
        """Release the followers (the replica is closing, its scheduler
        stopped)."""
        try:
            self._send("stop")
        except Exception:           # noqa: BLE001 - they are gone already
            pass
        if self.ctx.beat is not None:
            self.ctx.beat.stop()


class StepFollower:
    """A follower rank: runs every descriptor's call on its shard.  It
    owns an `Engine` that is never started, for its cache (`_new_cache`:
    the same geometry as the leader's, the rank's kv heads) and its
    compiled tick (`_make_tick`), whose state it writes from the
    descriptors instead of requests."""

    def __init__(self, ctx, model, serving_config=None):
        from .engine import Engine
        self.ctx = ctx
        self.engine = Engine(model, serving_config)
        check_engine(self.engine)
        self.model = self.engine.model
        self.vocab = self.engine.cfg.vocab_size
        self.heads = self.engine._kv_heads
        self.engine.cache = self.engine._new_cache()
        self.engine._tick = self.engine._make_tick()
        self._result = None          # (seq, tokens, fin) of the last call
        self.calls = 0

    # ---- the channel ----
    def recv(self):
        box = [None]
        compat.broadcast_object_list(box, src=self.ctx.leader,
                                     group=self.ctx.group)
        return box[0]

    def run(self):
        """Execute descriptors until ``stop``; raises `DesyncError` (or
        the channel's error when the leader is gone)."""
        with torch.no_grad():
            while True:
                desc = self.recv()
                self.step(desc)
                if desc["kind"] == "stop":
                    return

    def step(self, desc):
        self.check(desc)
        kind = desc["kind"]
        if kind == "stop":
            return
        fn = getattr(self, "_" + kind)
        self._result = None
        res = fn(desc)
        if res is not None:
            self._result = (desc["seq"],) + res
        self.calls += 1

    def check(self, desc):
        """The desync check: the leader's draws of the previous call
        against this rank's own."""
        want = desc.get("check")
        if want is None or self._result is None:
            return
        seq, tokens, fin = want
        mine_seq, mine, mine_fin = self._result
        if seq != mine_seq:
            raise DesyncError(
                f"tensor-parallel rank {self.ctx.rank}: the leader's check "
                f"is for call {seq}, this rank's last call was {mine_seq}")
        bad = {k: (t, mine.get(k)) for k, t in tokens.items()
               if t >= 0 and mine.get(k, -1) >= 0 and mine[k] != t}
        if fin is not None and mine_fin is not None:
            bad.update({("fin", k): (f, mine_fin.get(k))
                        for k, f in fin.items() if mine_fin.get(k) != f})
        if bad:
            raise DesyncError(
                f"tensor-parallel rank {self.ctx.rank} diverged from its "
                f"leader at call {seq}: {{row: (leader, this rank)}} {bad}")

    # ---- the calls ----
    def _draw(self, logits, sample):
        out = {}
        for row, (pos, knobs) in sample.items():
            if knobs is None:
                out[row] = -1           # the request's own generator
                continue
            tok = fused_sample_call(logits[row:row + 1, pos, :],
                                    **_unpack_knobs(knobs, self.vocab))
            out[row] = int(tok.cpu()[0])
        return out

    def _set_rows(self, desc):
        cache = self.engine.cache
        cache.device_table.copy_(torch.from_numpy(desc["table"]))
        cache.device_offsets.copy_(torch.from_numpy(desc["offsets"]))
        return cache

    def _prefill(self, desc):
        cache = self.engine.cache
        dev = self.engine.device
        views = cache.rows_view(desc["table"], desc["offsets"])
        logits = self.model(torch.tensor(desc["tokens"], device=dev),
                            caches=views)
        return self._draw(logits, desc["sample"]), None

    def _decode(self, desc):
        cache = self._set_rows(desc)
        logits = self.model(torch.tensor(desc["tokens"],
                                         device=self.engine.device),
                            caches=cache.layers)
        return self._draw(logits[:, -1:, :], desc["sample"]), None

    def _tick(self, desc):
        tick = self.engine._tick
        if tick is None or tick.fallback_reason is not None:
            raise DesyncError(
                f"tensor-parallel rank {self.ctx.rank}: a tick descriptor, "
                "but this rank's compiled tick is off or latched "
                f"({None if tick is None else tick.fallback_reason})")
        if desc["state"] is not None:
            for name, arr in desc["state"].items():
                tick._state[name].copy_(torch.from_numpy(arr))
        self._set_rows(desc)
        mode = desc["mode"]
        if mode not in tick.steps:
            if not tick._first_call(mode):
                return None
        else:
            tick.steps[mode]()
        slots = desc["slots"]
        last = tick._state["last"].cpu().numpy()
        fin = tick._state["fin"].cpu().numpy()
        return ({s: int(last[s]) for s in slots},
                {s: int(fin[s]) for s in slots})

    def _export(self, desc):
        mine = self.engine.cache.read_pages(desc["ids"])
        compat.all_gather_object([], mine, group=self.ctx.group)
        return None

    def _adopt(self, desc):
        h, r = self.heads, self.ctx.rank
        self.engine.cache.write_pages(desc["ids"], {
            "k_pool": desc["k"][:, :, :, r * h:(r + 1) * h],
            "v_pool": desc["v"][:, :, :, r * h:(r + 1) * h]})
        return None
