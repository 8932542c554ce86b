"""The port's hot-spare recovery (paddle_tpu_torch/framework/hot_spare.py)
against the JAX package's (paddle_tpu/framework/hot_spare.py) on the CPU:
the counterparts of tests/test_hot_spare.py.

- The buddy ring equals JAX's for worlds 1-8 and mesh process orders; a
  map either package advertises is read by the other.
- The receiver's double buffer under a mid-transfer kill, crc bitrot
  counted, the ladder falling to disk loudly, ``buddy_crash``, the
  remap on resize, the agents' stream / park / peer restore over real
  rpc sockets, the park that aligns a survivor's own copy with the
  replica it holds, `crc32_combine` against zlib.
- The sentinel prefers a fresher snapshot and skips a stale one; fit
  with the flag on (a world of one) equals the flag off bit for bit; a
  snapshot equals the state of its step bit for bit while later steps
  run; the fault points parse to JAX's dicts.
- Two-process drills through the port's launcher (gloo, a tiny GPT
  through ``Model.fit``, tests/_torch_hot_spare_worker.py):
  ``step:crash_at=3,rank=1`` → the relaunched rank 1 restores from its
  buddy's memory (``peer``), rank 0 from its own parked copy, and the
  losses equal an uninterrupted run's bit for bit; with ``buddy_crash``
  the ladder falls to the sharded disk checkpoint, loudly, with the same
  losses.
"""
import json
import os
import pickle
import threading
import zlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from paddle_tpu.distributed.store import FileKVStore as JaxFileKVStore
from paddle_tpu.framework import hot_spare as jhs
from paddle_tpu.utils import fault_injection as jfi
from paddle_tpu_torch.distributed.store import FileKVStore
from paddle_tpu_torch.framework import hot_spare
from paddle_tpu_torch.framework.hot_spare import (
    BuddyUnavailableError, HotSpareStore, PeerRestoreWarning,
    PeerSnapshotError, SnapshotIntegrityError)
from paddle_tpu_torch.observability import registry
from paddle_tpu_torch.utils import fault_injection
from paddle_tpu_torch.utils import flags as port_flags

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_hot_spare_worker.py")
FLAG_KEYS = ("FLAGS_hot_spare", "FLAGS_hot_spare_every",
             "FLAGS_hot_spare_chunk_kb", "FLAGS_hot_spare_timeout_s",
             "FLAGS_fault_inject", "FLAGS_sentinel",
             "FLAGS_sentinel_dump_path")


@pytest.fixture
def flags(tmp_path):
    old = port_flags.get_flags(list(FLAG_KEYS))
    port_flags.set_flags({"FLAGS_sentinel_dump_path":
                          str(tmp_path / "sentinel.json")})
    yield port_flags.set_flags
    port_flags.set_flags(old)
    hot_spare.disarm()


def _count(name):
    return registry.counter(name).value


def _record(owner, step, n=2500):
    g = torch.Generator().manual_seed(step)
    state = {"w": torch.randn(n, generator=g, dtype=torch.float64),
             "step": step}
    return hot_spare.make_record(owner, step,
                                 {"it": step, "epoch": 0, "next_step": step},
                                 state)


def _send(store, rec, chunk=4096, upto=None, xfer="x", commit=True,
          corrupt_chunk=None):
    """Drive the receiver protocol by hand (what the agent's stream
    does)."""
    payload = rec["payload"]
    chunks = [payload[i:i + chunk] for i in range(0, len(payload), chunk)]
    store.begin(rec["owner"], xfer, rec["step"], rec["book"], len(chunks),
                rec["nbytes"], rec["crc"])
    for i, c in enumerate(chunks):
        if upto is not None and i >= upto:
            return None
        data = c[:-1] + bytes([c[-1] ^ 0xFF]) if i == corrupt_chunk else c
        store.chunk(rec["owner"], xfer, i, zlib.crc32(c), data)
    return store.commit(rec["owner"], xfer) if commit else None


# ---------------------------------------------------------------------------
# the buddy ring and its map
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", range(1, 9))
def test_buddy_ring_equals_jax(world):
    assert hot_spare.derive_buddies(world) == jhs.derive_buddies(world)
    rng = np.random.default_rng(world)
    for _ in range(3):
        mesh = SimpleNamespace(process_ids=[int(p) for p in
                                            rng.permutation(world)])
        assert hot_spare.derive_buddies(world, mesh=mesh) == \
            jhs.derive_buddies(world, mesh=mesh)
    other = SimpleNamespace(process_ids=list(range(world + 1)))
    assert hot_spare.derive_buddies(world, mesh=other) == \
        jhs.derive_buddies(world, mesh=other)


def test_advertised_maps_cross_the_packages(tmp_path):
    jstore, pstore = JaxFileKVStore(str(tmp_path)), FileKVStore(str(tmp_path))
    sent = jhs.advertise_buddy_map(jstore, "a", 4, resized_from=8)
    assert hot_spare.read_buddy_map(pstore, "a") == sent
    mesh = SimpleNamespace(process_ids=[2, 0, 3, 1])
    sent = hot_spare.advertise_buddy_map(pstore, "b", 4, mesh=mesh,
                                         resized_from=8)
    assert jhs.read_buddy_map(jstore, "b") == sent == {2: 0, 0: 3, 3: 1,
                                                       1: 2}
    assert json.loads(pstore.get("b/hot_spare/buddies")) == json.loads(
        jstore.get("a/hot_spare/buddies")) | {"buddies": {
            str(k): v for k, v in sent.items()}}


def test_buddy_remap_on_resize(monkeypatch):
    assert hot_spare.derive_buddies(4) == {0: 1, 1: 2, 2: 3, 3: 0}
    assert hot_spare.derive_buddies(2) == {0: 1, 1: 0}
    assert hot_spare.derive_buddies(1) == {}
    monkeypatch.setenv("PADDLE_ELASTIC_RESIZED", "4:2")
    agent = hot_spare.HotSpareAgent("remap", 0, 2, store=None, serve=False)
    assert agent.buddies == {0: 1, 1: 0}
    agent.close(park=False)


# ---------------------------------------------------------------------------
# the receiver's double buffer and crc
# ---------------------------------------------------------------------------

def test_double_buffer_keeps_last_valid_on_mid_transfer_kill():
    store = HotSpareStore()
    assert _send(store, _record(0, 1), xfer="g1") == 1
    _send(store, _record(0, 2), xfer="g2", upto=2, commit=False)
    assert store.latest(0)["step"] == 1
    with pytest.raises(PeerSnapshotError):
        store.commit(0, "g2")
    assert store.latest(0)["step"] == 1
    assert _send(store, _record(0, 3), xfer="g3") == 3
    rec = store.latest(0)
    assert rec["step"] == 3
    hot_spare.verify_record(rec)
    want = _record(0, 3)
    assert b"".join(rec["payload"]) == want["payload"]
    assert rec["crc"] == want["crc"] == zlib.crc32(want["payload"])


def test_chunk_crc_bitrot_rejected_and_counted():
    store = HotSpareStore()
    _send(store, _record(0, 1), xfer="ok")
    before = _count("ckpt.peer.crc_failures")
    with pytest.raises(SnapshotIntegrityError):
        _send(store, _record(0, 2), xfer="rot", corrupt_chunk=1)
    assert _count("ckpt.peer.crc_failures") > before
    with pytest.raises(PeerSnapshotError):
        store.commit(0, "rot")
    assert store.latest(0)["step"] == 1


@pytest.mark.parametrize("sizes", [(1, 1), (5, 4096), (4096, 1),
                                   (70000, 3), (3, 70000)])
def test_crc32_combine_equals_zlib(sizes):
    a, b = (bytes(np.random.default_rng(n).integers(0, 256, n, np.uint8))
            for n in sizes)
    assert hot_spare.crc32_combine(zlib.crc32(a), zlib.crc32(b), len(b)) \
        == zlib.crc32(a + b)
    crcs, whole = hot_spare.chunk_crcs(a + b, len(a))
    assert whole == zlib.crc32(a + b) and crcs[0] == zlib.crc32(a)


def test_ladder_falls_to_disk_loudly_on_bitrot(tmp_path, flags, monkeypatch):
    store = FileKVStore(str(tmp_path))
    hot_spare.advertise_buddy_map(store, "rot", 2)
    rec = dict(_record(1, 4), parked_by=0)
    rec["payload"] = rec["payload"][:-1] + \
        bytes([rec["payload"][-1] ^ 0xFF])
    store.set("rot/hot_spare/parked/r1", pickle.dumps(rec))
    disk = {"model": "from-disk"}
    before = _count("ckpt.peer.crc_failures")
    monkeypatch.setenv("PADDLE_TRAINER_ID", "1")
    with pytest.warns(PeerRestoreWarning, match="falling back"):
        got = hot_spare.restore_with_ladder(
            "rot", 1, disk_fn=lambda: (disk, {"step": 0}, "disk"),
            store=store)
    assert got[2] == "disk" and got[0] is disk
    assert _count("ckpt.peer.crc_failures") > before


def test_buddy_crash_injection_forces_disk(tmp_path, flags):
    store = FileKVStore(str(tmp_path))
    hot_spare.advertise_buddy_map(store, "bc", 2)
    store.set("bc/hot_spare/parked/r1",
              pickle.dumps(dict(_record(1, 4), parked_by=0)))
    flags({"FLAGS_fault_inject": "buddy_crash:count=1"})
    with pytest.raises(BuddyUnavailableError):
        hot_spare.peer_restore("bc", 1, store=store)
    got = hot_spare.peer_restore("bc", 1, store=store)
    assert got is not None and got[2] == "peer"
    assert torch.equal(got[0]["w"], torch.randn(
        2500, generator=torch.Generator().manual_seed(4),
        dtype=torch.float64))


# ---------------------------------------------------------------------------
# agents over real rpc sockets
# ---------------------------------------------------------------------------

def test_agent_stream_park_and_peer_restore(tmp_path, flags):
    store = FileKVStore(str(tmp_path))
    hot_spare.advertise_buddy_map(store, "agents", 2)
    a0 = hot_spare.HotSpareAgent("agents", 0, 2, store=store, every=1,
                                 chunk_bytes=4096)
    a1 = hot_spare.HotSpareAgent("agents", 1, 2, store=store, every=1,
                                 chunk_bytes=4096)
    try:
        w = torch.arange(6000, dtype=torch.float32)
        state = {"w": w, "h": w.bfloat16(), "step": 2}
        sent = _count("ckpt.peer.snapshots")
        a1.snapshot_now(2, state, {"it": 3, "epoch": 0, "next_step": 3})
        assert _count("ckpt.peer.snapshots") > sent
        got = hot_spare.peer_restore("agents", 1, store=store)
        assert got is not None and got[2] == "peer"
        assert torch.equal(got[0]["w"], w)
        assert torch.equal(got[0]["h"].view(torch.int16),
                           w.bfloat16().view(torch.int16))
        flags({"FLAGS_fault_inject": "peer_snap_drop:at_step=4"})
        a1.snapshot_now(4, {"w": torch.zeros(6000), "step": 4}, {"it": 5})
        flags({"FLAGS_fault_inject": ""})
        assert hot_spare.store_for("agents").latest(1)["step"] == 2
        a0.park()                     # rank 1 "died" and never parked
    finally:
        a0.close(park=False)
        a1.close(park=False)
    hot_spare._STORES.pop("agents", None)
    got = hot_spare.peer_restore("agents", 1, store=store)
    assert got is not None and got[2] == "peer" and got[1]["it"] == 3


def test_park_aligns_own_copy_with_the_held_replica(tmp_path, flags):
    """A survivor whose newest own snapshot is past the replica it holds
    parks its own copy of the replica's step (it keeps two), so both
    relaunched ranks restore the same step."""
    store = FileKVStore(str(tmp_path))
    agent = hot_spare.HotSpareAgent("align", 0, 2, store=store, every=1,
                                    serve=False)
    try:
        for step in (2, 4):
            agent.snapshot_now(step, {"w": torch.full((3,), float(step))},
                               {"it": step})
        hot_spare.store_for("align").install(_record(1, 2))
        assert agent.park() == 2
    finally:
        agent.close(park=False)
        hot_spare._STORES.pop("align", None)
    own = pickle.loads(store.get("align/hot_spare/parked/r0"))
    peer = pickle.loads(store.get("align/hot_spare/parked/r1"))
    assert (own["step"], own["parked_by"], peer["step"],
            peer["parked_by"]) == (2, 0, 2, 0)
    got = hot_spare.peer_restore("align", 0, store=store)
    assert got[2] == "self" and float(got[0]["w"][0]) == 2.0


def test_snapshot_is_its_step_bit_for_bit_while_steps_run(flags,
                                                          monkeypatch):
    """The capture is finished before `maybe_snapshot` returns: the steps
    that write the same tensors in place while the stream thread is still
    packing (held here until the steps are done) do not reach the
    snapshot, and the cadence that finds the transfer in flight is
    skipped."""
    from paddle_tpu_torch.nn import Linear
    from paddle_tpu_torch.optimizer import AdamW
    make_record = hot_spare.make_record
    steps_done = threading.Event()

    def slow(*a, **kw):
        steps_done.wait(30)
        return make_record(*a, **kw)
    monkeypatch.setattr(hot_spare, "make_record", slow)
    net = Linear(64, 64, device="cpu")
    opt = AdamW(1e-2, parameters=net.parameters())
    agent = hot_spare.HotSpareAgent("race", 0, 1, store=None, every=2,
                                    serve=False)
    want = {}
    x = torch.randn(8, 64, generator=torch.Generator().manual_seed(0))
    for it in range(1, 5):
        net(x).square().mean().backward()
        opt.step()
        opt.clear_grad()
        if agent.maybe_snapshot(it, lambda: {"model": net.state_dict(),
                                             "optimizer": opt.state_dict()},
                                {"it": it}):
            want[it] = {k: v.clone() for k, v in net.state_dict().items()}
    steps_done.set()
    agent.wait()
    state, book = hot_spare.validated_state(agent.latest_record())
    assert (sorted(want), book["it"], agent.stats["skipped"]) == ([2], 2, 1)
    for k, v in want[2].items():
        assert torch.equal(state["model"][k], v), k
        assert not torch.equal(net.state_dict()[k], v), k
    agent.close(park=False)


# ---------------------------------------------------------------------------
# the sentinel's rung
# ---------------------------------------------------------------------------

class _FakeModel:
    def __init__(self):
        self.restored = None

    def _sentinel_restore(self, state):
        self.restored = state


def _armed_agent_with_snapshot(it, flags):
    flags({"FLAGS_hot_spare": True})
    agent = hot_spare.arm(rank=0, world=1, job="sent", store=None)
    agent.snapshot_now(it, {"w": torch.full((8,), float(it))},
                       {"it": it, "epoch": 0, "next_step": it})
    return agent


@pytest.mark.parametrize("it,wins", [(9, "peer"), (3, "anchor")])
def test_sentinel_prefers_a_fresher_snapshot_and_skips_a_stale_one(
        flags, it, wins):
    from paddle_tpu_torch.framework.sentinel import TrainingSentinel
    model = _FakeModel()
    sen = TrainingSentinel(model=model)
    sen._anchor = ({"w": torch.full((8,), 5.0)},
                   {"it": 5, "epoch": 0, "next_step": 5})
    _armed_agent_with_snapshot(it, flags)
    restores = _count("ckpt.peer.restores")
    stale = _count("ckpt.peer.stale_skipped")
    directive = sen._escalate("drill", {"it": 12})
    if wins == "peer":
        assert directive.it == 9 and float(model.restored["w"][0]) == 9.0
        assert _count("ckpt.peer.restores") == restores + 1
    else:
        assert directive.it == 5 and float(model.restored["w"][0]) == 5.0
        assert _count("ckpt.peer.stale_skipped") == stale + 1


# ---------------------------------------------------------------------------
# fit: flag off = world of one bit for bit; the fault points
# ---------------------------------------------------------------------------

def test_flag_off_and_world1_bitwise_identity(flags):
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.io import TensorDataset
    from paddle_tpu_torch.nn import Linear, MSELoss
    from paddle_tpu_torch.optimizer import AdamW
    g = torch.Generator().manual_seed(0)
    x, y = torch.randn(24, 8, generator=g), torch.randn(24, 1, generator=g)
    base = torch.nn.Sequential(Linear(8, 16, device="cpu"), torch.nn.Tanh(),
                               Linear(16, 1, device="cpu"))

    def fit():
        import copy
        net = copy.deepcopy(base)
        model = Model(net).prepare(AdamW(0.01, parameters=net.parameters()),
                                   MSELoss())
        model.fit(TensorDataset([x, y]), batch_size=4, epochs=1, verbose=0,
                  shuffle=False)
        return {k: v.clone() for k, v in net.state_dict().items()}
    flags({"FLAGS_hot_spare": False})
    off = fit()
    flags({"FLAGS_hot_spare": True, "FLAGS_hot_spare_every": 2})
    snaps = _count("ckpt.peer.snapshots")
    on = fit()
    for k in off:
        assert torch.equal(off[k], on[k]), k
    # the fit armed a real agent (a world of one streams nothing) and
    # declared the family
    assert _count("ckpt.peer.snapshots") == snaps
    assert "ckpt_peer_snapshots" in registry.render_prometheus()
    assert hot_spare.current_agent() is None


@pytest.mark.parametrize("spec", [
    "peer_snap_drop:at_step=3,rank=1,after_chunks=2",
    "buddy_crash:rank=0,count=1",
    "peer_snap_drop:at_step=3,rank=1,after_chunks=2;"
    "buddy_crash:rank=0,count=1;step:crash_at=3,rank=1,once_file=/tmp/x",
])
def test_fault_point_specs_equal_jax(spec):
    assert fault_injection.parse(spec) == jfi.parse(spec)
    assert fault_injection.KNOWN_POINTS["peer_snap_drop"] == \
        jfi.KNOWN_POINTS["peer_snap_drop"]
    assert fault_injection.KNOWN_POINTS["buddy_crash"] == \
        jfi.KNOWN_POINTS["buddy_crash"]
    for bad in ("peer_snap_drop", "buddy_crash:nope=1",
                "peer_snap_drop:at_step=x"):
        with pytest.raises(fault_injection.FaultSpecError):
            fault_injection.parse(bad)


def test_ladder_points_fire_as_jax(flags, monkeypatch):
    flags({"FLAGS_fault_inject": "peer_snap_drop:at_step=3,rank=1,count=1"})
    monkeypatch.setenv("PADDLE_TRAINER_ID", "1")
    assert fault_injection.check_peer_snap_drop(2) is None
    assert fault_injection.check_peer_snap_drop(3) == {
        "at_step": 3, "rank": 1, "count": 1}
    assert fault_injection.check_peer_snap_drop(3) is None   # spent
    flags({"FLAGS_fault_inject": "buddy_crash:rank=0"})
    assert fault_injection.check_buddy_crash() is None       # rank 1
    monkeypatch.setenv("PADDLE_TRAINER_ID", "0")
    assert fault_injection.check_buddy_crash() == {"rank": 0}


# ---------------------------------------------------------------------------
# two-process drills through the launcher
# ---------------------------------------------------------------------------

def _launch(outdir, monkeypatch, fault=None, max_restart=0, limit_s=150,
            settle_at=None):
    from paddle_tpu_torch.distributed.launch.context import (Context,
                                                             parse_args)
    from paddle_tpu_torch.distributed.launch.controller import \
        CollectiveController
    env = {"FLAGS_hot_spare": "1", "FLAGS_hot_spare_every": "1",
           "FLAGS_fault_inject": fault or "",
           "PADDLE_ELASTIC_FAULT_TOLERANC_LEVEL": "1",
           "PADDLE_GUARDIAN_PEER_GRACE_S": "20",
           "FLAGS_flight_recorder_path": str(outdir / "fr.json"),
           "HOT_SPARE_SETTLE_AT": "-1" if settle_at is None
           else str(settle_at)}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    ctl = CollectiveController(Context(args=parse_args(
        ["--nproc_per_node", "2", "--max_restart", str(max_restart),
         "--job_id", f"hs-{outdir.name}", "--log_dir",
         str(outdir / "logs"), WORKER, str(outdir)])))
    out = {}
    th = threading.Thread(target=lambda: out.update(code=ctl.run()),
                          daemon=True)
    th.start()
    th.join(limit_s)
    if th.is_alive():                # the test's own time limit
        for p in ctl.procs:
            p.kill()
        th.join(10)
        pytest.fail(f"the drill ran past {limit_s} s")
    return out["code"]


def _losses(outdir, rank):
    by = {}
    with open(outdir / f"losses.{rank}.jsonl") as f:
        for line in f:
            rec = json.loads(line)
            by.setdefault(rec["step"], []).append(rec["loss"])
    return by


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    try:
        d = tmp_path_factory.mktemp("ref")
        assert _launch(d, mp) == 0
        return {r: [v[0] for _, v in sorted(_losses(d, r).items())]
                for r in range(2)}
    finally:
        mp.undo()


@pytest.mark.parametrize("buddy_crash", [False, True])
def test_hot_spare_drill(tmp_path, monkeypatch, reference, buddy_crash):
    """Rank 1 is hard-killed at the top of step 3, after each rank waited
    out its snapshot's transfer in flight (a loaded machine could crash
    rank 1 before its buddy held a committed replica); the relaunch
    resumes from the buddy's memory (or, with ``buddy_crash`` on rank 1,
    from the sharded disk checkpoint after a PeerRestoreWarning) and
    every step's loss equals the uninterrupted run's bit for bit."""
    d = tmp_path / ("bc" if buddy_crash else "peer")
    d.mkdir()
    fault = f"step:crash_at=3,rank=1,once_file={d / 'crash.once'}"
    if buddy_crash:
        fault += ";buddy_crash:rank=1"
    assert _launch(d, monkeypatch, fault=fault, max_restart=1,
                   settle_at=3) == 0
    lines = [ln.split(":") for ln in
             (d / "incarnations.log").read_text().splitlines()]
    assert len(lines) == 4, lines
    second = {int(ln[0]): ln for ln in lines[2:]}
    start = int(second[1][2])
    assert second[0][2] == second[1][2] and 1 <= start <= 3, lines
    if buddy_crash:
        assert second[1][3] == second[0][3] == "disk", lines
        assert "PeerRestoreWarning" in (d / "logs" /
                                        "worker.1.log").read_text()
    else:
        assert (second[1][3], second[0][3]) == ("peer", "self"), lines
    for r in range(2):
        got = _losses(d, r)
        assert [got[s][-1] for s in range(len(reference[r]))] == \
            reference[r], r


def test_fit_parks_only_on_an_exit_into_a_relaunch(tmp_path, flags,
                                                   monkeypatch):
    """A finished fit parks nothing (nothing relaunches; its snapshot is
    older than its last checkpoint); a fit an exception ends parks its
    own snapshot in the guardian store, as the relaunch expects."""
    from paddle_tpu_torch.hapi import Callback, Model
    from paddle_tpu_torch.io import TensorDataset
    from paddle_tpu_torch.nn import Linear, MSELoss
    from paddle_tpu_torch.optimizer import SGD
    monkeypatch.setenv("PADDLE_GUARDIAN_DIR", str(tmp_path / "kv"))
    monkeypatch.setenv("PADDLE_JOB_ID", "parks")
    flags({"FLAGS_hot_spare": True, "FLAGS_hot_spare_every": 1})
    g = torch.Generator().manual_seed(0)
    data = TensorDataset([torch.randn(8, 4, generator=g),
                          torch.randn(8, 1, generator=g)])

    class Boom(Callback):
        def on_train_batch_end(self, step, logs=None):
            if step == 2:
                raise RuntimeError("a peer failed")

    def fit(callbacks=()):
        net = Linear(4, 1, device="cpu")
        model = Model(net).prepare(SGD(0.1, parameters=net.parameters()),
                                   MSELoss())
        model.fit(data, batch_size=2, epochs=1, verbose=0, shuffle=False,
                  callbacks=list(callbacks))
    store = FileKVStore(str(tmp_path / "kv"))
    fit()
    assert store.get("parks/hot_spare/parked/r0") is None
    with pytest.raises(RuntimeError, match="a peer failed"):
        fit([Boom()])
    rec = pickle.loads(store.get("parks/hot_spare/parked/r0"))
    # iterations 1 and 2 each start a snapshot unless the one before is
    # still being packed (one in flight): the newest taken is parked
    assert (rec["owner"], rec["parked_by"]) == (0, 0) and \
        rec["step"] in (1, 2)
    assert hot_spare.current_agent() is None
