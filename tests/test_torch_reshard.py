"""The port's elastic reshard (paddle_tpu_torch/distributed/reshard.py)
against the JAX package's (paddle_tpu/distributed/reshard.py) on the CPU.

- The shard math (`split_bounds`, `shard_slices`, `overlap_slices`,
  `MeshSpec.coords`) equals JAX's on uneven and 2-D meshes.
- Checkpoints cross the packages both ways: JAX's `save_sharded` at dp 4
  (ranks in threads, as tests/test_reshard.py saves) restored by the port
  at dp 2, dp 3 and dp 2 × mp 2, and the port's save restored by JAX's
  `restore_resharded`, bit for bit with a bfloat16 array among them; the
  two layout sections are equal apart from the nonce.
- The counterparts of tests/test_reshard.py: the fast path, a pre-layout
  checkpoint, a mismatch naming both layouts, ``FLAGS_reshard_on_resume``
  off, the optimizer's moments through a reshard (the continued run
  equals the uninterrupted one bit for bit), a shard fetched through the
  guardian store, retention and torn directories, the barrier timeout.
- The process-local saver (``local=True``): tensor-parallel parts with
  their partition, the global shapes derived and checked.
"""
import copy
import importlib
import os
import threading

import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.utils.flags import set_flags as jax_set_flags
from paddle_tpu_torch.distributed.reshard import (
    LayoutError, LayoutMismatchError, MeshSpec, ShardedCheckpointer,
    offer_shards, overlap_slices, read_layout, replicated,
    restore_latest_resharded, restore_resharded, shard_slices,
    split_bounds)
from paddle_tpu_torch.framework.checkpoint_manager import (
    CheckpointError, CheckpointManager)
from paddle_tpu_torch.utils.flags import set_flags

CPU = "cpu"
# the modules (each package's distributed namespace has a `reshard`
# function of its own)
jrs = importlib.import_module("paddle_tpu.distributed.reshard")
prs = importlib.import_module("paddle_tpu_torch.distributed.reshard")


# ---------------------------------------------------------------------------
# shard math
# ---------------------------------------------------------------------------

MESHES = [(("dp",), (4,)), (("dp",), (3,)), (("dp", "mp"), (2, 2)),
          (("dp", "mp"), (3, 2)), (("mp", "dp"), (2, 3))]
SHAPES = [(7,), (3,), (8, 6), (7, 5), (1, 9), (5, 4, 3)]


@pytest.mark.parametrize("axes,shape", MESHES)
def test_shard_math_equals_jax(axes, shape):
    pm, jm = MeshSpec(axes, shape), jrs.MeshSpec(axes, shape)
    assert pm.world == jm.world and repr(pm) == repr(jm)
    for n in (0, 1, 3, 7, 8, 13):
        for parts in (1, 2, 3, 4):
            for i in range(parts):
                assert split_bounds(n, parts, i) == \
                    jrs.split_bounds(n, parts, i)
    for r in range(pm.world):
        assert pm.coords(r) == jm.coords(r)
    parts = [None] + list(axes)
    for gshape in SHAPES:
        for p0 in parts:
            for p1 in parts:
                part = ((p0, p1) + (None,) * len(gshape))[:len(gshape)]
                if p0 is not None and p0 == p1:
                    continue
                for r in range(pm.world):
                    mine = shard_slices(gshape, part, pm, r)
                    assert mine == jrs.shard_slices(gshape, part, jm, r)
                    for r2 in range(pm.world):
                        other = shard_slices(gshape, part, pm, r2)
                        assert overlap_slices(mine, other) == \
                            jrs.overlap_slices(mine, other)
    with pytest.raises(LayoutMismatchError):
        shard_slices((8,), ("pp",), pm, 0)
    with pytest.raises(ValueError):
        split_bounds(4, 2, 2)


# ---------------------------------------------------------------------------
# state and threads
# ---------------------------------------------------------------------------

def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((7, 6)).astype("float32"),
            "b": rng.standard_normal((6,)).astype("float32"),
            "h": rng.standard_normal((5, 4)).astype(ml_dtypes.bfloat16),
            "m1": rng.standard_normal((7, 6)).astype("float32"),
            "ids": rng.integers(0, 99, (9,)).astype("int64")}


def _jax_state(a):
    T = paddle.to_tensor
    return {"model": {"w": T(a["w"]), "b": T(a["b"]), "h": T(a["h"])},
            "optimizer": {"moment1.0": T(a["m1"]), "step_count": 3},
            "ids": a["ids"], "losses": [0.5, 0.25], "step": 1}


def _torch(x):
    if x.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(x.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(x.copy())


def _port_state(a):
    return {"model": {"w": _torch(a["w"]), "b": _torch(a["b"]),
                      "h": _torch(a["h"])},
            "optimizer": {"moment1.0": _torch(a["m1"]), "step_count": 3},
            "ids": a["ids"], "losses": [0.5, 0.25], "step": 1}


def _moment_partition(key, arr):
    if "moment" in key and arr.ndim >= 1:
        return ("dp",) + (None,) * (arr.ndim - 1)
    return replicated(arr.ndim)


def _threads(world, fn):
    errs = []

    def one(rank):
        try:
            fn(rank)
        except BaseException as e:  # noqa: BLE001 — asserted below
            errs.append((rank, e))
    ts = [threading.Thread(target=one, args=(r,)) for r in range(world)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(60)
    assert not errs, errs


def _jax_save(root, state, mesh, pf=None, step=0):
    _threads(mesh.world, lambda r: jrs.ShardedCheckpointer(
        root, mesh, r, partition_fn=pf).save(state, step=step))


def _port_save(root, state, mesh, pf=None, step=0, **kw):
    _threads(mesh.world, lambda r: ShardedCheckpointer(
        root, mesh, r, partition_fn=pf, map_location=CPU, **kw).save(
            state, step=step))


def _np_of(x):
    """numpy of either package's leaf (bf16 as its uint16 bits)."""
    if torch.is_tensor(x):
        if x.dtype == torch.bfloat16:
            return x.view(torch.uint16).numpy()
        return x.numpy()
    a = np.asarray(x._data_) if hasattr(x, "_data_") else np.asarray(x)
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a


def _want(a, key):
    x = a[key]
    return x.view(np.uint16) if x.dtype == ml_dtypes.bfloat16 else x


def _check_full(state, a):
    for k in ("w", "b", "h"):
        np.testing.assert_array_equal(_np_of(state["model"][k]), _want(a, k))
    np.testing.assert_array_equal(_np_of(state["optimizer"]["moment1.0"]),
                                  a["m1"])
    np.testing.assert_array_equal(_np_of(state["ids"]), a["ids"])
    assert state["losses"] == [0.5, 0.25] and state["step"] == 1
    assert state["optimizer"]["step_count"] == 3


TARGETS = [(("dp",), (2,)), (("dp",), (3,)), (("dp", "mp"), (2, 2))]


@pytest.mark.parametrize("axes,shape", TARGETS)
def test_jax_dp4_checkpoint_restores_in_port(tmp_path, axes, shape):
    a = _arrays()
    root = str(tmp_path / "ck")
    _jax_save(root, _jax_state(a), jrs.MeshSpec(("dp",), (4,)),
              _moment_partition)
    mesh = MeshSpec(axes, shape)
    for rank in range(mesh.world):
        ck = ShardedCheckpointer(root, mesh, rank, map_location=CPU)
        state, step = ck.restore_latest()
        assert step == 0 and not ck.last_report["fast_path"]
        assert ck.last_report["arrays_resharded"] >= 1
        _check_full(state, a)
        assert state["model"]["h"].dtype == torch.bfloat16
        assert isinstance(state["ids"], np.ndarray)
        # slices: the moment split over dp (and mp) of the new mesh
        part = tuple(axes) if len(axes) == 2 else ("dp", None)
        st, _ = restore_resharded(
            os.path.join(root, "ckpt-00000000"), mesh, rank,
            target_partition_fn=lambda k, m: part if "moment" in k
            else replicated(len(m["global_shape"])), map_location=CPU)
        sl = shard_slices((7, 6), part, mesh, rank)
        np.testing.assert_array_equal(
            _np_of(st["optimizer"]["moment1.0"]), a["m1"][sl])


@pytest.mark.parametrize("axes,shape", TARGETS)
def test_port_dp4_checkpoint_restores_in_jax(tmp_path, axes, shape):
    a = _arrays(1)
    root = str(tmp_path / "ck")
    _port_save(root, _port_state(a), MeshSpec(("dp",), (4,)),
               _moment_partition)
    mesh = jrs.MeshSpec(axes, shape)
    for rank in range(mesh.world):
        ck = jrs.ShardedCheckpointer(root, mesh, rank)
        state, step = ck.restore_latest()
        assert step == 0 and ck.last_report["arrays_resharded"] >= 1
        _check_full(state, a)
        assert np.asarray(state["model"]["h"]._data_).dtype == \
            ml_dtypes.bfloat16


def test_layout_sections_equal_apart_from_nonce(tmp_path):
    a = _arrays(2)
    mesh = ("dp", "mp"), (2, 2)
    _jax_save(str(tmp_path / "j"), _jax_state(a), jrs.MeshSpec(*mesh),
              _moment_partition)
    _port_save(str(tmp_path / "p"), _port_state(a), MeshSpec(*mesh),
               _moment_partition)

    def strip(layout):
        nonce = layout.pop("nonce")
        layout["rank_files"] = {r: f.replace(nonce, "N")
                                for r, f in layout["rank_files"].items()}
        return layout
    j = strip(jrs.read_layout(str(tmp_path / "j" / "ckpt-00000000")))
    p = strip(read_layout(str(tmp_path / "p" / "ckpt-00000000")))
    assert p == j
    assert p["arrays"]["model.h"]["dtype"] == "bfloat16"
    # the shard files themselves cross: JAX's loader reads the port's
    from paddle_tpu.framework.io import load as jax_load
    from paddle_tpu_torch.framework.io import load as port_load
    pf = os.path.join(tmp_path, "p", "ckpt-00000000", p["rank_files"]["3"])
    shard = jax_load(pf.replace("N", read_layout(
        str(tmp_path / "p" / "ckpt-00000000"))["nonce"]))
    assert isinstance(shard["objects"]["model"]["w"], jrs._ArrayRef)
    np.testing.assert_array_equal(shard["arrays"]["optimizer.moment1.0"],
                                  a["m1"][4:7])   # rank 3 = dp 1 of 2: rows 4-6
    jf = os.path.join(tmp_path, "j", "ckpt-00000000", j["rank_files"]["3"])
    shard = port_load(jf.replace("N", jrs.read_layout(
        str(tmp_path / "j" / "ckpt-00000000"))["nonce"]), map_location=CPU)
    assert isinstance(shard["objects"]["model"]["w"], prs._ArrayRef)


# ---------------------------------------------------------------------------
# tests/test_reshard.py's cases on the port
# ---------------------------------------------------------------------------

def test_reshard_4_to_2_and_3_roundtrip(tmp_path):
    a = _arrays(3)
    root = str(tmp_path / "ck")
    _port_save(root, _port_state(a), MeshSpec(("dp",), (4,)),
               _moment_partition)
    layout = read_layout(os.path.join(root, "ckpt-00000000"))
    assert layout["world_size"] == 4
    assert layout["arrays"]["optimizer.moment1.0"]["partition"] == \
        ["dp", None]
    assert layout["arrays"]["model.w"]["partition"] == [None, None]
    for new_world in (2, 3, 1, 5):
        mesh = MeshSpec(("dp",), (new_world,))
        for rank in range(new_world):
            ck = ShardedCheckpointer(root, mesh, rank, map_location=CPU)
            state, step = ck.restore_latest()
            assert step == 0 and not ck.last_report["fast_path"]
            _check_full(state, a)


def test_reshard_2d_mesh_uneven(tmp_path):
    arr = np.random.default_rng(3).standard_normal((7, 5)).astype("float32")
    root = str(tmp_path / "ck")
    _port_save(root, {"a": torch.from_numpy(arr)},
               MeshSpec(("dp", "mp"), (2, 2)), lambda k, a: ("dp", "mp"))
    path = os.path.join(root, "ckpt-00000000")
    layout = read_layout(path)
    from paddle_tpu_torch.framework.io import load
    s3 = load(os.path.join(path, layout["rank_files"]["3"]),
              map_location=CPU)
    np.testing.assert_array_equal(np.asarray(s3["arrays"]["a"]),
                                  arr[4:7, 3:5])
    for rank in range(3):
        st, report = restore_resharded(path, MeshSpec(("dp",), (3,)), rank,
                                       map_location=CPU)
        np.testing.assert_array_equal(st["a"].numpy(), arr)
        assert report["files_read"] == 4


def test_fast_path_same_layout_bit_equal(tmp_path):
    a = _arrays(4)
    root = str(tmp_path / "ck")
    mesh2 = MeshSpec(("dp",), (2,))
    _port_save(root, _port_state(a), mesh2, _moment_partition)
    path = os.path.join(root, "ckpt-00000000")
    for rank in range(2):
        st, report = restore_resharded(
            path, mesh2, rank,
            target_partition_fn=lambda k, m: tuple(m["partition"]),
            map_location=CPU)
        assert report["fast_path"] and report["files_read"] == 1
        np.testing.assert_array_equal(_np_of(st["model"]["h"]), _want(a, "h"))
        lo, hi = split_bounds(7, 2, rank)
        np.testing.assert_array_equal(_np_of(st["optimizer"]["moment1.0"]),
                                      a["m1"][lo:hi])
    root2 = str(tmp_path / "ck2")
    _port_save(root2, {"w": torch.from_numpy(a["w"])}, mesh2)
    st, report = restore_resharded(os.path.join(root2, "ckpt-00000000"),
                                   mesh2, 1, map_location=CPU)
    assert report["fast_path"] and report["files_read"] == 1
    np.testing.assert_array_equal(st["w"].numpy(), a["w"])


def test_pre_layout_checkpoint_loads_and_errors(tmp_path):
    root = str(tmp_path / "legacy")
    CheckpointManager(root, map_location=CPU).save(
        {"model": {"w": torch.ones(3, 2)}, "next_epoch": 2}, step=0)
    mesh = MeshSpec(("dp",), (1,))
    st, step, report = restore_latest_resharded(root, mesh, 0,
                                                map_location=CPU)
    assert report["format"] == "legacy" and step == 0
    assert torch.equal(st["model"]["w"], torch.ones(3, 2))
    with pytest.raises(LayoutError) as ei:
        restore_resharded(os.path.join(root, "ckpt-00000000"),
                          MeshSpec(("dp",), (2,)), 0, map_location=CPU)
    assert "layout" in str(ei.value) and "version" in str(ei.value)
    with pytest.raises(LayoutError):
        restore_latest_resharded(root, mesh, 0, strict_layout=True,
                                 map_location=CPU)


def test_layout_mismatch_names_both_layouts(tmp_path):
    root = str(tmp_path / "ck")
    _port_save(root, {"a": torch.arange(24.).reshape(6, 4)},
               MeshSpec(("dp", "mp"), (2, 2)), lambda k, a: ("dp", "mp"))
    with pytest.raises(LayoutMismatchError) as ei:
        restore_resharded(os.path.join(root, "ckpt-00000000"),
                          MeshSpec(("dp",), (2,)), 0,
                          target_partition_fn=lambda k, m: ("dp", "mp"),
                          map_location=CPU)
    assert "dp=2×mp=2" in str(ei.value) and "dp=2" in str(ei.value)


def test_reshard_on_resume_flag_off_fails_loudly(tmp_path):
    root = str(tmp_path / "ck")
    mesh2 = MeshSpec(("dp",), (2,))
    _port_save(root, {"a": torch.ones(4, 2)}, mesh2)
    path = os.path.join(root, "ckpt-00000000")
    set_flags({"FLAGS_reshard_on_resume": False})
    try:
        st, report = restore_resharded(
            path, mesh2, 0,
            target_partition_fn=lambda k, m: tuple(m["partition"]),
            map_location=CPU)
        assert report["fast_path"]
        with pytest.raises(LayoutMismatchError) as ei:
            restore_resharded(path, MeshSpec(("dp",), (4,)), 0,
                              map_location=CPU)
        msg = str(ei.value)
        assert "dp=2" in msg and "dp=4" in msg
        assert "FLAGS_reshard_on_resume" in msg
    finally:
        set_flags({"FLAGS_reshard_on_resume": True})


def test_optimizer_state_roundtrip_through_reshard(tmp_path):
    """AdamW moments split over dp 4 on disk, assembled at world 1: the
    continued run equals the uninterrupted one bit for bit."""
    from paddle_tpu_torch.nn import Linear
    from paddle_tpu_torch.optimizer import AdamW

    base = torch.nn.Sequential(Linear(5, 9, device=CPU), torch.nn.Tanh(),
                               Linear(9, 3, device=CPU))

    def build():
        m = copy.deepcopy(base)
        return m, AdamW(1e-2, parameters=m.parameters())

    def step(m, o, i):
        rng = np.random.default_rng(i)
        x = torch.from_numpy(rng.standard_normal((4, 5)).astype("float32"))
        y = torch.from_numpy(rng.standard_normal((4, 3)).astype("float32"))
        loss = ((m(x) - y) ** 2).mean()
        loss.backward()
        o.step()
        o.clear_grad()
        return float(loss.detach())

    m_ref, o_ref = build()
    ref = [step(m_ref, o_ref, i) for i in range(6)]
    m, o = build()
    first = [step(m, o, i) for i in range(3)]
    root = str(tmp_path / "ck")
    _port_save(root, {"model": m.state_dict(), "optimizer": o.state_dict()},
               MeshSpec(("dp",), (4,)), _moment_partition, step=2)
    m2, o2 = build()
    ck = ShardedCheckpointer(root, MeshSpec(("dp",), (1,)), 0,
                             map_location=CPU)
    restored, _ = ck.restore_latest()
    assert ck.last_report["arrays_resharded"] >= 1
    m2.load_state_dict(restored["model"])
    o2.set_state_dict(restored["optimizer"])
    assert first + [step(m2, o2, i) for i in range(3, 6)] == ref


def test_shard_fetch_via_guardian_store(tmp_path):
    from paddle_tpu_torch.distributed.store import FileKVStore
    arr = np.random.default_rng(5).standard_normal((6, 3)).astype("float32")
    root = str(tmp_path / "ck")
    _port_save(root, {"a": torch.from_numpy(arr)}, MeshSpec(("dp",), (2,)),
               lambda k, a: ("dp",) + (None,) * (a.ndim - 1))
    path = os.path.join(root, "ckpt-00000000")
    store = FileKVStore(str(tmp_path / "kv"))
    assert offer_shards(store, path) == 2
    os.remove(os.path.join(path, read_layout(path)["rank_files"]["1"]))
    st, _ = restore_resharded(path, MeshSpec(("dp",), (1,)), 0, store=store,
                              fetch_timeout_s=5, map_location=CPU)
    np.testing.assert_array_equal(st["a"].numpy(), arr)
    with pytest.raises(CheckpointError):
        restore_resharded(path, MeshSpec(("dp",), (1,)), 0,
                          store=FileKVStore(str(tmp_path / "kv2")),
                          fetch_timeout_s=0.2, map_location=CPU)


def test_sharded_retention_and_torn_dir_skipped(tmp_path):
    from paddle_tpu_torch.utils import monitor
    root = str(tmp_path / "ck")
    ck = ShardedCheckpointer(root, MeshSpec(("dp",), (1,)), 0, max_to_keep=2,
                             map_location=CPU)
    deleted = monitor.get_monitor_value("ckpt.retention_deleted") or 0
    for s in range(4):
        ck.save({"v": torch.full((2,), float(s))}, step=s)
    assert sorted(os.listdir(root)) == ["ckpt-00000002", "ckpt-00000003"]
    assert monitor.get_monitor_value("ckpt.retention_deleted") == deleted + 2
    os.remove(os.path.join(root, "ckpt-00000003", "manifest.json"))
    st, step = ck.restore_latest()
    assert step == 2 and float(st["v"][0]) == 2.0
    # torn directories older than the newest valid one are collected
    # (ckpt-3, its manifest removed above, and ckpt-1), and a save
    # without a step numbers past the newest committed directory
    os.makedirs(os.path.join(root, "ckpt-00000001"))
    torn = monitor.get_monitor_value("ckpt.torn_gcd") or 0
    ck.save({"v": torch.full((2,), 4.0)}, step=4)
    assert sorted(os.listdir(root)) == ["ckpt-00000002", "ckpt-00000004"]
    assert monitor.get_monitor_value("ckpt.torn_gcd") == torn + 2
    fresh = ShardedCheckpointer(root, MeshSpec(("dp",), (1,)), 0,
                                map_location=CPU)
    os.makedirs(os.path.join(root, "ckpt-00000009"))     # no manifest
    assert fresh.save({"v": torch.ones(2)}).endswith("ckpt-00000005")


def test_barrier_timeout_leaves_torn_dir(tmp_path):
    root = str(tmp_path / "ck")
    ck0 = ShardedCheckpointer(root, MeshSpec(("dp",), (2,)), 0,
                              barrier_timeout_s=0.4, map_location=CPU)
    with pytest.raises(CheckpointError):
        ck0.save({"v": torch.ones(2)}, step=0)
    assert ck0.restore_latest() is None


# ---------------------------------------------------------------------------
# process-local shards
# ---------------------------------------------------------------------------

def test_local_parts_save_the_global_layout(tmp_path):
    """Each rank of an mp 2 world saves its own column and row parts; the
    layout records the global shapes, JAX's restore assembles them, and a
    part that is not its share is refused."""
    rng = np.random.default_rng(6)
    col = rng.standard_normal((4, 8)).astype("float32")
    row = rng.standard_normal((6, 3)).astype("float32")
    rep = rng.standard_normal((5,)).astype("float32")
    mesh = MeshSpec(("mp",), (2,))
    parts = {"col": (None, "mp"), "row": ("mp", None), "rep": (None,)}

    def local(rank):
        return {"col": torch.from_numpy(col[:, 4 * rank:4 * rank + 4].copy()),
                "row": torch.from_numpy(row[3 * rank:3 * rank + 3].copy()),
                "rep": torch.from_numpy(rep)}
    root = str(tmp_path / "ck")
    _threads(2, lambda r: ShardedCheckpointer(
        root, mesh, r, partition_fn=lambda k, a: parts[k], local=True,
        map_location=CPU).save(local(r), step=0))
    layout = read_layout(os.path.join(root, "ckpt-00000000"))
    assert layout["arrays"]["col"]["global_shape"] == [4, 8]
    assert layout["arrays"]["row"]["global_shape"] == [6, 3]
    st, _ = jrs.restore_resharded(os.path.join(root, "ckpt-00000000"),
                                  jrs.MeshSpec(("dp",), (1,)), 0)
    for k, want in (("col", col), ("row", row), ("rep", rep)):
        np.testing.assert_array_equal(np.asarray(st[k]._data_), want)
    with pytest.raises(LayoutError, match="share"):
        prs.global_shapes_of({"col": torch.zeros(4, 3)}, mesh, 0,
                             lambda k, a: (None, "mp"),
                             global_shapes={"col": (4, 8)})


def test_port_reads_flag_only_its_format(tmp_path):
    """A layout of another format (the JAX package's orbax lane) is refused
    with its format named."""
    root = str(tmp_path / "ck")
    _port_save(root, {"a": torch.ones(2)}, MeshSpec(("dp",), (1,)))
    path = os.path.join(root, "ckpt-00000000")
    from paddle_tpu_torch.framework.checkpoint_manager import (read_manifest,
                                                               write_manifest)
    m = read_manifest(path)
    m["layout"]["format"] = "orbax"
    write_manifest(path, files=list(m["files"]), layout=m["layout"])
    with pytest.raises(LayoutError, match="orbax"):
        restore_resharded(path, MeshSpec(("dp",), (1,)), 0, map_location=CPU)
    jax_set_flags({})
