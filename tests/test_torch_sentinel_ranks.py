"""The training sentinel across ranks on the port
(paddle_tpu_torch/framework/sentinel.py's health and blame records, the
launch controller's quarantine, the compiled mesh step's health):
tests/test_sentinel.py's controller and blame drills under their names
(the blame drill's two ranks through the port's launcher, then its
quarantine relaunch on one worker), the health and blame records crossing
between the two packages through one `FileKVStore` directory in both
directions, and hapi ``fit`` on 2 gloo ranks through the compiled mesh
step with the sentinel on against off, bit for bit."""
import json
import os

import numpy as np
import pytest

from paddle_tpu.distributed.store import FileKVStore as JaxFileKVStore
from paddle_tpu.distributed.watchdog import ErrorTrap as JaxErrorTrap
from paddle_tpu.framework import sentinel as jsentinel

from paddle_tpu_torch.distributed.launch.context import Context, parse_args
from paddle_tpu_torch.distributed.launch.controller import \
    CollectiveController
from paddle_tpu_torch.distributed.store import FileKVStore
from paddle_tpu_torch.distributed.watchdog import ErrorTrap
from paddle_tpu_torch.framework import sentinel
from paddle_tpu_torch.framework.sentinel import (TrainingSentinel,
                                                 publish_blame, read_blame)
from paddle_tpu_torch.utils.flags import get_flags, set_flags

from _torch_dist_worker import _mlp, _np, run_ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_sentinel_worker.py")


def test_controller_quarantine_shrinks_world(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_JOB_ID", "default")
    args = parse_args(["--nproc_per_node", "2", "--log_dir",
                       str(tmp_path), "dummy.py"])
    ctl = CollectiveController(Context(args=args))
    ctl._guardian_env()
    publish_blame(ctl._trap, 1, {"anomalies": 4})
    assert read_blame(ctl._trap.store, ctl._trap.job)["rank"] == 1
    ctl._apply_quarantine()
    assert ctl._world == 1
    assert ctl._extra_env["PADDLE_ELASTIC_RESIZED"] == "2:1"
    # the blame is consumed: a second relaunch does not shrink again
    ctl._apply_quarantine()
    assert ctl._world == 1


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_health_and_blame_records_cross_the_packages(tmp_path, writer):
    """Health and blame records one package writes the other reads through
    one directory, and both decide the same blame from them."""
    jax_side = (JaxFileKVStore, JaxErrorTrap, jsentinel)
    port_side = (FileKVStore, ErrorTrap, sentinel)
    w_store, w_trap, w_mod = jax_side if writer == "jax" else port_side
    r_store, r_trap, r_mod = port_side if writer == "jax" else jax_side
    for rank, n in ((0, 0), (1, 3), (2, 0)):
        w_mod.publish_health(w_trap(w_store(str(tmp_path)), job="j",
                                    rank=rank),
                             {"local_anomalies": n, "skips": n, "it": 7})
    reader = r_trap(r_store(str(tmp_path)), job="j", rank=0)
    health = r_mod.read_health(reader)
    assert health == w_mod.read_health(w_trap(w_store(str(tmp_path)),
                                              job="j", rank=1))
    assert sorted(health) == [0, 1, 2] and health[1]["local_anomalies"] == 3
    assert r_mod.decide_blame(health) == w_mod.decide_blame(health) == 1
    w_mod.publish_blame(w_trap(w_store(str(tmp_path)), job="j", rank=2), 1,
                        {"anomalies": 3, "by": 2})
    rec = r_mod.read_blame(r_store(str(tmp_path)), "j")
    assert (rec["rank"], rec["anomalies"], rec["by"]) == (1, 3, 2)
    r_mod.clear_blame(r_store(str(tmp_path)), "j")
    assert w_mod.read_blame(w_store(str(tmp_path)), "j") is None


def test_sentinel_dump_path_and_local_source_match_jax(tmp_path):
    from paddle_tpu.utils import flags as jflags
    saved = get_flags(["FLAGS_sentinel_dump_path"])
    jsaved = jflags.get_flags(["FLAGS_sentinel_dump_path"])
    try:
        for p in ("", str(tmp_path / "s.json"), str(tmp_path / "s")):
            set_flags({"FLAGS_sentinel_dump_path": p})
            jflags.set_flags({"FLAGS_sentinel_dump_path": p})
            for rank, nranks in ((0, 1), (1, 2), (3, 4)):
                assert sentinel.sentinel_dump_path(rank, nranks) == \
                    jsentinel.sentinel_dump_path(rank, nranks)
    finally:
        set_flags(saved)
        jflags.set_flags(jsaved)
    for nranks in (1, 2):
        mine = TrainingSentinel(model=None, nranks=nranks, rank=0)
        theirs = jsentinel.TrainingSentinel(model=None, nranks=nranks,
                                            rank=0)
        for gsq in (None, 4.0, float("inf"), float("nan")):
            assert mine._local_source(gsq) == theirs._local_source(gsq)


def test_blame_drill_two_procs(tmp_path, monkeypatch):
    """Rank 1's gradients are corrupted six times: both ranks skip the
    steps, rank 1 counts the anomalies as its own, the blame names it and
    the escalation raises SentinelError on both ranks; leaving the
    processes, it makes the controller (fault level 1) relaunch the job on
    one worker with ``PADDLE_ELASTIC_RESIZED=2:1``."""
    monkeypatch.setenv("FLAGS_sentinel_dump_path",
                       str(tmp_path / "sentinel.json"))
    monkeypatch.setenv("FLAGS_flight_recorder_path",
                       str(tmp_path / "fr.json"))
    monkeypatch.setenv("PADDLE_ELASTIC_FAULT_TOLERANC_LEVEL", "1")
    args = parse_args(["--nproc_per_node", "2", "--max_restart", "1",
                       "--log_dir", str(tmp_path / "logs"),
                       WORKER, str(tmp_path), "raise"])
    ctl = CollectiveController(Context(args=args))
    assert ctl.run() == 0
    reports = {}
    for rank in (0, 1):
        p = tmp_path / f"blame_report.{rank}.json"
        assert p.exists(), list(tmp_path.iterdir())
        reports[rank] = json.load(open(p))
    # rank 1's gradients were the anomalies' source: blamed by name
    assert reports[0]["report"]["blamed_rank"] == 1, reports
    assert reports[0]["report"]["local_anomalies"] == 0, reports
    assert reports[1]["report"]["local_anomalies"] >= 2, reports
    # both ranks skipped the same steps (the found-inf is the world's)
    assert reports[0]["report"]["quarantined"] == \
        reports[1]["report"]["quarantined"] != []
    # the sentinel dump carries the blame for a post-mortem
    dump = tmp_path / "sentinel.rank0.json"
    assert dump.exists(), list(tmp_path.iterdir())
    data = json.load(open(dump))
    assert data["reason"] == "sentinel"
    assert data["sentinel"]["blamed_rank"] == 1
    assert all("sentinel-error" in reports[r]["outcome"] for r in (0, 1))
    # the quarantine relaunch: one worker, told the world shrank
    assert ctl._world == 1
    relaunch = json.load(open(tmp_path / "relaunch.0.json"))
    assert relaunch == {"world": 1, "resized": "2:1"}
    assert not (tmp_path / "relaunch.1.json").exists()


def test_fit_two_ranks_sentinel_on_equals_off(tmp_path):
    """hapi ``fit`` on 2 gloo ranks through the compiled mesh step (the
    plain body on the CPU): under the sentinel (its health after the dp
    all-reduce, the exchange on the trap) the losses and the weights
    equal the run without it bit for bit, and both ranks published their
    health with no anomaly."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((16, 8)).astype(np.float32)
    y = rng.standard_normal((16, 4)).astype(np.float32)
    params = [_np(p) for p in _mlp(1).parameters()]
    outs = run_ranks(2, "sentinel_fit", tmp_path,
                     dict(params=params, x=x, y=y, batch=4,
                          guard_dir=str(tmp_path / "guard")))
    for r, res in enumerate(outs):
        off, on = res["off"], res["on"]
        assert on["meshed"] and on["sentinel"] and on["compiled"]
        assert not off["sentinel"]
        assert on["loss"] == off["loss"]
        for a, b in zip(on["params"], off["params"]):
            np.testing.assert_array_equal(a, b)
        assert res["report"]["anomalies"] == [] and \
            res["report"]["blamed_rank"] is None
        assert sorted(res["health"]) == [0, 1]
        assert all(h["local_anomalies"] == 0 for h in res["health"].values())
    for a, b in zip(outs[0]["on"]["params"], outs[1]["on"]["params"]):
        np.testing.assert_array_equal(a, b)
