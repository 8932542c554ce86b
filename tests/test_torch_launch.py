"""The port's launcher, spawn and elastic manager
(paddle_tpu_torch/distributed/launch, spawn.py, fleet/elastic.py):
tests/test_launch.py's five cases under their names, the argument
parser and the worker environment against the JAX package's key for key
(the package root on PYTHONPATH apart), what the controller adds for
ranks that share a card, and the controller's sentinel quarantine and
hot-spare refusal."""
import os

import pytest

from paddle_tpu.distributed.launch.context import Context as JaxContext
from paddle_tpu.distributed.launch.context import parse_args as jax_parse

import paddle_tpu_torch.distributed as dist
from paddle_tpu_torch.distributed.fleet.elastic import (ElasticManager,
                                                         ElasticStatus,
                                                         FileStore)
from paddle_tpu_torch.distributed.launch import controller as ctl
from paddle_tpu_torch.distributed.launch.context import (Context,
                                                         parse_args)
from paddle_tpu_torch.distributed.launch.controller import (
    ELASTIC_EXIT_CODE, CollectiveController)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_parse_args_and_env_contract():
    args = parse_args(["--nproc_per_node", "2", "--nnodes", "2",
                       "--node_rank", "1", "train.py", "--lr", "0.1"])
    ctx = Context(args=args)
    assert ctx.world_size() == 4
    env = ctx.proc_env(1, "127.0.0.1:1234")
    assert env["PADDLE_TRAINER_ID"] == "3"
    assert env["WORLD_SIZE"] == "4"
    assert env["PADDLE_MASTER"] == "127.0.0.1:1234"
    assert args.training_script == "train.py"
    assert args.training_script_args == ["--lr", "0.1"]


@pytest.mark.parametrize("argv", [
    ["train.py"],
    ["--nproc_per_node", "2", "--nnodes", "2", "--node_rank", "1",
     "--job_id", "j7", "--max_restart", "1", "--log_dir", "logs",
     "--devices", "0,1", "train.py", "--lr", "0.1"],
    ["--master", "127.0.0.1:9", "--nnodes", "1:4", "--pod_id", "p",
     "--elastic_quiet", "0.5", "--elastic_timeout", "15", "w.py", "-"],
])
def test_parse_args_and_proc_env_match_jax(argv, monkeypatch):
    """The same arguments parse to the same namespace, and ``proc_env``
    gives the same keys and values as JAX's, PYTHONPATH apart (each puts
    its own package root first)."""
    monkeypatch.setenv("PYTHONPATH", "/elsewhere")
    mine, theirs = parse_args(argv), jax_parse(argv)
    assert vars(mine) == vars(theirs)
    a, b = Context(args=mine), JaxContext(args=theirs)
    assert (a.nnodes_range(), a.world_size(), a.global_rank(1)) == \
        (b.nnodes_range(), b.world_size(), b.global_rank(1))
    for kw in ({}, {"rank": 5, "world": 6}):
        got = a.proc_env(1, "127.0.0.1:1234", **kw)
        want = b.proc_env(1, "127.0.0.1:1234", **kw)
        assert set(got) == set(want)
        assert {k: v for k, v in got.items() if k != "PYTHONPATH"} == \
            {k: v for k, v in want.items() if k != "PYTHONPATH"}
        assert got["PYTHONPATH"] == REPO + os.pathsep + "/elsewhere"


@pytest.mark.parametrize("cards,nproc,devices,want", [
    (1, 2, None, ["0", "0"]),        # two ranks share the one card
    (4, 2, None, [None, None]),      # a card a rank: NCCL's own lanes
    (0, 2, None, [None, None]),      # the CPU
    (8, 3, "5,6", ["5", "6", "5"]),  # --devices names each rank's card
])
def test_device_env_for_ranks_that_share_a_card(monkeypatch, cards, nproc,
                                                devices, want):
    """``LOCAL_WORLD_SIZE`` always; ``FLAGS_selected_gpus`` when the host's
    ranks outnumber its cards (or ``--devices``), which
    `init_parallel_env` reads as a named card, so the ranks that share it
    take NCCL's socket transport (`env.one_card_nccl_env`)."""
    monkeypatch.setattr(ctl, "_card_count", lambda: cards)
    argv = ["--nproc_per_node", str(nproc)] + \
        (["--devices", devices] if devices else []) + ["w.py"]
    c = CollectiveController(Context(args=parse_args(argv)))
    for i in range(nproc):
        env = c._device_env(i, nproc)
        assert env["LOCAL_WORLD_SIZE"] == str(nproc)
        assert env.get("FLAGS_selected_gpus") == want[i]


def test_launch_runs_workers(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(
        "import os, sys\n"
        "rank = os.environ['PADDLE_TRAINER_ID']\n"
        "open(os.path.join(os.path.dirname(__file__),\n"
        "     f'out.{rank}'), 'w').write(os.environ['LOCAL_WORLD_SIZE'])\n")
    args = parse_args(["--nproc_per_node", "2", str(script)])
    code = CollectiveController(Context(args=args)).run()
    assert code == 0
    assert (tmp_path / "out.0").read_text() == "2"
    assert (tmp_path / "out.1").exists()


def test_launch_propagates_failure(tmp_path):
    script = tmp_path / "bad.py"
    script.write_text("import sys; sys.exit(3)\n")
    args = parse_args(["--nproc_per_node", "2", str(script)])
    code = CollectiveController(Context(args=args)).run()
    assert code == 3


def test_elastic_manager_watch(tmp_path):
    store = FileStore(str(tmp_path / "store"), ttl=5)
    m1 = ElasticManager(node_id="0", np=2, store=store,
                        heartbeat_interval=0.1)
    m1.start()
    assert m1.watch() == ElasticStatus.HOLD
    # a second node joins: a membership change, RESTART (a scale event)
    store.register("1")
    status = m1.watch()
    assert status == ElasticStatus.RESTART
    assert m1.exit_code(status) == ELASTIC_EXIT_CODE
    assert m1.watch() == ElasticStatus.HOLD
    m1.stop()
    assert "0" not in store.alive_nodes()


def test_spawn_single_process():
    result = {}

    def fn(val):
        result["got"] = val

    dist.spawn_mod.spawn(fn, args=(42,), nprocs=1)
    assert result["got"] == 42


def test_hot_spare_advertisement_raises_only_with_its_flag(tmp_path):
    from paddle_tpu_torch.utils.flags import set_flags
    c = CollectiveController(Context(args=parse_args(
        ["--nproc_per_node", "2", "--log_dir", str(tmp_path), "w.py"])))
    c._advertise_hot_spare(2)            # off: nothing to advertise
    set_flags({"FLAGS_hot_spare": True})
    try:
        with pytest.raises(NotImplementedError, match="ROADMAP A8"):
            c._advertise_hot_spare(2)
    finally:
        set_flags({"FLAGS_hot_spare": False})


@pytest.mark.parametrize("armed", [True, False])
def test_init_parallel_env_reads_the_launch_contract(monkeypatch, tmp_path,
                                                     armed):
    """A launched rank that shares the one card: ``FLAGS_selected_gpus``
    names its card (so NCCL's socket lane is set up), and with the
    guardian's store exported `init_parallel_env` keeps torch's NCCL
    error handling out (``TORCH_NCCL_ASYNC_ERROR_HANDLING=0``), passes
    the group a timeout above the guardian's and arms the trap; without
    it, none of these."""
    import sys
    import torch
    from paddle_tpu_torch.distributed import env, watchdog
    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: None)
    monkeypatch.setattr(env.dist, "init_process_group",
                        lambda *a, **k: calls.append((a, k)))
    monkeypatch.setattr(env, "_state", dict(env._state))
    monkeypatch.setattr(sys, "excepthook", sys.excepthook)
    monkeypatch.setattr(watchdog, "_TRAP_HOOKED", False)
    for var in [k for k in os.environ
                if k.startswith(("NCCL_", "TORCH_NCCL_", "PADDLE_",
                                 "LOCAL_"))]:
        monkeypatch.delenv(var)
    contract = {"FLAGS_selected_gpus": "0", "LOCAL_WORLD_SIZE": "2",
                "PADDLE_TRAINER_ID": "1", "PADDLE_TRAINERS_NUM": "2"}
    if armed:
        contract["PADDLE_GUARDIAN_DIR"] = str(tmp_path)
    for var, val in contract.items():
        monkeypatch.setenv(var, val)
    watchdog.reset()
    try:
        env.init_parallel_env(init_method="tcp://localhost:1")
        (args, kw), = calls
        assert args == ("nccl",) and str(kw["device_id"]) == "cuda:0"
        assert os.environ["NCCL_HOSTID"] == env.one_card_nccl_env(1)[
            "NCCL_HOSTID"]
        if armed:
            assert os.environ["TORCH_NCCL_ASYNC_ERROR_HANDLING"] == "0"
            assert kw["timeout"].total_seconds() == 600.0
            trap = watchdog.get_watchdog().trap
            assert (trap.rank, trap.job) == (1, "default")
        else:
            assert "TORCH_NCCL_ASYNC_ERROR_HANDLING" not in os.environ
            assert "timeout" not in kw
            assert watchdog._WATCHDOG is None
    finally:
        watchdog.reset()
        # what init_parallel_env set (monkeypatch restores what it removed)
        for var in [*env.one_card_nccl_env(1),
                    "TORCH_NCCL_ASYNC_ERROR_HANDLING"]:
            os.environ.pop(var, None)
