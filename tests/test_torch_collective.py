"""The port's collectives (paddle_tpu_torch/distributed/collective.py) on 2
and 4 gloo ranks (spawned processes, `_torch_dist_worker`), held against
numpy and the JAX package's reduction rule (``_np_reduce``: the mean of
integers is float32); the world of one, the registry's counters and
`init_parallel_env`'s refusals in process."""
import numpy as np
import pytest
import torch

from paddle_tpu.distributed.collective import _np_reduce

from paddle_tpu_torch.distributed import collective as C
from paddle_tpu_torch.distributed import env
from paddle_tpu_torch.observability import registry

from _torch_dist_worker import run_ranks

_RESULTS = {}


@pytest.fixture(params=[2, 4], ids=["2ranks", "4ranks"])
def world(request, tmp_path_factory):
    """(world size, each rank's results) of the collectives case, run
    once per world size."""
    w = request.param
    if w not in _RESULTS:
        _RESULTS[w] = run_ranks(w, "collectives",
                                tmp_path_factory.mktemp(f"coll{w}"))
    return w, _RESULTS[w]


def _base(rank):
    return np.arange(6, dtype=np.float32).reshape(2, 3) + 10 * rank


@pytest.mark.parametrize("op", ["sum", "max", "min", "prod", "avg"])
def test_all_reduce_ops_against_numpy(world, op):
    w, outs = world
    want = _np_reduce(op, np.stack([_base(r) for r in range(w)]))
    for res in outs:
        np.testing.assert_allclose(res[f"all_reduce_{op}"], want, rtol=1e-6)
        assert res[f"all_reduce_{op}"].dtype == want.dtype


def test_avg_of_integers_is_float32_as_jax(world):
    w, outs = world
    stack = np.stack([np.arange(4, dtype=np.int64) + r for r in range(w)])
    want = _np_reduce("avg", stack)
    for dtype, got in (res["avg_int"] for res in outs):
        assert dtype == torch.float32 and want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_all_gather_parts_list_and_concat(world):
    w, outs = world
    parts = [_base(r) for r in range(w)]
    for res in outs:
        for got, want in zip(res["all_gather"], parts):
            np.testing.assert_array_equal(got, want)
        assert res["all_gather_list"] == w
        np.testing.assert_array_equal(res["all_gather_concat"],
                                      np.concatenate(parts, axis=1))


def test_broadcast_reduce_and_scatter(world):
    w, outs = world
    for r, res in enumerate(outs):
        np.testing.assert_array_equal(res["broadcast"], _base(w - 1))
        # only dst 0 changes; the others keep their tensor
        want = sum(_base(i) for i in range(w)) if r == 0 else _base(r)
        np.testing.assert_array_equal(res["reduce"], want)
        np.testing.assert_array_equal(res["scatter"], np.full(3, 100.0 + r))


def test_reduce_scatter_and_all_to_all(world):
    w, outs = world
    for r, res in enumerate(outs):
        want = sum(float(i * w + r) for i in range(w))
        np.testing.assert_array_equal(res["reduce_scatter"], np.full(3, want))
        full = sum(np.arange(w * 2, dtype=np.float32) + i for i in range(w))
        np.testing.assert_array_equal(res["reduce_scatter_concat"],
                                      full[2 * r:2 * r + 2])
        for j, got in enumerate(res["all_to_all"]):
            np.testing.assert_array_equal(got, np.full(2, 10.0 * j + r))


def test_point_to_point(world):
    w, outs = world
    for r, res in enumerate(outs):
        np.testing.assert_array_equal(res["ring"], np.full(3, (r - 1) % w))
    np.testing.assert_array_equal(outs[1]["send_recv"], np.full(2, 7.0))


def test_subgroups(world):
    """`new_group` over the even ranks: its members reduce among
    themselves; an outsider's call raises the membership error (a group of
    one, as in JAX, returns at once)."""
    w, outs = world
    evens = [r for r in range(w) if r % 2 == 0]
    for r, res in enumerate(outs):
        if r % 2 == 0:
            assert res["group_rank"] == evens.index(r)
            np.testing.assert_array_equal(res["even_sum"],
                                          np.full(2, float(sum(evens))))
        else:
            assert res["group_rank"] == -1
            if len(evens) > 1:
                assert "is not a member" in res["outsider"]


def test_collective_calls_counter(world):
    """``dist.collective_calls{op}``: one a call (the ring's send and recv
    each once, recv twice with the pair), and the bytes of a broadcast."""
    _, outs = world
    for r, res in enumerate(outs):
        calls = res["calls"]
        assert calls["all_reduce"] == 7 and calls["all_gather"] == 3
        assert calls["reduce_scatter"] == 2 and calls["all_to_all"] == 1
        assert calls["broadcast"] == calls["reduce"] == \
            calls["scatter"] == calls["barrier"] == 1
        assert calls["send"] == 1 + (r == 0)
        assert calls["recv"] == 1 + (r == 1)
        assert res["bytes"] == 24


def test_world_of_one_in_process():
    """Without a process group every collective is the world of one's
    (JAX's degenerate lane): tensors as they are, the mean of integers
    float32, send/recv through the queue, the counter moving."""
    calls = registry.counter("dist.collective_calls", "",
                             labelnames=("op",))
    before = calls.labels(op="all_reduce").value
    t = torch.arange(4.0)
    for op in ("sum", "max", "min", "prod", "avg"):
        C.all_reduce(t, op=op)
    assert torch.equal(t, torch.arange(4.0))
    assert calls.labels(op="all_reduce").value == before + 5
    i = torch.arange(3)
    C.all_reduce(i, op=C.ReduceOp.AVG)
    assert i.dtype == torch.float32
    assert torch.equal(C.all_gather(None, t)[0], t)
    C.broadcast(t)
    C.reduce(t)
    C.barrier()
    C.p2p_reset()
    C.send(torch.full((2,), 5.0), dst=0)
    assert not C.p2p_drained()
    got = torch.zeros(2)
    C.recv(got, src=0)
    assert C.p2p_drained() and torch.equal(got, torch.full((2,), 5.0))
    assert env.get_rank() == 0 and env.get_world_size() == 1
    assert C.get_group().ranks == [0]


def test_init_parallel_env_refusals(monkeypatch):
    """nccl without CUDA raises (the caller asks for gloo); a local rank
    without a card of its own raises unless ``device`` is named; a world
    above one needs a master.  Nothing falls back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="backend='gloo'"):
        env.init_parallel_env()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="no card of its own"):
        env.init_parallel_env(world_size=2, rank=1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for var in ("PADDLE_MASTER", "COORDINATOR_ADDRESS", "MASTER_ADDR"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError, match="needs a master"):
        env.init_parallel_env(backend="gloo", world_size=2, rank=0)
    assert not env.is_initialized()


def test_one_card_nccl_env():
    """Ranks that share a card get their own NCCL host id and the socket
    transport on the loopback interface."""
    a, b = env.one_card_nccl_env(0), env.one_card_nccl_env(1)
    assert a["NCCL_HOSTID"] != b["NCCL_HOSTID"]
    assert a["NCCL_SOCKET_IFNAME"] == "lo" and a["NCCL_IB_DISABLE"] == "1"


@pytest.mark.parametrize("world,cards,local,device,shares", [
    (16, 8, {"LOCAL_RANK": "3"}, None, False),       # 2 hosts x 8 cards
    (16, 8, {"LOCAL_RANK": "3", "LOCAL_WORLD_SIZE": "8"}, "cuda:3", False),
    (16, 8, {"PADDLE_LOCAL_SIZE": "8"}, "cuda:3", False),
    (8, 8, {}, "cuda:3", False),                     # a rank a card
    (4, 8, {}, "cuda:3", False),                     # fewer ranks than cards
    (16, 8, {"LOCAL_WORLD_SIZE": "16"}, "cuda:0", True),  # 2 ranks a card
    (4, 1, {}, "cuda:0", True)],                     # one card, one host
    ids=["multihost-default", "multihost-named", "multihost-paddle",
         "rank-a-card", "fewer-ranks", "two-a-card", "one-card"])
def test_nccl_env_only_for_ranks_that_share_a_card(monkeypatch, world, cards,
                                                   local, device, shares):
    """`init_parallel_env` sets `one_card_nccl_env` only when the caller
    names ``device`` and this host runs more ranks than it has cards: a
    job over several hosts keeps NCCL's own transports (its world exceeds
    one host's cards)."""
    import os
    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: None)
    monkeypatch.setattr(env.dist, "init_process_group",
                        lambda *a, **k: calls.append((a, k)))
    monkeypatch.setattr(env, "_state", dict(env._state))
    for var in ("LOCAL_RANK", "PADDLE_LOCAL_RANK", "LOCAL_WORLD_SIZE",
                "PADDLE_LOCAL_SIZE"):
        monkeypatch.delenv(var, raising=False)
    for var, val in local.items():
        monkeypatch.setenv(var, val)
    saved = dict(os.environ)
    try:
        for var in [k for k in os.environ if k.startswith("NCCL_")]:
            del os.environ[var]
        env.init_parallel_env(device=device, world_size=world, rank=3,
                              init_method="tcp://localhost:1")
        set_here = sorted(k for k in os.environ if k.startswith("NCCL_"))
    finally:
        os.environ.clear()
        os.environ.update(saved)
    assert len(calls) == 1 and calls[0][1]["device_id"].type == "cuda"
    assert set_here == (sorted(env.one_card_nccl_env(3)) if shares else [])
