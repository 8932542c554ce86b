"""Sharded checkpoints and the elastic reshard through the port's hapi
``fit`` (paddle_tpu_torch/hapi/model.py, callbacks.py) on the CPU, and
the resize planner (paddle_tpu_torch/distributed/fleet/elastic.py)
against the JAX package's.

- ``fit`` on two gloo ranks (a tiny GPT, dp 2) with a ModelCheckpoint
  writes a shard file a rank, and the layout section equals the one the
  JAX package's ModelCheckpoint writes for the same model (apart from
  the nonce); a world of one resumes it, resharded, to the saved state
  bit for bit.
- At dp 1 × mp 2 (ParallelGPTForCausalLM over the hybrid topology) each
  rank writes its own part of each split tensor, partition "mp", and the
  fused q/k/v projection whole; a world of one resumes the parameters
  and the moments equal to the gathered shards
  (`convert.gather_paddle_tpu_state` and its optimizer twin) bit for
  bit, and its next epoch's losses equal a world-one run started from
  that gathered state bit for bit.
- `plan_topology`, `resized_worlds`, `reshard_mesh_for` equal JAX's; a
  model description raises (its planner is not ported).
"""
import copy
import importlib
import os
import sys
import threading

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed.fleet import elastic as jel
from paddle_tpu_torch import convert
from paddle_tpu_torch.distributed.fleet import elastic as pel
from paddle_tpu_torch.distributed.reshard import MeshSpec, read_layout
from paddle_tpu_torch.framework.checkpoint_manager import scan_steps
from paddle_tpu_torch.hapi import Model
from paddle_tpu_torch.models import ParallelGPTForCausalLM, gpt_config
from paddle_tpu_torch.nn import CrossEntropyLoss
from paddle_tpu_torch.optimizer import AdamW

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_dist_worker import run_ranks  # noqa: E402

jrs = importlib.import_module("paddle_tpu.distributed.reshard")
CFG = dict(num_layers=2, hidden_size=32, num_heads=4, vocab_size=128,
           max_seq_len=16)
EPOCHS, BATCH = 2, 2


def _rows(n=8, seed=0):
    ids = np.random.default_rng(seed).integers(0, 128, (n, 17))
    return ids[:, :-1], ids[:, 1:]


class _Rows:
    def __init__(self, x, y):
        self.x, self.y = x, y

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        return self.x[i], self.y[i]


def _world1_model():
    net = ParallelGPTForCausalLM(gpt_config("gpt2-124m", **CFG),
                                 device="cpu", seed=0)
    opt = AdamW(1e-3, parameters=net.parameters())
    return Model(net).prepare(opt, CrossEntropyLoss()), net, opt


def _strip(layout):
    layout = copy.deepcopy(layout)
    nonce = layout.pop("nonce")
    layout["rank_files"] = {r: f.replace(nonce, "N")
                            for r, f in layout["rank_files"].items()}
    return layout


def _newest(root):
    return scan_steps(root)[0][1]


def _assert_state(got, want):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        g = got[k]
        if torch.is_tensor(g):
            g = g.detach().numpy()
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(np.asarray(g), v, err_msg=k)
        elif isinstance(v, dict):
            assert g == v, k
        else:
            assert g == v, k


@pytest.fixture(scope="module")
def dp2(tmp_path_factory):
    d = tmp_path_factory.mktemp("dp2")
    x, y = _rows()
    outs = run_ranks(2, "sharded_fit", d, {
        "dp": 2, "mp": 1, "cfg": CFG, "save_dir": str(d / "ck"), "x": x,
        "y": y, "batch": BATCH // 2, "epochs": EPOCHS})
    return d / "ck", outs


def test_two_rank_fit_layout_equals_jax(dp2):
    root, _ = dp2
    path = _newest(str(root))
    port = read_layout(path)
    assert port["world_size"] == 2 and port["mesh"] == {
        "axes": ["dp"], "shape": [2]}
    # JAX's ModelCheckpoint state of the same model, saved by JAX's
    # ShardedCheckpointer over the same mesh (ranks in threads)
    from paddle_tpu.hapi.callbacks import ModelCheckpoint as JaxCkpt
    from paddle_tpu.models import GPTForCausalLM as JaxGPT
    from paddle_tpu.models.gpt import GPTConfig
    paddle.seed(0)
    jnet = JaxGPT(GPTConfig(vocab_size=128, hidden_size=32, num_layers=2,
                            num_heads=4, max_seq_len=16))
    jopt = paddle.optimizer.AdamW(1e-3, parameters=jnet.parameters())
    jmodel = paddle.Model(jnet)
    jmodel.prepare(jopt, paddle.nn.CrossEntropyLoss())
    x, y = _rows()
    jmodel.train_batch([paddle.to_tensor(x[:2])], [paddle.to_tensor(y[:2])])
    cb = JaxCkpt(save_dir=str(root.parent / "jax"))
    cb.set_model(jmodel)
    state = cb._state(EPOCHS)
    mesh = jrs.MeshSpec(("dp",), (2,))
    errs = []

    def rank(r):
        try:
            jrs.ShardedCheckpointer(str(root.parent / "jax"), mesh, r).save(
                state, step=0)
        except BaseException as e:  # noqa: BLE001 — asserted below
            errs.append(e)
    ts = [threading.Thread(target=rank, args=(r,)) for r in range(2)]
    [t.start() for t in ts]
    [t.join(60) for t in ts]
    assert not errs, errs
    jax = jrs.read_layout(str(root.parent / "jax" / "ckpt-00000000"))
    assert _strip(port) == _strip(jax)


def test_world_one_resumes_the_dp2_checkpoint(dp2):
    root, outs = dp2
    model, net, opt = _world1_model()
    x, y = _rows()
    hist = model.fit(_Rows(x, y), batch_size=BATCH, epochs=EPOCHS,
                     shuffle=False, verbose=0, resume=str(root))
    assert hist["loss"] == []                 # resumed past the last epoch
    rep = model.last_resume["report"]
    assert model.last_resume["source"] == "disk"
    assert not rep["fast_path"] and rep["arrays_resharded"] > 0
    assert rep["saved_mesh"] == "MeshSpec(dp=2)" and \
        rep["target_mesh"] == "MeshSpec(dp=1)"
    _assert_state(net.state_dict(), outs[0]["state"])
    _assert_state(opt.state_dict(), outs[0]["opt"])
    # the dp replicas were equal: rank 1's copy is the same state
    _assert_state(net.state_dict(), outs[1]["state"])


def test_mp2_checkpoint_resumes_at_world_one(tmp_path):
    x, y = _rows(seed=1)
    root = tmp_path / "ck"
    outs = run_ranks(2, "sharded_fit", tmp_path, {
        "dp": 1, "mp": 2, "cfg": CFG, "save_dir": str(root), "x": x,
        "y": y, "batch": BATCH, "epochs": EPOCHS})
    layout = read_layout(_newest(str(root)))
    assert layout["mesh"] == {"axes": ["mp"], "shape": [2]}
    parts = {k: m["partition"] for k, m in layout["arrays"].items()}
    split = [k for k, p in parts.items() if "mp" in p]
    assert any(k.startswith("model.") for k in split)
    assert any(k.startswith("optimizer.moment1.") for k in split)
    qkv = [k for k in parts if "qkv" in k]
    assert qkv and all(parts[k] == [None] * len(parts[k]) for k in qkv)
    for k in split:
        assert layout["arrays"][k]["global_shape"] == \
            list(np.shape(outs[0]["global"].get(k[len("model."):])
                          if k.startswith("model.") else
                          outs[0]["global_opt"][k[len("optimizer."):]]))
    # world one: the gathered shards, bit for bit
    model, net, opt = _world1_model()
    model.fit(_Rows(x, y), batch_size=BATCH, epochs=EPOCHS, shuffle=False,
              verbose=0, resume=str(root))
    assert model.last_resume["report"]["arrays_resharded"] > 0
    _assert_state(net.state_dict(), outs[0]["global"])
    _assert_state(opt.state_dict(), outs[0]["global_opt"])
    # the next epoch against a world-one run started from the gathered state
    got = model.fit(_Rows(x, y), batch_size=BATCH, epochs=EPOCHS + 1,
                    shuffle=False, verbose=0, log_freq=1, resume=str(root))
    ref_model, ref_net, ref_opt = _world1_model()
    convert.load_paddle_tpu_state(ref_net, outs[0]["global"])
    convert.load_paddle_tpu_optimizer_state(ref_opt, outs[0]["global_opt"])
    want = ref_model.fit(_Rows(x, y), batch_size=BATCH, epochs=1,
                         shuffle=False, verbose=0, log_freq=1)
    assert got["loss"] == want["loss"] and len(want["loss"]) == 1
    for k, v in ref_net.state_dict().items():
        assert torch.equal(net.state_dict()[k], v), k


# ---------------------------------------------------------------------------
# the planner
# ---------------------------------------------------------------------------

def test_planner_equals_jax(monkeypatch):
    for n in (1, 2, 3, 8):
        assert pel.plan_topology(n) == jel.plan_topology(n)
        got, want = pel.reshard_mesh_for(n), jel.reshard_mesh_for(n)
        assert (got.axes, got.shape) == (want.axes, want.shape)
    assert pel.resized_worlds() is None and jel.resized_worlds() is None
    for raw in ("4:2", "2:1", "x:1", "3"):
        monkeypatch.setenv("PADDLE_ELASTIC_RESIZED", raw)
        assert pel.resized_worlds() == jel.resized_worlds()
    monkeypatch.setenv("PADDLE_RESHARD_MESH",
                       '{"axes": ["dp", "mp"], "shape": [2, 2]}')
    got, want = pel.reshard_mesh_for(1), jel.reshard_mesh_for(1)
    assert isinstance(got, MeshSpec) and (got.axes, got.shape) == \
        (want.axes, want.shape) == (("dp", "mp"), (2, 2))
    # the hapi resume reads the same override
    model, _, _ = _world1_model()
    assert model._resume_target_mesh() == got
    with pytest.raises(NotImplementedError, match="ROADMAP A8"):
        pel.plan_topology(4, model_desc={"params": 1e9})
    monkeypatch.delenv("PADDLE_RESHARD_MESH")
    with pytest.raises(NotImplementedError, match="ROADMAP A8"):
        pel.reshard_mesh_for(4, model_desc={"params": 1e9})
