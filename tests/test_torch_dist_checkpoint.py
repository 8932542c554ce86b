"""The port's distributed checkpoint functions
(paddle_tpu_torch/distributed/checkpoint.py) on the CPU, against the JAX
package's (paddle_tpu/distributed/checkpoint.py).

- `save_state_dict` / `load_state_dict`, `save_checkpoint` /
  `restore_latest` (retention, a torn newest), `DistributedSaver` and
  `save/load_model_and_optimizer` round trip bit for bit, number leaves
  as their own types; a two-rank save (ranks in threads) loads on a
  world of one.
- `validate_layout` raises JAX's errors, word for word, on the same
  layout dicts.
- A checkpoint JAX writes through orbax is refused with its format
  named (the port's lane is the pickle shards; ROADMAP Queue C).
"""
import os
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed import checkpoint as jck
from paddle_tpu_torch.distributed import checkpoint as pck
from paddle_tpu_torch.distributed.reshard import (LayoutError,
                                                  LayoutMismatchError,
                                                  read_layout)
from paddle_tpu_torch.framework.checkpoint_manager import write_manifest
from paddle_tpu_torch.nn import Linear
from paddle_tpu_torch.optimizer import AdamW

CPU = "cpu"


def _state(seed):
    g = torch.Generator().manual_seed(seed)
    return {"model": {"w": torch.randn(5, 3, generator=g),
                      "h": torch.randn(4, generator=g).bfloat16()},
            "optimizer": {"moment1.0": torch.randn(5, 3, generator=g),
                          "step_count": 7, "lr": 0.5},
            "tags": [torch.arange(3), 2]}


def _assert_equal(got, want):
    if torch.is_tensor(want):
        assert got.dtype == want.dtype and torch.equal(got, want)
    elif isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _assert_equal(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        for a, b in zip(got, want):
            _assert_equal(a, b)
    else:
        assert type(got) is type(want) and got == want


def test_state_dict_round_trip_in_place(tmp_path):
    saved = _state(0)
    path = pck.save_state_dict(saved, str(tmp_path / "sd"))
    target = _state(1)
    live = target["model"]["w"]
    pck.load_state_dict(target, path)
    _assert_equal(target, saved)
    assert target["model"]["w"] is live            # copied in place
    layout = read_layout(path)
    assert layout["format"] == "pickle-shards"
    assert layout["arrays"]["optimizer.step_count"]["global_shape"] == []
    assert layout["arrays"]["model.h"]["dtype"] == "bfloat16"


def test_two_ranks_save_one_rank_loads(tmp_path):
    saved = _state(2)
    path = str(tmp_path / "sd")
    errs = []

    def rank(r):
        try:
            pck.save_state_dict(saved, path, process_group=SimpleNamespace(
                rank=r, nranks=2))
        except BaseException as e:  # noqa: BLE001 — asserted below
            errs.append(e)
    ts = [threading.Thread(target=rank, args=(r,)) for r in range(2)]
    [t.start() for t in ts]
    [t.join(60) for t in ts]
    assert not errs and read_layout(path)["world_size"] == 2
    target = _state(3)
    pck.load_state_dict(target, path)
    _assert_equal(target, saved)


def test_save_checkpoint_retention_and_restore_latest(tmp_path):
    root = str(tmp_path / "root")
    for step in range(3):
        st = _state(10 + step)
        pck.save_checkpoint(st, root, step, max_to_keep=2)
    assert sorted(os.listdir(root)) == ["ckpt-00000001", "ckpt-00000002"]
    os.remove(os.path.join(root, "ckpt-00000002", "manifest.json"))
    target = _state(0)
    assert pck.restore_latest(target, root) == 1
    _assert_equal(target, _state(11))
    assert pck.restore_latest(_state(0), str(tmp_path / "none")) is None


def test_saver_and_model_optimizer_round_trip(tmp_path):
    def build():
        m = torch.nn.Sequential(Linear(4, 6, device=CPU), torch.nn.Tanh(),
                                Linear(6, 2, device=CPU))
        return m, AdamW(1e-2, parameters=m.parameters())
    m, o = build()
    x = torch.randn(3, 4, generator=torch.Generator().manual_seed(0))
    m(x).square().mean().backward()
    o.step()
    o.clear_grad()
    path = pck.save_model_and_optimizer(m, o, str(tmp_path / "mo"))
    m2, o2 = build()
    pck.load_model_and_optimizer(m2, o2, path)
    _assert_equal(m2.state_dict(), m.state_dict())
    _assert_equal(o2.state_dict(), o.state_dict())
    saver = pck.DistributedSaver()
    saver.save(str(tmp_path / "ds"), state_dict={"w": torch.ones(2, 2)})
    got = {"w": torch.zeros(2, 2)}
    saver.load(str(tmp_path / "ds"), state_dict=got)
    assert torch.equal(got["w"], torch.ones(2, 2))


LAYOUT = {"layout_version": 1, "format": "pickle-shards", "world_size": 4,
          "mesh": {"axes": ["dp", "mp"], "shape": [2, 2]},
          "arrays": {"a": {"global_shape": [4, 6], "dtype": "float32",
                           "partition": ["dp", "mp"]},
                     "b": {"global_shape": [3], "dtype": "float32",
                           "partition": [None]}}}

CASES = [
    {"a": (4, 6), "b": (3,)},                    # matches
    {"a": (4, 6)},                               # unexpected key b
    {"a": (4, 6), "b": (3,), "c": (1,)},         # missing key c
    {"a": (4, 5), "b": (3,)},                    # shape mismatch
]


@pytest.mark.parametrize("case", range(len(CASES)))
def test_validate_layout_raises_jax_errors(tmp_path, case):
    path = str(tmp_path / "ck")
    os.makedirs(path)
    write_manifest(path, files=[], layout=LAYOUT)
    targets = {k: np.zeros(s, np.float32) for k, s in CASES[case].items()}

    def outcome(fn):
        try:
            return ("ok", fn(path, targets) is not None)
        except Exception as e:  # noqa: BLE001 — compared below
            return (type(e).__name__, str(e))
    assert outcome(pck.validate_layout) == outcome(jck.validate_layout)
    # no layout passes in both
    bare = str(tmp_path / "bare")
    os.makedirs(bare)
    write_manifest(bare, files=[])
    assert pck.validate_layout(bare, targets) is None
    assert jck.validate_layout(bare, targets) is None


def test_jax_orbax_checkpoint_refused_with_its_format(tmp_path):
    path = str(tmp_path / "orbax")
    jck.save_state_dict({"w": paddle.to_tensor(np.ones((2, 3), "float32"))},
                        path)
    assert read_layout(path)["format"] == "orbax"
    with pytest.raises(LayoutError, match="orbax"):
        pck.load_state_dict({"w": torch.zeros(2, 3)}, path)
    root = str(tmp_path / "root")
    jck.save_checkpoint({"w": paddle.to_tensor(np.ones((2, 3), "float32"))},
                        root, 0)
    with pytest.raises(LayoutError, match="orbax"):
        pck.restore_latest({"w": torch.zeros(2, 3)}, root)
    # a mismatch is still the mismatch error, before the format
    with pytest.raises(LayoutMismatchError):
        pck.load_state_dict({"w": torch.zeros(2, 2)}, path)
