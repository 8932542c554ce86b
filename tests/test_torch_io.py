"""The port's `save` / `load` and checkpoint manager
(paddle_tpu_torch/framework/io.py, checkpoint_manager.py) on the CPU,
against the JAX package's.

- `save` / `load`: nested state with fp32, bf16, fp16, int and fp8
  tensors round trips bit for bit; a write that raises leaves no
  temporary; a file `paddle_tpu.save` wrote (bf16 arrays among them)
  loads to equal tensors, also in a child process where ``jax`` and
  ``paddle_tpu`` cannot be imported.
- `CheckpointManager`: the JAX package's single-process cases, under the
  same names (tests/test_fault_tolerance.py's atomic save, manager,
  retention, async-error and fault-spec cases; tests/test_checkpoint.py's
  round trips of model, optimizer and scalar leaves, and a loaded state
  that outlives a compiled step), plus the anchor surviving retention,
  ``validate_finite`` refusing a NaN, a child killed in the middle of a
  save, and a directory the JAX package's manager wrote restored by the
  port's.  Values restored are compared exactly: nothing is computed.
"""
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.framework import checkpoint_manager as jcm
import paddle_tpu_torch as pt
from paddle_tpu_torch.framework import CompiledTrainStep
from paddle_tpu_torch.framework.checkpoint_manager import (
    CheckpointError, CheckpointManager, NonFiniteCheckpointError,
    scan_steps, step_dir_name, validate_finite_state, verify_checkpoint)
from paddle_tpu_torch.nn import Linear
from paddle_tpu_torch.optimizer import SGD, AdamW
from paddle_tpu_torch.utils import fault_injection, flags, monitor
from paddle_tpu_torch.utils.fault_injection import (FaultSpecError,
                                                    InjectedFault)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_fault_flag():
    yield
    flags.set_flags({"FLAGS_fault_inject": ""})


def _state(v=1.0):
    return {"w": torch.full((4, 4), v, dtype=torch.float32),
            "step": int(v)}


def _mgr(root, **kw):
    return CheckpointManager(str(root), map_location="cpu", **kw)


def _bits(t):
    if t.dtype in (torch.bfloat16, torch.float16):
        return t.view(torch.int16)
    if t.dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
        return t.view(torch.uint8)
    return t


def _assert_same(a, b):
    assert type(a) is type(b), (type(a), type(b))
    if torch.is_tensor(a):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(_bits(a), _bits(b))
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    else:
        assert a == b


# ---- save / load ----

def test_save_load_round_trips_every_type_bit_for_bit(tmp_path):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(3, 5, generator=g)
    state = {"fp32": x, "nested": {"bf16": x.bfloat16(),
                                   "fp16": [x.half(), (x * 3).half()],
                                   "fp8": (x.to(torch.float8_e4m3fn),
                                           x.to(torch.float8_e5m2))},
             "int": torch.arange(7, dtype=torch.int64),
             "i32": torch.arange(4, dtype=torch.int32),
             "scalar": torch.tensor(2.5), "n": 3, "s": "text", "none": None}
    path = str(tmp_path / "a" / "state.pkl")
    pt.save(state, path)
    _assert_same(pt.load(path, map_location="cpu"), state)


def test_save_keeps_trainable_and_param_name(tmp_path):
    lin = Linear(3, 2, device="cpu")
    lin.weight.param_name = "fc.w"
    pt.save({"w": lin.weight, "b": lin.bias.detach()}, str(tmp_path / "p"))
    out = pt.load(str(tmp_path / "p"), map_location="cpu")
    assert out["w"].requires_grad and not out["b"].requires_grad
    from paddle_tpu_torch.framework import io as pio
    import pickle
    with open(tmp_path / "p", "rb") as f:
        raw = pickle.load(f)
    assert isinstance(raw["w"], pio._TensorState) and raw["w"].name == "fc.w"


def test_save_is_atomic_under_injected_torn_write(tmp_path):
    path = str(tmp_path / "m.pdparams")
    pt.save(_state(1.0), path)
    flags.set_flags(
        {"FLAGS_fault_inject": "ckpt_write:after_bytes=16,mode=raise"})
    with pytest.raises(InjectedFault):
        pt.save(_state(2.0), path)
    flags.set_flags({"FLAGS_fault_inject": ""})
    loaded = pt.load(path, map_location="cpu")
    assert torch.equal(loaded["w"], torch.full((4, 4), 1.0))
    assert [n for n in os.listdir(tmp_path) if ".tmp." in n] == []


def _jax_state():
    rng = np.random.default_rng(3)
    w = paddle.to_tensor(rng.standard_normal((4, 6)).astype(np.float32))
    return {"model": {"w": w, "w_bf16": w.astype("bfloat16"),
                      "ids": paddle.to_tensor(np.arange(5, dtype=np.int32))},
            "opt": {"step_count": 4, "lr": [0.5, 0.25]}, "epoch": 2}


def _check_jax_state(out, jstate):
    for k, v in jstate["model"].items():
        want = np.asarray(v._data_)
        got = out["model"][k]
        if k == "w_bf16":
            assert got.dtype == torch.bfloat16
            np.testing.assert_array_equal(got.float().numpy(),
                                          want.astype(np.float32))
        else:
            np.testing.assert_array_equal(got.numpy(), want)
    assert out["opt"] == jstate["opt"] and out["epoch"] == 2


def test_load_reads_a_jax_file(tmp_path):
    jstate = _jax_state()
    path = str(tmp_path / "j.pdparams")
    paddle.save(jstate, path)
    _check_jax_state(pt.load(path, map_location="cpu"), jstate)


def test_load_of_a_jax_file_imports_neither_jax_nor_the_jax_package(
        tmp_path):
    jstate = _jax_state()
    path = str(tmp_path / "j.pdparams")
    paddle.save(jstate, path)
    code = textwrap.dedent(f"""
        import sys
        sys.modules["jax"] = None
        sys.modules["paddle_tpu"] = None
        sys.modules["ml_dtypes"] = None
        import paddle_tpu_torch as pt
        out = pt.load({path!r}, map_location="cpu")
        w = out["model"]["w_bf16"]
        print(w.dtype, float(w.float().sum()), out["opt"]["step_count"])
    """)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=REPO))
    assert r.returncode == 0, r.stderr
    want = float(np.asarray(jstate["model"]["w_bf16"]._data_)
                 .astype(np.float32).sum())
    dtype, total, steps = r.stdout.split()
    assert dtype == "torch.bfloat16" and int(steps) == 4
    assert float(total) == pytest.approx(want, rel=1e-6)


def test_load_refuses_other_jax_package_globals(tmp_path):
    import pickle
    path = str(tmp_path / "bad.pkl")
    with open(path, "wb") as f:
        pickle.dump({"x": jcm.CheckpointError("boom")}, f)
    with pytest.raises(pickle.UnpicklingError, match="refusing"):
        pt.load(path, map_location="cpu")


# ---- CheckpointManager: the JAX package's single-process cases ----

def test_manager_save_restore_roundtrip(tmp_path):
    mgr = _mgr(tmp_path)
    mgr.save(_state(1.0), step=0)
    mgr.save(_state(2.0), step=1)
    state, step = mgr.restore_latest()
    assert step == 1
    assert torch.equal(state["w"], torch.full((4, 4), 2.0))
    assert mgr.all_steps() == [0, 1]
    mgr.save(_state(3.0))             # numbering continues past the newest
    assert mgr.latest_step() == 2


def test_restore_latest_skips_and_gcs_torn_checkpoint(tmp_path):
    mgr = _mgr(tmp_path)
    mgr.save(_state(1.0), step=0)
    mgr.save(_state(2.0), step=1)
    (tmp_path / step_dir_name(1) / "manifest.json").unlink()
    before = monitor.get_monitor_value("ckpt.torn_skipped")
    state, step = mgr.restore_latest()
    assert step == 0
    assert torch.equal(state["w"], torch.full((4, 4), 1.0))
    assert not (tmp_path / step_dir_name(1)).exists()
    assert monitor.get_monitor_value("ckpt.torn_skipped") == before + 1


def test_crc_mismatch_detected_as_corrupt(tmp_path):
    mgr = _mgr(tmp_path)
    mgr.save(_state(1.0), step=0)
    mgr.save(_state(2.0), step=1)
    payload = tmp_path / step_dir_name(1) / "state.pkl"
    raw = bytearray(payload.read_bytes())
    raw[len(raw) // 2] ^= 0xFF        # same size, one byte flipped
    payload.write_bytes(bytes(raw))
    assert not verify_checkpoint(str(tmp_path / step_dir_name(1)))
    _state_r, step = mgr.restore_latest()
    assert step == 0


def test_retention_keeps_last_n(tmp_path):
    mgr = _mgr(tmp_path, max_to_keep=2)
    before = monitor.get_monitor_value("ckpt.retention_deleted")
    for s in range(5):
        mgr.save(_state(float(s)), step=s)
    assert mgr.all_steps(valid_only=False) == [3, 4]
    assert monitor.get_monitor_value("ckpt.retention_deleted") == before + 3


def test_retention_never_deletes_last_valid(tmp_path):
    mgr = _mgr(tmp_path, max_to_keep=1)
    mgr.save(_state(1.0), step=10)
    for s in (11, 12):                # two newer torn directories
        d = tmp_path / step_dir_name(s)
        d.mkdir()
        (d / "state.pkl").write_bytes(b"garbage")
    mgr._retain()
    assert (tmp_path / step_dir_name(10)).exists()
    _state_r, step = mgr.restore_latest()
    assert step == 10
    assert mgr.all_steps(valid_only=False) == [10]


def test_failed_save_leaves_previous_checkpoint_restorable(tmp_path):
    mgr = _mgr(tmp_path, max_to_keep=1)
    mgr.save(_state(1.0), step=0)
    flags.set_flags(
        {"FLAGS_fault_inject": "ckpt_write:after_bytes=8,mode=raise"})
    with pytest.raises(InjectedFault):
        mgr.save(_state(2.0), step=1)
    flags.set_flags({"FLAGS_fault_inject": ""})
    state, step = mgr.restore_latest()
    assert step == 0
    assert torch.equal(state["w"], torch.full((4, 4), 1.0))


def test_async_save_error_reraises_at_wait_and_next_save(tmp_path):
    mgr = _mgr(tmp_path, async_save=True)
    mgr.save(_state(1.0), step=0)
    mgr.wait()
    flags.set_flags(
        {"FLAGS_fault_inject": "ckpt_write:after_bytes=8,mode=raise"})
    mgr.save(_state(2.0), step=1)     # fails on the save thread
    with pytest.raises(CheckpointError):
        mgr.wait()
    flags.set_flags({"FLAGS_fault_inject": ""})
    mgr.save(_state(3.0), step=2)     # the error is raised once
    mgr.wait()
    _state_r, step = mgr.restore_latest()
    assert step == 2


def test_async_save_error_surfaces_at_next_save(tmp_path):
    mgr = _mgr(tmp_path, async_save=True)
    flags.set_flags(
        {"FLAGS_fault_inject": "ckpt_write:after_bytes=8,mode=raise"})
    mgr.save(_state(1.0), step=0)
    mgr._thread.join()
    flags.set_flags({"FLAGS_fault_inject": ""})
    with pytest.raises(CheckpointError):
        mgr.save(_state(2.0), step=1)


def test_back_to_back_async_saves_take_distinct_default_steps(tmp_path):
    """A second async save with no step, queued while the first still
    waits in ``before_write`` (an epoch-end save, then a SIGTERM save),
    takes the next step and leaves the first checkpoint whole."""
    mgr = _mgr(tmp_path, async_save=True)
    mgr.save(_state(1.0), before_write=lambda: time.sleep(0.3))
    mgr.save(_state(2.0))
    mgr.wait()
    assert [s for s, _ in scan_steps(str(tmp_path))] == [1, 0]
    for step, v in ((0, 1.0), (1, 2.0)):
        got = pt.load(os.path.join(tmp_path, step_dir_name(step),
                                   "state.pkl"), map_location="cpu")
        assert torch.equal(got["w"], torch.full((4, 4), v))


@pytest.mark.parametrize("bad", [
    "bogus_point:after_bytes=1",
    "ckpt_write",
    "ckpt_write:",
    "ckpt_write:after_bytes",
    "ckpt_write:after_bytes=xyz",
    "ckpt_write:nope=1",
    "step:sigterm_at=1;;",
    "step:crash_at=x",                # a JAX step key with a bad value
    "step:sigterm_at=1,bogus=0",
    "rank_crash:at_seq=xyz",          # a guardian point with a bad value
    ":after_bytes=1",
    "rpc_drop:count=x",               # an rpc point with a bad value
    "peer_snap_drop:at_step=1",       # a JAX point the port does not have
    "loss_spike:at_step=x",           # a sentinel point with a bad value
])
def test_fault_spec_rejects_malformed(bad):
    with pytest.raises(FaultSpecError):
        fault_injection.parse(bad)


def test_fault_spec_malformed_flag_raises_not_silently_ignores(tmp_path):
    flags.set_flags({"FLAGS_fault_inject": "ckpt_write:after_bytes"})
    with pytest.raises(FaultSpecError):
        pt.save(_state(1.0), str(tmp_path / "x.pdparams"))


def test_fault_spec_parse_ok():
    spec = fault_injection.parse(
        "ckpt_write:after_bytes=128,mode=raise;step:sigterm_at=3;"
        "data_slow:delay_s=0.5,every=2")
    assert spec["ckpt_write"] == {"after_bytes": 128, "mode": "raise"}
    assert spec["step"] == {"sigterm_at": 3}
    assert spec["data_slow"] == {"delay_s": 0.5, "every": 2}
    assert fault_injection.parse("") == {}
    from paddle_tpu.utils import fault_injection as jfi
    for spec_s in ("ckpt_write:after_bytes=128,mode=raise;step:sigterm_at=3",
                   "data_corrupt:at_sample=4,count=2"):
        assert fault_injection.parse(spec_s) == jfi.parse(spec_s)


# ---- tests/test_checkpoint.py's single-process cases ----

def _linear(seed):
    lin = Linear(8, 8, device="cpu")
    with torch.no_grad():
        lin.reset_parameters(torch.Generator().manual_seed(seed))
    return lin


def test_save_load_roundtrip(tmp_path):
    model = _linear(0)
    ref = {k: v.clone() for k, v in model.state_dict().items()}
    p = str(tmp_path / "ckpt")
    pt.save(model.state_dict(), p)
    model2 = _linear(123)
    model2.load_state_dict(pt.load(p, map_location="cpu"))
    for k, v in model2.state_dict().items():
        assert torch.equal(v, ref[k])


def _adamw_step(model, opt, seed):
    x = torch.randn(4, 8, generator=torch.Generator().manual_seed(seed))
    model(x).mean().backward()
    opt.step()
    opt.clear_grad()


def test_save_model_and_optimizer(tmp_path):
    model = _linear(0)
    opt = AdamW(0.01, parameters=model.parameters())
    _adamw_step(model, opt, 1)
    m1_ref = opt._state["moment1"][0].clone()
    p = str(tmp_path / "both")
    pt.save({"model": model.state_dict(), "opt": opt.state_dict()}, p)
    model2 = _linear(5)
    opt2 = AdamW(0.01, parameters=model2.parameters())
    _adamw_step(model2, opt2, 2)
    both = pt.load(p, map_location="cpu")
    model2.load_state_dict(both["model"])
    opt2.set_state_dict(both["opt"])
    assert torch.equal(model2.weight, model.weight)
    assert torch.equal(opt2._state["moment1"][0], m1_ref)
    assert opt2._step_count == opt._step_count


def test_non_tensor_leaves_restored(tmp_path):
    state = {"model": {"w": torch.ones(2, 2)}, "step_count": 7,
             "lr": 0.125, "flag": True}
    p = str(tmp_path / "scalars")
    pt.save(state, p)
    fresh = pt.load(p, map_location="cpu")
    assert fresh["step_count"] == 7 and isinstance(fresh["step_count"], int)
    assert fresh["lr"] == 0.125 and fresh["flag"] is True
    assert torch.equal(fresh["model"]["w"], torch.ones(2, 2))


def test_loaded_state_survives_donating_compiled_step(tmp_path):
    """A loaded state copied into a model is not aliased by it: compiled
    steps after the load leave the loaded dict as it was."""
    net = _linear(0)
    opt = SGD(0.1, parameters=net.parameters())
    x, y = torch.ones(4, 8), torch.zeros(4, 8)
    cs = CompiledTrainStep(lambda a, b: ((net(a) - b) ** 2).mean(), opt,
                           network=net)
    for _ in range(3):
        cs(x, y)
    path = str(tmp_path / "m.pdparams")
    pt.save(net.state_dict(), path)
    loaded = pt.load(path, map_location="cpu")
    snapshot = {k: v.clone() for k, v in loaded.items()}
    net.load_state_dict(loaded)
    for _ in range(3):
        cs(x, y)
    for k, v in loaded.items():
        assert torch.equal(v, snapshot[k])
    assert not torch.equal(net.weight, snapshot["weight"])


# ---- the port's additions ----

def test_anchor_survives_retention(tmp_path):
    mgr = _mgr(tmp_path, max_to_keep=1)
    before = monitor.get_monitor_value("ckpt.anchor_saves")
    mgr.save_anchor(_state(9.0), step=3)
    for s in range(4):
        mgr.save(_state(float(s)), step=s)
    assert mgr.all_steps(valid_only=False) == [3]
    state, step = mgr.restore_anchor()
    assert step == 3 and torch.equal(state["w"], torch.full((4, 4), 9.0))
    assert monitor.get_monitor_value("ckpt.anchor_saves") == before + 1


def test_validate_finite_refuses_nan(tmp_path):
    bad = {"model": {"w": torch.tensor([1.0, float("nan")])}, "n": 1}
    with pytest.raises(NonFiniteCheckpointError) as e:
        validate_finite_state(bad)
    assert e.value.key == "model.w"
    mgr = _mgr(tmp_path)
    with pytest.raises(NonFiniteCheckpointError):
        mgr.save(bad, step=0, validate_finite=True)
    with pytest.raises(NonFiniteCheckpointError):
        mgr.save_anchor(bad, step=0)
    assert mgr.all_steps(valid_only=False) == []
    assert not (tmp_path / "anchor").exists()
    validate_finite_state({"w": torch.ones(2), "i": torch.arange(2),
                           "a": np.ones(3)})


def test_crash_in_the_middle_of_a_save_in_a_child(tmp_path):
    """A child killed by ``ckpt_write`` while it writes step 1 leaves a
    torn ``ckpt-00000001``; the parent's restore skips it."""
    root = tmp_path / "ck"
    code = textwrap.dedent(f"""
        import torch
        from paddle_tpu_torch.framework.checkpoint_manager import \\
            CheckpointManager
        mgr = CheckpointManager({str(root)!r}, map_location="cpu")
        for s in range(3):
            mgr.save({{"w": torch.full((64, 64), float(s))}}, step=s)
    """)
    env = dict(os.environ, PYTHONPATH=REPO,
               FLAGS_fault_inject="ckpt_write:after_bytes=50,"
                                  f"file={step_dir_name(1)}")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, env=env)
    assert r.returncode == fault_injection.DEFAULT_EXIT_CODE, r.stderr
    assert (root / step_dir_name(1)).exists()
    assert not verify_checkpoint(str(root / step_dir_name(1)))
    assert not (root / step_dir_name(2)).exists()
    state, step = _mgr(root).restore_latest()
    assert step == 0 and torch.equal(state["w"], torch.zeros(64, 64))
    assert not (root / step_dir_name(1)).exists()


def test_jax_manager_directory_restores_in_the_port(tmp_path):
    jmgr = jcm.CheckpointManager(str(tmp_path), max_to_keep=3)
    for s in range(2):
        jmgr.save({"w": paddle.to_tensor(np.full((3, 3), s, np.float32)),
                   "step": s}, step=s)
    jmgr.save_anchor({"w": paddle.to_tensor(np.ones((2,), np.float32))},
                     step=1)
    mgr = _mgr(tmp_path)
    assert mgr.all_steps() == [0, 1]
    state, step = mgr.restore_latest()
    assert step == 1 and state["step"] == 1
    assert torch.equal(state["w"], torch.full((3, 3), 1.0))
    anchor, astep = mgr.restore_anchor()
    assert astep == 1 and torch.equal(anchor["w"], torch.ones(2))
    # and the port's manifests verify under the JAX package's reader
    mgr.save(_state(5.0), step=7)
    assert jcm.verify_checkpoint(str(tmp_path / step_dir_name(7)))
