"""The port's training sentinel (paddle_tpu_torch/framework/sentinel.py,
the sentinel seams of hapi/model.py and framework/train_step.py, the
fault points of utils/fault_injection.py) against the JAX package's on
the CPU.

The fit drills are tests/test_sentinel.py's (its blame and controller
drills are in tests/test_torch_sentinel_ranks.py): a 2-layer fp32 MLP on 48
seeded rows, batch 4, one epoch, the same weights in both packages
(``convert``), the same flags and fault spec.  Each drill runs in both
packages and holds the port to JAX:

- ``report()``: the rollbacks, the quarantined iterations, the skips and
  the anomalies' iterations and signals exactly; each anomaly's value to
  ``VALUE_RTOL`` relative (a z-score or a norm ratio, computed from
  losses and norms that differ in the last bits);
- the final weights within ``PARAM_ATOL`` (XLA:CPU contracts
  multiply-adds, torch rounds each op; tests/test_torch_hapi.py's bound);
- in the port, the final weights equal, bit for bit, a run without the
  sentinel that never trains the quarantined iterations (JAX holds its
  own to 5e-4): a rollback restores every value exactly and a replay runs
  the same ops.

Besides: the sentinel on against off bit for bit in each lane, the
detection units, ``decide_blame``, the dump's schema
(``tools/check_telemetry.py --sentinel-dump``), the fault specs, the
GradScaler's unit-scale wrapper, the anchors' retention and finiteness,
a rollback through a ``data.Pipeline``, ``bad_batch`` on token ids
(``ValueError`` in both packages), and the hot-spare rung (the
fresher own snapshot: tests/test_torch_hot_spare.py).
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.framework import sentinel as jsentinel
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.gpt import gpt_config as jax_gpt_config
from paddle_tpu.utils import fault_injection as jfi
from paddle_tpu_torch import convert
from paddle_tpu_torch import data as pdata
from paddle_tpu_torch.amp import GradScaler
from paddle_tpu_torch.framework.checkpoint_manager import (
    CheckpointManager, NonFiniteCheckpointError, validate_finite_state,
    verify_checkpoint)
from paddle_tpu_torch.framework.sentinel import (TrainingSentinel,
                                                 decide_blame,
                                                 sentinel_enabled)
from paddle_tpu_torch.hapi import Model
from paddle_tpu_torch.models import GPTForCausalLM, gpt_config
from paddle_tpu_torch.nn import CrossEntropyLoss, Linear, MSELoss
from paddle_tpu_torch.optimizer import SGD, AdamW
from paddle_tpu_torch.utils import fault_injection
from paddle_tpu_torch.utils import flags as port_flags
from paddle_tpu_torch.utils import monitor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
try:
    import check_telemetry
finally:
    sys.path.pop(0)

N, BS = 48, 4
VALUE_RTOL = 1e-3
PARAM_ATOL = 2e-5
FLAG_KEYS = ("FLAGS_sentinel", "FLAGS_compiled_train_step",
             "FLAGS_fault_inject", "FLAGS_sentinel_check_every",
             "FLAGS_sentinel_anchor_every", "FLAGS_sentinel_max_skips",
             "FLAGS_sentinel_rollback_after", "FLAGS_sentinel_window",
             "FLAGS_sentinel_dump_path", "FLAGS_sentinel_spike_zscore",
             "FLAGS_hot_spare")


@pytest.fixture
def flags(tmp_path):
    """Set the same flags in both packages (restored after); sentinel
    dumps go under the test's directory."""
    old = port_flags.get_flags(list(FLAG_KEYS))
    jold = {k: paddle.get_flags([k])[k] for k in FLAG_KEYS}

    def both(values):
        values = dict(values)
        port_flags.set_flags(values)
        paddle.set_flags(values)
    both({"FLAGS_sentinel_dump_path": str(tmp_path / "sentinel.json")})
    yield both
    port_flags.set_flags(old)
    paddle.set_flags(jold)


class ToyData:
    """Row ``i``: 8 normals from seed i and tanh of their sum; with
    ``spike`` (a batch index or a set of them) the rows of those batches
    are scaled by 30 (a fault the data itself carries: a finite loss spike
    in either lane)."""

    def __init__(self, spike=None):
        self.spike = {spike} if isinstance(spike, int) else set(spike or ())

    def __len__(self):
        return N

    def __getitem__(self, i):
        rng = np.random.default_rng(i)
        x = rng.normal(size=(8,)).astype(np.float32)
        y = np.tanh(np.sum(x, keepdims=True)).astype(np.float32)
        if i // BS in self.spike:
            x, y = x * 30.0, y * 30.0
        return x, y


def _jax_net():
    paddle.seed(3)
    return jnn.Sequential(jnn.Linear(8, 16), jnn.Tanh(), jnn.Linear(16, 1))


def _start_weights():
    return {k: np.asarray(v.numpy()) for k, v in _jax_net().state_dict()
            .items()}


def _port_net():
    net = torch.nn.Sequential(Linear(8, 16, device="cpu"), torch.nn.Tanh(),
                              Linear(16, 1, device="cpu"))
    convert.load_paddle_tpu_state(net, _start_weights())
    return net


def _jax_model():
    net = _jax_net()
    model = paddle.Model(net)
    model.prepare(optimizer=paddle.optimizer.AdamW(
        0.01, parameters=net.parameters()), loss=jnn.MSELoss())
    return model, net


def _port_model():
    net = _port_net()
    model = Model(net)
    model.prepare(optimizer=AdamW(0.01, parameters=net.parameters()),
                  loss=MSELoss())
    return model, net


def _fit(pkg, data=None, save_dir=None):
    """fit one epoch in ``pkg`` under the flags set; returns (final
    weights as numpy, the sentinel's report or None, the Model)."""
    model, net = _jax_model() if pkg == "jax" else _port_model()
    cls = paddle.Model if pkg == "jax" else Model
    # each fit starts with the fault points' fire budgets full
    (jfi if pkg == "jax" else fault_injection)._SENTINEL_STATE["raw"] = ""
    holder = {}
    orig = cls._install_sentinel

    def patched(self, cb):
        s = orig(self, cb)
        holder["sentinel"] = s
        return s
    cls._install_sentinel = patched
    kw = dict(batch_size=BS, epochs=1, verbose=0, shuffle=False)
    if save_dir is not None:
        kw["save_dir"] = str(save_dir)
    try:
        model.fit(data if data is not None else ToyData(), **kw)
    finally:
        cls._install_sentinel = orig
    if pkg == "jax":
        w = {k: np.asarray(v._data_) for k, v in net.state_dict().items()}
    else:
        w = {k: v.detach().numpy().copy() for k, v in net.state_dict()
             .items()}
    s = holder.get("sentinel")
    return w, (s.report() if s is not None else None), model


def _clean_skipping(skip_iters, compiled, spike=None):
    """The port without the sentinel, the quarantined iterations never
    trained."""
    port_flags.set_flags({"FLAGS_sentinel": False,
                          "FLAGS_compiled_train_step": compiled,
                          "FLAGS_fault_inject": ""})
    model, net = _port_model()
    data = ToyData(spike)
    for it in range(N // BS):
        if it in skip_iters:
            continue
        rows = [data[i] for i in range(it * BS, (it + 1) * BS)]
        xs = torch.from_numpy(np.stack([r[0] for r in rows]))
        ys = torch.from_numpy(np.stack([r[1] for r in rows]))
        model.train_batch(xs, ys)
    return {k: v.detach().numpy().copy() for k, v in net.state_dict()
            .items()}


def _same_report(got, want):
    for key in ("rollbacks", "quarantined", "skips", "anchor_it",
                "enabled"):
        assert got[key] == want[key], (key, got, want)
    assert [(a["step"], a["signal"]) for a in got["anomalies"]] == \
        [(a["step"], a["signal"]) for a in want["anomalies"]], (got, want)
    for a, b in zip(got["anomalies"], want["anomalies"]):
        if b["value"] is None or not np.isfinite(b["value"]):
            assert a["value"] == b["value"] or (
                np.isnan(a["value"]) and np.isnan(b["value"])), (a, b)
        else:
            np.testing.assert_allclose(a["value"], b["value"],
                                       rtol=VALUE_RTOL)


def _close_weights(got, want):
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=PARAM_ATOL, err_msg=k)


def _equal_weights(got, want):
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _drill(flags, values, compiled, data_spike=None, with_ckpt=None):
    """Run the drill in both packages; returns the port's (weights,
    report) after holding them to JAX's."""
    flags(dict(values, FLAGS_sentinel=True,
               FLAGS_compiled_train_step=compiled))
    jw, jrep, _ = _fit("jax", ToyData(data_spike),
                       with_ckpt and with_ckpt / "jax")
    w, rep, model = _fit("port", ToyData(data_spike),
                         with_ckpt and with_ckpt / "port")
    _same_report(rep, jrep)
    _close_weights(w, jw)
    if compiled:
        cs = model._compiled_step
        assert cs and cs.compiled and cs._sentinel, cs and cs.fallback_reason
    return w, rep, model


# ------------------------------------------------------------- fit drills


@pytest.mark.parametrize("compiled", [False, True])
def test_sentinel_on_off_bit_for_bit(flags, compiled):
    """Healthy path: the sentinel's seams and the unit-scale scaler change
    nothing; the weights are bit for bit those without it, in each lane."""
    flags({"FLAGS_sentinel": False, "FLAGS_compiled_train_step": compiled})
    off, rep_off, _ = _fit("port")
    flags({"FLAGS_sentinel": True})
    on, rep, model = _fit("port")
    assert rep_off is None and rep["anomalies"] == [] and \
        rep["rollbacks"] == 0
    _equal_weights(on, off)
    flags({"FLAGS_sentinel": True})
    jw, jrep, _ = _fit("jax")
    _same_report(rep, jrep)
    _close_weights(on, jw)


def test_rollback_drill_eager_loss_spike(flags, tmp_path):
    """loss_spike at iteration 7, anchors through the CheckpointManager:
    one rollback, 7 quarantined, the anchor dir verified, the weights
    those of a clean run that skips 7."""
    w, rep, _ = _drill(flags, {
        "FLAGS_sentinel_check_every": 4, "FLAGS_sentinel_anchor_every": 4,
        "FLAGS_fault_inject": "loss_spike:at_step=7,scale=1e6"}, False,
        with_ckpt=tmp_path)
    assert rep["rollbacks"] == 1 and 7 in rep["quarantined"], rep
    assert verify_checkpoint(str(tmp_path / "port" / "anchor"))
    _equal_weights(w, _clean_skipping(set(rep["quarantined"]), False))


@pytest.mark.parametrize("compiled", [False, True])
def test_rollback_on_a_spike_the_data_carries(flags, compiled):
    """Batch 7's rows scaled by 30: a finite loss spike that rides the
    compiled lane too; the rollback restores into the captured step (no
    second build) and the replay skips 7."""
    w, rep, model = _drill(flags, {
        "FLAGS_sentinel_check_every": 4, "FLAGS_sentinel_anchor_every": 4,
        "FLAGS_sentinel_window": 16}, compiled, data_spike=7)
    assert rep["rollbacks"] == 1 and rep["quarantined"] == [7], rep
    assert rep["anomalies"][0]["signal"] == "loss_spike"
    _equal_weights(w, _clean_skipping({7}, compiled, spike=7))


def test_quarantine_drill_compiled_bad_batch(flags):
    """A NaN batch at 7 in the compiled lane: skipped inside the step by
    the update's skip flag (no rollback) and quarantined."""
    w, rep, _ = _drill(flags, {
        "FLAGS_sentinel_check_every": 4, "FLAGS_sentinel_anchor_every": 4,
        "FLAGS_fault_inject": "bad_batch:at_step=7,mode=nan"}, True)
    assert rep["skips"] == 1 and rep["rollbacks"] == 0 and \
        rep["quarantined"] == [7], rep
    _equal_weights(w, _clean_skipping({7}, True))


def test_grad_bitflip_skipped_by_the_unit_scaler(flags):
    """An Inf gradient element at 5 (eager lane): the unit-scale scaler's
    found-inf skips the update, the sentinel quarantines 5."""
    w, rep, _ = _drill(flags, {
        "FLAGS_sentinel_check_every": 4, "FLAGS_sentinel_anchor_every": 4,
        "FLAGS_fault_inject": "grad_bitflip:at_step=5"}, False)
    assert rep["skips"] == 1 and rep["quarantined"] == [5], rep
    _equal_weights(w, _clean_skipping({5}, False))


def test_skip_streak_escalates_to_rollback(flags, tmp_path):
    w, rep, _ = _drill(flags, {
        "FLAGS_sentinel_check_every": 2, "FLAGS_sentinel_max_skips": 2,
        "FLAGS_sentinel_anchor_every": 2,
        "FLAGS_fault_inject": "bad_batch:mode=nan,count=3"}, False,
        with_ckpt=tmp_path)
    assert rep["rollbacks"] >= 1 and {0, 1} <= set(rep["quarantined"]), rep
    _equal_weights(w, _clean_skipping(set(rep["quarantined"]), False))


def test_max_rollbacks_stands_down(flags, tmp_path):
    """Spikes in batches 7 and 9: the first rolls back; the second, after
    FLAGS_sentinel_max_rollbacks = 1, makes the sentinel stand down and
    dump ``disabled``."""
    _, rep, _ = _drill(flags, {
        "FLAGS_sentinel_check_every": 4, "FLAGS_sentinel_anchor_every": 4,
        "FLAGS_sentinel_window": 16, "FLAGS_sentinel_max_rollbacks": 1},
        False, data_spike={7, 9})
    assert rep["enabled"] is False and rep["rollbacks"] == 1, rep
    assert rep["quarantined"] == [7, 9], rep
    path = str(tmp_path / "sentinel.json")
    assert json.load(open(path))["sentinel"]["action"] == "disabled"
    assert not check_telemetry.check_sentinel_dump(path)


@pytest.mark.parametrize("compiled", [False, True])
def test_rollback_rewinds_a_data_pipeline(flags, compiled):
    """fit over a data.Pipeline: the restore rewinds the pipeline onto the
    anchor's position, the replay skips the quarantined batch, and the
    weights equal the clean run that skips it."""
    flags({"FLAGS_sentinel": True, "FLAGS_compiled_train_step": compiled,
           "FLAGS_sentinel_check_every": 4, "FLAGS_sentinel_anchor_every": 4,
           "FLAGS_sentinel_window": 16})
    pipe = pdata.pipeline(ToyData(spike=7)).batch(BS)
    w, rep, _ = _fit("port", pipe)
    assert rep["rollbacks"] == 1 and rep["quarantined"] == [7], rep
    _equal_weights(w, _clean_skipping({7}, compiled, spike=7))


def test_bad_batch_on_token_ids_raises_like_jax(flags):
    """bad_batch scales integer ids into floats; the JAX embedding refuses
    them with ValueError, and so does the port's, before any launch."""
    flags({"FLAGS_sentinel": True, "FLAGS_compiled_train_step": True,
           "FLAGS_fault_inject": "bad_batch:at_step=1"})
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 64, (4, 17))
    x, y = ids[:, :-1].copy(), ids[:, 1:].copy()
    cfg = dict(vocab_size=64, hidden_size=32, num_layers=1, num_heads=2,
               max_seq_len=16)
    paddle.seed(0)
    jm = JaxGPT(jax_gpt_config("gpt2-124m", **cfg))
    jmodel = paddle.Model(jm).prepare(
        paddle.optimizer.SGD(0.1, parameters=jm.parameters()),
        jnn.CrossEntropyLoss())
    jfi._SENTINEL_STATE["raw"] = ""
    with pytest.raises(ValueError, match="integer"):
        jmodel.fit(paddle.io.TensorDataset([x, y]), batch_size=2,
                   verbose=0, shuffle=False)
    fault_injection._SENTINEL_STATE["raw"] = ""
    tm = GPTForCausalLM(gpt_config("gpt2-124m", **cfg), device="cpu")
    model = Model(tm).prepare(SGD(0.1, parameters=tm.parameters()),
                              CrossEntropyLoss())
    from paddle_tpu_torch.io import TensorDataset
    with pytest.raises(ValueError, match="integer"):
        model.fit(TensorDataset([x, y]), batch_size=2, verbose=0,
                  shuffle=False)


def test_multi_rank_and_hot_spare_raise(flags):
    """A world above one rank is ported (the blame exchange:
    tests/test_torch_sentinel_ranks.py).  The hot-spare rung raised until
    hot-spare recovery was ported: now the sentinel builds with it in a
    world of one or of two, and fit under the sentinel with the agent
    armed trains bit for bit as without it (the agent's snapshots copy,
    they never write)."""
    from paddle_tpu_torch.framework import hot_spare
    sen = TrainingSentinel(model=None, nranks=2, rank=1)
    assert (sen.nranks, sen.rank, sen.report()["blamed_rank"]) == (2, 1,
                                                                  None)
    flags({"FLAGS_sentinel": True, "FLAGS_hot_spare": True})
    assert TrainingSentinel(model=None, nranks=2, rank=1).nranks == 2
    assert TrainingSentinel(model=None)._peer_candidate() is None
    weights = {}
    for on in (True, False):
        flags({"FLAGS_hot_spare": on})
        model, _ = _port_model()
        model.fit(ToyData(), batch_size=BS, verbose=0, shuffle=False)
        weights[on] = {k: v.clone()
                       for k, v in model.network.state_dict().items()}
    for k in weights[False]:
        assert torch.equal(weights[True][k], weights[False][k]), k
    assert hot_spare.current_agent() is None       # closed by the fit


def test_sentinel_off_removes_its_wrapper(flags):
    """A fit under the sentinel installs the unit-scale scaler and a step
    with the health output; the next fit without it drops both."""
    flags({"FLAGS_sentinel": True, "FLAGS_compiled_train_step": True})
    model, _ = _port_model()
    model.fit(ToyData(), batch_size=BS, verbose=0, shuffle=False)
    assert model._scaler._sentinel_wrapper and model._compiled_step._sentinel
    flags({"FLAGS_sentinel": False})
    model.fit(ToyData(), batch_size=BS, verbose=0, shuffle=False)
    assert model._scaler is None and not model._compiled_step._sentinel


# ------------------------------------------------------------- the units


def test_gradscaler_min_loss_scale_floor_and_streak_metric():
    sc = GradScaler(init_loss_scaling=256.0, decr_every_n_nan_or_inf=1,
                    min_loss_scale=64.0)
    for _ in range(10):
        sc._found_inf = True
        sc.update()
    assert sc.get_loss_scaling() == 64.0
    assert sc.found_inf_streak == 10
    assert monitor.get_monitor_value("amp.found_inf_streak") == 10
    sc._found_inf = False
    sc.update()
    assert sc.found_inf_streak == 0
    assert monitor.get_monitor_value("amp.found_inf_streak") == 0


def test_gradscaler_always_check_skips_at_unit_scale():
    net = Linear(4, 2, device="cpu")
    with torch.no_grad():
        net.reset_parameters(torch.Generator().manual_seed(0))
    opt = SGD(0.1, parameters=net.parameters())
    net(torch.ones(2, 4)).sum().backward()
    with torch.no_grad():
        net.weight.grad[0, 0] = float("inf")
    before = net.weight.detach().clone()
    sc = GradScaler(init_loss_scaling=1.0, use_dynamic_loss_scaling=False,
                    always_check_found_inf=True)
    sc.step(opt)
    assert sc._found_inf and torch.equal(before, net.weight)


def test_planted_found_inf_is_taken_once():
    """The health pass's flag, planted, is the next unscale_'s decision
    (no second reduction) and is consumed by it."""
    net = Linear(4, 2, device="cpu")
    opt = SGD(0.1, parameters=net.parameters())
    with torch.no_grad():
        net.reset_parameters(torch.Generator().manual_seed(0))
    net(torch.ones(2, 4)).sum().backward()
    sc = GradScaler(init_loss_scaling=1.0, use_dynamic_loss_scaling=False,
                    always_check_found_inf=True)
    sc._planted_found_inf = torch.tensor(True)
    sc.unscale_(opt)
    assert sc._found_inf and sc._planted_found_inf is None


def test_validate_finite_refuses_poisoned_checkpoint(tmp_path):
    mgr = CheckpointManager(str(tmp_path), map_location="cpu")
    bad = {"model": {"w": torch.tensor([1.0, float("nan")])}}
    with pytest.raises(NonFiniteCheckpointError) as ei:
        mgr.save(bad, step=0, validate_finite=True)
    assert "model.w" in str(ei.value)
    assert mgr.restore_latest() is None
    validate_finite_state({"a": [np.zeros(3), {"b": np.ones(2)}], "n": 7,
                           "s": "text"})
    with pytest.raises(NonFiniteCheckpointError):
        validate_finite_state({"a": [np.zeros(3),
                                     {"b": np.array([np.inf])}]})


def test_anchor_is_exempt_from_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2, map_location="cpu")
    mgr.save_anchor({"w": torch.ones(3)}, step=1)
    for s in range(6):
        mgr.save({"w": torch.full((3,), float(s))}, step=s)
    assert mgr.all_steps() == [4, 5]
    state, step = mgr.restore_anchor()
    assert step == 1 and torch.equal(state["w"], torch.ones(3))
    with pytest.raises(NonFiniteCheckpointError):
        mgr.save_anchor({"w": torch.tensor([float("nan")])}, step=2)
    assert mgr.restore_anchor()[1] == 1


def test_new_fault_point_specs_validate():
    spec = fault_injection.parse(
        "bad_batch:at_step=3,mode=nan;loss_spike:at_step=2,scale=1e6;"
        "grad_bitflip:rank=1,count=6")
    assert spec == jfi.parse(
        "bad_batch:at_step=3,mode=nan;loss_spike:at_step=2,scale=1e6;"
        "grad_bitflip:rank=1,count=6")
    for bad in ("bad_batch:nope=1", "loss_spike:at_step=x", "grad_bitflip"):
        with pytest.raises(fault_injection.FaultSpecError):
            fault_injection.parse(bad)


def test_fault_seams_fire_within_their_budget(flags):
    flags({"FLAGS_fault_inject": "loss_spike:scale=10,count=2"})
    fault_injection._SENTINEL_STATE["raw"] = ""
    loss = torch.tensor(2.0)
    got = [float(fault_injection.spike_loss(loss, it)) for it in range(4)]
    assert got == [20.0, 20.0, 2.0, 2.0]
    flags({"FLAGS_fault_inject": "bad_batch:at_step=1"})
    x = torch.arange(4)
    assert fault_injection.corrupt_batch(x, 0) is x
    bad = fault_injection.corrupt_batch(x, 1)
    assert bad.dtype == torch.float32 and float(bad[1]) == 1e6


def test_zscore_spike_detection_unit(flags):
    flags({"FLAGS_sentinel": True, "FLAGS_sentinel_window": 16,
           "FLAGS_sentinel_check_every": 1})
    sen = TrainingSentinel(model=None)
    for it in range(12):
        sen.after_step(it, 0, it, 1.0 + 0.01 * it, update=True)
    assert sen.report()["anomalies"] == []
    sen.after_step(12, 0, 12, 1e6, update=True)
    rep = sen.report()
    assert [a["signal"] for a in rep["anomalies"]] == ["loss_spike"]
    assert rep["quarantined"] == [12]


def test_nonfinite_loss_detection_unit(flags):
    flags({"FLAGS_sentinel": True, "FLAGS_sentinel_check_every": 1})
    sen = TrainingSentinel(model=None)
    sen.after_step(0, 0, 0, torch.tensor(float("nan")), update=True)
    rep = sen.report()
    assert rep["anomalies"][0]["signal"] == "nonfinite_loss"
    assert rep["quarantined"] == [0]


def test_blame_decision_unit():
    for mod in (jsentinel, sys.modules[TrainingSentinel.__module__]):
        h = {0: {"local_anomalies": 0}, 1: {"local_anomalies": 3}}
        assert mod.decide_blame(h) == 1
        assert mod.decide_blame({0: {"local_anomalies": 2},
                                 1: {"local_anomalies": 3}}) is None
        assert mod.decide_blame({0: {"local_anomalies": 0},
                                 1: {"local_anomalies": 1}}) is None
        assert mod.decide_blame({0: {"local_anomalies": 4}}) is None
    assert decide_blame({0: {}, 1: {"local_anomalies": 2},
                         2: {"local_anomalies": 0}}) == 1


def test_sentinel_dump_schema(flags, tmp_path):
    dump_path = str(tmp_path / "sentinel.json")
    flags({"FLAGS_sentinel": True, "FLAGS_sentinel_check_every": 1,
           "FLAGS_sentinel_dump_path": dump_path})
    sen = TrainingSentinel(model=None)
    sen.after_step(0, 0, 0, float("nan"), update=True)
    path = sen.dump(action="rollback", step=0, anchor_step=0)
    assert path == dump_path
    assert not check_telemetry.check_sentinel_dump(path)
    data = json.load(open(path))
    assert data["reason"] == "sentinel"
    assert data["sentinel"]["anomalies"][0]["signal"] == "nonfinite_loss"


def test_drill_dumps_pass_check_telemetry(flags, tmp_path):
    """The rollback a fit drill makes leaves a dump the checker passes."""
    _drill(flags, {
        "FLAGS_sentinel_check_every": 4, "FLAGS_sentinel_anchor_every": 4,
        "FLAGS_fault_inject": "loss_spike:at_step=7,scale=1e6"}, False)
    path = str(tmp_path / "sentinel.json")
    assert not check_telemetry.check_sentinel_dump(path)
    assert json.load(open(path))["sentinel"]["action"] == "rollback"


def test_sentinel_disabled_flag_reads_false(flags):
    flags({"FLAGS_sentinel": False})
    assert not sentinel_enabled()
    flags({"FLAGS_sentinel": True})
    assert sentinel_enabled()


def test_gpt_spike_the_data_carries_matches_jax(flags):
    """The CPU twin of chip_smoke.py's sentinel-gpt2 (b): a 2-layer GPT
    fed the same 8 rows each step (its loss falls), batch 20 of 32 random
    rows; check, anchor and z-score window 8, the compiled lane.  The
    report equals JAX's; the weights after 31 AdamW(3e-3) steps agree to
    5e-4 (tests/test_sentinel.py's own bound for a drill against its
    clean run); the port's weights equal a clean run without the
    quarantined batches bit for bit."""
    from paddle_tpu.io import TensorDataset as JTensorDataset
    from paddle_tpu_torch.io import TensorDataset
    rng = np.random.default_rng(0)
    same, other = rng.integers(0, 64, (2, 8, 17))
    k, steps = 20, 32

    def rows(skip=()):
        r = np.concatenate([other if i == k else same for i in range(steps)
                            if i not in skip])
        return r[:, :-1].copy(), r[:, 1:].copy()
    cfg = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
               max_seq_len=16)
    flags({"FLAGS_sentinel": True, "FLAGS_compiled_train_step": True,
           "FLAGS_sentinel_check_every": 8, "FLAGS_sentinel_anchor_every": 8,
           "FLAGS_sentinel_window": 8})
    paddle.seed(0)
    jm = JaxGPT(jax_gpt_config("gpt2-124m", **cfg))
    start = {n: np.asarray(v.numpy()) for n, v in jm.state_dict().items()}
    jmodel = paddle.Model(jm).prepare(
        paddle.optimizer.AdamW(3e-3, parameters=jm.parameters()),
        jnn.CrossEntropyLoss())
    holder = {}

    def grab(cls):
        orig = cls._install_sentinel

        def patched(self, cb):
            holder[cls] = orig(self, cb)
            return holder[cls]
        return orig, patched
    orig, patched = grab(paddle.Model)
    paddle.Model._install_sentinel = patched
    try:
        jmodel.fit(JTensorDataset(list(rows())), batch_size=8, verbose=0,
                   shuffle=False)
    finally:
        paddle.Model._install_sentinel = orig
    jrep = holder[paddle.Model].report()

    def port_fit(sentinel, skip=()):
        port_flags.set_flags({"FLAGS_sentinel": sentinel})
        tm = GPTForCausalLM(gpt_config("gpt2-124m", **cfg), device="cpu")
        convert.load_paddle_tpu_state(tm, start)
        model = Model(tm).prepare(AdamW(3e-3, parameters=tm.parameters()),
                                  CrossEntropyLoss())
        orig, patched = grab(Model)
        Model._install_sentinel = patched
        try:
            model.fit(TensorDataset(list(rows(skip))), batch_size=8,
                      verbose=0, shuffle=False)
        finally:
            Model._install_sentinel = orig
        return {n: v.detach().numpy().copy()
                for n, v in tm.state_dict().items()}
    w = port_fit(True)
    rep = holder[Model].report()
    _same_report(rep, jrep)
    assert rep["rollbacks"] == 1 and k in rep["quarantined"], rep
    assert rep["anomalies"][0] == dict(rep["anomalies"][0], step=k,
                                       signal="loss_spike")
    jw = {n: np.asarray(v.numpy()) for n, v in jm.state_dict().items()}
    for n in jw:
        np.testing.assert_allclose(w[n], jw[n], rtol=0, atol=5e-4,
                                   err_msg=n)
    _equal_weights(w, port_fit(False, skip=set(rep["quarantined"])))
