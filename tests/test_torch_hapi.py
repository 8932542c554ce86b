"""The port's training runtime (paddle_tpu_torch/hapi, nn/losses.py,
metric, distributed/fleet/elastic.py) against the JAX package's on the
CPU, where the port's compiled train step runs its body with the
kernels' plain versions.

- ``Model.fit`` on a 2-layer fp32 GPT and Llama at width 64 (dropout 0,
  the same weights through ``convert``, 8 rows of seeded token ids,
  batch 2, two epochs) gives JAX ``Model.fit``'s per-step losses and
  final parameters, with ``FLAGS_compiled_train_step`` on and off in
  both packages, and with ``accumulate_grad_batches=2``.  Tolerances are
  tests/test_torch_train.py's (XLA:CPU contracts multiply-adds, torch
  rounds each op): losses to ``LOSS_RTOL`` relative; parameters all but
  1 in 10^4 of the elements within ``PARAM_ATOL`` and every element
  within ``PARAM_ATOL`` + ``PARAM_RTOL`` relative.
- ``evaluate`` / ``predict`` against JAX's (loss to ``LOSS_RTOL``,
  logits to 1e-5); ``save`` then ``load`` exactly; ``fit(resume=True)``
  from the ``ckpt-N`` the JAX package's ``ModelCheckpoint`` wrote
  continues with JAX's own continued losses.
- The counterparts of tests/test_fault_tolerance.py's hapi resume
  cases and drills: resume with ``max_to_keep``, resume over a torn
  checkpoint, and in child processes a crash in a torn write then
  resume, and SIGTERM → exit 101 → relaunch → resume (the resumed losses
  equal the uninterrupted run's exactly: the same ops on the CPU).
- The losses (every argument of ``CrossEntropyLoss``; ``MSELoss``) and
  metrics against JAX's to 1e-6; async ``ModelCheckpoint`` against a
  synchronous one, exactly; the names that raise ``NotImplementedError``.
"""
import os
import shutil
import signal
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import metric as jmetric
from paddle_tpu import nn as jnn
from paddle_tpu.hapi import Model as JModel
from paddle_tpu.hapi.callbacks import Callback as JCallback
from paddle_tpu.io import TensorDataset as JTensorDataset
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_config as jax_llama_config
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.gpt import gpt_config as jax_gpt_config
from paddle_tpu_torch import convert, metric
from paddle_tpu_torch.distributed.fleet.elastic import (ELASTIC_EXIT_CODE,
                                                        PreemptionHandler)
from paddle_tpu_torch.framework.checkpoint_manager import (
    CheckpointManager, step_dir_name, write_manifest)
from paddle_tpu_torch.hapi import Callback, Model, ModelCheckpoint
from paddle_tpu_torch.io import TensorDataset
from paddle_tpu_torch.models import (GPTForCausalLM, LlamaForCausalLM,
                                     gpt_config, llama_config)
from paddle_tpu_torch.nn import CrossEntropyLoss, Linear, MSELoss
from paddle_tpu_torch.optimizer import SGD, AdamW
from paddle_tpu_torch.utils import flags as port_flags
from paddle_tpu_torch.utils import monitor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQ = 32
LR = 1e-3
LOSS_RTOL = 1e-5
PARAM_ATOL = 2e-5
PARAM_RTOL = 1e-2
GPT_TINY = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
                max_seq_len=SEQ)
LLAMA_TINY = dict(hidden_size=64, num_heads=4, num_kv_heads=2,
                  intermediate_size=192, max_seq_len=SEQ)


@pytest.fixture(autouse=True)
def _restore_flags():
    saved = port_flags.get_flags(["FLAGS_compiled_train_step",
                                  "FLAGS_sentinel", "FLAGS_hot_spare"])
    jsaved = paddle.get_flags("FLAGS_compiled_train_step")
    yield
    port_flags.set_flags(saved)
    paddle.set_flags(jsaved)


def _data(rows=8, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 512, (rows, SEQ + 1))
    return ids[:, :-1].copy(), ids[:, 1:].copy()


def _jax_model(kind):
    paddle.seed(0)
    if kind == "llama":
        return JaxLlama(jax_llama_config("tiny", **LLAMA_TINY))
    return JaxGPT(jax_gpt_config("gpt2-124m", **GPT_TINY))


def _port_model(kind, jm=None):
    tm = LlamaForCausalLM(llama_config("tiny", **LLAMA_TINY),
                          device="cpu") if kind == "llama" else \
        GPTForCausalLM(gpt_config("gpt2-124m", **GPT_TINY), device="cpu")
    if jm is not None:
        convert.load_paddle_tpu_state(
            tm, {k: v.numpy() for k, v in jm.state_dict().items()})
    return tm


class _JaxLosses(JCallback):
    def __init__(self):
        super().__init__()
        self.losses = []

    def on_train_batch_end(self, step, logs=None):
        self.losses.append(logs["loss"])


class _Losses(Callback):
    def __init__(self):
        super().__init__()
        self.losses = []

    def on_train_batch_end(self, step, logs=None):
        self.losses.append(logs["loss"])


def _jax_fit(jm, x, y, compiled, accum=1, epochs=2, **kw):
    paddle.set_flags({"FLAGS_compiled_train_step": compiled})
    rec = _JaxLosses()
    model = JModel(jm).prepare(
        paddle.optimizer.AdamW(LR, parameters=jm.parameters()),
        jnn.CrossEntropyLoss())
    model.fit(JTensorDataset([x, y]), batch_size=2, epochs=epochs,
              verbose=0, shuffle=False, log_freq=1, callbacks=[rec],
              accumulate_grad_batches=accum, **kw)
    return model, rec.losses


def _port_fit(tm, x, y, compiled, accum=1, epochs=2, **kw):
    port_flags.set_flags({"FLAGS_compiled_train_step": compiled})
    rec = _Losses()
    model = Model(tm).prepare(AdamW(LR, parameters=tm.parameters()),
                              CrossEntropyLoss())
    model.fit(TensorDataset([x, y]), batch_size=2, epochs=epochs,
              verbose=0, shuffle=False, log_freq=1,
              callbacks=[rec] + kw.pop("callbacks", []),
              accumulate_grad_batches=accum, **kw)
    return model, rec.losses


def _assert_params_close(tm, jm):
    """All but 1 in 10^4 of the elements within PARAM_ATOL, every one
    within PARAM_ATOL + PARAM_RTOL relative (test_torch_train.py's)."""
    jstate = {k: np.asarray(v._data_) for k, v in jm.state_dict().items()}
    off = total = 0
    for name, p in tm.state_dict().items():
        got, want = p.detach().numpy(), jstate[name]
        off += int((np.abs(got - want) > PARAM_ATOL).sum())
        total += got.size
        np.testing.assert_allclose(got, want, rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, err_msg=name)
    assert off <= 1e-4 * total, (off, total)


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("compiled", [True, False],
                         ids=["compiled", "eager"])
@pytest.mark.parametrize("kind", ["gpt", "llama"])
def test_fit_matches_jax_fit(kind, compiled, accum):
    x, y = _data()
    jm = _jax_model(kind)
    tm = _port_model(kind, jm)
    _, want = _jax_fit(jm, x, y, compiled, accum)
    fallbacks = monitor.get_monitor_value("jit.compiled_step_fallback")
    model, got = _port_fit(tm, x, y, compiled, accum)
    assert len(got) == len(want) == 8
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    _assert_params_close(tm, jm)
    cs = model._compiled_step
    if compiled:
        assert cs.compiled and monitor.get_monitor_value("jit.compiled_step_fallback") == fallbacks
    else:
        assert cs is None


def test_evaluate_and_predict_match_jax():
    x, y = _data(rows=6, seed=2)
    jm = _jax_model("gpt")
    tm = _port_model("gpt", jm)
    jmodel = JModel(jm).prepare(loss=jnn.CrossEntropyLoss())
    model = Model(tm).prepare(loss=CrossEntropyLoss())
    want = jmodel.evaluate(JTensorDataset([x, y]), batch_size=2, verbose=0)
    got = model.evaluate(TensorDataset([x, y]), batch_size=2, verbose=0)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL)
    jout = jmodel.predict(JTensorDataset([x]), batch_size=4)
    out = model.predict(TensorDataset([x]), batch_size=4,
                        stack_outputs=True)
    want_logits = np.concatenate([np.asarray(o._data_) for o in jout])
    assert out.shape == want_logits.shape == (6, SEQ, 512)
    np.testing.assert_allclose(out.numpy(), want_logits, rtol=1e-5,
                               atol=1e-5)
    loss, logits = model.eval_batch([torch.from_numpy(x[:2])],
                                    [torch.from_numpy(y[:2])])
    np.testing.assert_allclose(logits.numpy(), want_logits[:2], rtol=1e-5,
                               atol=1e-5)


def test_save_then_load_round_trips(tmp_path):
    x, y = _data()
    model, _ = _port_fit(_port_model("llama"), x, y, True, epochs=1)
    path = str(tmp_path / "m" / "final")
    model.save(path)
    other = Model(_port_model("llama"))
    other.prepare(AdamW(LR, parameters=other.network.parameters()),
                  CrossEntropyLoss())
    other.load(path)
    for (k, a), (_, b) in zip(model.network.state_dict().items(),
                              other.network.state_dict().items()):
        assert torch.equal(a, b), k
    sa, sb = model._optimizer.state_dict(), other._optimizer.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        if torch.is_tensor(sa[k]):
            assert torch.equal(sa[k], sb[k]), k
        else:
            assert sa[k] == sb[k], k


def test_resume_from_a_jax_model_checkpoint(tmp_path):
    """JAX trains 2 epochs with ModelCheckpoint; JAX and the port each
    resume from that ``ckpt-N`` for a third epoch: equal losses."""
    x, y = _data()
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    _jax_fit(_jax_model("gpt"), x, y, True, save_dir=jdir)
    shutil.copytree(jdir, pdir)
    jm2 = _jax_model("gpt")
    for p in jm2.parameters():                 # resume must overwrite these
        p.set_value(np.zeros(p.shape, np.float32))
    _, want = _jax_fit(jm2, x, y, True, epochs=3, save_dir=jdir,
                       resume=True)
    tm = _port_model("gpt")
    model, got = _port_fit(tm, x, y, True, epochs=3, save_dir=pdir,
                           resume=True)
    assert len(got) == len(want) == 4
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    _assert_params_close(tm, jm2)
    assert model._optimizer._step_count == 12
    assert CheckpointManager(pdir, map_location="cpu").latest_step() == 2


# ---- tests/test_fault_tolerance.py's hapi resume cases ----

class _LinData:
    def __init__(self):
        rng = np.random.default_rng(0)
        self.x = rng.standard_normal((16, 4)).astype(np.float32)
        self.y = rng.standard_normal((16, 2)).astype(np.float32)

    def __len__(self):
        return 16

    def __getitem__(self, i):
        return self.x[i], self.y[i]


def _fit_model():
    net = Linear(4, 2, device="cpu")
    with torch.no_grad():
        net.reset_parameters(torch.Generator().manual_seed(0))
    model = Model(net)
    model.prepare(optimizer=SGD(0.05, parameters=net.parameters()),
                  loss=lambda out, y: ((out - y) ** 2).mean())
    return model


def test_hapi_fit_resume_and_max_to_keep(tmp_path):
    data = _LinData()
    save_dir = str(tmp_path / "ck")
    model = _fit_model()
    model.fit(data, batch_size=8, epochs=3, verbose=0, save_dir=save_dir,
              max_to_keep=2)
    ref = model.network.weight.detach().clone()
    assert len(CheckpointManager(save_dir).all_steps()) == 2

    model2 = _fit_model()
    hist = model2.fit(data, batch_size=8, epochs=3, verbose=0,
                      save_dir=save_dir, max_to_keep=2, resume=True)
    assert hist["loss"] == []                  # nothing left to train
    assert torch.equal(model2.network.weight, ref)

    model3 = _fit_model()
    model3.fit(data, batch_size=8, epochs=5, verbose=0, save_dir=save_dir,
               max_to_keep=2, resume=True)
    assert CheckpointManager(save_dir).latest_step() == 4
    assert not torch.equal(model3.network.weight, ref)


def test_hapi_fit_resume_skips_torn_checkpoint(tmp_path):
    data = _LinData()
    save_dir = str(tmp_path / "ck")
    model = _fit_model()
    model.fit(data, batch_size=8, epochs=2, verbose=0, save_dir=save_dir)
    newest = CheckpointManager(save_dir).latest_step()
    os.remove(os.path.join(save_dir, step_dir_name(newest), "manifest.json"))
    model2 = _fit_model()
    hist = model2.fit(data, batch_size=8, epochs=2, verbose=0,
                      save_dir=save_dir, resume=True)
    assert len(hist["loss"]) == 1              # epoch 1 ran again
    assert CheckpointManager(save_dir).latest_step() == newest


#: the drills' worker: fit over a data.Pipeline (prefetched on the CPU)
#: with a ModelCheckpoint every epoch; each step's loss is appended to
#: losses.log, each start to incarnations.log, and a callback reports the
#: global step to the ``step`` fault point.
WORKER = textwrap.dedent("""
    import os, sys
    import numpy as np, torch
    from paddle_tpu_torch import data as D
    from paddle_tpu_torch.hapi import Callback, Model
    from paddle_tpu_torch.nn import Linear, MSELoss
    from paddle_tpu_torch.optimizer import SGD
    from paddle_tpu_torch.utils import fault_injection

    out = sys.argv[1]

    class Rows:
        def __init__(self):
            rng = np.random.default_rng(0)
            self.x = rng.standard_normal((16, 4)).astype(np.float32)
            self.y = rng.standard_normal((16, 2)).astype(np.float32)
        def __len__(self):
            return 16
        def __getitem__(self, i):
            return self.x[i], self.y[i]

    class Log(Callback):
        it = 0
        def on_train_batch_end(self, step, logs=None):
            with open(os.path.join(out, "losses.log"), "a") as f:
                f.write(repr(logs["loss"]) + "\\n")
            fault_injection.check_step(Log.it)
            Log.it += 1

    net = Linear(4, 2, device="cpu")
    with torch.no_grad():
        net.reset_parameters(torch.Generator().manual_seed(7))
    model = Model(net).prepare(SGD(0.05, parameters=net.parameters()),
                               MSELoss())
    pipe = D.pipeline(Rows()).shuffle(seed=3).batch(4).device_prefetch(
        2, device="cpu")
    with open(os.path.join(out, "incarnations.log"), "a") as f:
        f.write("start\\n")
    model.fit(pipe, epochs=3, verbose=0, log_freq=1, callbacks=[Log()],
              save_dir=os.path.join(out, "ckpts"), resume=True)
""")


def _run_worker(tmp_path, outdir, fault=""):
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("FLAGS_fault_inject", None)
    if fault:
        env["FLAGS_fault_inject"] = fault
    return subprocess.run([sys.executable, str(script), str(outdir)],
                          env=env, capture_output=True, text=True,
                          timeout=240)


def _losses(outdir):
    with open(os.path.join(outdir, "losses.log")) as f:
        return [float(v) for v in f.read().split()]


@pytest.fixture(scope="module")
def clean_run(tmp_path_factory):
    base = tmp_path_factory.mktemp("clean")
    out = base / "out"
    out.mkdir()
    r = _run_worker(base, out)
    assert r.returncode == 0, r.stderr
    return _losses(out)


def test_drill_torn_write_crash_then_resume(tmp_path, clean_run):
    d = tmp_path / "torn"
    d.mkdir()
    r = _run_worker(tmp_path, d, f"ckpt_write:after_bytes=50,"
                                 f"file={step_dir_name(1)}")
    assert r.returncode == 23, r.stderr        # killed writing epoch 1's
    first = _losses(d)
    assert len(first) == 8
    r = _run_worker(tmp_path, d)
    assert r.returncode == 0, r.stderr
    assert "torn/corrupt" in r.stderr          # skipped, removed, redone
    resumed = _losses(d)[8:]
    assert len(clean_run) == 12 and first[:4] + resumed == clean_run


def test_drill_sigterm_preemption_relaunch_resumes(tmp_path, clean_run):
    d = tmp_path / "preempt"
    d.mkdir()
    r = _run_worker(tmp_path, d, "step:sigterm_at=5")
    assert r.returncode == ELASTIC_EXIT_CODE, r.stderr
    first = _losses(d)
    assert len(first) == 6                     # saved mid-epoch 1, exited
    man = CheckpointManager(str(d / "ckpts"), map_location="cpu")
    state, _step = man.restore_latest()
    assert state["next_epoch"] == 1
    assert state["data_pipeline"]["stages"]["shard"]["global_position"] == 8
    r = _run_worker(tmp_path, d)
    assert r.returncode == 0, r.stderr
    assert first + _losses(d)[6:] == clean_run


# ---- losses and metrics ----

def _pair(arr):
    return torch.from_numpy(arr), paddle.to_tensor(arr)


CE_CASES = {
    "mean": dict(),
    "sum-ignore": dict(reduction="sum", ignore_index=3),
    "none": dict(reduction="none"),
    "weight": dict(weight=True),
    "weight-sum": dict(weight=True, reduction="sum"),
    "soft": dict(soft_label=True),
    "soft-smooth": dict(soft_label=True, label_smoothing=0.1),
    "smooth": dict(label_smoothing=0.2),
    "axis1": dict(axis=1),
    "no-softmax": dict(use_softmax=False),
    "label-last-dim": dict(keepdim=True),
}


@pytest.mark.parametrize("case", sorted(CE_CASES))
def test_cross_entropy_loss_matches_jax(case):
    kw = dict(CE_CASES[case])
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((6, 4, 7)).astype(np.float32)
    labels = rng.integers(0, 7, (6, 4))
    labels[0, :2] = -100
    if kw.pop("keepdim", False):
        labels = labels[..., None]
    if kw.get("axis") == 1:
        logits = logits[:, 0, :]
        labels = labels[:, 0].clip(0)
    if kw.pop("weight", False):
        kw["weight"] = rng.uniform(0.5, 2.0, 7).astype(np.float32)
        labels = labels.clip(0)
    if kw.get("soft_label"):
        soft = rng.uniform(0, 1, logits.shape).astype(np.float32)
        labels = soft / soft.sum(-1, keepdims=True)
    if kw.get("use_softmax") is False:
        e = np.exp(logits)
        logits = (e / e.sum(-1, keepdims=True)).astype(np.float32)
    t_in, j_in = _pair(logits)
    t_lbl, j_lbl = _pair(labels)
    tkw, jkw = dict(kw), dict(kw)
    if "weight" in kw:
        tkw["weight"], jkw["weight"] = _pair(kw["weight"])
    got = CrossEntropyLoss(**tkw)(t_in, t_lbl)
    want = jnn.CrossEntropyLoss(**jkw)(j_in, j_lbl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want._data_),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_mse_loss_matches_jax(reduction):
    rng = np.random.default_rng(1)
    a, b = (rng.standard_normal((5, 3)).astype(np.float32) for _ in "ab")
    got = MSELoss(reduction)(*(torch.from_numpy(v) for v in (a, b)))
    want = jnn.MSELoss(reduction)(*(paddle.to_tensor(v) for v in (a, b)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want._data_),
                               rtol=1e-6)


def test_cross_entropy_loss_bf16_fused_path_is_the_models_loss():
    tm = _port_model("gpt")
    x, y = (torch.from_numpy(v[:2]) for v in _data())
    logits, loss = tm(x, labels=y)
    assert torch.equal(CrossEntropyLoss()(logits, y), loss)


def test_metrics_match_jax():
    rng = np.random.default_rng(4)
    pred = rng.standard_normal((20, 5)).astype(np.float32)
    label = rng.integers(0, 5, (20, 1))
    prob = rng.uniform(0, 1, (20,)).astype(np.float32)
    binary = rng.integers(0, 2, (20,))
    for mk, args in ((lambda m: m.Accuracy(topk=(1, 3)), (pred, label)),
                     (lambda m: m.Precision(), (prob, binary)),
                     (lambda m: m.Recall(), (prob, binary)),
                     (lambda m: m.Auc(num_thresholds=255), (prob, binary))):
        a, b = mk(metric), mk(jmetric)
        ta = tuple(torch.from_numpy(v) for v in args)
        ja = tuple(paddle.to_tensor(v) for v in args)
        a.update(*a.compute(*ta))
        b.update(*b.compute(*ja))
        np.testing.assert_allclose(a.accumulate(), b.accumulate(),
                                   rtol=1e-6)
        assert a.name() == b.name()
    got = metric.accuracy(torch.from_numpy(pred), torch.from_numpy(label),
                          k=2)
    want = jmetric.accuracy(paddle.to_tensor(pred), paddle.to_tensor(label),
                            k=2)
    # XLA takes the mean as a product by 1/n, torch divides: 1 ulp apart
    np.testing.assert_allclose(float(got), float(np.asarray(want._data_)),
                               rtol=1e-6)


def test_fit_updates_metrics_and_evaluates():
    x, y = _data(rows=4)
    tm = _port_model("gpt")
    model = Model(tm).prepare(AdamW(LR, parameters=tm.parameters()),
                              CrossEntropyLoss())

    class TokenAcc(metric.Accuracy):
        def compute(self, pred, label, *args):
            return super().compute(pred.reshape(-1, pred.shape[-1]), label)

    model._metrics = [TokenAcc()]
    hist = model.fit(TensorDataset([x, y]), TensorDataset([x, y]),
                     batch_size=2, epochs=1, verbose=0, shuffle=False)
    assert len(hist["loss"]) == 1
    assert 0.0 <= model._metrics[0].accumulate() <= 1.0


# ---- async ModelCheckpoint, preemption handler, what raises ----

def test_async_model_checkpoint_equals_a_synchronous_one(tmp_path):
    x, y = _data()
    dirs = {}
    for mode in (False, True):
        d = str(tmp_path / f"async{mode}")
        _port_fit(_port_model("gpt"), x, y, True, save_dir=d,
                  callbacks=[ModelCheckpoint(1, d, async_save=mode)])
        dirs[mode] = CheckpointManager(d, map_location="cpu")
    for step in (0, 1):
        a, b = dirs[False].restore(step), dirs[True].restore(step)
        for k in a["model"]:
            assert torch.equal(a["model"][k], b["model"][k]), (step, k)
        assert a["next_epoch"] == b["next_epoch"] == step + 1
        for k, v in a["optimizer"].items():
            if torch.is_tensor(v):
                assert torch.equal(v, b["optimizer"][k]), (step, k)


def test_preemption_handler_catches_sigterm():
    h = PreemptionHandler().install()
    try:
        hit = []
        h.add_callback(lambda: hit.append(1))
        assert not h.preempted()
        os.kill(os.getpid(), signal.SIGTERM)
        assert h.preempted()
    finally:
        h.uninstall()
    assert signal.getsignal(signal.SIGTERM) is not h._on_signal
    with pytest.raises(SystemExit) as e:
        h.exit_for_relaunch()
    assert e.value.code == ELASTIC_EXIT_CODE == 101


def test_out_of_slice_names_raise(tmp_path):
    tm = _port_model("gpt")
    opt = AdamW(LR, parameters=tm.parameters())
    with pytest.raises(NotImplementedError, match="A9"):
        Model(tm).prepare(opt, CrossEntropyLoss(), jit=True)
    model = Model(tm).prepare(opt, CrossEntropyLoss())
    with pytest.raises(NotImplementedError, match="A9"):
        model.summary()
    x, y = _data(rows=2)
    ds = TensorDataset([x, y])
    # the training sentinel is ported: fit runs under it, in a unit-scale
    # scaler, on a compiled step with the health output
    port_flags.set_flags({"FLAGS_sentinel": True})
    model.fit(ds, verbose=0)
    assert model._scaler._sentinel_wrapper
    assert model._compiled_step._sentinel
    # hot-spare recovery, a resume from a layout-bearing checkpoint and a
    # ModelCheckpoint over two ranks raised (ROADMAP A8) until they were
    # ported: fit runs with the agent; a manifest whose layout is not a
    # layout is refused with LayoutError (no quiet whole-state load); a
    # two-rank ModelCheckpoint is a ShardedCheckpointer over dp 2
    from paddle_tpu_torch.distributed.reshard import (LayoutError,
                                                      ShardedCheckpointer)
    port_flags.set_flags({"FLAGS_sentinel": False, "FLAGS_hot_spare": True})
    try:
        model.fit(ds, verbose=0)
    finally:
        port_flags.set_flags({"FLAGS_hot_spare": False})
    d = tmp_path / step_dir_name(0)
    d.mkdir()
    (d / "state.pkl").write_bytes(b"x")
    write_manifest(str(d), step=0, layout={"world_size": 2})
    with pytest.raises(LayoutError, match="layout version"):
        model.fit(ds, verbose=0, save_dir=str(tmp_path), resume=True)
    cb = ModelCheckpoint(save_dir=str(tmp_path / "m"))
    model._nranks = 2
    cb.set_model(model)
    assert isinstance(cb.manager, ShardedCheckpointer)
    assert (cb.manager.mesh.axes, cb.manager.mesh.shape) == (("dp",), (2,))
    model._nranks = 1
