"""The port's telemetry on the metrics registry against the JAX
package's: the same tiny greedy serve run in both engines gives the same
``serving_stats()`` keys and equal counts that do not depend on timing,
and the Prometheus expositions (parsed by tools/check_telemetry.py's
``parse_prometheus``) the same family names, types and label names; the
request label cap converges (tests/test_observability.py's case); the
``ckpt.*``, ``data.*``, ``io.*`` and ``jit.*`` families after the same
calls in both packages.  Each test runs against a fresh registry in each
package (the process-wide ``REGISTRY`` swapped for the test), so no other
test's families leak in."""
import importlib

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import data as jdata
from paddle_tpu import io as jio
from paddle_tpu import nn as jnn
from paddle_tpu.framework import checkpoint_manager as jcm
from paddle_tpu.framework.train_step import \
    CompiledTrainStep as JaxCompiledTrainStep
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_config as jax_llama_config
from paddle_tpu.observability import registry as jregistry
from paddle_tpu.serving import Engine as JaxEngine
from paddle_tpu.serving import ServingConfig as JaxServingConfig
from paddle_tpu.serving import stats as jstats
from paddle_tpu.utils import flags as jflags
from paddle_tpu.utils import monitor as jmonitor
from paddle_tpu_torch import convert
from paddle_tpu_torch import data as tdata
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.framework import CompiledTrainStep
from paddle_tpu_torch.framework import checkpoint_manager as tcm
from paddle_tpu_torch.models import LlamaForCausalLM, llama_config
from paddle_tpu_torch.nn import Linear
from paddle_tpu_torch.observability import registry as tregistry
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.serving import Engine, ServingConfig
from paddle_tpu_torch.serving import stats as tstats
from paddle_tpu_torch.utils import flags as tflags
from paddle_tpu_torch.utils import monitor as tmonitor

check_telemetry = importlib.import_module("tools.check_telemetry")
TIMING_FREE = ("requests_submitted", "requests_completed",
               "tokens_generated", "prefill_chunks", "prefill_steps",
               "requests_rejected_queue_full", "requests_cancelled_shutdown",
               "tick_fallbacks", "adapters_loaded", "trace_spans")


@pytest.fixture
def registries(monkeypatch):
    """A fresh process registry in each package for the test."""
    monkeypatch.setattr(tregistry, "REGISTRY", tregistry.MetricsRegistry())
    monkeypatch.setattr(jregistry, "REGISTRY", jregistry.MetricsRegistry())


@pytest.fixture(scope="module")
def pair():
    paddle.seed(9)
    jm = JaxLlama(jax_llama_config("tiny", max_seq_len=64))
    jm.eval()
    tm = LlamaForCausalLM(llama_config("tiny", max_seq_len=64),
                          device="cpu")
    convert.load_paddle_tpu_state(
        tm, {k: v.numpy() for k, v in jm.state_dict().items()})
    return jm, tm


def _serve(cls, cfg, model, prompts):
    with cls(model, cfg) as eng:
        futs = [eng.submit(p, max_new_tokens=6) for p in prompts]
        outs = [f.result(timeout=180).output_ids for f in futs]
    return outs, eng.stats()


def _families(text):
    """{family: type} of the exposition's serving families, and {series:
    set of label-name tuples}, through check_telemetry's strict parser."""
    series, typed, errors = check_telemetry.parse_prometheus(text)
    assert errors == []
    types = {k: v for k, v in typed.items() if k.startswith("serving_")}
    labels = {name: {tuple(sorted(lab)) for lab, _ in rows}
              for name, rows in series.items() if name.startswith("serving_")}
    return types, labels


def test_serve_run_stats_and_exposition_match_jax(pair, registries):
    """Three prompts through two slots with the compiled tick on in both
    engines: the tokens equal; ``serving_stats()`` has JAX's keys, and its
    timing-free counts equal JAX's; the expositions carry the same
    ``serving_*`` families with the same types and label names (the
    per-request ``request_tokens{request_id}`` family included)."""
    jm, tm = pair
    on = {"FLAGS_compiled_tick": True}
    tflags.set_flags(on)
    jflags.set_flags(on)
    prompts = [np.random.default_rng(i).integers(0, 512, (n,))
               .astype(np.int32) for i, n in enumerate((5, 19, 40))]
    touts, tst = _serve(Engine, ServingConfig(num_slots=2), tm, prompts)
    jouts, jst = _serve(JaxEngine, JaxServingConfig(num_slots=2), jm,
                        prompts)
    for t, j in zip(touts, jouts):
        np.testing.assert_array_equal(t, j)
    assert set(tst) == set(jst)
    assert tst == tstats.serving_stats()
    for key in TIMING_FREE:
        assert tst[key] == jst[key], key
    assert tst["requests_completed"] == 3 and tst["tokens_generated"] == 18
    assert tst["tick_compiled_hits"] > 0 and tst["decode_steps"] > 0
    ttypes, tlabels = _families(tregistry.render_prometheus())
    jtypes, jlabels = _families(jregistry.render_prometheus())
    assert ttypes == jtypes
    assert tlabels == jlabels
    assert ttypes["serving_tick_ms"] == "histogram"
    assert tlabels["serving_request_tokens"] == {("request_id",)}
    assert tmonitor.all_stats()["serving.request_tokens{request_id=0}"] == 6


def test_reset_serving_stats_keeps_other_families(registries):
    """Engine start resets every ``serving.*`` family (its labelled
    children too) and nothing else, as JAX's does."""
    for mod, mon in ((tstats, tmonitor), (jstats, jmonitor)):
        mon.incr("io.batches_fetched", 2)
        mod.incr("decode_steps", 3)
        mod.request_observe("request_tokens", 7, 5)
        mod.reset_serving_stats()
        s = mon.all_stats()
        assert s["io.batches_fetched"] == 2
        assert s["serving.decode_steps"] == 0
        assert "serving.request_tokens{request_id=7}" not in s


def test_request_label_cardinality_converges(registries):
    """The per-request family keeps at most FLAGS_serving_request_label_cap
    children, the most recent ids, in both packages; re-touching an old id
    brings it back and evicts the least recent."""
    saved = tflags.get_flags(["FLAGS_serving_request_label_cap"])
    kept = {}
    try:
        for name, mod, reg, fl in (
                ("port", tstats, tregistry, tflags),
                ("jax", jstats, jregistry, jflags)):
            fl.set_flags({"FLAGS_serving_request_label_cap": 8})
            for rid in range(100):
                mod.request_observe("request_tokens", rid, 1)
            mod.request_observe("request_tokens", 0, 1)
            fam = reg.counter("serving.request_tokens",
                              labelnames=("request_id",))
            kept[name] = {vals[0] for vals, _ in fam._samples()}
    finally:
        tflags.set_flags(saved)
        jflags.set_flags(saved)
    assert kept["port"] == kept["jax"] == \
        {"0"} | {str(r) for r in range(93, 100)}


def _family_values(mon, prefix):
    return {k: v for k, v in mon.all_stats().items() if k.startswith(prefix)}


def test_checkpoint_families_match_jax(registries, tmp_path):
    """Three saves under max_to_keep=2, an anchor, a torn newest step and
    a restore: ``ckpt.saves``, ``restores``, ``anchor_saves``,
    ``retention_deleted``, ``torn_skipped`` and the ``save_ms`` count equal
    JAX's; async managers declare ``ckpt.save_blocked_ms`` at 0."""
    def drive(cm, root, state):
        mgr = cm.CheckpointManager(str(root), max_to_keep=2,
                                   **({"map_location": "cpu"}
                                      if cm is tcm else {}))
        for s in range(3):
            mgr.save(state, step=s)
        mgr.save_anchor(state, step=2)
        (root / cm.step_dir_name(2) / "manifest.json").unlink()
        assert mgr.restore_latest()[1] == 1
        cm.CheckpointManager(str(root / "async"), async_save=True)
    drive(tcm, tmp_path / "port", {"w": torch.ones(3)})
    drive(jcm, tmp_path / "jax", {"w": paddle.to_tensor(np.ones(3))})
    tvals = _family_values(tmonitor, "ckpt.")
    jvals = _family_values(jmonitor, "ckpt.")
    assert set(tvals) == set(jvals)
    for k in jvals:
        if not k.endswith(".sum"):      # times differ, counts do not
            assert tvals[k] == jvals[k], k
    assert tvals["ckpt.saves"] == 3 and tvals["ckpt.save_ms.count"] == 3
    assert tvals["ckpt.save_blocked_ms.count"] == 0


class _Rows:
    """16 token rows, index 3 unreadable; row 5 longer than a packed row."""

    def __len__(self):
        return 16

    def __getitem__(self, i):
        if i == 3:
            raise ValueError("unreadable record")
        return np.arange(1, (12 if i == 5 else 3) + 1, dtype=np.int64)


def test_data_and_io_families_match_jax(registries):
    """A packed pipeline over rows with one unreadable record and one
    document longer than a row, and a DataLoader's three batches: the
    ``data.*`` and ``io.*`` families hold JAX's counts after the same
    calls (``data.records_skipped``, ``data.docs_truncated``,
    ``data.batches`` / ``starved_steps`` of a meter fed the same arrivals,
    ``io.batches_fetched`` and the ``io.fetch_ms`` / ``data.fetch_ms``
    counts)."""
    for D, io_ in ((tdata, tio), (jdata, jio)):
        pipe = D.pipeline(_Rows(), corrupt_threshold=4).pack(8).batch(2)
        list(pipe)
        meter = pipe.goodput
        meter.record_consume(0.0, 0.5)
        meter.record_consume(2.0, 0.0)
        xs = np.arange(24, dtype=np.float32).reshape(12, 2)
        ds = io_.TensorDataset([xs if D is jdata else torch.from_numpy(xs)])
        list(io_.DataLoader(ds, batch_size=4))
    for prefix in ("data.", "io."):
        tvals = _family_values(tmonitor, prefix)
        jvals = _family_values(jmonitor, prefix)
        assert set(tvals) == set(jvals), prefix
        for k in jvals:
            if not k.endswith(".sum") and k != "data.input_bound":
                assert tvals[k] == jvals[k], k
    assert tmonitor.get_monitor_value("data.records_skipped") == 1
    assert tmonitor.get_monitor_value("data.docs_truncated") == 1
    assert tmonitor.get_monitor_value("data.starved_steps") == 1
    assert tmonitor.get_monitor_value("io.batches_fetched") == 3
    assert tmonitor.get_monitor_value("io.fetch_ms.count") == 3


def _jax_mlp():
    paddle.seed(0)
    net = jnn.Sequential(jnn.Linear(8, 16), jnn.ReLU(), jnn.Linear(16, 4))
    opt = paddle.optimizer.AdamW(learning_rate=0.01,
                                 parameters=net.parameters())
    return net, opt


def _port_mlp():
    net = torch.nn.Sequential(Linear(8, 16, device="cpu"), torch.nn.ReLU(),
                              Linear(16, 4, device="cpu"))
    return net, AdamW(learning_rate=0.01, parameters=net.parameters())


@pytest.mark.parametrize("compiled", [True, False], ids=["on", "off"])
def test_jit_families_match_jax(registries, compiled):
    """Five steps of a compiled train step on an MLP, the flag on and off:
    ``jit.compiled_step_hit`` (4 on), ``jit.compiled_step_fallback`` (5
    off) and ``jit.compiled_step_compile`` (one graph / one program) equal
    JAX's."""
    saved = tflags.get_flags(["FLAGS_compiled_train_step"])
    flag = {"FLAGS_compiled_train_step": compiled}
    tflags.set_flags(flag)
    jflags.set_flags(flag)
    rng = np.random.default_rng(0)
    batches = [(rng.normal(size=(4, 8)).astype(np.float32),
                rng.normal(size=(4, 4)).astype(np.float32))
               for _ in range(5)]
    try:
        jnet, jopt = _jax_mlp()
        jcs = JaxCompiledTrainStep(
            lambda x, y: ((jnet(x) - y) ** 2).mean(), jopt, network=jnet)
        tnet, topt = _port_mlp()
        tcs = CompiledTrainStep(
            lambda x, y: ((tnet(x) - y) ** 2).mean(), topt, network=tnet)
        for x, y in batches:
            jcs(paddle.to_tensor(x), paddle.to_tensor(y))
            tcs(torch.from_numpy(x), torch.from_numpy(y))
    finally:
        tflags.set_flags(saved)
        jflags.set_flags({"FLAGS_compiled_train_step": True})
    tvals = _family_values(tmonitor, "jit.compiled_step")
    jvals = _family_values(jmonitor, "jit.compiled_step")
    assert tvals == jvals
    assert tvals == ({"jit.compiled_step_hit": 4,
                      "jit.compiled_step_compile": 1} if compiled
                     else {"jit.compiled_step_fallback": 5})
