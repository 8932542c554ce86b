"""The port's telemetry (paddle_tpu_torch/observability, utils/monitor.py,
utils/log.py, ops/flops.py) against the JAX package's on the CPU.

- The registry: the same operations on a fresh registry in each package
  give the same Prometheus exposition text and the same JSON snapshot,
  exactly; ``log_buckets`` and the histogram percentiles are equal.
- The monitor shim: the same flat ``all_stats`` keys and values as JAX's,
  ``reset`` clearing the derived keys.
- The exporter: its lines pass ``tools/check_telemetry.py --snapshots``
  (``check_snapshots``); with the flag empty nothing starts.
- The flight recorder: the bounded ring, the disabled no-op, and in child
  processes the dump on an unhandled exception and on SIGTERM through the
  port's ``PreemptionHandler`` (whose own flag still rises: the dump
  chains with it).
- ``StepMetrics`` on the host clock: counts, throughput, MFU against a
  given peak, the RSS watermark; ``fit`` runs under it.
- The FLOPs counter on the tiny GPT and Llama: every op's count equal to
  JAX ``FlopsCounter.by_op``'s, exactly, but the flash attention's, which
  JAX reads in the wrong layout (the port counts 4·B·H·S²·D / 2; JAX,
  fed head-major tensors, reads S as H); with JAX's attention estimator
  given the layout it expects, the train-step totals are equal.
"""
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import observability as jobs
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_config as jax_llama_config
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.gpt import gpt_config as jax_gpt_config
from paddle_tpu.ops import flops as jflops
from paddle_tpu.utils import monitor as jmonitor
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.hapi import Model
from paddle_tpu_torch.models import (GPTForCausalLM, LlamaForCausalLM,
                                     gpt_config, llama_config)
from paddle_tpu_torch.nn import CrossEntropyLoss, Linear
from paddle_tpu_torch.observability import (FlightRecorder, MetricsExporter,
                                            MetricsRegistry, StepMetrics)
from paddle_tpu_torch.observability import exporter as exp_mod
from paddle_tpu_torch.observability.step_metrics import PEAK_FLOPS
from paddle_tpu_torch.ops.flops import FlopsCounter
from paddle_tpu_torch.optimizer import SGD
from paddle_tpu_torch.utils import flags as port_flags
from paddle_tpu_torch.utils import monitor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
try:
    import check_telemetry
finally:
    sys.path.pop(0)

SEQ = 32
GPT_TINY = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
                max_seq_len=SEQ)
LLAMA_TINY = dict(hidden_size=64, num_heads=4, num_kv_heads=2,
                  intermediate_size=192, max_seq_len=SEQ)


# ------------------------------------------------------------- registry


def _ops_basic(reg):
    reg.counter("req.total", "requests").inc(3)
    reg.gauge("queue.depth", "depth").set(7)
    reg.gauge("queue.depth2").inc(2.5)
    h = reg.histogram("lat.ms", "latency (ms)")
    for v in (0.5, 1.0, 3.3, 12.0, 250.0, 7e5):
        h.observe(v)


def _ops_labels(reg):
    c = reg.counter("serving.routed", "routed", labelnames=("adapter", "x"))
    c.labels(adapter="a", x="1").inc()
    c.labels("b", 'q"uote\\n').inc(4)
    g = reg.gauge("device.memory.peak_bytes", "peak",
                  labelnames=("device",))
    g.labels(device="0").max(10)
    g.labels(device="0").max(4)
    h = reg.histogram("9bad-name", "help with \\ and\nnewline",
                      labelnames=("k",), buckets=(1.0, 2.0, 5.0))
    h.labels(k="v").observe(1.5)
    h.labels(k="v").observe(10)


def _ops_lru(reg):
    c = reg.counter("per.request", "per request", labelnames=("id",))
    for i in range(6):
        c.labels_lru(3, id=str(i)).inc(i)
    reg.histogram("empty.hist")
    reg.gauge("neg").dec(3)


@pytest.mark.parametrize("ops", [_ops_basic, _ops_labels, _ops_lru],
                         ids=lambda f: f.__name__)
def test_registry_exposition_matches_jax(ops):
    mine, theirs = MetricsRegistry(), jobs.MetricsRegistry()
    ops(mine)
    ops(theirs)
    assert mine.render_prometheus() == theirs.render_prometheus()
    assert mine.dump_json() == theirs.dump_json()
    series, typed, errors = check_telemetry.parse_prometheus(
        mine.render_prometheus())
    assert not errors, errors


@pytest.mark.parametrize("args", [(), (1e-3, 10.0, 4), (0.5, 5e3, 1)])
def test_log_buckets_and_percentiles_match_jax(args):
    assert obs.log_buckets(*args) == jobs.log_buckets(*args)
    rng = np.random.default_rng(0)
    mine = obs.Histogram("h", buckets=obs.log_buckets(*args))
    theirs = jobs.Histogram("h", buckets=jobs.log_buckets(*args))
    for v in rng.lognormal(1.0, 2.0, 200):
        mine.observe(v)
        theirs.observe(v)
    assert mine.snapshot() == theirs.snapshot()


def test_registry_type_clash_raises():
    reg = MetricsRegistry()
    reg.counter("x")
    with pytest.raises(TypeError, match="already registered"):
        reg.gauge("x")
    with pytest.raises(ValueError, match="cannot decrease"):
        reg.counter("y").inc(-1)


def test_monitor_shim_matches_jax():
    """incr / set_value / observe / all_stats / get_monitor_value / reset:
    the JAX shim's keys and values."""
    got = {}
    for name, mod in (("port", monitor), ("jax", jmonitor)):
        p = f"shimtest.{name}."
        mod.incr(p + "c", 2)
        mod.incr(p + "c", -1)
        mod.set_value(p + "g", 5)
        mod.observe(p + "h", 2.0)
        mod.observe(p + "h", 4.0)
        stats = {k[len(p):]: v for k, v in mod.all_stats().items()
                 if k.startswith(p)}
        vals = (mod.get_monitor_value(p + "h.sum"),
                mod.get_monitor_value(p + "h.count"),
                mod.get_monitor_value(p + "missing", -1))
        mod.reset(p + "h.sum")
        after = {k[len(p):]: v for k, v in mod.all_stats().items()
                 if k.startswith(p)}
        got[name] = (stats, vals, after)
    assert got["port"] == got["jax"]
    assert got["port"][0] == {"c": 1, "g": 5, "h.sum": 6.0, "h.count": 2}
    assert got["port"][2]["h.count"] == 0


# ------------------------------------------------------------- exporter


def test_exporter_lines_pass_check_telemetry(tmp_path):
    reg = MetricsRegistry()
    reg.counter("exp.ticks").inc(3)
    reg.histogram("exp.ms").observe(2.0)
    path = str(tmp_path / "metrics.jsonl")
    ex = MetricsExporter(path, interval_s=0.03, registry=reg).start()
    time.sleep(0.15)
    ex.stop()
    lines = [json.loads(line) for line in open(path) if line.strip()]
    assert len(lines) >= 2                 # periodic and final
    assert all(rec["schema_version"] == exp_mod.SNAPSHOT_SCHEMA_VERSION == 1
               for rec in lines)
    assert lines[-1]["counters"]["exp.ticks"] == 3
    n, errors = check_telemetry.check_snapshots(path)
    assert n == len(lines) and not errors, errors


def test_maybe_start_exporter_flag_gated(tmp_path):
    assert exp_mod.maybe_start_exporter() is None   # flag empty
    assert exp_mod.get_exporter() is None
    path = str(tmp_path / "auto.jsonl")
    port_flags.set_flags({"FLAGS_metrics_export_path": path,
                          "FLAGS_metrics_export_interval_s": 0.05})
    try:
        ex = exp_mod.maybe_start_exporter()
        assert ex is not None and ex.running
        assert exp_mod.maybe_start_exporter() is ex
    finally:
        port_flags.set_flags({"FLAGS_metrics_export_path": "",
                              "FLAGS_metrics_export_interval_s": 10.0})
        exp_mod.stop_exporter()
    n, errors = check_telemetry.check_snapshots(path)
    assert n >= 1 and not errors, errors


# ------------------------------------------------------ flight recorder


def test_flight_recorder_ring_is_bounded(tmp_path):
    fr = FlightRecorder(capacity=4)
    for i in range(10):
        fr.record("span", f"e{i}")
    assert [e["name"] for e in fr.events()] == ["e6", "e7", "e8", "e9"]
    out = fr.dump(path=str(tmp_path / "fr.json"), reason="test")
    data = json.load(open(out))
    assert data["reason"] == "test"
    assert [e["name"] for e in data["events"]] == ["e6", "e7", "e8", "e9"]
    assert "counters" in data["metrics"]
    assert all(e["ts"] > 0 and e["mono"] > 0 for e in data["events"])
    assert fr.dump(path=str(tmp_path / "x.json"), reason="test",
                   once=True) is None      # deduplicated by reason


def test_flight_recorder_disabled_is_noop(tmp_path):
    fr = FlightRecorder(capacity=0)
    fr.record("span", "x")
    assert fr.events() == []
    assert fr.dump(path=str(tmp_path / "no.json")) is None
    assert not os.path.exists(tmp_path / "no.json")


_WORKER = r'''
import sys, time
from paddle_tpu_torch.observability import StepMetrics, flight_recorder
from paddle_tpu_torch.utils import monitor
mode = sys.argv[1]
sm = StepMetrics(prefix="drill.", memory_every=1000)
monitor.incr("drill.runs")
if mode == "crash":
    for _ in range(3):
        with sm.step(examples=4):
            pass
    flight_recorder.record("drill", "about_to_fail")
    raise RuntimeError("synthetic training failure for the drill")
from paddle_tpu_torch.distributed.fleet.elastic import PreemptionHandler
handler = PreemptionHandler().install()
for _ in range(3):
    with sm.step(examples=4):
        pass
print("ready", flush=True)
deadline = time.monotonic() + 60
while not handler.preempted():
    with sm.step(examples=4):
        time.sleep(0.01)
    if time.monotonic() > deadline:
        raise SystemExit("never received SIGTERM")
handler.uninstall()
print("preempted", flush=True)
'''


def _run_worker(mode, tmp_path):
    dump = str(tmp_path / f"fr_{mode}.json")
    env = dict(os.environ, FLAGS_flight_recorder_path=dump, PYTHONPATH=REPO)
    proc = subprocess.Popen([sys.executable, "-c", _WORKER, mode], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, dump


def test_flight_recorder_dumps_on_unhandled_exception(tmp_path):
    proc, dump = _run_worker("crash", tmp_path)
    out, _ = proc.communicate(timeout=120)
    assert proc.returncode != 0
    assert os.path.exists(dump), out
    data = json.load(open(dump))
    assert data["reason"] == "exception"
    assert data["error"]["type"] == "RuntimeError"
    assert "synthetic training failure" in data["error"]["message"]
    assert any(e["kind"] == "step" for e in data["events"])
    assert data["metrics"]["counters"]["drill.runs"] == 1


def test_flight_recorder_dumps_on_sigterm_through_the_handler(tmp_path):
    """SIGTERM dumps the ring and the handler's own flag still rises (the
    loop ends and says so): the dump chains with PreemptionHandler."""
    proc, dump = _run_worker("sigterm", tmp_path)
    assert "ready" in proc.stdout.readline()
    proc.send_signal(signal.SIGTERM)
    out, _ = proc.communicate(timeout=120)
    assert proc.returncode == 0 and "preempted" in out, out
    data = json.load(open(dump))
    assert data["reason"] == "sigterm"
    assert any(e["kind"] == "preemption" for e in data["events"])
    assert any(e["kind"] == "step" for e in data["events"])


# ---------------------------------------------------------- step metrics


def test_step_metrics_throughput_and_mfu():
    reg = MetricsRegistry()
    sm = StepMetrics(prefix="t.", registry=reg, peak_flops=1e12,
                     tokens_per_example=16)
    sm.set_flops_per_step(2e9)
    for _ in range(4):
        with sm.step(examples=8):
            time.sleep(0.002)
    snap = sm.snapshot()
    assert snap["steps"] == 4
    assert snap["examples_total"] == 32
    assert snap["tokens_total"] == 32 * 16
    assert snap["step_time_ms"]["count"] == 4
    assert snap["step_time_ms"]["p50"] >= 1.0
    assert snap["tokens_per_sec"] > 0
    assert 0 < snap["mfu"] < 2.0
    assert snap["peak_flops"] == 1e12
    assert snap["memory"]["host"]["peak_rss_bytes"] > 0


def test_step_metrics_peak_flops():
    """FLAGS_peak_flops wins; the CPU has no table entry (no MFU); the
    H100 SXM's dense bf16 peak is the table's."""
    assert StepMetrics(prefix="pf0.", registry=MetricsRegistry()) \
        .peak_flops() is None
    port_flags.set_flags({"FLAGS_peak_flops": 5e11})
    try:
        sm = StepMetrics(prefix="pf.", registry=MetricsRegistry())
        assert sm.peak_flops() == 5e11
    finally:
        port_flags.set_flags({"FLAGS_peak_flops": 0.0})
    assert PEAK_FLOPS["NVIDIA H100 80GB HBM3"] == 989.4e12


class _Data:
    def __len__(self):
        return 32

    def __getitem__(self, i):
        rng = np.random.default_rng(i)
        return (rng.normal(size=(8,)).astype(np.float32),
                np.array([i % 2], dtype=np.int64))


def test_fit_reports_step_metrics_and_exports(tmp_path):
    """fit runs under StepMetrics (train. prefix): steps, examples, the
    counted FLOPs and an MFU against FLAGS_peak_flops; with the export
    flag set its lines pass check_telemetry."""
    net = torch.nn.Sequential(Linear(8, 8, device="cpu"), torch.nn.ReLU(),
                              Linear(8, 2, device="cpu"))
    with torch.no_grad():
        gen = torch.Generator().manual_seed(0)
        net[0].reset_parameters(gen)
        net[2].reset_parameters(gen)
    model = Model(net).prepare(SGD(0.1, parameters=net.parameters()),
                               CrossEntropyLoss())
    path = str(tmp_path / "fit.jsonl")
    reg = obs.REGISTRY
    steps0 = reg.counter("train.steps_total").value
    ex0 = reg.counter("train.examples_total").value
    port_flags.set_flags({"FLAGS_metrics_export_path": path,
                          "FLAGS_peak_flops": 1e9})
    try:
        model.fit(_Data(), batch_size=8, epochs=1, verbose=0, shuffle=False)
    finally:
        port_flags.set_flags({"FLAGS_metrics_export_path": "",
                              "FLAGS_peak_flops": 0.0})
        exp_mod.stop_exporter()
    snap = model.step_metrics.snapshot()
    assert snap["steps"] - steps0 == 4
    assert snap["examples_total"] - ex0 == 32
    # two linears (2 x 8 x (8*8 + 8*2)) and the relu (8 x 8), three times
    assert snap["flops_per_step"] == 3 * (2 * 8 * (8 * 8 + 8 * 2) + 8 * 8)
    assert snap["mfu"] > 0
    n, errors = check_telemetry.check_snapshots(path)
    assert n >= 1 and not errors, errors
    last = json.loads(open(path).read().splitlines()[-1])
    assert "train.step_time_ms" in last["histograms"]


# ----------------------------------------------------------------- FLOPs


def _flops_pair(kind):
    paddle.seed(0)
    if kind == "llama":
        jm = JaxLlama(jax_llama_config("tiny", **LLAMA_TINY))
        tm = LlamaForCausalLM(llama_config("tiny", **LLAMA_TINY),
                              device="cpu")
    else:
        jm = JaxGPT(jax_gpt_config("gpt2-124m", **GPT_TINY))
        tm = GPTForCausalLM(gpt_config("gpt2-124m", **GPT_TINY),
                            device="cpu")
    ids = np.random.default_rng(0).integers(0, 512, (2, SEQ))
    from paddle_tpu.core.state import no_grad
    with no_grad(), jflops.FlopsCounter() as jfc:
        jm(paddle.to_tensor(ids))
    with torch.no_grad(), FlopsCounter() as fc:
        tm(torch.from_numpy(ids))
    return jfc, fc


@pytest.mark.parametrize("kind", ["gpt", "llama"])
def test_train_step_flops_match_jax(kind):
    jfc, fc = _flops_pair(kind)
    assert sorted(fc.by_op) == sorted(jfc.by_op)
    for name, n in jfc.by_op.items():
        if name != "flash_attention":
            assert fc.by_op[name] == n, name
    # the attention the kernels compute: [B, S, H, D] = [2, 32, 4, 16]
    layers = 2
    want = layers * jflops._attention_flops(((2, SEQ, 4, 16),))
    assert fc.by_op["flash_attention"] == want
    # JAX's counter reads its head-major [B, H, S, D] call as S = H
    assert jfc.by_op["flash_attention"] == \
        layers * jflops._attention_flops(((2, 4, SEQ, 16),))
    jax_fixed = jfc.train_step_flops - 3 * jfc.by_op["flash_attention"] + \
        3 * want
    assert fc.train_step_flops == jax_fixed


def test_flops_of_lora_and_model_ops():
    """Model-code tensor ops outside the entries are counted under the
    JAX names (LoRA's A @ B * s + W: matmul, multiply, add); the ops inside
    an entry are not counted twice."""
    from paddle_tpu_torch.nn import attach_lora
    net = torch.nn.Sequential(Linear(8, 16, device="cpu"))
    attach_lora(net, rank=2, targets=("0",))
    x = torch.ones(3, 8)
    with torch.no_grad(), FlopsCounter() as fc:
        net(x)
    assert fc.by_op == {"matmul": 2 * 8 * 2 * 16, "multiply": 8 * 16,
                        "add": 8 * 16, "linear": 2 * 3 * 8 * 16}


def test_measure_step_flops_leaves_the_generators():
    """fit's FLOPs forward (dropout on) puts every generator back: the
    trajectory is the one without the measurement."""
    tm = GPTForCausalLM(gpt_config("gpt2-124m", dropout=0.1, attn_dropout=0.1,
                                   **GPT_TINY), device="cpu")
    model = Model(tm).prepare(SGD(0.1, parameters=tm.parameters()),
                              CrossEntropyLoss())
    model.step_metrics = StepMetrics(prefix="m.", registry=MetricsRegistry())
    before = [s.clone() for s in model._rng_states()]
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, 512, (2, SEQ)))
    model._measure_step_flops(ids)
    after = model._rng_states()
    assert len(before) >= 2
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    assert model.step_metrics.flops_per_step > 0
    assert tm.training
