"""The port's request tracing (paddle_tpu_torch/observability/tracing.py)
against paddle_tpu/observability/tracing.py: the counterparts of
tests/test_tracing.py's units (off is inert, the wire form, both clocks
and an idempotent end, child spans and ``bind``, the ring cap, tail
sampling where the first decision wins, spool / merge / chrome flows),
the same trace ids decided alike by both packages' ``decide``, and the
engine's spans: every request one ``engine.request`` root with
``engine.queue``, ``engine.prefill`` and ``engine.decode`` children, one
decision and one winner, under the compiled tick, on the uncompiled lane
and after a crash restart, with the JAX engine's span and event names;
a failed request decides non-ok; ``tools/trace_analyze.py`` reads the
spools."""
import importlib
import json
import os

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_config as jax_llama_config
from paddle_tpu.observability import tracing as jtracing
from paddle_tpu.serving import Engine as JaxEngine
from paddle_tpu.serving import ServingConfig as JaxServingConfig
from paddle_tpu.utils import flags as jflags
from paddle_tpu_torch import convert
from paddle_tpu_torch.models import LlamaForCausalLM, llama_config
from paddle_tpu_torch.observability import Span, TraceContext, tracing
from paddle_tpu_torch.serving import Engine, ServingConfig
from paddle_tpu_torch.utils import flags as tflags
from paddle_tpu_torch.utils import monitor

TRACE_DEFAULTS = {"FLAGS_trace_dir": "", "FLAGS_trace_latency_threshold_ms":
                  250.0, "FLAGS_trace_sample_rate": 0.05,
                  "FLAGS_trace_buffer_cap": 4096}
PHASES = {"engine.request", "engine.queue", "engine.prefill",
          "engine.decode"}


@pytest.fixture()
def trace_dir(tmp_path):
    """Tracing armed into this test's own spool directory, in both
    packages (threshold 0 keeps every trace; the JAX package spools into
    ``<dir>-jax``: both name a process's spool by its pid); the flags, the
    rings and the compiled-tick flag put back after it."""
    d = str(tmp_path / "traces")
    saved = tflags.get_flags(["FLAGS_compiled_tick"])
    tracing.reset()
    jtracing.reset()
    tflags.set_flags({"FLAGS_trace_dir": d,
                      "FLAGS_trace_latency_threshold_ms": 0.0})
    jflags.set_flags({"FLAGS_trace_dir": d + "-jax",
                      "FLAGS_trace_latency_threshold_ms": 0.0})
    yield d
    tflags.set_flags(dict(TRACE_DEFAULTS, **saved))
    jflags.set_flags(TRACE_DEFAULTS)
    tracing.reset()
    jtracing.reset()


@pytest.fixture(scope="module")
def pair():
    paddle.seed(5)
    jm = JaxLlama(jax_llama_config("tiny", max_seq_len=64))
    jm.eval()
    tm = LlamaForCausalLM(llama_config("tiny", max_seq_len=64),
                          device="cpu")
    convert.load_paddle_tpu_state(
        tm, {k: v.numpy() for k, v in jm.state_dict().items()})
    return jm, tm


def _prompts(lens, seed=0, vocab=512):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (n,)).astype("int32") for n in lens]


def _merged(d, mod=tracing):
    mod.spool_now(d)
    return mod.merge_spools(d)


def _winners(trace):
    return [s for s in trace.get("spans", []) if s.get("winner")]


# ---------------------------------------------------------------- units
def test_tracing_off_is_inert():
    """With FLAGS_trace_dir empty: no span, no decision, no context, no
    spool, and ``bind_wire(None)`` writes nothing."""
    tflags.set_flags({"FLAGS_trace_dir": ""})
    assert tracing.enabled() is False
    assert tracing.start_span("x") is None
    assert tracing.decide("t", "error", 1.0) is None
    assert tracing.current_wire() is None
    assert tracing.spool_now() is None
    with tracing.bind_wire(None):
        assert tracing.current() is None


def test_context_wire_roundtrip():
    ctx = TraceContext("t-1", "s-1", "p-1", sampled=True)
    back = TraceContext.from_wire(ctx.wire())
    assert (back.trace_id, back.span_id, back.parent_span_id,
            back.sampled) == ("t-1", "s-1", "p-1", True)
    assert ctx.wire() == jtracing.TraceContext(
        "t-1", "s-1", "p-1", sampled=True).wire()
    assert TraceContext.from_wire(None) is None
    short = TraceContext.from_wire(("t", "s"))
    assert short.parent_span_id is None and short.sampled is None


def test_span_record_dual_clocks_and_idempotent_end(trace_dir):
    span = tracing.start_span("unit.op", rid=7)
    assert isinstance(span, Span)
    span.event("tick", n=1)
    span.end(status="ok", winner=True, tokens=3)
    span.end(status="error")            # a second end is ignored
    assert span.status == "ok"
    (tr,) = _merged(trace_dir)["traces"]
    (rec,) = tr["spans"]
    assert rec["name"] == "unit.op" and rec["status"] == "ok"
    assert rec["winner"] is True
    assert rec["attrs"] == {"rid": 7, "tokens": 3}
    assert rec["events"][0]["name"] == "tick"
    assert rec["events"][0]["t_ms"] >= 0
    assert rec["wall"] > 0 and rec["t1"] >= rec["t0"] > 0


def test_child_spans_share_trace_and_bind_propagates(trace_dir):
    root = tracing.start_span("root")
    child = tracing.start_span("child", parent=root)
    assert child.ctx.trace_id == root.ctx.trace_id
    assert child.ctx.parent_span_id == root.ctx.span_id
    with tracing.bind(root):
        implicit = tracing.start_span("implicit")
        wire = tracing.current_wire()
    assert implicit.ctx.trace_id == root.ctx.trace_id
    assert wire[0] == root.ctx.trace_id
    assert tracing.current() is None
    with tracing.bind_wire(wire):
        remote = tracing.start_span("remote")
    assert remote.ctx.trace_id == root.ctx.trace_id


def test_ring_is_bounded_by_buffer_cap(trace_dir):
    tflags.set_flags({"FLAGS_trace_buffer_cap": 8})
    dropped = monitor.get_monitor_value("serving.trace.spans_dropped")
    for i in range(20):
        tracing.start_span(f"op{i}").end()
    with tracing._lock:
        assert len(tracing._buffer) == 8
    assert monitor.get_monitor_value("serving.trace.spans_dropped") == \
        dropped + 12


def test_tail_sampling_policy_and_first_decision_wins(trace_dir):
    tflags.set_flags({"FLAGS_trace_latency_threshold_ms": 100.0,
                      "FLAGS_trace_sample_rate": 0.0})
    assert tracing.decide("t-err", "EvictedError", 1.0) is True
    assert tracing.decide("t-slow", "ok", 500.0) is True
    assert tracing.decide("t-fast", "ok", 1.0) is False
    assert tracing.decide("t-fast", "error", 1.0) is False
    tflags.set_flags({"FLAGS_trace_sample_rate": 1.0})
    assert tracing.decide("t-floor", "ok", 1.0) is True
    assert tracing._hash_floor("t-x") == tracing._hash_floor("t-x")


def test_decisions_equal_jax_decide(trace_dir):
    """The same 200 trace ids, statuses and latencies under the default
    floor (0.05) and a 100 ms threshold: both packages keep the same
    traces for the same reasons (the hash floor is the trace id's)."""
    knobs = {"FLAGS_trace_latency_threshold_ms": 100.0,
             "FLAGS_trace_sample_rate": 0.05}
    tflags.set_flags(knobs)
    jflags.set_flags(knobs)
    rng = np.random.default_rng(0)
    for i in range(200):
        tid = f"rep-{i:x}-{rng.integers(1 << 30):x}"
        status = "ok" if i % 7 else "DeadlineExceededError"
        lat = float(rng.uniform(0, 200))
        assert tracing.decide(tid, status, lat) == \
            jtracing.decide(tid, status, lat), tid
        assert tracing._decided[tid]["reason"] == \
            jtracing._decided[tid]["reason"]
    assert any(r["reason"] == "floor" for r in tracing._decided.values())


def test_spool_merge_elides_dropped_keeps_undecided(trace_dir):
    tflags.set_flags({"FLAGS_trace_latency_threshold_ms": 1e9,
                      "FLAGS_trace_sample_rate": 0.0})
    for tid in ("keep", "drop", "lost"):
        root = tracing.start_span(f"req-{tid}")
        root.ctx.trace_id = tid
        root.end()
    tracing.decide("keep", "error", 1.0)
    tracing.decide("drop", "ok", 1.0)
    merged = _merged(trace_dir)
    by_id = {t["trace_id"]: t for t in merged["traces"]}
    assert by_id["keep"]["sampled"] is True
    assert by_id["keep"]["decision"]["reason"] == "status:error"
    assert len(by_id["keep"]["spans"]) == 1
    assert by_id["drop"]["sampled"] is False
    assert "spans" not in by_id["drop"]
    assert by_id["drop"]["span_count"] == 1
    assert by_id["lost"]["sampled"] is None
    assert by_id["lost"]["decision_count"] == 0
    assert len(by_id["lost"]["spans"]) == 1
    for line in open(tracing.spool_path(trace_dir)):
        json.loads(line)
    out = tracing.write_merged(merged, trace_dir + "/merged.json")
    assert tracing.load_merged(out) == json.loads(json.dumps(merged))


def test_chrome_export_emits_cross_process_flows(trace_dir, tmp_path):
    """One flow pair for the cross-process parent edge, none for the
    local one; the events and rows equal JAX's ``chrome_events``."""
    rec = {"kind": "span", "trace": "t", "span": "a.1", "parent": None,
           "name": "router.request", "proc": "router", "pid": 1,
           "wall": 100.0, "t0": 1.0, "t1": 2.0, "status": "ok"}
    child = dict(rec, span="b.1", parent="a.1", name="engine.request",
                 proc="rep-0", pid=2, winner=True)
    local = dict(rec, span="a.2", parent="a.1", name="router.attempt")
    merged = {"schema_version": 1,
              "traces": [{"trace_id": "t", "sampled": True,
                          "spans": [rec, child, local]}]}
    events, proc_names = tracing.chrome_events(merged)
    assert (events, proc_names) == jtracing.chrome_events(merged)
    assert [e["ph"] for e in events if e["ph"] in "sf"] == ["s", "f"]
    assert len(proc_names) == 2
    out = tracing.export_chrome(merged, str(tmp_path / "chrome.json"))
    doc = json.load(open(out))
    jout = jtracing.export_chrome(merged, str(tmp_path / "jchrome.json"))
    assert doc == json.load(open(jout))
    assert any(e.get("args", {}).get("winner")
               for e in doc["traceEvents"] if e["ph"] == "X")


# ---------------------------------------------------------------- engine
def _serve(cls, cfg, model, prompts, n=4, **kw):
    with cls(model, cfg) as eng:
        futs = [eng.submit(p, max_new_tokens=n, **kw) for p in prompts]
        outs = [f.result(timeout=180) for f in futs]
        st = eng.stats()
    return outs, st


def _check_request_traces(merged, n):
    """Each of ``n`` traces: one decision (ok), one engine.request root,
    its winner, the four phases, every parent inside the trace, the
    prefill span's chunk and first_token events."""
    assert len(merged["traces"]) == n
    for tr in merged["traces"]:
        assert tr["decision_count"] == 1
        assert tr["decision"]["status"] == "ok"
        names = [s["name"] for s in tr["spans"]]
        assert set(names) == PHASES and len(names) == 4
        (root,) = [s for s in tr["spans"] if s["parent"] is None]
        assert root["name"] == "engine.request"
        (winner,) = _winners(tr)
        assert winner["span"] == root["span"]
        (pre,) = [s for s in tr["spans"] if s["name"] == "engine.prefill"]
        assert {"chunk", "first_token"} <= \
            {e["name"] for e in pre["events"]}
        ids = {s["span"] for s in tr["spans"]}
        assert all(s["parent"] in ids for s in tr["spans"]
                   if s["parent"] is not None)


@pytest.mark.parametrize("tick", [True, False], ids=["tick", "uncompiled"])
def test_engine_trace_phases_match_jax(pair, trace_dir, tick):
    """Three requests through two slots (one waits for a slot) on the
    tick and on the uncompiled lane: each trace has one root, its four
    phases, one decision and one winner; the span names, their events and
    the engine's trace counters equal the JAX engine's on the same
    traffic, and the tokens too."""
    jm, tm = pair
    tflags.set_flags({"FLAGS_compiled_tick": tick})
    prompts = _prompts([5, 8, 6], seed=1)
    outs, st = _serve(Engine, ServingConfig(num_slots=2), tm, prompts)
    spooled = os.path.exists(tracing.spool_path(trace_dir))  # at shutdown
    jouts, jst = _serve(JaxEngine, JaxServingConfig(num_slots=2), jm,
                        prompts)
    for o, j in zip(outs, jouts):
        np.testing.assert_array_equal(o.output_ids, j.output_ids)
    merged = _merged(trace_dir)
    jmerged = _merged(trace_dir + "-jax", jtracing)
    _check_request_traces(merged, 3)
    _check_request_traces(jmerged, 3)

    def shape(m):
        return sorted(sorted((s["name"], tuple(sorted(
            {e["name"] for e in s.get("events", [])})))
            for s in tr["spans"]) for tr in m["traces"])
    assert shape(merged) == shape(jmerged)
    for key in ("trace_spans", "trace_decisions", "trace_decisions_kept"):
        assert st[key] == jst[key] > 0, key
    assert st["trace_spans"] == 12 and spooled
    assert (st["tick_compiled_hits"] > 0) == tick


def test_trace_analyze_reads_the_spools(pair, trace_dir):
    _, tm = pair
    _serve(Engine, ServingConfig(num_slots=2), tm, _prompts([6, 4, 7], 2))
    ta = importlib.import_module("tools.trace_analyze")
    tracing.spool_now(trace_dir)
    report = ta.build_report(ta.load_merged_doc(trace_dir=trace_dir))
    assert report["analyzed"] == 3
    assert report["complete_fraction"] == 1.0
    assert report["winner_violations"] == []
    assert report["multi_decision_traces"] == 0
    assert report["span_sum"]["checked"] == 3
    assert report["span_sum"]["violations"] == []
    assert {"prefill", "decode"} <= set(report["phase_ms"])


def test_engine_failure_trace_decides_non_ok(pair, trace_dir):
    """A request evicted at its deadline still decides its trace once,
    with the error status, kept by tail sampling whatever its latency."""
    _, tm = pair
    tflags.set_flags({"FLAGS_trace_latency_threshold_ms": 1e9,
                      "FLAGS_trace_sample_rate": 0.0})
    with Engine(tm, ServingConfig(num_slots=2)) as eng:
        with pytest.raises(ValueError):
            eng.submit(np.zeros((0,), np.int32), max_new_tokens=4)
        fut = eng.submit(_prompts([5], seed=3)[0], max_new_tokens=4,
                         deadline_s=1e-4)
        with pytest.raises(Exception):
            fut.result(timeout=180)
    kept = [t for t in _merged(trace_dir)["traces"] if t["sampled"]]
    assert len(kept) == 1
    (tr,) = kept
    assert tr["decision_count"] == 1
    assert tr["decision"]["status"] == "DeadlineExceededError"
    assert tr["decision"]["reason"] == "status:DeadlineExceededError"
    assert _winners(tr) == []
    assert all(s["status"] == "DeadlineExceededError"
               for s in tr["spans"] if s["name"] == "engine.request")


class _FailOnce(torch.nn.Module):
    """The model, whose next forward raises once ``arm`` is set."""

    def __init__(self, inner):
        super().__init__()
        self.inner = inner
        self.config = inner.config
        self.arm = False

    def forward(self, ids, caches=None):
        if self.arm:
            self.arm = False
            raise RuntimeError("injected model failure")
        return self.inner(ids, caches=caches)


def test_crash_restart_traces_decide_once(pair, trace_dir):
    """A crash fails the in-flight request (its trace decides
    ``RuntimeError`` once, no winner) and the restarted loop serves the
    next one under a new tick: one root, four phases, one winner."""
    _, tm = pair
    model = _FailOnce(tm)
    eng = Engine(model, ServingConfig(num_slots=2,
                                      max_scheduler_restarts=2)).start()
    try:
        p = _prompts([7], seed=4)[0]
        model.arm = True
        bad = eng.submit(p, max_new_tokens=4)
        assert "injected" in str(bad.exception(timeout=60))
        good = eng.generate(p, max_new_tokens=4)
        st = eng.stats()
    finally:
        eng.shutdown()
    assert good.output_ids.size == 4 and st["scheduler_restarts"] == 1
    by_status = {}
    for tr in _merged(trace_dir)["traces"]:
        assert tr["decision_count"] == 1
        by_status.setdefault(tr["decision"]["status"], []).append(tr)
    (failed,), (ok,) = by_status["RuntimeError"], by_status["ok"]
    assert _winners(failed) == [] and len(_winners(ok)) == 1
    _check_request_traces({"traces": [ok]}, 1)


def test_tracing_off_makes_no_spans(pair):
    """With the flag empty the engine makes no trace object and writes no
    record, and the trace counters stay 0."""
    _, tm = pair
    tflags.set_flags({"FLAGS_trace_dir": ""})
    tracing.reset()
    with Engine(tm, ServingConfig(num_slots=1)) as eng:
        fut = eng.submit(_prompts([5])[0], max_new_tokens=3)
        req = eng._pending.get(fut.request_id)
        assert req is None or req.trace is None
        fut.result(timeout=60)
        st = eng.stats()
    assert st["trace_spans"] == st["trace_decisions"] == 0
    with tracing._lock:
        assert not tracing._buffer and not tracing._decided
