"""The port's serving resilience and the slot layout against the JAX
package (tests/test_guardian.py's serving drills and
tests/test_compiled_tick.py's tick cases): `Engine.drain`, a SIGTERM drill
through `install_preemption_drain` in a child process, a crash and a stall
each restarting the loop with a fresh cache and tick, the give-up past
``max_scheduler_restarts``, the exporter `Engine.start` starts, the tick's
static blockers, ``drain(migrate=True)`` moving an in-flight slot to a
survivor engine, ``kv_layout="slots"`` against the JAX slot engine,
`SlotKVCache` against JAX's, and the watchdog's thread helpers.  The
models are the tiny Llama (fp32, CPU), weights carried by
`convert.load_paddle_tpu_state` where JAX runs too."""
import json
import os
import subprocess
import sys
import threading
import time
import warnings
import weakref

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed import watchdog as jax_watchdog
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_config as jax_llama_config
from paddle_tpu.serving import Engine as JaxEngine
from paddle_tpu.serving import SamplingParams as JaxSamplingParams
from paddle_tpu.serving import ServingConfig as JaxServingConfig
from paddle_tpu.serving.kv_slots import SlotKVCache as JaxSlotKVCache
from paddle_tpu.core.tensor import Tensor as JaxTensor
from paddle_tpu_torch import convert
from paddle_tpu_torch.distributed import watchdog
from paddle_tpu_torch.models import LlamaForCausalLM, llama_config
from paddle_tpu_torch.observability import exporter
from paddle_tpu_torch.observability import flight_recorder as fr
from paddle_tpu_torch.serving import (Engine, EngineShutdownError,
                                      SamplingParams, SchedulerStallError,
                                      ServingConfig, SlotKVCache)
from paddle_tpu_torch.serving.compiled_tick import (CompiledServingTick,
                                                    TickFallbackWarning)
from paddle_tpu_torch.utils import flags as tflags

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROMPT = np.arange(1, 8, dtype=np.int32)


@pytest.fixture(scope="module")
def pair():
    paddle.seed(3)
    jm = JaxLlama(jax_llama_config("tiny", max_seq_len=64))
    jm.eval()
    tm = LlamaForCausalLM(llama_config("tiny", max_seq_len=64),
                          device="cpu")
    convert.load_paddle_tpu_state(
        tm, {k: v.numpy() for k, v in jm.state_dict().items()})
    return jm, tm.eval()


@pytest.fixture
def flags(tmp_path):
    """The tick and recorder flags restored after the test; the flight
    recorder dumps under ``tmp_path``."""
    keys = ["FLAGS_compiled_tick", "FLAGS_flight_recorder_path",
            "FLAGS_metrics_export_path"]
    saved = tflags.get_flags(keys)
    tflags.set_flags({"FLAGS_flight_recorder_path":
                      str(tmp_path / "flight.json")})
    yield tflags
    tflags.set_flags(saved)


class _Faulty(torch.nn.Module):
    """A model whose forward calls are counted: call ``fail_at`` raises,
    call ``stall_at`` sleeps ``stall_s`` in slices an async raise can
    land between, and every call sleeps ``step_s`` (work in flight long
    enough for a drain to see it)."""

    def __init__(self, inner, fail_at=None, stall_at=None, stall_s=20.0,
                 step_s=0.0):
        super().__init__()
        self.inner = inner
        self.config = inner.config
        self.position_rows = None
        self.calls = 0
        self.fail_at, self.stall_at = fail_at, stall_at
        self.stall_s, self.step_s = stall_s, step_s

    def forward(self, ids, caches=None):
        self.calls += 1
        if self.calls == self.fail_at:
            raise RuntimeError("injected model failure")
        if self.calls == self.stall_at:
            t0 = time.monotonic()
            while time.monotonic() - t0 < self.stall_s:
                time.sleep(0.01)
        if self.step_s:
            time.sleep(self.step_s)
        return self.inner(ids, caches=caches)


def _greedy(tm, prompt, n):
    with Engine(tm, ServingConfig(num_slots=1)) as eng:
        return eng.generate(prompt, max_new_tokens=n).output_ids


def _events(name):
    return [e for e in fr.get_recorder().events() if e["name"] == name]


@pytest.mark.parametrize("tick", [True, False], ids=["tick", "uncompiled"])
def test_drain_completes_inflight_fails_queued(pair, flags, tick):
    """Two requests decoding and three queued: `drain` lets the two finish
    with their 25 tokens, fails the queue with `EngineShutdownError`
    ("draining"), records drain_begin / drain_end and shuts the engine
    down; a submit after it raises.  With the compiled tick on, every
    decode step of the drain is a tick."""
    _, tm = pair
    flags.set_flags({"FLAGS_compiled_tick": tick})
    eng = Engine(_Faulty(tm, step_s=0.01), ServingConfig(
        num_slots=2, max_queue=8)).start()
    inflight = [eng.submit(PROMPT, max_new_tokens=25) for _ in range(2)]
    t0 = time.monotonic()
    while eng.stats().get("active_slots", 0) < 2 and \
            time.monotonic() - t0 < 30:
        time.sleep(0.005)
    queued = [eng.submit(PROMPT, max_new_tokens=25) for _ in range(3)]
    n_begin = len(_events("drain_begin"))
    eng.drain(deadline_s=60)
    st = eng.stats()        # before _greedy's engine resets the families
    want = _greedy(tm, PROMPT, 25)
    for f in inflight:
        out = f.result(timeout=1)
        assert out.finish_reason == "length"
        np.testing.assert_array_equal(out.output_ids, want)
    for f in queued:
        with pytest.raises(EngineShutdownError, match="draining"):
            f.result(timeout=1)
    with pytest.raises(EngineShutdownError):
        eng.submit(PROMPT)
    assert st["requests_cancelled_drain"] == 3
    assert (st["tick_compiled_hits"] == st["decode_steps"] > 0) == tick
    assert len(_events("drain_begin")) == n_begin + 1
    assert _events("drain_end")[-1]["unfinished"] == 0
    eng.drain()                         # idempotent on a stopped engine


@pytest.mark.parametrize("tick", [True, False])
def test_drain_migrate_moves_an_inflight_slot(pair, flags, tick):
    """``drain(migrate=True)`` with an installed migrator: the decoding
    slot's pages and tokens go to a survivor engine, which finishes the
    request (the full stream equal to an undisturbed run) without running
    its prompt again; the drained engine ends with every page free."""
    from paddle_tpu_torch.serving import migration
    _, tm = pair
    want = _greedy(tm, PROMPT, 40)
    flags.set_flags({"FLAGS_compiled_tick": tick})
    survivor = Engine(tm, ServingConfig(num_slots=2)).start()
    # 10 ms a model call: the request is mid-decode when the drain lands
    eng = Engine(_Faulty(tm, step_s=0.01), ServingConfig(num_slots=2)).start()
    try:
        def migrate(req, header, blobs, target):
            out = survivor.submit_resume(
                req.prompt, list(req.tokens),
                migration.unpack(header, *blobs),
                max_new_tokens=req.max_new_tokens,
                sampling=req.sampling).result(timeout=120)
            return {"replica": "survivor", "output_ids": out.output_ids,
                    "finish_reason": out.finish_reason}
        eng.migrator = migrate
        fut = eng.submit(PROMPT, max_new_tokens=40)
        deadline = time.monotonic() + 60
        while not eng._active:
            assert time.monotonic() < deadline, "never decoded"
            time.sleep(0.002)
        eng.drain(deadline_s=60, migrate=True)
        out = fut.result(timeout=60)
        st = eng.stats()
        pages_left = eng.cache.pages_in_use
    finally:
        eng.shutdown()
        survivor.shutdown()
    np.testing.assert_array_equal(out.output_ids, want)
    assert out.decoded_by == "survivor"
    assert st["migrations"] == st["migration_resumed_requests"] == 1
    assert st["migration_pages_received"] == st["migration_pages_sent"] >= 1
    assert st["migration_fallbacks"] == 0 and pages_left == 0


WORKER = r'''
import json, os, signal, sys, time
import numpy as np
import torch
from paddle_tpu_torch.models import LlamaForCausalLM, llama_config
from paddle_tpu_torch.serving import Engine, EngineShutdownError, ServingConfig

out = sys.argv[1]
model = LlamaForCausalLM(llama_config("tiny", max_seq_len=64), device="cpu",
                         seed=0).eval()
fwd = model.forward
def slow(*a, **k):
    time.sleep(0.02)            # work in flight for the drain to finish
    return fwd(*a, **k)
model.forward = slow
eng = Engine(model, ServingConfig(num_slots=2, max_queue=8,
                                  drain_grace_s=60.0)).start()
handler = eng.install_preemption_drain()
prompt = np.arange(1, 4, dtype=np.int32)
inflight = [eng.submit(prompt, max_new_tokens=30) for _ in range(2)]
t0 = time.monotonic()
while eng.stats().get("active_slots", 0) < 2 and time.monotonic() - t0 < 60:
    time.sleep(0.01)
queued = [eng.submit(prompt, max_new_tokens=30) for _ in range(3)]
os.kill(os.getpid(), signal.SIGTERM)
res = {"tokens": [], "queued_failed": 0, "rejected": 0, "errors": []}
for f in inflight:
    try:
        res["tokens"].append(int(f.result(timeout=120).output_ids.size))
    except Exception as e:
        res["errors"].append(type(e).__name__)
for f in queued:
    try:
        f.result(timeout=120)
    except EngineShutdownError:
        res["queued_failed"] += 1
    except Exception as e:
        res["errors"].append(type(e).__name__)
t0 = time.monotonic()
while eng._thread is not None and time.monotonic() - t0 < 60:
    time.sleep(0.01)            # the drain's shutdown
try:
    eng.submit(prompt)
except EngineShutdownError:
    res["rejected"] = 1
res["preempted"] = handler.preempted()
with open(os.path.join(out, "drain.json"), "w") as f:
    json.dump(res, f)
'''


def test_sigterm_drains_in_a_child(tmp_path):
    """A child serving with `install_preemption_drain` sends itself
    SIGTERM: the two in-flight requests finish with 30 tokens, the three
    queued ones fail with `EngineShutdownError`, a later submit raises,
    the flight recorder dumps on the signal, and the child exits 0."""
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    dump = tmp_path / "flight.json"
    env = dict(os.environ, PYTHONPATH=REPO,
               FLAGS_flight_recorder_path=str(dump))
    r = subprocess.run([sys.executable, str(script), str(tmp_path)],
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    res = json.loads((tmp_path / "drain.json").read_text())
    assert res == {"tokens": [30, 30], "queued_failed": 3, "rejected": 1,
                   "errors": [], "preempted": True}, res
    assert json.loads(dump.read_text())["reason"] == "sigterm"


def test_crash_fails_outstanding_and_restarts(pair, flags):
    """The first prefill call raises: every outstanding future, queued or
    mid-admission, fails with that error; the loop restarts once with a
    new cache and a new tick, the old ones freed (the failed futures keep
    the error, not the frames' locals), and then serves generate's
    tokens."""
    _, tm = pair
    model = _Faulty(tm, fail_at=1)
    eng = Engine(model, ServingConfig(num_slots=2, max_queue=8,
                                      max_scheduler_restarts=1)).start()
    cache0, tick0 = weakref.ref(eng.cache), weakref.ref(eng._tick)
    futs = [eng.submit(PROMPT, max_new_tokens=3) for _ in range(3)]
    for f in futs:
        exc = f.exception(timeout=30)
        assert isinstance(exc, RuntimeError), exc
        assert "injected model failure" in str(exc)
    out = eng.generate(PROMPT, max_new_tokens=5, timeout=60)
    st = eng.stats()
    assert cache0() is None and tick0() is None
    assert eng.cache is not None and eng._tick is not None
    eng.shutdown()
    np.testing.assert_array_equal(out.output_ids, _greedy(tm, PROMPT, 5))
    assert st["scheduler_restarts"] == 1 and st["scheduler_stalls"] == 0
    assert _events("scheduler_restart")[-1]["error"] == "RuntimeError"


def test_crash_past_the_restart_budget_stops_the_engine(pair, flags,
                                                        monkeypatch):
    """With ``max_scheduler_restarts=0`` the first crash fails every
    future, stops the engine (a submit raises) and leaves the scheduler
    thread with the error."""
    _, tm = pair
    seen = []
    monkeypatch.setattr(threading, "excepthook",
                        lambda args: seen.append(args.exc_type))
    eng = Engine(_Faulty(tm, fail_at=1), ServingConfig(
        num_slots=1, max_scheduler_restarts=0)).start()
    f = eng.submit(PROMPT, max_new_tokens=3)
    assert "injected" in str(f.exception(timeout=30))
    eng._thread.join(30)
    with pytest.raises(EngineShutdownError):
        eng.submit(PROMPT)
    assert eng.stats()["scheduler_restarts"] == 1
    assert seen == [RuntimeError]
    eng.shutdown()


def test_stall_restarts_with_a_fresh_tick(pair, flags, monkeypatch,
                                          tmp_path):
    """The compiled tick's 2nd call stalls for 60 s: within the 1 s budget
    (plus the watchdog's poll) the future fails with
    `SchedulerStallError`, the stall dump holds every thread's stack, the
    loop restarts with a new tick, and the next request gets generate's
    tokens through that tick."""
    _, tm = pair
    orig = CompiledServingTick._run
    calls = {"n": 0}

    def stalling_run(self):
        calls["n"] += 1
        if calls["n"] == 2:
            t0 = time.monotonic()
            while time.monotonic() - t0 < 60.0:
                time.sleep(0.01)         # interruptible by the async raise
        return orig(self)

    monkeypatch.setattr(CompiledServingTick, "_run", stalling_run)
    flags.set_flags({"FLAGS_compiled_tick": True})
    eng = Engine(tm, ServingConfig(num_slots=1, step_timeout_s=1.0,
                                   max_scheduler_restarts=2)).start()
    try:
        tick0 = eng._tick
        t0 = time.monotonic()
        f = eng.submit(PROMPT, max_new_tokens=4)
        exc = f.exception(timeout=30)
        assert isinstance(exc, SchedulerStallError), exc
        assert time.monotonic() - t0 < 10
        out = eng.generate(PROMPT, max_new_tokens=4, timeout=60)
        st = eng.stats()
        assert eng._tick is not tick0 and eng._tick.steps
    finally:
        eng.shutdown()
    np.testing.assert_array_equal(out.output_ids, _greedy(tm, PROMPT, 4))
    assert st["scheduler_stalls"] >= 1 and st["scheduler_restarts"] >= 1
    assert st["tick_compiled_hits"] > 0
    dump = json.loads((tmp_path / "flight.json").read_text())
    assert dump["reason"] == "serving-stall"
    assert dump["error"]["type"] == "SchedulerStallError"
    names = {t["name"] for t in dump["stall"]["threads"]}
    assert "paddle-tpu-torch-serving" in names
    assert _events("scheduler_stall")


def test_start_starts_the_exporter(pair, flags, tmp_path):
    """`Engine.start` starts the metrics exporter when
    ``FLAGS_metrics_export_path`` names a file (no thread without it)."""
    _, tm = pair
    exporter.stop_exporter(final_snapshot=False)
    with Engine(tm, ServingConfig(num_slots=1)):
        assert exporter.get_exporter() is None
    path = tmp_path / "metrics.jsonl"
    flags.set_flags({"FLAGS_metrics_export_path": str(path)})
    try:
        with Engine(tm, ServingConfig(num_slots=1)):
            assert exporter.get_exporter().running
    finally:
        exporter.stop_exporter()
    assert path.exists()


def _fallback_run(model, cfg, prompts, jax=False):
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        eng = (JaxEngine if jax else Engine)(model, cfg).start()
        kinds = [str(x.message) for x in w
                 if x.category.__name__ == "TickFallbackWarning"]
        try:
            outs = [f.result(timeout=300).output_ids for f in
                    [eng.submit(p, max_new_tokens=5) for p in prompts]]
            st = eng.stats()
        finally:
            eng.shutdown()
    return outs, st, kinds


@pytest.mark.parametrize("case", ["slots", "spec"])
def test_tick_static_blockers_match_jax(pair, flags, case):
    """The slot layout and speculation latch the uncompiled lane: one
    `TickFallbackWarning` when the tick is built, before any request, and
    ``tick.fallbacks`` counting every iteration that consulted the tick
    (all of the slot layout's; none of an all-greedy speculative run),
    equal to the JAX engine's counts; tokens equal JAX's."""
    jm, tm = pair
    prompts = [PROMPT, PROMPT[:4]]
    kw = dict(num_slots=2, kv_layout="slots") if case == "slots" else \
        dict(num_slots=2, speculation_k=2)
    flags.set_flags({"FLAGS_compiled_tick": True})
    outs, st, warned = _fallback_run(tm, ServingConfig(
        draft_model=tm if case == "spec" else None, **kw), prompts)
    want, jst, jwarned = _fallback_run(jm, JaxServingConfig(
        draft_model=jm if case == "spec" else None, **kw), prompts, jax=True)
    assert len(warned) == len(jwarned) == 1
    assert ("slots" if case == "slots" else "speculative") in warned[0]
    for a, b in zip(outs, want):
        np.testing.assert_array_equal(a, b)
    assert st["tick_fallbacks"] == jst["tick_fallbacks"]
    assert st["tick_compiled_hits"] == 0
    if case == "slots":
        assert st["tick_fallbacks"] == 1 + st["decode_steps"]
    else:
        assert st["tick_fallbacks"] == 1 and st["spec_windows"] > 0


def test_slot_lane_matches_jax_slot_engine(pair):
    """``kv_layout="slots"``: five requests of 3-9 tokens through 2 slots
    (batch-1 prefills, the uncompiled [2, 1] step), greedy, greedy with an
    eos, seeded-sampled and seeded with a penalty: every request's tokens
    and finish reason equal the JAX slot engine's, and the greedy ones the
    paged lane's."""
    jm, tm = pair
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, 512, (n,)).astype(np.int32)
               for n in (5, 9, 3, 7, 6)]
    eos = int(_greedy(tm, prompts[1], 8)[2])

    def subs(sp):
        return [(prompts[0], None, None), (prompts[1], None, eos),
                (prompts[2], sp(temperature=0.8, top_k=20, seed=3), None),
                (prompts[3], sp(temperature=1.0, top_p=0.9,
                                repetition_penalty=1.3, seed=5), None),
                (prompts[4], None, None)]

    def run(engine, reqs):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with engine as eng:
                futs = [eng.submit(p, max_new_tokens=8, sampling=s,
                                   eos_token_id=e) for p, s, e in reqs]
                return [f.result(timeout=300) for f in futs]

    want = run(JaxEngine(jm, JaxServingConfig(num_slots=2,
                                              kv_layout="slots")),
               subs(JaxSamplingParams))
    got = run(Engine(tm, ServingConfig(num_slots=2, kv_layout="slots")),
              subs(SamplingParams))
    paged = run(Engine(tm, ServingConfig(num_slots=2)), subs(SamplingParams))
    for w, g, p in zip(want, got, paged):
        np.testing.assert_array_equal(g.output_ids, w.output_ids)
        assert g.finish_reason == w.finish_reason
        np.testing.assert_array_equal(g.output_ids, p.output_ids)
    assert got[1].finish_reason == "eos"


def test_slot_kv_cache_matches_jax():
    """The same allocate / write_prefill / advance / release sequence on
    JAX's SlotKVCache and the port's: the same slots, free list, offsets
    (host and the uploaded device vector every layer shares) and K/V."""
    kw = dict(num_layers=2, num_slots=3, max_len=8, num_kv_heads=2,
              head_dim=4)
    jc, tc = JaxSlotKVCache(**kw), SlotKVCache(device="cpu", **kw)
    rng = np.random.default_rng(0)

    def prefill(n):
        return [{"k": rng.normal(size=(1, 8, 2, 4)).astype(np.float32),
                 "v": rng.normal(size=(1, 8, 2, 4)).astype(np.float32)}
                for _ in range(2)], n

    def check():
        assert tc._free == jc._free
        assert tc.offsets.tolist() == jc.offsets.tolist()
        jl, tl = jc.layer_caches(), tc.layer_caches()
        for a, b in zip(jl, tl):
            for name in ("k", "v"):
                np.testing.assert_array_equal(b[name].numpy(),
                                              np.asarray(a[name]._data_))
            np.testing.assert_array_equal(
                b["offset"].numpy(), np.asarray(a["offset"]._data_))
            assert b["offset"] is tl[0]["offset"]

    slots = []
    for n in (5, 3):
        caches, plen = prefill(n)
        s = jc.allocate()
        assert tc.allocate() == s
        jc.write_prefill(s, [{k: JaxTensor(v) for k, v in c.items()}
                             for c in caches], plen)
        tc.write_prefill(s, [{k: torch.from_numpy(v) for k, v in c.items()}
                             for c in caches], plen)
        slots.append(s)
        check()
    for c in (jc, tc):
        c.advance(slots)
        c.advance(slots[:1])
    check()
    for c in (jc, tc):
        c.release(slots[0])
    check()
    assert tc.allocate() == jc.allocate() == slots[0]
    with pytest.raises(ValueError, match="exceeds slot capacity"):
        tc.write_prefill(slots[1], prefill(9)[0], 9)


def test_async_raise_and_all_thread_stacks():
    """`async_raise` lands its exception in a thread looping in Python
    (at a bytecode boundary) and returns False for a finished thread;
    `all_thread_stacks` reports every live thread with JAX's keys, the
    caller's own stack included."""
    caught = []
    ready = threading.Event()

    def spin():
        ready.set()
        try:
            t0 = time.monotonic()
            while time.monotonic() - t0 < 30:
                time.sleep(0.005)
        except SchedulerStallError as e:
            caught.append(e)

    t = threading.Thread(target=spin, name="spin-under-test")
    t.start()
    ready.wait(10)
    stacks = watchdog.all_thread_stacks()
    assert watchdog.async_raise(t.ident, SchedulerStallError)
    t.join(10)
    assert not t.is_alive() and len(caught) == 1
    assert not watchdog.async_raise(t.ident, SchedulerStallError)
    names = {s["name"]: s for s in stacks}
    assert "spin-under-test" in names
    me = names[threading.current_thread().name]
    assert any("test_async_raise_and_all_thread_stacks" in line
               for line in me["stack"])
    want = jax_watchdog.all_thread_stacks()
    assert {tuple(sorted(s)) for s in stacks} == \
        {tuple(sorted(s)) for s in want}


def test_slot_kv_cache_default_device_is_the_card(monkeypatch):
    """`SlotKVCache` with no device resolves to the card like every other
    entry point: without CUDA it raises; ``"cpu"`` is taken."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SlotKVCache(1, 1, 16, 1, 8)
    assert SlotKVCache(1, 1, 16, 1, 8, device="cpu").layers[0]["k"] \
        .device.type == "cpu"
