"""The port's compiled scheduler tick and seeded sampling against the JAX
package: the key stream (PRNGKey, fold_in, random_bits) bit for bit
against ``jax.random``, the vectorized logit-processor chain and the token
choice against paddle_tpu/serving/compiled_tick.py, the engine's outputs
on the JAX tick's mixed workload against the JAX engine, the lanes
against each other, and the tick's own contract (typed warn-once
fallbacks, deadline eviction and cancellation, stats, persistent cache
tensors).  On the CPU the tick runs its body eagerly, the plain version
of the CUDA graph the card replays."""
import time
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_config as jax_llama_config
from paddle_tpu.serving import Engine as JaxEngine
from paddle_tpu.serving import SamplingParams as JaxSamplingParams
from paddle_tpu.serving import ServingConfig as JaxServingConfig
from paddle_tpu.serving import compiled_tick as jct
from paddle_tpu.utils import flags as jflags
from paddle_tpu_torch import convert, kernels
from paddle_tpu_torch.framework import prng
from paddle_tpu_torch.framework.capture import CapturedStep
from paddle_tpu_torch.models import LlamaForCausalLM, llama_config
from paddle_tpu_torch.observability.registry import REGISTRY, Histogram
from paddle_tpu_torch.serving import (DeadlineExceededError, Engine,
                                      PagedKVCache, RequestCancelledError,
                                      SamplingParams, ServingConfig)
from paddle_tpu_torch.serving import compiled_tick as tct
from paddle_tpu_torch.utils import flags as tflags

TICK_FLAGS = ("FLAGS_compiled_tick", "FLAGS_serving_fused_sampling")
SEEDS = list(range(0, 3100, 100))[:31] + [2**31 + 5]          # 32 seeds
COUNTS = [0, 1, 2, 3, 7, 31, 255, 1000]                         # 8 counts


@pytest.fixture
def flags():
    """Both packages' tick flags restored after the test."""
    saved = (tflags.get_flags(list(TICK_FLAGS)),
             jflags.get_flags(list(TICK_FLAGS)))
    yield
    tflags.set_flags(saved[0])
    jflags.set_flags(saved[1])


@pytest.fixture(scope="module")
def pair():
    paddle.seed(3)
    jm = JaxLlama(jax_llama_config("tiny", max_seq_len=64))
    jm.eval()
    tm = LlamaForCausalLM(llama_config("tiny", max_seq_len=64),
                          device="cpu")
    convert.load_paddle_tpu_state(
        tm, {k: v.numpy() for k, v in jm.state_dict().items()})
    return jm, tm


def _prompts(lens, seed=7, vocab=512):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (n,)).astype("int32") for n in lens]


# ---------------------------------------------------------------- key stream
def _jax_keys():
    """[32 x 8, 2] fold_in(PRNGKey(seed), count) keys from jax.random, and
    the base keys."""
    base = [np.asarray(jax.random.PRNGKey(s)) for s in SEEDS]
    folded = [np.asarray(jax.random.fold_in(jax.random.PRNGKey(s), n))
              for s in SEEDS for n in COUNTS]
    return np.asarray(base, np.int64), np.asarray(folded, np.int64)


def test_prng_key_and_fold_in_bit_identical_to_jax():
    base, folded = _jax_keys()
    got_base = torch.stack([prng.PRNGKey(s) for s in SEEDS])
    np.testing.assert_array_equal(got_base.numpy(), base)
    counts = torch.tensor(COUNTS).repeat(len(SEEDS))
    got = prng.fold_in(got_base.repeat_interleave(len(COUNTS), dim=0),
                       counts)
    np.testing.assert_array_equal(got.numpy(), folded)
    # one key at a time, with a Python count
    np.testing.assert_array_equal(
        prng.fold_in(prng.PRNGKey(SEEDS[3]), COUNTS[5]).numpy(),
        folded[3 * len(COUNTS) + 5])


@pytest.mark.parametrize("vocab", [512, 32000])
def test_random_bits_bit_identical_to_jax(vocab):
    """32 seeds x 8 counts, every key's [V] uint32 draw: no tolerance."""
    _, folded = _jax_keys()
    want = np.asarray(jax.vmap(lambda k: jax.random.bits(
        k, (vocab,), jnp.uint32))(jnp.asarray(folded, jnp.uint32)))
    got = prng.random_bits(torch.from_numpy(folded), (vocab,))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_uniform_bit_identical_to_jax(dtype):
    """The mantissa fill of every float type (8 drawn bits under bf16),
    with JAX's gumbel lower bound ``tiny``."""
    _, folded = _jax_keys()
    tiny = float(jnp.finfo(dtype).tiny)
    want = np.asarray(jax.vmap(lambda k: jax.random.uniform(
        k, (512,), dtype, minval=tiny))(jnp.asarray(folded, jnp.uint32))
        .astype(jnp.float32))
    got = prng.uniform(torch.from_numpy(folded), (512,),
                       getattr(torch, dtype), minval=tiny)
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_gumbel_and_categorical_match_jax():
    """fp32 Gumbel noise within two ulps of JAX's (each of the two logs
    may round one ulp apart between XLA's and torch's: 2.4e-7 is 2^-22,
    relative above 1 and absolute below), and the categorical draws over
    random [512] logits equal for all 256 keys.  torch's CPU math runs on
    the calling thread: in a process that has run XLA:CPU executables
    loaded from the persistent compilation cache, torch's log on its
    OpenMP worker threads was seen ~1e-4 off on some runs (one thread
    gives the accurate log every time)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _, folded = _jax_keys()
        keys = jnp.asarray(folded, jnp.uint32)
        want_g = np.asarray(jax.vmap(lambda k: jax.random.gumbel(
            k, (512,), jnp.float32))(keys))
        got_g = prng.gumbel(torch.from_numpy(folded), (512,)).numpy()
        logits = np.random.default_rng(0).normal(
            0, 2, (len(folded), 512)).astype(np.float32)
        want = np.asarray(jax.vmap(jax.random.categorical)(keys, logits))
        got = prng.categorical(torch.from_numpy(folded),
                               torch.from_numpy(logits))
    finally:
        torch.set_num_threads(threads)
    np.testing.assert_allclose(got_g, want_g, rtol=2.4e-7, atol=2.4e-7)
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------- the chain
KNOBS = {
    "all-off": dict(),
    "penalty": dict(pen=[1.3, 1.0, 0.7, 2.0]),
    "temperature": dict(temp=[0.5, 1.0, 1.7, 0.9]),
    "top-k": dict(temp=[1.0] * 4, topk=[1, 20, 0, 512]),
    "top-p": dict(temp=[1.0] * 4, topp=[0.5, 0.9, 1.0, 0.99]),
    "mixed": dict(temp=[0.0, 0.8, 1.0, 1.2], topk=[0, 20, 50, 0],
                  topp=[1.0, 0.9, 1.0, 0.8], pen=[1.3, 1.0, 1.1, 1.0]),
}


def _knob_inputs(name, seed=0, ns=4, vocab=512):
    rng = np.random.default_rng(seed)
    k = KNOBS[name]
    return dict(
        logits=rng.normal(0, 3, (ns, vocab)).astype(np.float32),
        temp=np.asarray(k.get("temp", [0.0] * ns), np.float32),
        top_k=np.asarray(k.get("topk", [0] * ns), np.int32),
        top_p=np.asarray(k.get("topp", [1.0] * ns), np.float32),
        penalty=np.asarray(k.get("pen", [1.0] * ns), np.float32),
        seen=rng.random((ns, vocab)) < 0.1)


def _torch_args(a):
    return (torch.from_numpy(a["logits"]), torch.from_numpy(a["temp"]),
            torch.from_numpy(a["top_k"]), torch.from_numpy(a["top_p"]),
            torch.from_numpy(a["penalty"]), torch.from_numpy(a["seen"]))


@pytest.mark.parametrize("name", list(KNOBS))
def test_process_logits_rows_matches_jax(name):
    """[4, 512] fp32 logits, each knob on and off: within 1e-6, with the
    same -inf positions."""
    a = _knob_inputs(name)
    want = np.asarray(jct.process_logits_rows(
        jnp.asarray(a["logits"]), jnp.asarray(a["temp"]),
        jnp.asarray(a["top_k"]), jnp.asarray(a["top_p"]),
        jnp.asarray(a["penalty"]), jnp.asarray(a["seen"])))
    got = tct.process_logits_rows(*_torch_args(a)).numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6, atol=1e-6)
    if name in ("top-k", "top-p"):
        assert np.isneginf(got).any()       # the knob acted


@pytest.mark.parametrize("name", list(KNOBS))
def test_choose_tokens_matches_jax(name):
    """Greedy rows' argmax and sampled rows' key-stream draws: JAX's
    tokens, over 8 counts of two seeds."""
    a = _knob_inputs(name, seed=1)
    keys = np.stack([np.asarray(jax.random.PRNGKey(s))
                     for s in (3, 5, 11, 2**31 + 5)]).astype(np.int64)
    for count in COUNTS:
        counts = np.full(4, count, np.int32) + np.arange(4, dtype=np.int32)
        want = np.asarray(jct.fused_sample_call(
            a["logits"], a["temp"], a["top_k"], a["top_p"], a["penalty"],
            a["seen"], keys.astype(np.uint32), counts))
        got = tct.choose_tokens(*_torch_args(a), torch.from_numpy(keys),
                                torch.from_numpy(counts))
        np.testing.assert_array_equal(got.numpy(), want)
        assert got.dtype == torch.int32
    # the uncompiled lane's entry point takes numpy knobs
    np.testing.assert_array_equal(
        tct.fused_sample_call(torch.from_numpy(a["logits"]), a["temp"],
                              a["top_k"], a["top_p"], a["penalty"],
                              a["seen"], keys, counts).numpy(), want)


def test_request_key_and_hostable():
    sp = SamplingParams(temperature=0.7, seed=2**31 + 5)
    np.testing.assert_array_equal(
        tct.request_key(sp),
        np.asarray(jct.request_key(JaxSamplingParams(
            temperature=0.7, seed=2**31 + 5))).astype(np.int64))
    assert tct.sampling_hostable(SamplingParams())
    assert tct.sampling_hostable(sp)
    assert not tct.sampling_hostable(SamplingParams(temperature=0.7))


# ---------------------------------------------------------------- engines
def _mixed_subs(jm, SP):
    """The JAX tick's mixed workload (tests/test_compiled_tick.py): greedy,
    greedy + eos (its slot refilled mid-flight), seeded top-k, seeded
    top-p + penalty, greedy; 8 tokens each through 2 slots."""
    pa, pb, pc, pd, pe = _prompts([5, 9, 3, 7, 6])
    ref = jm.generate(paddle.to_tensor(pb[None, :]), max_new_tokens=8,
                      temperature=0.0)
    eos = int(np.asarray(ref._data_)[0, pb.size + 1])
    return [(pa, 8, None, None), (pb, 8, None, eos),
            (pc, 8, SP(temperature=0.8, top_k=20, seed=3), None),
            (pd, 8, SP(temperature=1.0, top_p=0.9, repetition_penalty=1.3,
                       seed=5), None),
            (pe, 8, None, None)]


def _serve(engine_cls, cfg, model, subs):
    eng = engine_cls(model, cfg).start()
    try:
        futs = [eng.submit(p, max_new_tokens=n, sampling=sp, eos_token_id=e)
                for p, n, sp, e in subs]
        outs = [f.result(timeout=300) for f in futs]
        return outs, eng.stats(), eng._tick
    finally:
        eng.shutdown()


def test_engine_matches_jax_engine_mixed_workload(pair, flags):
    """Both engines with their compiled ticks on: the port's output_ids
    and finish reasons equal the JAX engine's for every request, seeded
    sampled ones included (the parent drew them from a torch.Generator)."""
    jm, tm = pair
    jflags.set_flags({k: True for k in TICK_FLAGS})
    tflags.set_flags({k: True for k in TICK_FLAGS})
    want, jsnap, _ = _serve(JaxEngine, JaxServingConfig(num_slots=2,
                                                        max_queue=8),
                            jm, _mixed_subs(jm, JaxSamplingParams))
    got, snap, tick = _serve(Engine, ServingConfig(num_slots=2, max_queue=8),
                             tm, _mixed_subs(jm, SamplingParams))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.output_ids, w.output_ids)
        assert g.finish_reason == w.finish_reason
    assert got[1].finish_reason == "eos" and got[1].output_ids.size < 8
    assert jsnap["tick_compiled_hits"] > 0
    assert snap["tick_compiled_hits"] > 0 and snap["tick_fallbacks"] == 0
    assert isinstance(tick, tct.CompiledServingTick)


@pytest.mark.parametrize("kv", ["float32", "int8", "adapters"])
def test_port_lanes_identical(pair, flags, kv):
    """The tick, the uncompiled lane (FLAGS_compiled_tick off, one fused
    sampling call) and both flags off (a sampling call per row): every
    request's tokens equal in all three, the seeded sampled ones too (a
    seeded row draws from its key stream under every flag).  Float and
    int8 pools, and an adapter pool with one adapter request."""
    jm, tm = pair
    subs = _mixed_subs(jm, SamplingParams)
    subs.append((_prompts([4], seed=9)[0], 6,
                 SamplingParams(repetition_penalty=1.5), None))
    kw = dict(num_slots=2, max_queue=8)
    adapter = None
    if kv == "int8":
        kw["cache_dtype"] = "int8"
    elif kv == "adapters":
        rng = np.random.default_rng(2)
        spec = {n: {"A": rng.normal(0, 0.1, (m.weight.shape[0], 4))
                    .astype(np.float32),
                    "B": rng.normal(0, 0.1, (4, m.weight.shape[1]))
                    .astype(np.float32), "rank": 4, "alpha": 4.0}
                for n, m in tm.named_modules()
                if n.endswith(("q_proj", "v_proj"))}
        kw.update(max_adapters=2, adapter_rank_pool=4, adapters={"a": spec})
        adapter = "a"
    runs = {}
    for lane, on in (("tick", (True, True)), ("uncompiled", (False, True)),
                     ("both-off", (False, False))):
        tflags.set_flags(dict(zip(TICK_FLAGS, on)))
        eng = Engine(tm, ServingConfig(**kw)).start()
        try:
            futs = [eng.submit(p, max_new_tokens=n, sampling=sp,
                               eos_token_id=e,
                               adapter_id=adapter if i == 2 else None)
                    for i, (p, n, sp, e) in enumerate(subs)]
            runs[lane] = [f.result(timeout=300).output_ids for f in futs]
            snap = eng.stats()
        finally:
            eng.shutdown()
        assert (snap["tick_compiled_hits"] > 0) == (lane == "tick")
    for a, b, c in zip(runs["tick"], runs["uncompiled"], runs["both-off"]):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    for toks in runs["both-off"]:
        assert ((toks >= 0) & (toks < 512)).all()


def test_unseeded_sampling_warns_once(pair, flags):
    """Sampling without a seed cannot ride the in-program draw: ONE typed
    TickFallbackWarning, tick.fallbacks counted, no compiled tick ran."""
    _, tm = pair
    pa, pb = _prompts([4, 6], seed=1)
    sp = SamplingParams(temperature=1.0)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        outs, snap, _ = _serve(Engine, ServingConfig(num_slots=2), tm,
                               [(pa, 6, sp, None), (pb, 6, sp, None)])
    tw = [x for x in w if issubclass(x.category, tct.TickFallbackWarning)]
    assert len(tw) == 1, [str(x.message) for x in tw]
    assert "seed" in str(tw[0].message)
    assert snap["tick_compiled_hits"] == 0 and snap["tick_fallbacks"] > 0
    assert all(o.output_ids.size == 6 for o in outs)


def test_forward_hooks_block_the_tick_but_not_the_adapter_pool(pair, flags):
    """A user forward hook latches the uncompiled lane (warned once, kind
    "hooks"); the adapter pool's own LoRA hooks do not."""
    _, tm = pair
    (p,) = _prompts([5], seed=2)
    _, snap, _ = _serve(Engine, ServingConfig(num_slots=1, max_adapters=1),
                        tm, [(p, 4, None, None)])
    assert snap["tick_compiled_hits"] > 0 and snap["tick_fallbacks"] == 0
    handle = tm.llama.norm.register_forward_hook(lambda *a: None)
    try:
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            outs, snap, _ = _serve(Engine, ServingConfig(num_slots=1), tm,
                                   [(p, 4, None, None)])
    finally:
        handle.remove()
    tw = [x for x in w if issubclass(x.category, tct.TickFallbackWarning)]
    assert len(tw) == 1 and "hooks" in str(tw[0].message)
    assert snap["tick_compiled_hits"] == 0 and snap["tick_fallbacks"] > 0
    assert outs[0].output_ids.size == 4


class _HostReadLlama(LlamaForCausalLM):
    """The tiny Llama whose decode forward reads one value to the host."""

    def forward(self, input_ids, labels=None, caches=None):
        out = super().forward(input_ids, labels=labels, caches=caches)
        if input_ids.shape[1] == 1:
            self.reads.append(float(out[0, 0, 0].item()))
        return out


class _JaxHostReadLlama(JaxLlama):
    def forward(self, input_ids, labels=None, caches=None):
        out = super().forward(input_ids, labels=labels, caches=caches)
        if input_ids.shape[1] == 1:
            self.reads.append(float(out[0, 0, 0].item()))
        return out


def test_host_read_in_the_decode_forward_falls_back_as_jax(pair, flags):
    """A decode forward that reads the host cannot be one captured tick:
    on a mode's first call the port's probe finds the read, the tick
    latches the uncompiled lane with ONE TickFallbackWarning, as the JAX
    tick does when its trace fails, and every request completes.  The
    fallback count, the warning and the tokens equal the JAX engine's,
    and the tokens equal the port's flag-off lane's.  (The parent raised
    from the capture on the card and, on the CPU, ran the read.)"""
    jm, _ = pair
    jflags.set_flags({k: True for k in TICK_FLAGS})
    tflags.set_flags({k: True for k in TICK_FLAGS})
    jh = _JaxHostReadLlama(jax_llama_config("tiny", max_seq_len=64))
    jh.set_state_dict(jm.state_dict())
    jh.eval()
    jh.reads = []
    th = _HostReadLlama(llama_config("tiny", max_seq_len=64), device="cpu")
    convert.load_paddle_tpu_state(
        th, {k: v.numpy() for k, v in jm.state_dict().items()})
    th.reads = []
    subs = [(p, 6, None, None) for p in _prompts([5, 9], seed=11)]
    runs = {}
    for name, cls, scfg, model, SP in (
            ("jax", JaxEngine, JaxServingConfig, jh, JaxSamplingParams),
            ("port", Engine, ServingConfig, th, SamplingParams)):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            outs, snap, tick = _serve(cls, scfg(num_slots=2), model, subs)
        mod = jct if name == "jax" else tct
        tw = [x for x in w if issubclass(x.category, mod.TickFallbackWarning)]
        runs[name] = (outs, snap, tick, tw)
    (jouts, jsnap, jtick, jtw), (touts, tsnap, ttick, ttw) = \
        runs["jax"], runs["port"]
    assert len(jtw) == len(ttw) == 1, [str(x.message) for x in ttw]
    assert "host read" in str(ttw[0].message)
    assert ttick.fallback_reason is not None and ttick.steps == {}
    assert jtick.fallback_reason is not None
    assert tsnap["tick_compiled_hits"] == jsnap["tick_compiled_hits"] == 0
    assert tsnap["tick_fallbacks"] == jsnap["tick_fallbacks"] > 0
    tflags.set_flags({"FLAGS_compiled_tick": False})
    off, _, _ = _serve(Engine, ServingConfig(num_slots=2), th, subs)
    for j, t, o in zip(jouts, touts, off):
        assert t.finish_reason == j.finish_reason == "length"
        np.testing.assert_array_equal(t.output_ids, j.output_ids)
        np.testing.assert_array_equal(t.output_ids, o.output_ids)


def _wait_hits(eng, n, timeout=60.0):
    t0 = time.monotonic()
    while eng.stats()["tick_compiled_hits"] < n:
        assert time.monotonic() - t0 < timeout, "the tick never ran"
        time.sleep(0.001)


def test_deadline_eviction_and_cancel_under_the_tick(pair, flags):
    """Mid-decode under the tick: a request whose deadline passes is
    evicted after its tokens reach the host, a cancelled one fails with
    RequestCancelledError, and the request beside them decodes the tokens
    it decodes alone."""
    _, tm = pair
    pa, pb, pc = _prompts([5, 6, 7], seed=4)
    with Engine(tm, ServingConfig(num_slots=3)) as eng:
        alone = eng.generate(pc, max_new_tokens=40).output_ids
    eng = Engine(tm, ServingConfig(num_slots=3)).start()
    try:
        late = eng.submit(pa, max_new_tokens=50, deadline_s=300.0)
        gone = eng.submit(pb, max_new_tokens=50)
        kept = eng.submit(pc, max_new_tokens=40)
        _wait_hits(eng, 3)
        eng._pending[late.request_id].deadline = time.monotonic()
        assert eng.cancel(gone.request_id)
        with pytest.raises(DeadlineExceededError, match="after"):
            late.result(timeout=60)
        with pytest.raises(RequestCancelledError):
            gone.result(timeout=60)
        np.testing.assert_array_equal(kept.result(timeout=60).output_ids,
                                      alone)
        snap = eng.stats()
    finally:
        eng.shutdown()
    assert snap["requests_evicted_deadline"] == 1
    assert snap["requests_cancelled"] == 1
    assert snap["tick_fallbacks"] == 0


def test_tick_stats_declared_at_start(pair, flags):
    """tick_compiled_hits and tick_fallbacks read 0 and tick_ms None
    before the first iteration, and the registry holds the empty
    ``serving.tick_ms`` histogram; then the hits count decode steps, and
    the mode's first tick is timed."""
    _, tm = pair
    eng = Engine(tm, ServingConfig(num_slots=2)).start()
    try:
        snap = eng.stats()
        assert snap["tick_compiled_hits"] == 0
        assert snap["tick_fallbacks"] == 0
        assert snap["tick_ms_avg"] is None
        hist = REGISTRY.get("serving.tick_ms")
        assert isinstance(hist, Histogram) and hist.count == 0
        eng.generate(_prompts([5])[0], max_new_tokens=4)
        snap = eng.stats()
    finally:
        eng.shutdown()
    assert snap["tick_compiled_hits"] == snap["decode_steps"] == 3
    assert set(eng._tick.first_tick_ms) == {"greedy"}
    assert eng._tick.first_tick_ms["greedy"] > 0
    assert snap["tick_ms_avg"] > 0 and snap["tokens_generated"] == 4


def test_flag_off_builds_no_tick(pair, flags):
    _, tm = pair
    tflags.set_flags({"FLAGS_compiled_tick": "0"})
    assert tflags.get_flags("FLAGS_compiled_tick") == \
        {"FLAGS_compiled_tick": False}
    outs, snap, tick = _serve(Engine, ServingConfig(num_slots=1), tm,
                              [(_prompts([5])[0], 3, None, None)])
    assert tick is None and snap["tick_compiled_hits"] == 0
    assert outs[0].output_ids.size == 3


def test_flags_registry_and_environment(monkeypatch, flags):
    """The port declares the flags it reads (the tick's two, the compiled
    train step's, the runtime's, the sentinel's, the telemetry's and the
    hang guardian's) with the JAX registry's defaults, reads
    ``FLAGS_*`` overrides from the environment at import, and coerces
    set_flags values as the JAX registry does."""
    import importlib
    monkeypatch.setenv("FLAGS_compiled_tick", "0")
    try:
        importlib.reload(tflags)
        assert tflags.flag("FLAGS_compiled_tick") is False
        assert tflags.flag("FLAGS_serving_fused_sampling") is True
    finally:
        monkeypatch.delenv("FLAGS_compiled_tick")
        importlib.reload(tflags)
    declared = TICK_FLAGS + ("FLAGS_compiled_train_step",)
    # the training runtime's, the sentinel's and the telemetry's flags
    runtime = ("FLAGS_fault_inject", "FLAGS_sentinel", "FLAGS_hot_spare",
               "FLAGS_sentinel_window", "FLAGS_sentinel_spike_zscore",
               "FLAGS_sentinel_check_every", "FLAGS_sentinel_max_skips",
               "FLAGS_sentinel_rollback_after",
               "FLAGS_sentinel_anchor_every", "FLAGS_sentinel_grad_factor",
               "FLAGS_sentinel_max_rollbacks", "FLAGS_sentinel_dump_path",
               "FLAGS_metrics_export_path",
               "FLAGS_metrics_export_interval_s", "FLAGS_peak_flops",
               "FLAGS_flight_recorder_size", "FLAGS_flight_recorder_path",
               "FLAGS_dump_dir", "FLAGS_trace_dir", "FLAGS_trace_sample_rate",
               "FLAGS_trace_latency_threshold_ms", "FLAGS_trace_buffer_cap",
               "FLAGS_serving_request_label_cap",
               "FLAGS_collective_timeout_s", "FLAGS_collective_hard_abort",
               "FLAGS_stall_dump_path", "FLAGS_desync_check_every",
               "FLAGS_collective_backend", "FLAGS_hot_spare_every",
               "FLAGS_hot_spare_chunk_kb", "FLAGS_hot_spare_timeout_s",
               "FLAGS_reshard_on_resume")
    assert tflags.get_flags() == dict(
        {k: True for k in declared}, FLAGS_fault_inject="",
        FLAGS_sentinel=False, FLAGS_hot_spare=False,
        FLAGS_sentinel_window=32, FLAGS_sentinel_spike_zscore=6.0,
        FLAGS_sentinel_check_every=8, FLAGS_sentinel_max_skips=3,
        FLAGS_sentinel_rollback_after=1, FLAGS_sentinel_anchor_every=32,
        FLAGS_sentinel_grad_factor=100.0, FLAGS_sentinel_max_rollbacks=3,
        FLAGS_sentinel_dump_path="", FLAGS_metrics_export_path="",
        FLAGS_metrics_export_interval_s=10.0, FLAGS_peak_flops=0.0,
        FLAGS_flight_recorder_size=512, FLAGS_flight_recorder_path="",
        FLAGS_dump_dir=".paddle_tpu_dumps", FLAGS_trace_dir="",
        FLAGS_trace_sample_rate=0.05, FLAGS_trace_latency_threshold_ms=250.0,
        FLAGS_trace_buffer_cap=4096, FLAGS_serving_request_label_cap=1024,
        FLAGS_collective_timeout_s=0.0, FLAGS_collective_hard_abort=True,
        FLAGS_stall_dump_path="", FLAGS_desync_check_every=16,
        FLAGS_collective_backend="auto", FLAGS_hot_spare_every=8,
        FLAGS_hot_spare_chunk_kb=1024, FLAGS_hot_spare_timeout_s=10.0,
        FLAGS_reshard_on_resume=True)
    jflags.set_flags({k: True for k in declared})
    assert tflags.get_flags(list(declared)) == \
        jflags.get_flags(list(declared))
    # the training runtime's flags, with the JAX defaults
    assert {k: tflags.flag(k) for k in runtime} == \
        {k: jflags.flag(k) for k in runtime}
    for value in ("yes", 0, "false", 1):
        tflags.set_flags({"FLAGS_serving_fused_sampling": value})
        jflags.set_flags({"FLAGS_serving_fused_sampling": value})
        assert tflags.flag("FLAGS_serving_fused_sampling") is \
            jflags.flag("FLAGS_serving_fused_sampling")


# ---------------------------------------------------------------- pieces
def test_cache_table_and_offsets_are_persistent():
    """Host mutations are copied into one table and one offsets tensor;
    absorb_tick advances the host mirror without a re-upload."""
    cache = PagedKVCache(2, 2, 32, 2, 8, page_size=8, device="cpu")
    pt, off = cache.device_table, cache.device_offsets
    slot = cache.allocate(2)
    cache.ensure_capacity(slot, 9)
    cache.set_offset(slot, 9)
    lay = cache.layer_caches()[1]
    assert lay["page_table"] is pt and lay["offset"] is off
    assert off.tolist()[slot] == 9 and pt[slot, :2].tolist() == \
        cache.table[slot, :2].tolist()
    off[slot] += 1                      # what the tick's body does
    cache.absorb_tick([slot])
    assert not cache._dirty and cache.offsets[slot] == 10
    cache.release(slot)
    cache.layer_caches()
    assert cache.layers[0]["offset"] is off and int(off[slot]) == 0
    assert not pt[slot].any()


def test_captured_step_runs_its_body_on_the_cpu():
    """On the CPU a CapturedStep is its body: no graph, no launch delta."""
    box = torch.zeros(2)
    step = CapturedStep(lambda: box.add_(1), [box], "cpu")
    before = kernels.launch_counts()
    step()
    step()
    assert box.tolist() == [2.0, 2.0]
    assert step.graph is None and step.replays == 0
    assert kernels.launch_counts() == before
    kernels.add_launch_counts({"rms_norm": 3})
    assert kernels.launch_counts()["rms_norm"] == before["rms_norm"] + 3
    kernels.add_launch_counts({"rms_norm": -3})
