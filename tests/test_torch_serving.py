"""The port's serving engine (paddle_tpu_torch/serving/): greedy outputs
identical to the JAX engine on the same tiny Llama, plus the scheduler's
own contract: prefix reuse, seeded sampling, admission, cancellation,
deadlines, shutdown and the options not ported yet."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_config as jax_llama_config
from paddle_tpu.serving import Engine as JaxEngine
from paddle_tpu.serving import ServingConfig as JaxServingConfig
from paddle_tpu_torch import convert
from paddle_tpu_torch.models import LlamaForCausalLM, llama_config
from paddle_tpu_torch.serving import (
    DeadlineExceededError, Engine, EngineShutdownError, QueueFullError,
    RequestCancelledError, SamplingParams, ServingConfig)


def _prompts(lens, seed=11, vocab=512):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (n,)).astype("int32") for n in lens]


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


@pytest.fixture(scope="module")
def model(pair):
    return pair[1]


def test_engine_matches_jax_engine(pair):
    """3 prompts (4, 8, 6 tokens) through 2 slots, 5 greedy tokens: the
    port's output_ids equal the JAX engine's (its host lane, which the
    port mirrors: the compiled tick is not ported)."""
    jm, tm = pair
    prompts = _prompts([4, 8, 6])
    prev = paddle.get_flags("FLAGS_compiled_tick")["FLAGS_compiled_tick"]
    paddle.set_flags({"FLAGS_compiled_tick": False})
    try:
        with JaxEngine(jm, JaxServingConfig(num_slots=2)) as eng:
            want = [f.result(timeout=300).output_ids
                    for f in [eng.submit(p, max_new_tokens=5)
                              for p in prompts]]
    finally:
        paddle.set_flags({"FLAGS_compiled_tick": prev})
    with Engine(tm, ServingConfig(num_slots=2)) as eng:
        got = [f.result(timeout=60).output_ids
               for f in [eng.submit(p, max_new_tokens=5) for p in prompts]]
        stats = eng.stats()
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    assert stats["requests_completed"] == 3
    assert stats["tokens_generated"] == 15


def test_prefix_reuse_keeps_outputs(model):
    """A request sharing a cached 32-token prefix reuses its pages and
    decodes the same tokens as without the cache."""
    base = _prompts([40], seed=2)[0]
    twin = np.concatenate([base[:32], _prompts([5], seed=4)[0]])
    outs = {}
    for cache_on in (True, False):
        cfg = ServingConfig(num_slots=2, enable_prefix_cache=cache_on)
        with Engine(model, cfg) as eng:
            a = eng.generate(base, max_new_tokens=4)
            b = eng.generate(twin, max_new_tokens=4)
            outs[cache_on] = (a.output_ids, b.output_ids, eng.stats())
    np.testing.assert_array_equal(outs[True][0], outs[False][0])
    np.testing.assert_array_equal(outs[True][1], outs[False][1])
    assert outs[True][2]["prefix_cache_hits"] == 1
    assert outs[True][2]["prefix_cache_hit_tokens"] == 32


def test_seeded_sampling_is_reproducible(model):
    sp = SamplingParams(temperature=0.9, top_k=50, top_p=0.9,
                        repetition_penalty=1.3, seed=7)
    (p,) = _prompts([6])
    runs = []
    for _ in range(2):
        with Engine(model, ServingConfig(num_slots=2)) as eng:
            runs.append(eng.generate(p, max_new_tokens=6,
                                     sampling=sp).output_ids)
    np.testing.assert_array_equal(runs[0], runs[1])
    assert ((runs[0] >= 0) & (runs[0] < 512)).all()


def test_eos_and_length_finish(model):
    (p,) = _prompts([5])
    with Engine(model, ServingConfig(num_slots=1)) as eng:
        first = eng.generate(p, max_new_tokens=3)
        assert first.finish_reason == "length"
        assert first.ids.size == p.size + 3
        eos = eng.generate(p, max_new_tokens=3,
                           eos_token_id=int(first.output_ids[0]))
    assert eos.finish_reason == "eos"
    np.testing.assert_array_equal(eos.output_ids, first.output_ids[:1])


def test_admission_cancel_deadline_shutdown(model):
    eng = Engine(model, ServingConfig(num_slots=1, max_queue=1))
    with pytest.raises(EngineShutdownError):
        eng.submit(np.arange(4))
    # not started: nothing drains the queue, so it fills deterministically
    eng._running = True
    fut = eng.submit(np.arange(4))
    with pytest.raises(QueueFullError):
        eng.submit(np.arange(4))
    assert eng.cancel(fut.request_id)
    with pytest.raises(RequestCancelledError):
        fut.result(timeout=1)
    eng._running = False
    with Engine(model, ServingConfig(num_slots=1)) as eng:
        late = eng.submit(np.arange(4), max_new_tokens=5, deadline_s=0.0)
        with pytest.raises(DeadlineExceededError):
            late.result(timeout=30)
        pending = eng.submit(np.arange(4), max_new_tokens=50)
    with pytest.raises(EngineShutdownError):
        pending.result(timeout=30)
    with pytest.raises(ValueError, match="no room"):
        Engine(model).start().submit(np.arange(64))


@pytest.mark.parametrize("kw", [
    dict(cache_dtype="int8"), dict(cache_dtype="fp8"),
    dict(speculation_k=2), dict(max_adapters=1), dict(role="prefill"),
    dict(kv_layout="slots")])
def test_unported_options_raise(kw):
    with pytest.raises(NotImplementedError):
        ServingConfig(**kw).validate()


def test_bf16_pools_serve(model):
    """bfloat16 KV pools under an fp32 model: finite, in-vocab tokens."""
    with Engine(model, ServingConfig(num_slots=2,
                                     cache_dtype="bfloat16")) as eng:
        out = eng.generate(_prompts([7])[0], max_new_tokens=4)
        assert eng.cache.layers[0]["k_pool"].dtype == torch.bfloat16
    assert out.output_ids.size == 4
    assert ((out.output_ids >= 0) & (out.output_ids < 512)).all()
