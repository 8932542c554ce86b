"""GPT behind the port's serving engine against the JAX package's engine
on the tests/test_serving.py model (tiny GPT: vocab 512, hidden 128, 2
layers, 4 heads, max_seq_len 64), fp32 on the CPU, weights carried by
`convert.py`: mixed-age slots with greedy and seeded-sampled requests,
the compiled tick on and off; int8 pools under a 2-adapter LoRA pool on
GPT's four projections; a slot decoding to the last rows of GPT's
learned position table beside another's prefill; and the engine's
refusal of a KV capacity past that table."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import gpt_config as jax_gpt_config
from paddle_tpu.serving import Engine as JaxEngine
from paddle_tpu.serving import SamplingParams as JaxSamplingParams
from paddle_tpu.serving import ServingConfig as JaxServingConfig
from paddle_tpu_torch import convert
from paddle_tpu_torch.models import GPTForCausalLM, gpt_config
from paddle_tpu_torch.serving import Engine, SamplingParams, ServingConfig
from paddle_tpu_torch.utils import flags as tflags
from paddle_tpu_torch.utils import monitor

TINY = dict(num_layers=2, hidden_size=128, num_heads=4, vocab_size=512,
            max_seq_len=64)
GPT_TARGETS = ("qkv_proj", "out_proj", "fc_in", "fc_out")


@pytest.fixture(scope="module")
def pair():
    paddle.seed(0)
    jm = JaxGPT(jax_gpt_config("gpt2-124m", **TINY))
    jm.eval()
    tm = GPTForCausalLM(gpt_config("gpt2-124m", **TINY), device="cpu")
    convert.load_paddle_tpu_state(
        tm, {k: v.numpy() for k, v in jm.state_dict().items()})
    return jm, tm.eval()


@pytest.fixture
def tick_flag():
    saved = tflags.get_flags(["FLAGS_compiled_tick"])
    yield
    tflags.set_flags(saved)


def _prompts(lens, seed=0, vocab=512):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (n,)).astype("int32") for n in lens]


def _run(engine, prompts, max_new, sampling=None, adapter_ids=None):
    sampling = sampling or [None] * len(prompts)
    adapter_ids = adapter_ids or [None] * len(prompts)
    with engine as eng:
        futs = [eng.submit(p, max_new_tokens=max_new, sampling=s,
                           adapter_id=a)
                for p, s, a in zip(prompts, sampling, adapter_ids)]
        return [f.result(timeout=300).output_ids for f in futs], eng.stats()


@pytest.fixture(scope="module")
def jax_mixed(pair):
    """The JAX engine's tokens for five prompts of 5-9 tokens through 2
    slots, 6 new tokens each, the fourth request seeded-sampled (its
    compiled tick on, the default)."""
    jm, _ = pair
    sp = [None] * 5
    sp[3] = JaxSamplingParams(temperature=0.8, top_k=50, top_p=0.95,
                              seed=3)
    return _run(JaxEngine(jm, JaxServingConfig(num_slots=2)),
                _prompts([5, 9, 3, 7, 6]), 6, sp)[0]


@pytest.mark.parametrize("tick", [True, False], ids=["tick", "uncompiled"])
def test_gpt_engine_matches_jax_engine(pair, jax_mixed, tick, tick_flag):
    """The same five requests through the port's engine: every request's
    tokens equal the JAX engine's, with the compiled tick on (every decode
    step a tick, no fallback) and off."""
    _, tm = pair
    tflags.set_flags({"FLAGS_compiled_tick": tick})
    sp = [None] * 5
    sp[3] = SamplingParams(temperature=0.8, top_k=50, top_p=0.95, seed=3)
    got, st = _run(Engine(tm, ServingConfig(num_slots=2)),
                   _prompts([5, 9, 3, 7, 6]), 6, sp)
    for g, w in zip(got, jax_mixed):
        np.testing.assert_array_equal(g, w)
    assert st["requests_completed"] == 5
    if tick:
        assert st["tick_compiled_hits"] == st["decode_steps"] > 0
        assert st["tick_fallbacks"] == 0
    else:
        assert st["tick_compiled_hits"] == 0


def _gpt_adapter(model, seed, rank=4, std=0.1):
    """An adapter_spec over GPT's four projections, factors N(0, std)."""
    rng = np.random.default_rng(seed)
    spec = {}
    for name, mod in model.named_modules():
        if name.rsplit(".", 1)[-1] in GPT_TARGETS:
            din, dout = mod.weight.shape
            spec[name] = {
                "A": rng.normal(0, std, (din, rank)).astype(np.float32),
                "B": rng.normal(0, std, (rank, dout)).astype(np.float32),
                "rank": rank, "alpha": float(rank)}
    return spec


def test_gpt_int8_pools_and_adapters_match_jax(pair):
    """int8 KV pools under a 2-adapter pool (rank pool 8) on GPT's qkv,
    out, fc_in and fc_out projections: a base, an adapter-a and an
    adapter-b request on one prompt give the JAX engine's tokens, and the
    adapters change them."""
    jm, tm = pair
    specs = {"a": _gpt_adapter(tm, 7), "b": _gpt_adapter(tm, 8, rank=8)}
    (prompt,) = _prompts([11], seed=3)
    ids = [None, "a", "b"]
    kw = dict(num_slots=3, cache_dtype="int8", max_adapters=2,
              adapter_rank_pool=8, adapters=specs)
    want = _run(JaxEngine(jm, JaxServingConfig(**kw)), [prompt] * 3, 5,
                adapter_ids=ids)[0]
    got, st = _run(Engine(tm, ServingConfig(**kw)), [prompt] * 3, 5,
                   adapter_ids=ids)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert not np.array_equal(got[0], got[1])
    assert not np.array_equal(got[1], got[2])
    assert st["requests_routed_adapter"] == 2


def test_gpt_slot_at_the_tables_last_rows_beside_a_prefill(pair):
    """A 60-token request decodes at positions 60-62 (its slot's offset
    reaching 63, the table's last row) beside a 40-token request that
    shares its two prefill calls, the second chunk left-shifted to
    positions 32-63 (pads past the prompt included): both decode the
    tokens of the full forward's greedy `generate`."""
    _, tm = pair
    long_p, mid_p = _prompts([60, 40], seed=5)
    with Engine(tm, ServingConfig(num_slots=2)) as eng:
        a = eng.submit(long_p, max_new_tokens=8)
        b = eng.submit(mid_p, max_new_tokens=3)
        a, b = a.result(timeout=300), b.result(timeout=300)
        # the engine's prefill model calls: one prefill_ms observation each
        prefill_calls = monitor.get_monitor_value("serving.prefill_ms.count")
    assert a.output_ids.size == 4 and a.finish_reason == "length"
    for out, p in ((a, long_p), (b, mid_p)):
        want = tm.generate(torch.from_numpy(p[None]), out.output_ids.size,
                           use_cache=False)[0, p.size:]
        np.testing.assert_array_equal(out.output_ids, want.numpy())
    assert prefill_calls >= 2


def test_gpt_engine_refuses_capacity_past_the_position_table(pair):
    """64 learned positions: a page of 48 rounds a slot up to 96 tokens
    and is refused at construction; pages that divide 64 (and int8's
    doubled page of 32) are taken; without caches a 65-token input
    raises."""
    _, tm = pair
    with pytest.raises(ValueError, match="64 learned positions"):
        Engine(tm, ServingConfig(page_size=48))
    with pytest.raises(ValueError, match="learned positions"):
        Engine(tm, ServingConfig(max_seq_len=80))
    Engine(tm, ServingConfig(page_size=16, cache_dtype="int8"))
    Engine(tm, ServingConfig(max_seq_len=50, page_size=8))
    with pytest.raises(ValueError, match="position table"):
        tm(torch.zeros(1, 65, dtype=torch.int64))
