"""Speculative decoding in the port's serving engine against the JAX
package's engine, fp32 on the CPU, weights carried by
`convert.load_paddle_tpu_state`: the tiny Llama (2 layers, GQA, vocab 512)
and tests/test_speculative.py's tiny GPT (2 layers, hidden 64, 2 heads,
vocab 128, max_seq_len 64), each with an agreeing draft (the target's
block 1 has zeroed output projections, the draft is its block 0) and a
negating one (the target's logits negated: every window rejects), token
for token and counter for counter; k = 0; eos mid-window; mixed sampling;
every page of both caches returned; int8 pools under speculation;
`PagedKVCache.rollback` against JAX's over the same operations; the
validation messages; GPT's learned positions and the verify window.

Engines serve with ``max_seq_len=48``: the port refuses a GPT whose KV
capacity (max_seq_len + speculation_k, in whole pages) passes its 64
learned positions, where the JAX engine reads a NaN fill past them (ROADMAP
Queue C)."""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import gpt_config as jax_gpt_config
from paddle_tpu.models import llama_config as jax_llama_config
from paddle_tpu.serving import Engine as JaxEngine
from paddle_tpu.serving import PagedKVCache as JaxPagedKVCache
from paddle_tpu.serving import ServingConfig as JaxServingConfig
from paddle_tpu_torch import convert
from paddle_tpu_torch.models import (GPTForCausalLM, LlamaForCausalLM,
                                     gpt_config, llama_config)
from paddle_tpu_torch.serving import (Engine, PagedKVCache, SamplingParams,
                                      ServingConfig)

TINY = dict(num_layers=2, hidden_size=64, num_heads=2, vocab_size=128,
            max_seq_len=64)
MAX_LEN = 48
FAMILIES = {
    # (JAX class, JAX config, port class, port config, kwargs, the output
    # projections of a block zeroed to make it a residual identity)
    "llama": (JaxLlama, jax_llama_config, LlamaForCausalLM, llama_config,
              ("tiny", dict(max_seq_len=64)), ("self_attn.o_proj",
                                               "mlp.down_proj")),
    "gpt": (JaxGPT, jax_gpt_config, GPTForCausalLM, gpt_config,
            ("gpt2-124m", TINY), ("attn.out_proj", "mlp.fc_out")),
}


def _port_of(family, jm, **over):
    _, _, tcls, tcfg, (name, kw), _ = FAMILIES[family]
    tm = tcls(tcfg(name, **dict(kw, **over)), device="cpu")
    convert.load_paddle_tpu_state(
        tm, {k: v.numpy() for k, v in jm.state_dict().items()})
    return tm.eval()


def _blocks(family, jm):
    return list(jm.llama.layers) if family == "llama" else list(jm.gpt.h)


@pytest.fixture(scope="module")
def families():
    """{family: (JAX target, JAX agreeing draft, port target, port draft)}:
    the target's block 1 has zeroed output projections (a residual
    identity) and the draft is a 1-block model sharing the target's
    embeddings, block 0, final norm and head, so both compute the same
    function."""
    out = {}
    for family, (jcls, jcfg, _, _, (name, kw), zero) in FAMILIES.items():
        paddle.seed(0)
        jm = jcls(jcfg(name, **kw))
        jm.eval()
        block = _blocks(family, jm)[1]
        for path in zero:
            lin = block
            for part in path.split("."):
                lin = getattr(lin, part)
            lin.weight._data_ = jnp.zeros_like(lin.weight._data_)
            if getattr(lin, "bias", None) is not None:
                lin.bias._data_ = jnp.zeros_like(lin.bias._data_)
        paddle.seed(1)
        jd = jcls(jcfg(name, **dict(kw, num_layers=1)))
        jd.eval()
        tgt = dict(jm.named_parameters())
        for pname, p in jd.named_parameters():
            p._data_ = tgt[pname]._data_
        out[family] = (jm, jd, _port_of(family, jm),
                       _port_of(family, jd, num_layers=1))
    return out


@pytest.fixture(scope="module")
def models(families):
    return families["llama"]


class _JaxNegator:
    """The JAX side's adversarial draft: the target's logits negated, so
    its greedy proposal is the target's argmin."""

    def __init__(self, inner):
        self.inner = inner
        self.config = inner.config

    def eval(self):
        return self

    def __call__(self, ids, caches=None):
        return self.inner(ids, caches=caches) * -1.0


class _Negator(_JaxNegator):
    """The port's adversarial draft (the same construction)."""

    def __call__(self, ids, caches=None):
        return -self.inner(ids, caches=caches)


def _prompts(lens, seed=0, vocab=128):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (n,)).astype("int32") for n in lens]


def _serve(engine, prompts, max_new, eos=None, sampling=None):
    sampling = sampling or [None] * len(prompts)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # the tick's static fallback
        with engine as eng:
            futs = [eng.submit(p, max_new_tokens=max_new, eos_token_id=eos,
                               sampling=s) for p, s in zip(prompts, sampling)]
            outs = [f.result(timeout=300) for f in futs]
            return outs, eng.stats(), eng


def _ref_greedy(tm, prompt, max_new, eos=None):
    ids = tm.generate(torch.from_numpy(prompt[None].astype(np.int64)),
                      max_new, eos_token_id=eos)
    return ids[0, prompt.size:].numpy()


SPEC_KEYS = ("spec_windows", "spec_proposed_tokens", "spec_accepted_tokens",
             "tokens_generated")


@pytest.mark.parametrize("draft", ["agreeing", "negating"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_spec_engine_matches_jax_engine(families, family, draft):
    """Three prompts through 2 slots, K 4, 10 new tokens each: the port's
    tokens equal the JAX engine's for every request, and generate's, and
    so do the window, proposal and acceptance counts (agreeing: every
    proposal accepted; negating: none)."""
    jm, jd, tm, td = families[family]
    prompts = _prompts([9, 5, 11], seed=4)
    j_draft, t_draft = (jd, td) if draft == "agreeing" else \
        (_JaxNegator(jm), _Negator(tm))
    kw = dict(num_slots=2, max_seq_len=MAX_LEN, speculation_k=4,
              enable_prefix_cache=False)
    want, jst, _ = _serve(JaxEngine(jm, JaxServingConfig(
        draft_model=j_draft, **kw)), prompts, 10)
    got, st, _ = _serve(Engine(tm, ServingConfig(draft_model=t_draft, **kw)),
                        prompts, 10)
    for w, g, p in zip(want, got, prompts):
        np.testing.assert_array_equal(g.output_ids, w.output_ids)
        np.testing.assert_array_equal(g.output_ids, _ref_greedy(tm, p, 10))
    for key in SPEC_KEYS:
        assert st[key] == jst[key], (key, st[key], jst[key])
    rate = 1.0 if draft == "agreeing" else 0.0
    assert st["spec_acceptance_rate"] == rate
    assert st["spec_proposed_tokens"] > 0
    for key in ("spec_draft_ms_avg", "spec_verify_ms_avg",
                "spec_rollback_ms_avg"):
        assert st[key] > 0


def test_k0_with_draft_is_plain_decode(models):
    """speculation_k=0 with a draft: the plain decode loop (the compiled
    tick hosts it), no draft cache, no spec counter moves."""
    _, _, tm, td = models
    (p,) = _prompts([9], seed=3)
    outs, st, eng = _serve(Engine(tm, ServingConfig(
        num_slots=2, max_seq_len=MAX_LEN, draft_model=td, speculation_k=0)),
        [p], 8)
    np.testing.assert_array_equal(outs[0].output_ids, _ref_greedy(tm, p, 8))
    assert eng.draft_cache is None
    assert st["spec_windows"] == 0 and st["spec_acceptance_rate"] is None
    assert st["tick_compiled_hits"] == st["decode_steps"] > 0


def test_eos_mid_window_truncates(models):
    """An eos inside an accepted window ends the request there, as
    generate does, in both packages; every page of both caches returns."""
    jm, jd, tm, td = models
    (p,) = _prompts([8], seed=1)
    free = _ref_greedy(tm, p, 10)
    # token 0 comes from the prefill, window 1 emits tokens 1-5 (K 4, all
    # accepted): token 3 is mid-window
    eos = int(free[3])
    assert eos not in free[:3]
    kw = dict(num_slots=1, max_seq_len=MAX_LEN, speculation_k=4,
              enable_prefix_cache=False)
    want, _, _ = _serve(JaxEngine(jm, JaxServingConfig(draft_model=jd, **kw)),
                        [p], 10, eos=eos)
    got, _, eng = _serve(Engine(tm, ServingConfig(draft_model=td, **kw)),
                         [p], 10, eos=eos)
    assert got[0].finish_reason == "eos" == want[0].finish_reason
    np.testing.assert_array_equal(got[0].output_ids, want[0].output_ids)
    np.testing.assert_array_equal(got[0].output_ids,
                                  _ref_greedy(tm, p, 10, eos=eos))
    assert got[0].output_ids.size == 4
    assert eng.cache.pages_in_use == 0 and eng.draft_cache.pages_in_use == 0


def test_mixed_sampling_falls_back_to_plain_step(models):
    """A sampled request disables speculation on the iterations it shares
    (each consults the tick, which counts a fallback, then the plain step
    runs); the greedy request keeps generate's tokens."""
    _, _, tm, td = models
    prompts = _prompts([6, 6], seed=8)
    sampling = [None, SamplingParams(temperature=0.9, seed=5)]
    outs, st, _ = _serve(Engine(tm, ServingConfig(
        num_slots=2, max_seq_len=MAX_LEN, draft_model=td, speculation_k=4,
        enable_prefix_cache=False)), prompts, 6, sampling=sampling)
    np.testing.assert_array_equal(outs[0].output_ids,
                                  _ref_greedy(tm, prompts[0], 6))
    assert outs[1].output_ids.size == 6
    assert st["decode_steps"] > 0
    assert st["tick_fallbacks"] == 1 + st["decode_steps"]
    assert st["tick_compiled_hits"] == 0


def test_spec_engine_all_pages_return_after_load(models):
    """Three requests through 2 slots with a rollback every window: after
    the load both pools are empty and no reservation is left, and with
    the prefix cache on the target holds exactly the tree's pages."""
    _, _, tm, td = models
    prompts = _prompts([9, 6, 11], seed=9)
    for tree in (False, True):
        outs, _, eng = _serve(Engine(tm, ServingConfig(
            num_slots=2, max_seq_len=MAX_LEN, draft_model=td,
            speculation_k=4, page_size=4, enable_prefix_cache=tree)),
            prompts, 12)
        cached = eng.prefix_tree.cached_pages() if tree else 0
        assert eng.cache.pages_in_use == cached
        assert tree is False or cached > 0
        assert eng.draft_cache.pages_in_use == 0
        assert sum(eng.cache._reserved.values()) == 0
        assert eng.draft_cache.available_pages == \
            eng.draft_cache.usable_pages
        for p, o in zip(prompts, outs):
            np.testing.assert_array_equal(o.output_ids,
                                          _ref_greedy(tm, p, 12))


def test_int8_spec_engine_matches_jax_engine(models):
    """Speculation over int8 pools (rejected rows keep stale codes and
    scales until overwritten, behind the causal bound): the port's tokens
    equal the JAX int8 spec engine's, and every page returns."""
    jm, jd, tm, td = models
    prompts = _prompts([9, 13], seed=13)
    kw = dict(num_slots=2, max_seq_len=MAX_LEN, cache_dtype="int8",
              speculation_k=4, enable_prefix_cache=False)
    want, jst, _ = _serve(JaxEngine(jm, JaxServingConfig(
        draft_model=jd, **kw)), prompts, 10)
    got, st, eng = _serve(Engine(tm, ServingConfig(draft_model=td, **kw)),
                          prompts, 10)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.output_ids, w.output_ids)
    assert st["spec_accepted_tokens"] == jst["spec_accepted_tokens"] > 0
    assert eng.cache.pages_in_use == 0 and eng.draft_cache.pages_in_use == 0
    assert eng.cache.layers[0]["k_pool"].dtype == torch.int8


def _pool_state(cache, slot):
    return (cache.table.tolist(), list(cache._free_pages),
            dict(cache._reserved), list(cache._private.get(slot, [])),
            cache.available_pages, cache.pages_in_use)


ROLLBACK_OPS = {
    # JAX test_rollback_returns_exact_pages: grow, roll back, keep the
    # horizon page, regrow
    "exact-pages": (0, [("grow", 39), ("rollback", 17), ("rollback", 16),
                        ("grow", 47), ("rollback", 40), ("grow", 44)]),
    # test_rollback_never_touches_shared_pages: two tree pages lead
    "shared": (2, [("grow", 39), ("rollback", 0), ("grow", 23),
                   ("rollback", 9)]),
    # windows of K 4 a step, all rejected, across page edges
    "windows": (1, [("grow", 12), ("rollback", 9), ("grow", 13),
                    ("rollback", 10), ("grow", 14), ("rollback", 15),
                    ("grow", 19), ("rollback", 16)]),
}


@pytest.mark.parametrize("case", sorted(ROLLBACK_OPS))
def test_rollback_matches_jax(case):
    """The same allocate / ensure_capacity / rollback / release sequence
    on JAX's PagedKVCache and the port's: after every operation the same
    table, free list, reservations, private pages and availability (a
    rollback never changes ``available_pages``), and the port's device
    table follows its host table at the next upload."""
    n_shared, ops = ROLLBACK_OPS[case]
    kw = dict(num_layers=1, num_slots=2, max_len=64, num_kv_heads=2,
              head_dim=4, page_size=8, num_pages=10)
    caches = [JaxPagedKVCache(**kw), PagedKVCache(device="cpu", **kw)]
    slots = []
    for c in caches:
        shared = [c._free_pages.pop() for _ in range(n_shared)]
        slots.append(c.allocate(6, shared_pages=shared))
    assert slots[0] == slots[1]
    slot = slots[0]
    for op, pos in ops:
        avail = [c.available_pages for c in caches]
        for c in caches:
            getattr(c, "ensure_capacity" if op == "grow" else "rollback")(
                slot, pos)
        if op == "rollback":
            assert [c.available_pages for c in caches] == avail
        assert _pool_state(caches[1], slot) == _pool_state(caches[0], slot)
        caches[1].layer_caches()
        np.testing.assert_array_equal(caches[1].device_table.numpy(),
                                      caches[1].table)
    for c in caches:
        c.release(slot)
    assert _pool_state(caches[1], slot) == _pool_state(caches[0], slot)


VALIDATION = {
    "no-draft": dict(speculation_k=2),
    "spec-on-slots": dict(speculation_k=2, draft_model=object(),
                          kv_layout="slots"),
    "negative-k": dict(speculation_k=-1),
    "layout": dict(kv_layout="pages"),
    "int8-on-slots": dict(cache_dtype="int8", kv_layout="slots"),
    "adapters-on-slots": dict(max_adapters=2, kv_layout="slots"),
    "drain-grace": dict(drain_grace_s=-1.0),
    "step-timeout": dict(step_timeout_s=-0.5),
    "restarts": dict(max_scheduler_restarts=-1),
    "role": dict(role="router"),
}


@pytest.mark.parametrize("case", sorted(VALIDATION))
def test_validation_messages_match_jax(case):
    """`ServingConfig.validate` raises what the JAX package raises, with
    its words."""
    kw = VALIDATION[case]
    with pytest.raises(ValueError) as want:
        JaxServingConfig(**kw).validate()
    with pytest.raises(ValueError) as got:
        ServingConfig(**kw).validate()
    assert str(got.value) == str(want.value)


def test_draft_checks_match_jax(families):
    """A draft with fewer positions than max_seq_len or another vocab is
    refused at construction, in the JAX engine's words; a valid config
    has the JAX fields' defaults."""
    jm, _, tm, _ = families["gpt"]
    for over in (dict(max_seq_len=32), dict(vocab_size=64)):
        paddle.seed(2)
        jd = JaxGPT(jax_gpt_config("gpt2-124m",
                                   **dict(TINY, num_layers=1, **over)))
        td = _port_of("gpt", jd, num_layers=1, **over)
        with pytest.raises(ValueError) as want:
            JaxEngine(jm, JaxServingConfig(speculation_k=2, draft_model=jd))
        with pytest.raises(ValueError) as got:
            Engine(tm, ServingConfig(speculation_k=2, draft_model=td))
        assert str(got.value) == str(want.value)
    for name in ("drain_grace_s", "step_timeout_s", "max_scheduler_restarts",
                 "speculation_k", "kv_layout"):
        assert getattr(ServingConfig(), name) == \
            getattr(JaxServingConfig(), name)


def test_gpt_draft_refused_past_position_rows(families):
    """GPT's learned positions bound the verify window: the capacity is
    max_seq_len + K rounded up to whole pages, held against the target's
    and the draft's ``position_rows``.  A draft with a shorter table is
    refused by name; the default max_seq_len 64 with K 4 (80 positions) is
    refused too, 48 with K 4 (64) serves."""
    _, _, tm, td = families["gpt"]
    short = GPTForCausalLM(gpt_config("gpt2-124m", **dict(
        TINY, num_layers=1, max_seq_len=56)), device="cpu").eval()
    with pytest.raises(ValueError, match="draft_model's 56 learned"):
        Engine(tm, ServingConfig(max_seq_len=MAX_LEN, speculation_k=4,
                                 draft_model=short))
    with pytest.raises(ValueError, match="model's 64 learned"):
        Engine(tm, ServingConfig(speculation_k=4, draft_model=td))
    Engine(tm, ServingConfig(max_seq_len=MAX_LEN, speculation_k=4,
                             draft_model=td))
    Engine(tm, ServingConfig(kv_layout="slots"))       # capacity 64
