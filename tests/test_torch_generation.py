"""The port's generation path against the JAX package's on the same
weights: dense-cache attention (`masked_multihead_attention`), `generate`
with and without the cache, eos padding, `speculative_generate` and
`beam_search` for the tiny GPT (the tests/test_serving.py model) and the
tiny Llama (GQA), fp32 on the CPU, weights carried by `convert.py`,
inputs from numpy seeds; then activation recompute (`use_recompute`)
against the port without it and against JAX, and the flash op's
trainable-mask route against JAX's XLA attention.

JAX compiles each new shape on the CPU, so every case keeps to at most
4 new tokens."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.incubate.nn import functional as JIF
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import generation as jgen
from paddle_tpu.models import gpt_config as jax_gpt_config
from paddle_tpu.models import llama_config as jax_llama_config
from paddle_tpu.pallas import flash_attention as jfa
from paddle_tpu_torch import convert
from paddle_tpu_torch.distributed.fleet.utils import recompute
from paddle_tpu_torch.incubate.nn import functional as IF
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.models import (GPTForCausalLM, LlamaForCausalLM,
                                     generation, gpt_config, llama_config)
from paddle_tpu_torch.nn import functional as F

# fp32 on the CPU on both sides, sums in other orders (XLA's einsum
# against torch's): a few fp32 ulps of the largest term
MMHA_TOL = dict(rtol=1e-5, atol=1e-6)
TINY_GPT = dict(num_layers=2, hidden_size=128, num_heads=4, vocab_size=512,
                max_seq_len=64)


def _np(t):
    return np.asarray(t._data_)


def _port(jm, tm):
    convert.load_paddle_tpu_state(
        tm, {k: v.numpy() for k, v in jm.state_dict().items()})
    jm.eval()
    return tm.eval()


@pytest.fixture(scope="module")
def gpt_pair():
    paddle.seed(0)
    jm = JaxGPT(jax_gpt_config("gpt2-124m", **TINY_GPT))
    return jm, _port(jm, GPTForCausalLM(gpt_config("gpt2-124m", **TINY_GPT),
                                        device="cpu"))


@pytest.fixture(scope="module")
def llama_pair():
    paddle.seed(1)
    jm = JaxLlama(jax_llama_config("tiny", max_seq_len=64))
    return jm, _port(jm, LlamaForCausalLM(llama_config("tiny",
                                                       max_seq_len=64),
                                          device="cpu"))


@pytest.fixture(scope="module")
def draft_pair():
    """A 1-layer GPT draft of the tiny GPT's width."""
    paddle.seed(2)
    cfg = dict(TINY_GPT, num_layers=1)
    jm = JaxGPT(jax_gpt_config("gpt2-124m", **cfg))
    return jm, _port(jm, GPTForCausalLM(gpt_config("gpt2-124m", **cfg),
                                        device="cpu"))


def _ids(seed, b=2, s=6, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)) \
        .astype(np.int32)


# ------------------------------------------------ dense-cache attention
@pytest.mark.parametrize("per_row", [False, True], ids=["scalar", "rows"])
@pytest.mark.parametrize("h_kv", [4, 2], ids=["mha", "gqa"])
@pytest.mark.parametrize("s_new", [5, 1], ids=["prefill", "decode"])
def test_masked_mha_matches_jax(per_row, h_kv, s_new):
    """Random caches, new K/V written at a scalar offset or at one offset
    a row: the output and the written caches against the JAX op, and the
    caches are the port's own tensors, written in place."""
    rng = np.random.default_rng(3)
    b, s_max, h, d = 3, 16, 4, 8

    def mk(*shape):
        return rng.normal(size=shape).astype(np.float32)
    q, k, v = mk(b, s_new, h, d), mk(b, s_new, h_kv, d), mk(b, s_new, h_kv, d)
    ck, cv = mk(b, s_max, h_kv, d), mk(b, s_max, h_kv, d)
    off = np.array([0, 7, 11], np.int32) if per_row else np.int32(9)
    j_out, j_ck, j_cv = JIF.masked_multihead_attention(
        *(Tensor(a) for a in (q, k, v, ck, cv)), Tensor(off))
    tck, tcv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    out, ck2, cv2 = IF.masked_multihead_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), tck, tcv,
        torch.from_numpy(np.asarray(off)))
    assert ck2 is tck and cv2 is tcv
    np.testing.assert_allclose(out.numpy(), _np(j_out), **MMHA_TOL)
    np.testing.assert_array_equal(tck.numpy(), _np(j_ck))
    np.testing.assert_array_equal(tcv.numpy(), _np(j_cv))


def test_masked_mha_host_offset_overflow_raises():
    c = torch.zeros(1, 8, 2, 4)
    q = torch.zeros(1, 3, 2, 4)
    with pytest.raises(ValueError, match="KV cache overflow"):
        IF.masked_multihead_attention(q, q, q, c, c.clone(), 6)
    with pytest.raises(ValueError, match="KV cache overflow"):
        IF.masked_multihead_attention(q, q, q, c, c.clone(),
                                      torch.tensor([6], dtype=torch.int32))


# ------------------------------------------------------------ generate
@pytest.mark.parametrize("family", ["gpt", "llama"])
@pytest.mark.parametrize("use_cache", [True, False], ids=["cache", "full"])
def test_generate_greedy_matches_jax(family, use_cache, gpt_pair,
                                     llama_pair):
    """Greedy `generate`, 4 new tokens for 2 rows: the port's ids equal
    the JAX package's, with and without the cache."""
    jm, tm = gpt_pair if family == "gpt" else llama_pair
    ids = _ids(4)
    want = _np(jm.generate(Tensor(ids), max_new_tokens=4,
                           use_cache=use_cache))
    got = tm.generate(torch.from_numpy(ids), max_new_tokens=4,
                      use_cache=use_cache)
    assert got.dtype == torch.int32 and got.shape == (2, 10)
    np.testing.assert_array_equal(got.numpy(), want)


def test_generate_gqa_cache_holds_kv_heads_only(llama_pair, monkeypatch):
    """The tiny Llama has 4 query heads and 2 kv heads: `generate`'s
    caches are fp32 ``[B, max_len, 2, D]``."""
    _, tm = llama_pair
    made = []
    real = generation.init_kv_caches

    def spy(*a, **kw):
        made.append(real(*a, **kw))
        return made[-1]
    monkeypatch.setattr(generation, "init_kv_caches", spy)
    tm.generate(torch.from_numpy(_ids(5, b=1)), max_new_tokens=2)
    cfg = tm.config
    assert cfg.num_kv_heads < cfg.num_heads
    for c in made[0]:
        assert c["k"].shape == (1, 8, cfg.num_kv_heads, cfg.head_dim)
        assert c["k"].dtype == torch.float32
        assert c["offset"].device.type == "cpu"


def test_generate_eos_pads_like_jax(gpt_pair):
    """eos = row 0's first greedy token: row 0 finishes at once and pads
    with eos while row 1 goes on (JAX's `_EosTracker`), in both paths."""
    jm, tm = gpt_pair
    ids = _ids(6)
    first = int(tm.generate(torch.from_numpy(ids), max_new_tokens=1)[0, -1])
    for use_cache in (True, False):
        want = _np(jm.generate(Tensor(ids), max_new_tokens=4,
                               use_cache=use_cache, eos_token_id=first))
        got = tm.generate(torch.from_numpy(ids), max_new_tokens=4,
                          use_cache=use_cache, eos_token_id=first)
        np.testing.assert_array_equal(got.numpy(), want)
        assert (got[0, 6:] == first).all()


def test_sampled_generate_draws_from_its_generator(gpt_pair):
    """Sampling draws from the generator it is given: equal generators
    give equal ids, torch's global RNG plays no part."""
    _, tm = gpt_pair
    ids = torch.from_numpy(_ids(7))
    runs = []
    for seed in (5, 5):
        torch.manual_seed(len(runs))
        runs.append(tm.generate(ids, max_new_tokens=4, temperature=0.9,
                                top_k=40, top_p=0.9, repetition_penalty=1.2,
                                generator=torch.Generator().manual_seed(seed)))
    assert torch.equal(runs[0], runs[1])
    with pytest.raises(ValueError, match="top_p"):
        tm.generate(ids, top_p=0.0)


def test_speculative_generate_matches_jax(gpt_pair, draft_pair):
    """K = 2 with a 1-layer draft, 4 new tokens: equal to JAX's and to
    greedy `generate`."""
    (jm, tm), (jd, td) = gpt_pair, draft_pair
    ids = _ids(8)
    want = _np(jgen.speculative_generate(jm, jd, Tensor(ids),
                                         max_new_tokens=4, speculation_k=2))
    got = generation.speculative_generate(tm, td, torch.from_numpy(ids),
                                          max_new_tokens=4, speculation_k=2)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), tm.generate(torch.from_numpy(ids),
                                 max_new_tokens=4).numpy())


def test_speculative_overshoot_past_the_position_table(gpt_pair,
                                                       draft_pair):
    """max_len = max_seq_len: the verify windows reach K positions past
    GPT's 64-row table; the port clamps those rows (their outputs are not
    used), and the tokens stay greedy `generate`'s."""
    (_, tm), (_, td) = gpt_pair, draft_pair
    ids = torch.from_numpy(_ids(9, s=58))
    got = generation.speculative_generate(tm, td, ids, max_new_tokens=10,
                                          speculation_k=4)
    assert got.shape == (2, 64)
    assert torch.equal(got, tm.generate(ids, max_new_tokens=10))


@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_beam_search_matches_jax(family, gpt_pair, llama_pair):
    """4 beams, 3 new tokens, eos = the first token of row 0's best
    one-token beam (so beams finish and are kept at a frozen score): the
    port's ids equal JAX's."""
    jm, tm = gpt_pair if family == "gpt" else llama_pair
    ids = _ids(10)
    eos = int(generation.beam_search(tm, torch.from_numpy(ids),
                                     max_new_tokens=1, num_beams=4)[0, -1])
    want = _np(jgen.beam_search(jm, Tensor(ids), max_new_tokens=3,
                                num_beams=4, eos_token_id=eos))
    got = generation.beam_search(tm, torch.from_numpy(ids),
                                 max_new_tokens=3, num_beams=4,
                                 eos_token_id=eos)
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="num_beams"):
        generation.beam_search(tm, torch.from_numpy(ids), num_beams=0)


def test_generate_step_and_flops(gpt_pair, llama_pair):
    """`GPTForCausalLM.generate_step` greedy equals `generate`'s first
    token; Llama's FLOPs a token equal JAX's."""
    _, tm = gpt_pair
    ids = torch.from_numpy(_ids(11))
    step = GPTForCausalLM.generate_step(tm, ids, temperature=0.0)
    assert torch.equal(step.to(ids.dtype), tm.generate(ids, 1)[:, -1])
    drawn = GPTForCausalLM.generate_step(
        tm, ids, temperature=1.0, top_k=5,
        generator=torch.Generator().manual_seed(0))
    assert drawn.shape == (2, 1)
    jl, tl = llama_pair
    assert tl.flops_per_token() == jl.flops_per_token()
    assert tl.flops_per_token(128) == jl.flops_per_token(128)


# ------------------------------------------------------------ recompute
def _gpt_grads(cfg, ids, labels, seed=0):
    m = GPTForCausalLM(cfg, device="cpu", seed=seed)
    _, loss = m(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    loss.backward()
    return m, loss, {n: p.grad for n, p in m.named_parameters()}


def test_recompute_gradients_bit_for_bit_with_dropout():
    """The tiny GPT with attention and residual dropout 0.1: the loss and
    every gradient with `use_recompute` equal the run without it bit for
    bit, and both generators stand where the run without it left them
    (each draw made once, the recompute drawing nothing)."""
    cfg = dict(TINY_GPT, dropout=0.1, attn_dropout=0.1)
    rng = np.random.default_rng(12)
    ids = rng.integers(0, 512, (2, 32)).astype(np.int64)
    labels = np.roll(ids, -1, axis=1)
    runs = [_gpt_grads(gpt_config("gpt2-124m", **cfg, use_recompute=r),
                       ids, labels) for r in (False, True)]
    (m0, l0, g0), (m1, l1, g1) = runs
    assert torch.equal(l0, l1)
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name
    for gen in ("flash_generator", "dropout_generator"):
        assert torch.equal(getattr(m0, gen).get_state(),
                           getattr(m1, gen).get_state())


def test_recompute_draws_once_and_replays_masks():
    """`recompute` over a region with a dropout mask and a flash seed:
    the first run draws, the backward's recompute takes both back (the
    generators move once), and the gradients equal the plain run's."""
    lin = torch.nn.Linear(8, 8)
    x = torch.randn(2, 4, 8, requires_grad=True)
    gens = [torch.Generator().manual_seed(3) for _ in range(2)]

    def region(t):
        y = F.dropout(lin(t), 0.5, generator=gens[0])
        q = y.reshape(2, 4, 2, 4)
        return fa.flash_attention(q, q, q, dropout=0.2, causal=True,
                                  generator=gens[1])
    out = recompute(region, x)
    states = [g.get_state() for g in gens]
    out.sum().backward()
    assert all(torch.equal(g.get_state(), s) for g, s in zip(gens, states))
    want_x, want_w = x.grad.clone(), lin.weight.grad.clone()
    x.grad = lin.weight.grad = None
    for g in gens:
        g.manual_seed(3)
    plain = region(x)
    plain.sum().backward()
    assert torch.equal(out, plain)
    assert torch.equal(x.grad, want_x) and torch.equal(lin.weight.grad,
                                                       want_w)


def test_recompute_gradients_match_jax():
    """`use_recompute` on both sides, the dropouts off: loss and every
    gradient of the tiny GPT within 1e-6 of JAX's."""
    paddle.seed(13)
    jcfg = jax_gpt_config("gpt2-124m", **TINY_GPT, use_recompute=True)
    jm = JaxGPT(jcfg)
    tm = GPTForCausalLM(gpt_config("gpt2-124m", **TINY_GPT,
                                   use_recompute=True), device="cpu")
    convert.load_paddle_tpu_state(
        tm, {k: v.numpy() for k, v in jm.state_dict().items()})
    rng = np.random.default_rng(14)
    ids = rng.integers(0, 512, (2, 16)).astype(np.int32)
    labels = np.roll(ids, -1, axis=1).astype(np.int64)
    _, j_loss = jm(Tensor(ids), labels=Tensor(labels))
    j_loss.backward()
    _, loss = tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(j_loss.numpy()),
                               rtol=1e-6)
    jgrads = {n: _np(p.grad) for n, p in jm.named_parameters()}
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), jgrads[name], rtol=1e-6,
                                   atol=1e-6, err_msg=name)


# ------------------------------------------------------ trainable mask
@pytest.mark.parametrize("causal", [False, True])
def test_trainable_mask_gradient_matches_jax_xla_attention(causal):
    """A learned additive bias ``[1, H, S, S]`` that requires grad: the
    port's op takes its plain version (counted in ``plain_routes``) and
    autograd gives the bias, q, k and v JAX's gradients (its
    ``_xla_attention`` route)."""
    rng = np.random.default_rng(15 + causal)
    b, s, h, d = 2, 16, 4, 8
    q, k, v, g = (rng.normal(size=(b, s, h, d)).astype(np.float32)
                  for _ in range(4))
    bias = rng.normal(size=(1, h, s, s)).astype(np.float32)
    jt = [Tensor(a, stop_gradient=False) for a in (q, k, v, bias)]
    j_out = jfa.flash_attention(*jt[:3], attn_mask=jt[3], causal=causal)
    (j_out * Tensor(g)).sum().backward()
    tt = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v, bias)]
    routes = fa.flash_attention.plain_routes
    out = fa.flash_attention(*tt[:3], attn_mask=tt[3], causal=causal)
    assert fa.flash_attention.plain_routes == routes + 1
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), _np(j_out), rtol=1e-5,
                               atol=1e-6)
    for t, j in zip(tt, jt):
        np.testing.assert_allclose(t.grad.numpy(), _np(j.grad), rtol=1e-5,
                                   atol=1e-6)
    # a mask that needs no grad keeps the kernels' route
    fa.flash_attention(*(t.detach() for t in tt))
    fa.flash_attention(*(t.detach() for t in tt[:3]),
                       attn_mask=tt[3].detach())
    assert fa.flash_attention.plain_routes == routes + 1
