"""Quantized (int8 / fp8) KV pools in the port against the JAX package:
the per-row quantization bit for bit, the quantized paged op against
JAX's gather path and its Pallas kernel in interpret mode, the cache's
pool layout, and greedy engine outputs identical to the JAX engine's on
the tiny Llama, with the pages in use halved at equal load."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import quantization as JQ
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.incubate.nn import functional as JIF
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_config as jax_llama_config
from paddle_tpu.pallas.flash_attention import paged_decode_attention as \
    jax_paged_decode
from paddle_tpu.serving import Engine as JaxEngine
from paddle_tpu.serving import ServingConfig as JaxServingConfig
from paddle_tpu_torch import convert, kernels
from paddle_tpu_torch import quantization as Q
from paddle_tpu_torch.incubate.nn import functional as IF
from paddle_tpu_torch.kernels import paged_decode as pd
from paddle_tpu_torch.models import LlamaForCausalLM, llama_config
from paddle_tpu_torch.serving import Engine, PagedKVCache, ServingConfig

QUANT = ["int8", "fp8"]


def _np(t):
    return np.asarray(t._data_)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bytes(a):
    """The raw bytes of a numpy array or a torch tensor, for bitwise
    comparison of int8 / float8 codes."""
    if isinstance(a, torch.Tensor):
        return Q.as_bytes(a).numpy().view(np.uint8)
    return np.asarray(a).view(np.uint8)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")


@pytest.mark.parametrize("name", QUANT)
@pytest.mark.parametrize("shape", [(4, 7, 2, 16), (3, 1, 4, 128),
                                   (64, 8, 128)])
def test_quantize_kv_rows_bitwise_matches_jax(name, shape):
    """Codes and scales equal bit for bit (0 codes may differ: a division
    that rounds otherwise would flip a code at a .5 boundary), over rows
    whose magnitudes span 1e-2..10, plus an all-zero row (scale 1e-12)."""
    rng = np.random.default_rng(len(shape))
    x = rng.normal(size=shape) * rng.uniform(0.01, 10, size=shape[:-2]
                                             + (1, 1))
    x = x.astype(np.float32)
    x.reshape((-1,) + shape[-2:])[0] = 0.0
    sd, qmax = JQ.KV_QUANT_DTYPES[name]
    jq, js = JQ.quantize_kv_rows(jnp.asarray(x), qmax, sd)
    tsd, tqmax = Q.KV_QUANT_DTYPES[name]
    assert tqmax == qmax
    tq, ts = Q.quantize_kv_rows(_t(x), tqmax, tsd)
    assert tq.dtype == tsd and ts.dtype == torch.float32
    assert int((_bytes(tq) != _bytes(jq)).sum()) == 0
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(Q.dequantize_kv(tq, ts).numpy(),
                                  np.asarray(JQ.dequantize_kv(jq, js)))


def test_kv_quant_params():
    assert Q.kv_quant_params("int8") == (torch.int8, 127.0)
    assert Q.kv_quant_params("fp8") == (torch.float8_e4m3fn, 448.0)
    assert Q.kv_quant_params("bfloat16") is None


def _quant_case(seed, s_new, offs, name, B=3, H=8, Hkv=2, D=16, psz=8, N=4):
    """Pools of random codes with random scales, and new q/k/v."""
    rng = np.random.default_rng(seed)
    P = 1 + B * N
    sd, qmax = JQ.KV_QUANT_DTYPES[name]
    vals = rng.uniform(-qmax, qmax, (2, P, psz, Hkv, D)).astype(np.float32)
    pools = np.asarray(jnp.asarray(np.round(vals) if name == "int8" else vals)
                       .astype(sd))
    scales = rng.uniform(0.005, 0.03, (2, P, psz)).astype(np.float32)
    q = rng.normal(size=(B, s_new, H, D)).astype(np.float32)
    k = rng.normal(size=(B, s_new, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, s_new, Hkv, D)).astype(np.float32)
    table = rng.permutation(np.arange(1, P)).reshape(B, N).astype(np.int32)
    return q, k, v, pools, scales, table, np.asarray(offs, np.int32), psz


def _port_pools(pools, scales, name):
    dt = Q.KV_QUANT_DTYPES[name][0]
    kp, vp = (torch.from_numpy(p.view(np.uint8).copy()).view(dt)
              for p in pools)
    return kp, vp, _t(scales[0].copy()), _t(scales[1].copy())


@pytest.mark.parametrize("name", QUANT)
@pytest.mark.parametrize("s_new,offs", [(1, (5, 0, 30)), (6, (0, 9, 26))])
def test_quant_paged_op_matches_jax_gather_path(name, s_new, offs):
    """Decode (the kernel's plain version) and a prefill chunk (gather,
    dequantize, cache attend) against the JAX op's gather path: pools and
    scales written identically, outputs within rtol = atol = 1e-5."""
    q, k, v, pools, scales, table, off, psz = _quant_case(
        s_new, s_new, offs, name)
    j_out, j_kp, j_vp, j_ks, j_vs = JIF.paged_masked_multihead_attention(
        Tensor(q), Tensor(k), Tensor(v), Tensor(pools[0]), Tensor(pools[1]),
        Tensor(table), Tensor(off), psz, k_scale=Tensor(scales[0]),
        v_scale=Tensor(scales[1]))
    kp, vp, ks, vs = _port_pools(pools, scales, name)
    out, kp2, vp2, ks2, vs2 = IF.paged_masked_multihead_attention(
        _t(q), _t(k), _t(v), kp, vp, _t(table), _t(off), psz, k_scale=ks,
        v_scale=vs)
    assert all(a is b for a, b in ((kp, kp2), (vp, vp2), (ks, ks2),
                                   (vs, vs2)))           # in place
    for got, want in ((kp, j_kp), (vp, j_vp)):
        np.testing.assert_array_equal(_bytes(got), _bytes(_np(want)))
    np.testing.assert_array_equal(ks.numpy(), _np(j_ks))
    np.testing.assert_array_equal(vs.numpy(), _np(j_vs))
    np.testing.assert_allclose(out.numpy(), _np(j_out), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("name", QUANT)
def test_quant_decode_matches_pallas_interpret(interpret, monkeypatch,
                                               name):
    """The decode read against the JAX op routed through its Pallas kernel
    in interpret mode (PADDLE_TPU_PAGED_PALLAS=1), 1e-5."""
    monkeypatch.setenv("PADDLE_TPU_PAGED_PALLAS", "1")
    q, k, v, pools, scales, table, off, psz = _quant_case(
        7, 1, (3, 17, 31), name)
    j_out = JIF.paged_masked_multihead_attention(
        Tensor(q), Tensor(k), Tensor(v), Tensor(pools[0]), Tensor(pools[1]),
        Tensor(table), Tensor(off), psz, k_scale=Tensor(scales[0]),
        v_scale=Tensor(scales[1]))[0]
    kp, vp, ks, vs = _port_pools(pools, scales, name)
    out = IF.paged_masked_multihead_attention(
        _t(q), _t(k), _t(v), kp, vp, _t(table), _t(off), psz, k_scale=ks,
        v_scale=vs)[0]
    np.testing.assert_allclose(out.numpy(), _np(j_out), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("name", QUANT)
def test_quant_decode_ref_matches_pallas_kernel(interpret, name):
    """`paged_decode_ref` with scales against the Pallas kernel called
    directly (GQA 4:1, a page edge, a bf16 query), 1e-5 in fp32 and one
    bf16 rounding (2^-8 relative) in bf16."""
    _, _, _, pools, scales, table, off, psz = _quant_case(
        9, 1, (0, 8, 23), name)
    q = np.random.default_rng(9).normal(size=(3, 8, 16)).astype(np.float32)
    for qdt, tol in ((jnp.float32, 1e-5), (jnp.bfloat16, 1e-2)):
        want = np.asarray(jax_paged_decode(
            jnp.asarray(q, qdt), jnp.asarray(pools[0]), jnp.asarray(pools[1]),
            jnp.asarray(table), jnp.asarray(off),
            k_scale=jnp.asarray(scales[0]),
            v_scale=jnp.asarray(scales[1])).astype(jnp.float32))
        kp, vp, ks, vs = _port_pools(pools, scales, name)
        tq = _t(q).to(torch.float32 if qdt == jnp.float32
                      else torch.bfloat16)
        got = pd.paged_decode_ref(tq, kp, vp, _t(table), _t(off),
                                  k_scale=ks, v_scale=vs)
        assert got.dtype == tq.dtype
        np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                                   atol=tol)


def test_quant_wrapper_takes_the_plain_version_on_cpu():
    kernels.reset_launch_counts()
    _, _, _, pools, scales, table, off, psz = _quant_case(
        2, 1, (1, 2, 3), "int8")
    q = torch.randn(3, 8, 16)
    kp, vp, ks, vs = _port_pools(pools, scales, "int8")
    out = pd.paged_decode_attention(q, kp, vp, _t(table), _t(off),
                                    k_scale=ks, v_scale=vs)
    torch.testing.assert_close(out, pd.paged_decode_ref(
        q, kp, vp, _t(table), _t(off), k_scale=ks, v_scale=vs))
    counts = kernels.launch_counts()
    assert {"paged_decode_int8", "paged_decode_fp8"} <= set(counts)
    assert all(n == 0 for n in counts.values()), counts


@pytest.mark.parametrize("name", QUANT)
def test_paged_cache_quant_pools(name):
    """Pools of the storage type, zero; scales float32 [P, page_size] of
    ones; a prefill view shares them; the quantized op writes them back
    in place."""
    cache = PagedKVCache(2, 2, 32, 2, 16, page_size=8, dtype=name,
                         device="cpu")
    lay = cache.layers[0]
    sd = Q.KV_QUANT_DTYPES[name][0]
    assert cache.quant_dtype == name
    assert lay["k_pool"].dtype == sd and lay["v_pool"].dtype == sd
    assert not Q.as_bytes(lay["k_pool"]).any()
    assert lay["k_scale"].shape == (1 + 2 * 4, 8)
    assert lay["k_scale"].dtype == torch.float32
    assert bool((lay["v_scale"] == 1).all())
    slot = cache.allocate(2)
    cache.ensure_capacity(slot, 7)
    views = cache.prefill_view([slot], [0])
    assert views[1]["k_scale"] is cache.layers[1]["k_scale"]
    x = torch.randn(2, 8, 2, 16)
    IF.paged_cache_attention(torch.randn(2, 8, 4, 16), x, x, views[0])
    cache.absorb_view(views)
    page = int(cache.table[slot, 0])
    assert bool((lay["k_scale"][page] != 1).all())
    assert PagedKVCache(1, 1, 16, 1, 8, device="cpu").quant_dtype is None


# ---------------------------------------------------------------- engine
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


def _jax_outputs(jm, cfg, prompts, max_new):
    prev = paddle.get_flags("FLAGS_compiled_tick")["FLAGS_compiled_tick"]
    paddle.set_flags({"FLAGS_compiled_tick": False})
    try:
        with JaxEngine(jm, cfg) as eng:
            return [f.result(timeout=300).output_ids
                    for f in [eng.submit(p, max_new_tokens=max_new)
                              for p in prompts]]
    finally:
        paddle.set_flags({"FLAGS_compiled_tick": prev})


@pytest.mark.parametrize("name", QUANT)
def test_quant_engine_matches_jax_engine(pair, name):
    """4 prompts (4..40 tokens, two sharing a 32-token prefix) through 2
    slots, 6 greedy tokens: output_ids equal the JAX engine's (its host
    lane), with a prefix hit on the quantized pool."""
    jm, tm = pair
    prompts = _prompts([4, 40, 9, 37])
    prompts[3][:32] = prompts[1][:32]
    want = _jax_outputs(jm, JaxServingConfig(num_slots=2, cache_dtype=name),
                        prompts, 6)
    with Engine(tm, ServingConfig(num_slots=2, cache_dtype=name)) as eng:
        got = [f.result(timeout=120).output_ids
               for f in [eng.submit(p, max_new_tokens=6) for p in prompts]]
        st = eng.stats()
        assert eng.cache.page_size == 32      # 2 x page_size
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    assert st["prefix_cache_hits"] >= 1
    assert st["tokens_generated"] == 24


def test_int8_engine_pages_halve_at_equal_load(pair):
    """At equal load the int8 pool's peak pages in use are half the float
    pool's (64 positions a request: 4 float pages, 2 int8 pages), as
    tests/test_speculative.py states for the JAX engine."""
    _, tm = pair
    prompts = _prompts([16, 16], seed=12)
    peaks = {}
    for dtype in ("float32", "int8", "fp8"):
        cfg = ServingConfig(num_slots=2, cache_dtype=dtype,
                            enable_prefix_cache=False)
        with Engine(tm, cfg) as eng:
            outs = [f.result(timeout=120)
                    for f in [eng.submit(p, max_new_tokens=48)
                              for p in prompts]]
            peaks[dtype] = eng.stats()["kv_pages_peak"]
        assert all(o.output_ids.size == 48 for o in outs)
    assert peaks["int8"] * 2 == peaks["float32"] == 8, peaks
    assert peaks["fp8"] == peaks["int8"]
