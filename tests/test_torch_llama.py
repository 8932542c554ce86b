"""The port's Llama cache path against the JAX package: rope, the paged
attention op (decode and prefill chunk) and one prefill-chunk + decode
call of the whole model, with the same weights (paddle_tpu_torch.convert)."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.incubate.nn import functional as JIF
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_config as jax_llama_config
from paddle_tpu.serving.paged_kv import PagedKVCache as JaxPagedKVCache
from paddle_tpu_torch import convert
from paddle_tpu_torch.incubate.nn import functional as IF
from paddle_tpu_torch.models import LlamaForCausalLM, llama_config
from paddle_tpu_torch.serving import PagedKVCache


def _np(t):
    return np.asarray(t._data_)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def pair():
    """The tiny Llama in both packages with the same weights."""
    paddle.seed(5)
    jm = JaxLlama(jax_llama_config("tiny", max_seq_len=64))
    jm.eval()
    state = {k: v.numpy() for k, v in jm.state_dict().items()}
    tm = LlamaForCausalLM(llama_config("tiny", max_seq_len=64),
                          device="cpu")
    convert.load_paddle_tpu_state(tm, state)
    return jm, tm


@pytest.mark.parametrize("per_row", [True, False])
def test_rope_matches_jax(per_row):
    rng = np.random.default_rng(1)
    q = rng.normal(size=(2, 5, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, 5, 2, 16)).astype(np.float32)
    pos = (np.array([[3], [40]], np.int32) + np.arange(5, dtype=np.int32)
           if per_row else np.arange(7, 12, dtype=np.int32))
    jq, jk, _ = JIF.fused_rotary_position_embedding(
        Tensor(q), Tensor(k), position_ids=Tensor(pos))
    tq, tk, tv = IF.fused_rotary_position_embedding(
        _t(q), _t(k), position_ids=_t(pos))
    assert tv is None
    np.testing.assert_allclose(tq.numpy(), _np(jq), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tk.numpy(), _np(jk), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("s_new,offs", [(1, (5, 0, 30)), (6, (0, 9, 26))])
def test_paged_attention_matches_jax(s_new, offs):
    """Decode (the kernel's plain version) and a prefill chunk (gather +
    cache attend) against the JAX op on the same pools and table."""
    rng = np.random.default_rng(s_new)
    B, H, Hkv, D, psz, N = 3, 8, 2, 16, 8, 4
    P = 1 + B * N
    k_pool = rng.normal(size=(P, psz, Hkv, D)).astype(np.float32)
    v_pool = rng.normal(size=(P, psz, Hkv, D)).astype(np.float32)
    q = rng.normal(size=(B, s_new, H, D)).astype(np.float32)
    k = rng.normal(size=(B, s_new, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, s_new, Hkv, D)).astype(np.float32)
    table = rng.permutation(np.arange(1, P)).reshape(B, N).astype(np.int32)
    off = np.asarray(offs, np.int32)
    j_out, j_kp, j_vp = JIF.paged_masked_multihead_attention(
        Tensor(q), Tensor(k), Tensor(v), Tensor(k_pool), Tensor(v_pool),
        Tensor(table), Tensor(off), psz)
    kp, vp = _t(k_pool.copy()), _t(v_pool.copy())
    out, kp2, vp2 = IF.paged_masked_multihead_attention(
        _t(q), _t(k), _t(v), kp, vp, _t(table), _t(off), psz)
    assert kp2 is kp and vp2 is vp          # updated in place
    np.testing.assert_array_equal(kp.numpy(), _np(j_kp))
    np.testing.assert_array_equal(vp.numpy(), _np(j_vp))
    np.testing.assert_allclose(out.numpy(), _np(j_out), rtol=1e-5,
                               atol=1e-5)


def test_paged_attention_overflow_raises():
    pools = torch.zeros(3, 4, 1, 8)
    with pytest.raises(ValueError, match="overflow"):
        IF.paged_masked_multihead_attention(
            torch.zeros(1, 2, 1, 8), torch.zeros(1, 2, 1, 8),
            torch.zeros(1, 2, 1, 8), pools, pools.clone(),
            torch.tensor([[1, 2]], dtype=torch.int32),
            torch.tensor([7], dtype=torch.int32), 4)


def test_llama_cache_path_matches_jax(pair):
    """One [2, 8] prefill chunk and one decode step through each
    package's PagedKVCache: logits within 1e-4."""
    jm, tm = pair
    rng = np.random.default_rng(3)
    prompts = rng.integers(0, 512, (2, 8)).astype(np.int32)
    caches = [JaxPagedKVCache(2, 2, 64, 2, 32, page_size=8),
              PagedKVCache(2, 2, 64, 2, 32, page_size=8)]
    for c in caches:
        slots = [c.allocate(8), c.allocate(8)]
        for s in slots:
            c.ensure_capacity(s, 8)
    views = caches[0].prefill_view([0, 1], [0, 0])
    j_logits = jm(Tensor(prompts), caches=views)
    caches[0].absorb_view(views)
    views = caches[1].prefill_view([0, 1], [0, 0])
    with torch.no_grad():
        t_logits = tm(_t(prompts), caches=views)
    caches[1].absorb_view(views)
    np.testing.assert_allclose(t_logits.numpy(), _np(j_logits),
                               rtol=1e-4, atol=1e-4)
    nxt = np.argmax(_np(j_logits)[:, -1], axis=-1).astype(np.int32)[:, None]
    for c in caches:
        c.set_offset(0, 8)
        c.set_offset(1, 8)
    j_logits = jm(Tensor(nxt), caches=caches[0].layer_caches())
    with torch.no_grad():
        t_logits = tm(_t(nxt), caches=caches[1].layer_caches())
    np.testing.assert_allclose(t_logits.numpy(), _np(j_logits),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(caches[1].layers[1]["k_pool"].numpy(),
                               _np(caches[0].layers[1]["k_pool"]),
                               rtol=1e-5, atol=1e-5)


def test_llama_without_cache_raises(pair):
    _, tm = pair
    with pytest.raises(NotImplementedError, match="flash attention"):
        tm(torch.zeros(1, 4, dtype=torch.int32))


def test_convert_raises_on_key_and_shape_mismatch(pair):
    jm, tm = pair
    state = {k: v.numpy() for k, v in jm.state_dict().items()}
    missing = dict(state)
    missing.pop("lm_head.weight")
    with pytest.raises(KeyError, match="missing.*lm_head.weight"):
        convert.load_paddle_tpu_state(tm, missing)
    extra = dict(state, **{"llama.extra.weight": np.zeros(3, np.float32)})
    with pytest.raises(KeyError, match="unexpected.*llama.extra.weight"):
        convert.load_paddle_tpu_state(tm, extra)
    bad = dict(state)
    bad["llama.norm.weight"] = np.zeros(7, np.float32)
    with pytest.raises(ValueError, match="llama.norm.weight"):
        convert.load_paddle_tpu_state(tm, bad)


def test_state_dict_layout_is_paddles(pair):
    """Linear weights stay [in, out] and names cross unchanged."""
    jm, tm = pair
    own = tm.state_dict()
    assert set(own) == set(jm.state_dict())
    assert tuple(own["llama.layers.0.self_attn.k_proj.weight"].shape) == \
        (128, 64)
    sd = convert.state_dict_from_paddle_tpu(
        {"w": np.ones((2, 3), np.float32)}, device="cpu",
        dtype="bfloat16")
    assert sd["w"].dtype == torch.bfloat16 and sd["w"].shape == (2, 3)
