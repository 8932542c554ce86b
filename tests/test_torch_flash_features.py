"""The flash kernels' features (attention dropout, additive and boolean
masks, segment ids) in the port's plain versions against the JAX
package's Pallas kernels run in interpret mode, forward and backward, on
the same numpy inputs and the same seed; the dropout hash bit for bit;
and the public attention entry points (``scaled_dot_product_attention``,
``flash_attention(segment_ids=...)``,
``variable_length_memory_efficient_attention``) against the JAX
package's.  The CUDA kernels are held against these plain versions by
tests/test_torch_cuda.py on the card."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core.tensor import Tensor
from paddle_tpu.incubate.nn import functional as JIF
from paddle_tpu.nn import functional as JF
from paddle_tpu.pallas import flash_attention as jfa
from paddle_tpu_torch import kernels
from paddle_tpu_torch.incubate.nn import functional as IF
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.nn import functional as F

# fp32 on the CPU on both sides; the sums run in other orders (XLA's dot
# against torch's matmul), so values agree to a few fp32 ulps of the
# largest term: 1e-5 absolute and relative (the plain features' own
# tolerance; the keep-mask itself is compared bit for bit)
TOL = dict(rtol=1e-5, atol=1e-5)
B, H, H_KV, S, D = 2, 4, 2, 128, 32
BLOCK = 64                   # 2 x 2 Pallas tiles at S 128


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _inputs(seed, head_major):
    rng = np.random.default_rng(seed)

    def mk(heads):
        shape = (B, heads, S, D) if head_major else (B, S, heads, D)
        return rng.normal(size=shape).astype(np.float32)
    return mk(H), mk(H_KV), mk(H_KV), mk(H)


@pytest.mark.parametrize("seed", [0, 1234, 0xFFFFFFFF, 2654435761])
@pytest.mark.parametrize("q0,k0", [(0, 0), (3968, 4032), (4032, 64)])
def test_dropout_uniform_matches_pallas_hash(seed, q0, k0):
    """The plain hash equals ``_dropout_uniform`` bit for bit on 64 x 64
    positions, for heads b * H + h of a B 2, H 12 call (both batches), at
    small positions and near 4096."""
    qp = torch.arange(q0, q0 + 64)[:, None]
    kp = torch.arange(k0, k0 + 64)[None, :]
    for head in (0, 5, 11, 12, 23):
        want = np.asarray(jfa._dropout_uniform(
            jnp.uint32(seed), jnp.int32(head), q0, k0, 64, 64))
        got = fa.dropout_uniform(seed, head, qp, kp).numpy()
        np.testing.assert_array_equal(got, want)


def test_dropout_keep_share_and_head_algebra():
    """The keep-mask of a B 2, H 4 call: ~90% kept at p 0.1, each
    (batch, head) its own stream (no two equal), and the mask of batch 1
    head 2 is the hash at head 1 * 4 + 2 = 6."""
    keep = fa._keep(77, 0.1, 2, 4, 256, "cpu")
    assert abs(float(keep.float().mean()) - 0.9) < 0.005
    flat = keep.reshape(8, -1)
    assert all(not torch.equal(flat[i], flat[j])
               for i in range(8) for j in range(i))
    pos = torch.arange(256)
    u6 = fa.dropout_uniform(77, 6, pos[:, None], pos[None, :])
    assert torch.equal(keep[1, 2], u6 >= torch.tensor(0.1))


def _features(kind, rng):
    """(mask fp32 [.., S, S] or None, segment ids [B, S] int32 or None,
    dropout, the dead (batch, q row) or None) of a feature case."""
    mask = seg = dead = None
    dropout = 0.0
    if kind in ("bool", "all"):
        keep = np.ones((B, 1, S, S), bool)
        keep[:, :, :, S - 28:] = False             # key padding
        keep[1, 0, 5] = False                      # a fully masked q row
        dead = (1, 5)
        mask = np.where(keep, 0.0, fa.NEG_INF).astype(np.float32)
    if kind == "additive":
        mask = rng.normal(size=(1, H, S, S)).astype(np.float32)
    if kind in ("segments", "all"):
        seg = np.repeat(np.arange(4, dtype=np.int32), S // 4)[None]
        seg = np.repeat(seg, B, axis=0)
        seg[1, 40:] += 1                           # other borders in batch 1
    if kind in ("dropout", "all"):
        dropout = 0.1
    if kind == "all":
        mask = mask + rng.normal(size=(B, 1, S, S)).astype(np.float32)
    return mask, seg, dropout, dead


def _pallas(q, k, v, do, mask, seg, dropout, seed, causal, head_major):
    """(out, lse [B, H, S], (dq, dk, dv)) of the Pallas kernels in
    interpret mode: ``_pallas_flash_fwd`` and ``jax.vjp(_flash_core)``."""
    sc = 1.0 / math.sqrt(D)
    jm = None if mask is None else jnp.asarray(mask)
    jqs = jks = None
    if seg is not None:
        jqs, jks = jnp.asarray(seg)[:, :, None], jnp.asarray(seg)[:, None, :]
    jseed = jnp.full((1, 1), seed, jnp.uint32) if dropout else None
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    out, lse = jfa._pallas_flash_fwd(
        jq, jk, jv, jm, jqs, jks, jseed, causal=causal, scale=sc,
        block_q=BLOCK, block_k=BLOCK, dropout=dropout, head_major=head_major)

    def core(a, b_, c):
        return jfa._flash_core(a, b_, c, jm, jqs, jks, jseed, causal, sc,
                               dropout, BLOCK, BLOCK, BLOCK, BLOCK,
                               head_major)
    _, vjp = jax.vjp(core, jq, jk, jv)
    grads = vjp(jnp.asarray(do))
    return (np.asarray(out), np.asarray(lse)[..., 0],
            [np.asarray(g) for g in grads])


def _check_against_pallas(kind, causal, head_major, case_seed):
    q, k, v, do = _inputs(case_seed, head_major)
    mask, seg, dropout, dead = _features(
        kind, np.random.default_rng(case_seed + 100))
    seed = 987654 + case_seed
    j_out, j_lse, j_grads = _pallas(q, k, v, do, mask, seg, dropout, seed,
                                    causal, head_major)
    feats = dict(mask=None if mask is None else _t(mask),
                 segment_ids=None if seg is None else _t(seg),
                 dropout=dropout, seed=seed)
    out, lse = fa.flash_attention_ref(_t(q), _t(k), _t(v), causal, None,
                                      head_major, **feats)
    np.testing.assert_allclose(out.numpy(), j_out, **TOL)
    np.testing.assert_allclose(lse.numpy(), j_lse, **TOL)
    grads = fa.flash_attention_bwd_ref(_t(q), _t(k), _t(v), out, lse,
                                       _t(do), causal, None, head_major,
                                       **feats)
    for got, want in zip(grads, j_grads):
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the kernels' split of the backward, from the same delta
    delta = fa._delta(out, _t(do), head_major)
    dk, dv = fa.flash_bwd_dkv(_t(q), _t(k), _t(v), _t(do), lse, delta,
                              causal, None, head_major, **feats)
    dq = fa.flash_bwd_dq(_t(q), _t(k), _t(v), _t(do), lse, delta, causal,
                         None, head_major, **feats)
    for got, want in zip((dq, dk, dv), grads):
        assert torch.equal(got, want)
    if dead is not None:
        bi, row = dead
        for t in (out.numpy(), j_out, grads[0].numpy(), j_grads[0]):
            t_bh = t if head_major else t.transpose(0, 2, 1, 3)
            assert not t_bh[bi, :, row].any()
        assert lse[bi, 0, row] < -1e29 and j_lse[bi, 0, row] < -1e29


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("head_major", [True, False])
def test_flash_dropout_ref_matches_pallas(interpret, causal, head_major):
    """Dropout 0.1 at B2 H4 H_kv2 S128 D32 (GQA, 2 x 2 tiles): out, lse
    and dq/dk/dv against the Pallas kernels with the same [1, 1] seed."""
    _check_against_pallas("dropout", causal, head_major,
                          int(causal) + 2 * int(head_major))


@pytest.mark.parametrize("kind", ["additive", "bool", "segments", "all"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_masks_ref_matches_pallas(interpret, kind, causal):
    """An additive [1, H, S, S] mask, a boolean key-padding mask with a
    fully masked row ([B, 1, S, S], as 0 / NEG_INF), four segments a row,
    and all of them with dropout: out, lse and the gradients against the
    Pallas kernels; the dead row gives out 0, dq 0 and lse ~-1e30 on both
    sides."""
    _check_against_pallas(kind, causal, kind != "additive",
                          10 + int(causal) + 2 * len(kind))


def test_flash_op_seeds_from_its_generator():
    """The public op draws one seed per call from the CPU generator it is
    given (equal generators, equal outputs) and never from torch's global
    RNG; the backward reuses the forward's seed (its gradients are those
    of the plain backward at that seed)."""
    q, k, v, do = (_t(a) for a in _inputs(3, True))
    outs = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(11)
        torch.manual_seed(len(outs))          # the global RNG moves on
        outs.append(fa.flash_attention(q, k, v, dropout=0.1, causal=True,
                                       head_major=True, generator=gen))
    assert torch.equal(*outs)
    seed = fa.draw_seed(torch.Generator().manual_seed(11))
    out, lse = fa.flash_attention_ref(q, k, v, True, None, True,
                                      dropout=0.1, seed=seed)
    assert torch.equal(outs[0], out)
    qa, ka, va = (t.clone().requires_grad_(True) for t in (q, k, v))
    fa.flash_attention(qa, ka, va, dropout=0.1, causal=True, head_major=True,
                       generator=torch.Generator().manual_seed(11)
                       ).backward(do)
    want = fa.flash_attention_bwd_ref(q, k, v, out, lse, do, True, None,
                                      True, dropout=0.1, seed=seed)
    for got, w in zip((qa.grad, ka.grad, va.grad), want):
        torch.testing.assert_close(got, w, **TOL)


def test_feature_plain_backward_matches_autograd():
    """The hand-written backward with every feature equals autograd
    through the plain forward (no gradient reaches the mask)."""
    q, k, v, do = (_t(a) for a in _inputs(4, False))
    mask, seg, p, _ = _features("all", np.random.default_rng(5))
    feats = dict(mask=_t(mask), segment_ids=_t(seg), dropout=p, seed=99)
    qa, ka, va = (t.clone().requires_grad_(True) for t in (q, k, v))
    out, lse = fa.flash_attention_ref(qa, ka, va, True, None, False, **feats)
    out.backward(do)
    grads = fa.flash_attention_bwd_ref(q, k, v, out.detach(), lse.detach(),
                                       do, True, None, False, **feats)
    for got, want in zip(grads, (qa.grad, ka.grad, va.grad)):
        torch.testing.assert_close(got, want, **TOL)


def test_cpu_route_counts_no_variant_launch():
    kernels.reset_launch_counts()
    q, k, v, do = (_t(a) for a in _inputs(6, True))
    mask, seg, p, _ = _features("all", np.random.default_rng(6))
    feats = dict(mask=_t(mask), segment_ids=_t(seg), dropout=p, seed=1)
    out, lse = fa.flash_attention_fwd(q, k, v, True, None, True, **feats)
    fa.flash_attention_bwd(q, k, v, out, lse, do, True, None, True, **feats)
    counts = kernels.launch_counts()
    # every wrapper's count, the flash backward's delta pass among them
    assert set(fa.VARIANT_LAUNCHES) <= set(counts) and len(counts) == 18
    assert all(n == 0 for n in counts.values()), counts


# ------------------------------------------------- public entry points
def _bshd(seed, s=S):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, s, H, D)).astype(np.float32)
            for _ in range(3)]


def _padding_mask(s=S):
    keep = np.ones((B, 1, s, s), bool)
    keep[0, :, :, s - 30:] = False
    keep[1, 0, 9] = False
    return keep


def test_sdpa_matches_jax(interpret, monkeypatch):
    """``scaled_dot_product_attention`` with a boolean padding mask,
    causal, dropout 0.1: the JAX op (its Pallas kernels in interpret mode,
    the dropout key fixed) against the port's (the seed those key's bits
    give)."""
    q, k, v = _bshd(21)
    keep = _padding_mask()
    key = jax.random.PRNGKey(5)
    monkeypatch.setattr(jfa._state, "next_rng_key", lambda: key)
    seed = int(np.asarray(jax.random.bits(key, (1, 1), jnp.uint32))[0, 0])
    monkeypatch.setattr(fa, "draw_seed", lambda generator=None: seed)
    want = JF.scaled_dot_product_attention(
        Tensor(q), Tensor(k), Tensor(v), attn_mask=Tensor(keep),
        dropout_p=0.1, is_causal=True)
    got = F.scaled_dot_product_attention(
        _t(q), _t(k), _t(v), attn_mask=_t(keep), dropout_p=0.1,
        is_causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want._data_), **TOL)
    assert not got[1, 9].any()
    eval_out = F.scaled_dot_product_attention(
        _t(q), _t(k), _t(v), attn_mask=_t(keep), is_causal=True,
        training=False)
    assert not torch.equal(eval_out, got)


def test_segment_ids_op_matches_jax(interpret):
    """``flash_attention(segment_ids=...)``: three packed documents a row,
    non-causal and causal, forward and gradients against the JAX op."""
    q, k, v = _bshd(22)
    seg = np.zeros((B, S), np.int32)
    seg[:, 50:] = 1
    seg[:, 100:] = 2
    seg[1, 20:] += 3
    g = np.random.default_rng(23).normal(size=q.shape).astype(np.float32)
    for causal in (False, True):
        jq, jk, jv = (Tensor(a, stop_gradient=False) for a in (q, k, v))
        j_out = jfa.flash_attention(jq, jk, jv, causal=causal,
                                    segment_ids=Tensor(seg))
        (j_out * Tensor(g)).sum().backward()
        tq, tk, tv = (_t(a).requires_grad_(True) for a in (q, k, v))
        out = fa.flash_attention(tq, tk, tv, causal=causal,
                                 segment_ids=_t(seg))
        (out * _t(g)).sum().backward()
        np.testing.assert_allclose(out.detach().numpy(),
                                   np.asarray(j_out._data_), **TOL)
        for t, j in ((tq, jq), (tk, jk), (tv, jv)):
            np.testing.assert_allclose(t.grad.numpy(),
                                       np.asarray(j.grad._data_), **TOL)


def test_varlen_attention_matches_jax(interpret):
    """``variable_length_memory_efficient_attention`` with an additive
    [B, 1, S, S] length mask (the second row 96 tokens long) against the
    JAX op; its lengths arguments are not read on either side."""
    q, k, v = _bshd(24)
    lens = np.array([S, 96])
    mask = np.where(np.arange(S)[None, None, None, :]
                    < lens[:, None, None, None], 0.0, -1e4)
    mask = np.broadcast_to(mask, (B, 1, S, S)).astype(np.float32)
    want = JIF.variable_length_memory_efficient_attention(
        Tensor(q), Tensor(k), Tensor(v), seq_lens=Tensor(lens),
        kv_seq_lens=Tensor(lens), mask=Tensor(mask))
    got = IF.variable_length_memory_efficient_attention(
        _t(q), _t(k), _t(v), seq_lens=_t(lens), kv_seq_lens=_t(lens),
        mask=_t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want._data_), **TOL)


def test_masks_of_other_dtypes_become_fp32():
    """A boolean mask becomes 0 / NEG_INF and a bf16 bias is cast to fp32,
    in their own shapes (no expansion); the op's result under the bf16
    bias equals the plain version's under its fp32 cast."""
    keep = torch.from_numpy(_padding_mask())
    m = fa.additive_mask(keep)
    assert m.dtype == torch.float32 and m.shape == keep.shape
    assert torch.equal(m == 0, keep) and bool(m.min() == fa.NEG_INF)
    bias = torch.randn(1, 1, S, S).bfloat16()
    assert torch.equal(fa.additive_mask(bias), bias.float())
    q, k, v = (_t(a) for a in _bshd(25))
    got = fa.flash_attention(q, k, v, attn_mask=bias, causal=True)
    want, _ = fa.flash_attention_ref(q, k, v, True, mask=bias.float())
    assert torch.equal(got, want)
