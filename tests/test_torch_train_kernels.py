"""The training path's kernels (paddle_tpu_torch/kernels/): each plain
PyTorch version against the JAX package's Pallas kernel run in interpret
mode, forward and backward, on the same numpy inputs; and the CPU route of
the wrappers.  The CUDA kernels are held against these plain versions by
tests/test_torch_cuda.py on the card."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.pallas import flash_attention as jfa
from paddle_tpu.pallas import fused as pf
from paddle_tpu_torch import kernels
from paddle_tpu_torch.kernels import adam
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.kernels import rms_norm as rn
from paddle_tpu_torch.kernels import rope as rp
from paddle_tpu_torch.nn import functional as F

# fp32 on the CPU on both sides; the sums run in other orders (XLA's dot
# against torch's matmul), so values agree to a few fp32 ulps of the
# largest term: 1e-5 absolute and relative.
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _attn_inputs(seed, head_major, b=2, h=4, h_kv=2, s=128, d=32):
    rng = np.random.default_rng(seed)

    def mk(heads):
        shape = (b, heads, s, d) if head_major else (b, s, heads, d)
        return rng.normal(size=shape).astype(np.float32)
    return mk(h), mk(h_kv), mk(h_kv), mk(h)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("head_major", [True, False])
def test_flash_ref_matches_pallas(interpret, causal, head_major):
    """out, lse and dq/dk/dv at B2 H4 H_kv2 S128 D32 (GQA) against
    ``_pallas_flash_fwd`` and ``jax.vjp`` of ``_flash_core``."""
    q, k, v, do = _attn_inputs(int(causal) + 2 * int(head_major), head_major)
    sc = 1.0 / math.sqrt(q.shape[-1])
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    j_out, j_lse = jfa._pallas_flash_fwd(
        jq, jk, jv, causal=causal, scale=sc, block_q=128, block_k=128,
        head_major=head_major)

    def core(a, b_, c):
        return jfa._flash_core(a, b_, c, None, None, None, None, causal, sc,
                               0.0, 128, 128, 128, 128, head_major)
    _, vjp = jax.vjp(core, jq, jk, jv)
    j_grads = vjp(jnp.asarray(do))

    out, lse = fa.flash_attention_ref(_t(q), _t(k), _t(v), causal, None,
                                      head_major)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse)[..., 0], **TOL)
    grads = fa.flash_attention_bwd_ref(_t(q), _t(k), _t(v), out, lse, _t(do),
                                       causal, None, head_major)
    for got, want in zip(grads, j_grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_flash_bwd_kernel_refs_split_the_backward():
    """The dK/dV and dQ kernels' plain versions (and their wrappers' CPU
    route) give the whole plain backward's tensors from the same delta."""
    q, k, v, do = (_t(a) for a in _attn_inputs(4, False, s=48))
    out, lse = fa.flash_attention_ref(q, k, v, True)
    dq, dk, dv = fa.flash_attention_bwd_ref(q, k, v, out, lse, do, True)
    delta = (do * out).sum(-1).transpose(1, 2).contiguous()
    for fn in (fa.flash_bwd_dkv_ref, fa.flash_bwd_dkv):
        got_k, got_v = fn(q, k, v, do, lse, delta, True, None, False)
        assert torch.equal(got_k, dk) and torch.equal(got_v, dv)
    for fn in (fa.flash_bwd_dq_ref, fa.flash_bwd_dq):
        assert torch.equal(fn(q, k, v, do, lse, delta, True, None, False), dq)


def test_flash_bwd_ref_matches_autograd():
    """The hand-written backward equals autograd through the forward."""
    q, k, v, do = (_t(a) for a in _attn_inputs(7, True, s=40))
    qa, ka, va = (t.clone().requires_grad_(True) for t in (q, k, v))
    out, lse = fa.flash_attention_ref(qa, ka, va, True, None, True)
    out.backward(do)
    grads = fa.flash_attention_bwd_ref(q, k, v, out.detach(), lse.detach(),
                                       do, True, None, True)
    for got, want in zip(grads, (qa.grad, ka.grad, va.grad)):
        torch.testing.assert_close(got, want, **TOL)


def test_flash_op_differentiates_on_cpu():
    """The public op under autograd (CPU: the plain versions) gives the
    plain backward's gradients."""
    q, k, v, do = (_t(a) for a in _attn_inputs(8, False, s=33))
    qa, ka, va = (t.clone().requires_grad_(True) for t in (q, k, v))
    fa.flash_attention(qa, ka, va, causal=True).backward(do)
    out, lse = fa.flash_attention_ref(q, k, v, True)
    grads = fa.flash_attention_bwd_ref(q, k, v, out, lse, do, True)
    for got, want in zip((qa.grad, ka.grad, va.grad), grads):
        torch.testing.assert_close(got, want, **TOL)


def test_flash_op_refuses_unported_features():
    """The kernels, like the Pallas ones, give no mask gradient: a mask
    that requires grad takes the plain version under autograd (the JAX
    op's XLA route), counted in ``plain_routes``, on the CPU as on the
    card, and the mask gets its gradient; a mask that does not is taken
    by the kernels' route.  Dropout outside training is no dropout, as in
    the JAX op."""
    q, k, v, _ = (_t(a) for a in _attn_inputs(12, False, s=8))
    mask = torch.zeros(1, 1, 8, 8, requires_grad=True)
    routes = fa.flash_attention.plain_routes
    out = fa.flash_attention(q, k, v, attn_mask=mask)
    assert fa.flash_attention.plain_routes == routes + 1
    assert torch.equal(out, fa.flash_attention_ref(q, k, v, mask=mask)[0])
    out.square().sum().backward()
    assert mask.grad is not None and mask.grad.abs().sum() > 0
    assert torch.equal(fa.flash_attention(q, k, v, attn_mask=mask.detach()),
                       fa.flash_attention(q, k, v))
    assert torch.equal(fa.flash_attention(q, k, v, dropout=0.1,
                                          training=False),
                       fa.flash_attention(q, k, v))
    assert not torch.equal(fa.flash_attention(q, k, v, dropout=0.5),
                           fa.flash_attention(q, k, v))


@pytest.mark.parametrize("rows,n", [(8, 128), (32, 256)])
def test_rms_bwd_ref_matches_pallas(interpret, rows, n):
    """dx and dw against ``jax.vjp(rms_norm_pallas)`` (the Pallas
    backward kernel in interpret mode)."""
    rng = np.random.default_rng(rows + n)
    x = rng.normal(size=(rows, n)).astype(np.float32) * 2.0
    w = rng.normal(size=(n,)).astype(np.float32)
    g = rng.normal(size=(rows, n)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b: pf.rms_norm_pallas(a, b, 1e-5),
                     jnp.asarray(x), jnp.asarray(w))
    j_dx, j_dw = vjp(jnp.asarray(g))
    _, r = rn.rms_norm(_t(x), _t(w), 1e-5, return_rstd=True)
    dx, dw = rn.rms_norm_bwd(_t(x), _t(w), r, _t(g))
    np.testing.assert_allclose(dx.numpy(), np.asarray(j_dx), **TOL)
    # dw sums 8..32 rows of O(1) terms
    np.testing.assert_allclose(dw.numpy(), np.asarray(j_dw), rtol=1e-5,
                               atol=5e-5)


def test_rms_norm_function_matches_autograd():
    """`RMSNormFunction` (routed by nn.functional.rms_norm under grad) has
    the gradients of autograd through the plain forward."""
    x = torch.randn(5, 3, 64, dtype=torch.float64).float()
    w = 1 + 0.1 * torch.randn(64)
    g = torch.randn(5, 3, 64)
    xa, wa = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    y = F.rms_norm(xa, wa, 1e-6)
    assert y.grad_fn is not None and "RMSNormFunction" in y.grad_fn.name()
    y.backward(g)
    xb, wb = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    rn.rms_norm_ref(xb, wb, 1e-6).backward(g)
    torch.testing.assert_close(xa.grad, xb.grad, **TOL)
    torch.testing.assert_close(wa.grad, wb.grad, **TOL)
    with torch.no_grad():            # serving: the forward alone
        assert F.rms_norm(xa, wa, 1e-6).grad_fn is None


@pytest.mark.parametrize("neox", [True, False])
def test_rope_ref_matches_pallas(interpret, neox):
    """Forward and backward against ``rope_pallas`` and its VJP."""
    rng = np.random.default_rng(int(neox))
    t = rng.normal(size=(2, 16, 3, 32)).astype(np.float32)
    g = rng.normal(size=t.shape).astype(np.float32)
    ang = rng.uniform(0, 6.28, size=(16, 32)).astype(np.float32)
    cos, sin = np.cos(ang), np.sin(ang)
    jc, js = jnp.asarray(cos), jnp.asarray(sin)
    j_out, vjp = jax.vjp(lambda a: pf.rope_pallas(a, jc, js, neox),
                         jnp.asarray(t))
    (j_dt,) = vjp(jnp.asarray(g))
    out = rp.rope(_t(t), _t(cos), _t(sin), neox)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), **TOL)
    ta = _t(t).requires_grad_(True)
    rp.RopeFunction.apply(ta, _t(cos), _t(sin), neox).backward(_t(g))
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(j_dt), **TOL)
    np.testing.assert_allclose(
        rp.rope(_t(g), _t(cos), _t(sin), neox, inverse=True).numpy(),
        np.asarray(j_dt), **TOL)


@pytest.mark.parametrize("decoupled,wd", [(True, 0.01), (False, 0.1),
                                          (True, 0.0)])
def test_adam_ref_matches_pallas(interpret, decoupled, wd):
    """One update of an fp32 parameter against ``adam_update_pallas`` in
    interpret mode (AdamW, L2-coupled Adam, no decay).  The plain version
    rounds every op on its own, so it equals numpy doing the same ops one
    by one, bit for bit; XLA on the CPU contracts ``b*m + (1-b)*g`` into a
    fused multiply-add, which moves the moments' last bit: against the
    Pallas kernel, 2e-7 relative and 1e-8 absolute (an fp32 ulp of the
    O(0.1) terms)."""
    rng = np.random.default_rng(int(decoupled) + int(wd * 100))
    w, g = (rng.normal(size=(64, 48)).astype(np.float32) for _ in range(2))
    m1 = rng.normal(size=(64, 48)).astype(np.float32) * 1e-2
    m2 = np.abs(rng.normal(size=(64, 48))).astype(np.float32) * 1e-4
    lr, b1, b2, eps = 3e-4, 0.9, 0.999, 1e-8
    bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(3))
    bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(3))
    j_w, j_m1, j_m2 = pf.adam_update_pallas(
        jnp.asarray(w), jnp.asarray(g), jnp.asarray(m1), jnp.asarray(m2),
        jnp.float32(lr), jnp.float32(bc1), jnp.float32(bc2), b1=b1, b2=b2,
        eps=eps, wd=wd, decoupled=decoupled)
    tw, tm1, tm2 = _t(w.copy()), _t(m1.copy()), _t(m2.copy())
    scal = torch.tensor([lr, bc1, bc2, 1.0], dtype=torch.float32)
    adam.adam_update(tw, _t(g), tm1, tm2, None, scal, b1=b1, b2=b2,
                     eps=eps, wd=wd, decoupled=decoupled)
    f = np.float32
    gg = g + f(wd) * w if wd and not decoupled else g
    n_m1 = f(b1) * m1 + f(1 - b1) * gg
    n_m2 = f(b2) * m2 + f(1 - b2) * (gg * gg)
    upd = (n_m1 / f(bc1)) / (np.sqrt(n_m2 / f(bc2)) + f(eps))
    if wd and decoupled:
        upd = upd + f(wd) * w
    n_w = w - f(lr) * upd
    for got, want, seq in ((tw, j_w, n_w), (tm1, j_m1, n_m1),
                           (tm2, j_m2, n_m2)):
        np.testing.assert_array_equal(got.numpy(), seq)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-7,
                                   atol=1e-8)


def test_adam_ref_writes_the_rounded_parameter():
    """With a bf16 parameter beside its fp32 master, the parameter gets the
    new master rounded once; the master, m1 and m2 are those of the fp32
    update."""
    rng = np.random.default_rng(11)
    w, g = (rng.normal(size=(5, 7)).astype(np.float32) for _ in range(2))
    args = dict(scal=torch.tensor([1e-3, 0.1, 0.001, 1.0]), b1=0.9, b2=0.999,
                eps=1e-8, wd=0.01, decoupled=True)
    w32, m1, m2 = _t(w.copy()), torch.zeros(5, 7), torch.zeros(5, 7)
    adam.adam_update_ref(w32, _t(g).bfloat16().float(), m1, m2, None,
                         **args)
    mw, n1, n2 = _t(w.copy()), torch.zeros(5, 7), torch.zeros(5, 7)
    p = torch.empty(5, 7, dtype=torch.bfloat16)
    adam.adam_update(mw, _t(g).bfloat16(), n1, n2, p, **args)
    assert torch.equal(mw, w32) and torch.equal(n1, m1) and \
        torch.equal(n2, m2)
    assert torch.equal(p, w32.bfloat16())


def test_cpu_route_leaves_every_launch_count_at_zero():
    kernels.reset_launch_counts()
    q, k, v, do = (_t(a) for a in _attn_inputs(3, True, s=16))
    out, lse = fa.flash_attention_fwd(q, k, v, True, None, True)
    fa.flash_attention_bwd(q, k, v, out, lse, do, True, None, True)
    x = torch.randn(4, 64)
    _, r = rn.rms_norm(x, torch.ones(64), 1e-6, return_rstd=True)
    rn.rms_norm_bwd(x, torch.ones(64), r, x)
    rp.rope(torch.randn(1, 4, 2, 8), torch.ones(4, 8), torch.zeros(4, 8))
    w = torch.randn(3, 5)
    adam.adam_update(w, torch.randn(3, 5), torch.zeros(3, 5),
                     torch.zeros(3, 5), None,
                     torch.tensor([1e-3, 0.1, 0.001, 1.0]),
                     b1=0.9, b2=0.999, eps=1e-8, wd=0.01, decoupled=True)
    counts = kernels.launch_counts()
    assert {"flash_fwd", "flash_bwd_dkv", "flash_bwd_dq", "rms_norm_bwd",
            "rope", "adam"} <= set(counts)
    assert all(n == 0 for n in counts.values()), counts
