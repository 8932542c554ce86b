"""The port's kernels (paddle_tpu_torch/kernels/): each plain PyTorch
version against the JAX package's Pallas kernel in interpret mode, and
the CPU route of the wrappers.  The CUDA kernels themselves are held
against their plain versions by tests/test_torch_cuda.py on the card."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from paddle_tpu.pallas import fused as pf
from paddle_tpu.pallas.flash_attention import paged_decode_attention as \
    jax_paged_decode
from paddle_tpu_torch import kernels
from paddle_tpu_torch.kernels import paged_decode as pd
from paddle_tpu_torch.kernels import rms_norm as rn
from test_torch_cuda import paged_inputs as _paged_inputs


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")


@pytest.mark.parametrize("rows,n", [(8, 128), (32, 256)])
def test_rms_norm_ref_matches_pallas(interpret, rows, n):
    rng = np.random.default_rng(rows + n)
    x = rng.normal(size=(rows, n)).astype(np.float32) * 3.0
    w = rng.normal(size=(n,)).astype(np.float32)
    y_jax, (_, r_jax, _) = pf._rms_fwd_core(jnp.asarray(x), jnp.asarray(w),
                                            1e-5)
    y, r = rn.rms_norm_ref(torch.from_numpy(x), torch.from_numpy(w), 1e-5,
                           return_rstd=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_jax),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(r.numpy(), np.asarray(r_jax)[:, 0],
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("geometry", [
    dict(),                                         # GQA, n_rep 4
    dict(H=4, Hkv=4, off=(0, 8, 31)),               # MHA, offset 0, page edges
])
def test_paged_decode_ref_matches_pallas(interpret, geometry):
    q, k_pool, v_pool, pt, off = _paged_inputs(**geometry)
    ref = np.asarray(jax_paged_decode(
        jnp.asarray(q), jnp.asarray(k_pool), jnp.asarray(v_pool),
        jnp.asarray(pt), jnp.asarray(off)))
    out = pd.paged_decode_ref(*(torch.from_numpy(a) for a in
                                (q, k_pool, v_pool, pt, off)))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_paged_decode_ref_free_row_is_finite():
    """A free slot (table all 0, offset 0) reads scratch page 0."""
    q, k_pool, v_pool, pt, off = _paged_inputs()
    pt[1] = 0
    off[1] = 0
    out = pd.paged_decode_ref(*(torch.from_numpy(a) for a in
                                (q, k_pool, v_pool, pt, off)))
    assert torch.isfinite(out).all()
    # one live position: the output is that position's V
    want = torch.from_numpy(v_pool[0, 0]).repeat_interleave(4, dim=0)
    torch.testing.assert_close(out[1], want, rtol=1e-6, atol=1e-6)


def test_cpu_tensors_take_the_plain_versions():
    kernels.reset_launch_counts()
    q, k_pool, v_pool, pt, off = (torch.from_numpy(a)
                                  for a in _paged_inputs())
    out = pd.paged_decode_attention(q, k_pool, v_pool, pt, off)
    torch.testing.assert_close(out, pd.paged_decode_ref(q, k_pool, v_pool,
                                                        pt, off))
    x = torch.randn(4, 64, dtype=torch.bfloat16)
    w = torch.randn(64, dtype=torch.bfloat16)
    torch.testing.assert_close(rn.rms_norm(x, w, 1e-6),
                               rn.rms_norm_ref(x, w, 1e-6))
    assert kernels.launch_counts() == {"rms_norm": 0, "paged_decode": 0}


def test_rms_norm_ref_rounds_once_in_bf16():
    """bf16: x*r*w in fp32, one rounding (the TPU kernel's op order)."""
    x = torch.randn(3, 32).to(torch.bfloat16)
    w = (torch.rand(32) + 0.5).to(torch.bfloat16)
    xf = x.float()
    r = torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + 1e-6)
    want = (xf * r * w.float()).to(torch.bfloat16)
    assert torch.equal(rn.rms_norm_ref(x, w, 1e-6), want)


def test_wrappers_refuse_other_devices():
    meta = torch.empty(2, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        rn.rms_norm(meta, torch.empty(8, device="meta"), 1e-6)
    with pytest.raises(ValueError, match="unsupported device"):
        pd.paged_decode_attention(torch.empty(1, 2, 8, device="meta"),
                                  None, None, None, None)
