"""The port's CUDA kernels against their plain PyTorch versions on an
NVIDIA card.  This file imports neither JAX nor the JAX package, so it
also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Without a card every test skips."""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import paged_decode as pd
from paddle_tpu_torch.kernels import rms_norm as rn


def paged_inputs(seed=0, B=3, H=8, Hkv=2, D=16, psz=8, N=4,
                 off=(5, 17, 30)):
    """The inputs of tests/test_paged_kv.py's paged kernel test."""
    rng = np.random.default_rng(seed)
    P = 1 + B * N
    k_pool = rng.normal(size=(P, psz, Hkv, D)).astype(np.float32)
    v_pool = rng.normal(size=(P, psz, Hkv, D)).astype(np.float32)
    q = rng.normal(size=(B, H, D)).astype(np.float32)
    pt = rng.permutation(np.arange(1, P)).reshape(B, N).astype(np.int32)
    return q, k_pool, v_pool, pt, np.asarray(off, np.int32)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rms_norm_kernel_on_card(card, dtype):
    g = torch.Generator(device=card).manual_seed(0)
    for rows, n in [(4, 4096), (128, 4096), (3, 100)]:
        x = torch.randn(rows, n, device=card, generator=g).to(dtype)
        w = torch.randn(n, device=card, generator=g).to(dtype)
        y, r = rn.rms_norm(x, w, 1e-5, return_rstd=True)
        y_ref, r_ref = rn.rms_norm_ref(x, w, 1e-5, return_rstd=True)
        tol = 2e-5 if dtype == torch.float32 else 2e-2
        torch.testing.assert_close(y.float(), y_ref.float(), rtol=tol,
                                   atol=tol)
        torch.testing.assert_close(r, r_ref, rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_decode_kernel_on_card(card, dtype):
    for geometry in (dict(), dict(H=4, Hkv=4, off=(0, 8, 31)),
                     dict(H=8, Hkv=1, D=128, psz=16, N=3,
                          off=(47, 0, 16))):
        q, k_pool, v_pool, pt, off = (
            torch.from_numpy(a).to(card) for a in paged_inputs(**geometry))
        q, k_pool, v_pool = (t.to(dtype) for t in (q, k_pool, v_pool))
        out = pd.paged_decode_attention(q, k_pool, v_pool, pt, off)
        ref = pd.paged_decode_ref(q, k_pool, v_pool, pt, off)
        tol = 2e-5 if dtype == torch.float32 else 2e-2
        torch.testing.assert_close(out.float(), ref.float(), rtol=tol,
                                   atol=tol)
