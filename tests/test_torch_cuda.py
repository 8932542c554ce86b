"""The port's CUDA kernels against their plain PyTorch versions on an
NVIDIA card.  This file imports neither JAX nor the JAX package, so it
also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Without a card every test skips."""
import numpy as np
import pytest
import torch

from paddle_tpu_torch import amp, kernels
from paddle_tpu_torch import quantization as Q
from paddle_tpu_torch.framework import CompiledTrainStep
from paddle_tpu_torch.incubate.nn import functional as IF
from paddle_tpu_torch.kernels import adam
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.kernels import lora as kl
from paddle_tpu_torch.kernels import paged_decode as pd
from paddle_tpu_torch.kernels import rms_norm as rn
from paddle_tpu_torch.kernels import rope as rp
from paddle_tpu_torch.models import (GPTForCausalLM, LlamaForCausalLM,
                                     llama_config)
from paddle_tpu_torch.models.gpt import GPTConfig
from paddle_tpu_torch.nn import RMSNorm
from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
from paddle_tpu_torch import optimizer as optim
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.optimizer import lr as lrs
from paddle_tpu_torch.serving import (AdapterPool, Engine, SamplingParams,
                                      ServingConfig)
from paddle_tpu_torch.utils import flags as tick_flags
from paddle_tpu_torch.utils import monitor


def _jit_fallbacks():
    """The process's ``jit.compiled_step_fallback`` count: the eager steps
    compiled train steps took because they were not eligible."""
    return monitor.get_monitor_value("jit.compiled_step_fallback")


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


def _rms_row_norm(t):
    return float(t.detach().float().reshape(-1, t.shape[-1]).norm(dim=-1)
                 .square().mean().sqrt())


def _row_err(got, want, scale=None):
    """Largest relative error of a row (the last dim) against its own norm,
    ``|got - want| / max(|want|, 1e-2 x scale)``: every row of every tensor
    is held to its own scale, so a wrong row of small values (late causal
    positions) shows.  The floor only covers rows whose exact value is ~0
    (dQ of the first causal row); ``scale`` defaults to the tensor's RMS
    row norm and is given where a whole tensor is ~0 (dq and dk of a
    single key)."""
    g = got.detach().float().reshape(-1, got.shape[-1])
    w = want.detach().float().reshape(-1, want.shape[-1])
    norm = w.norm(dim=-1)
    scale = _rms_row_norm(want) if scale is None else scale
    floor = max(1e-2 * scale, 1e-30)
    return float(((g - w).norm(dim=-1) / norm.clamp_min(floor)).max())


# row tolerances: fp32, sums of many terms in another order; 16-bit, one
# rounding of the output (2^-9 relative) and of p and dS for the tensor
# cores, with room
ROW_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2, torch.float16: 1e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rms_norm_layer_has_gradients_on_card(card, dtype):
    """RMSNorm on the card is differentiable: x.grad and weight.grad match
    autograd through the plain version, each row within ROW_TOL of its
    own norm."""
    g = torch.Generator(device=card).manual_seed(1)
    x0 = torch.randn(64, 512, device=card, generator=g).to(dtype)
    dy = torch.randn(64, 512, device=card, generator=g).to(dtype)
    layer = RMSNorm(512, epsilon=1e-5, device=card, dtype=dtype)
    with torch.no_grad():
        layer.weight.copy_(1 + 0.1 * torch.randn(512, device=card,
                                                 generator=g))
    x = x0.clone().requires_grad_(True)
    y = layer(x)
    assert y.grad_fn is not None
    y.backward(dy)
    w_ref = layer.weight.detach().clone().requires_grad_(True)
    x_ref = x0.clone().requires_grad_(True)
    rn.rms_norm_ref(x_ref, w_ref, 1e-5).backward(dy)
    assert _row_err(x.grad, x_ref.grad) < ROW_TOL[dtype]
    assert _row_err(layer.weight.grad, w_ref.grad) < ROW_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rms_norm_bwd_kernel_on_card(card, dtype):
    """Both kernels against the plain backward: a shared-memory dw
    partial (N 4096), the workspace partial (N 16384) and the scalar
    tail (3 x 100)."""
    g = torch.Generator(device=card).manual_seed(2)
    before = rn.rms_norm_bwd.launches
    for rows, n in [(300, 4096), (40, 16384), (3, 100)]:
        x = torch.randn(rows, n, device=card, generator=g).to(dtype)
        w = (1 + 0.1 * torch.randn(n, device=card, generator=g)).to(dtype)
        dy = torch.randn(rows, n, device=card, generator=g).to(dtype)
        _, r = rn.rms_norm(x, w, 1e-5, return_rstd=True)
        dx, dw = rn.rms_norm_bwd(x, w, r, dy)
        dx_ref, dw_ref = rn.rms_norm_bwd_ref(x, w, r, dy)
        assert dx.dtype == dtype and dw.dtype == dtype
        assert _row_err(dx, dx_ref) < ROW_TOL[dtype], (rows, n)
        assert _row_err(dw, dw_ref) < ROW_TOL[dtype], (rows, n)
    assert rn.rms_norm_bwd.launches == before + 3


#: (rows, N, x off 16-byte alignment): the register path at the decode
#: step, a prefill chunk and the training shape, Llama-2 70B's width, the
#: staged path (16384), the generic loop (N 100, and rows one element off
#: 16-byte alignment)
RMS_SHAPES = [(1, 4096, False), (4, 4096, False), (128, 4096, False),
              (4096, 4096, False), (4, 8192, False), (300, 8192, False),
              (4, 16384, False), (300, 16384, False), (3, 100, False),
              (4, 4096, True), (128, 4096, True)]
RMS_DTYPES = [torch.float32, torch.bfloat16, torch.float16]


def _rows_of(card, g, rows, n, dtype, misaligned):
    """[rows, n] of dtype from the card generator; ``misaligned``: a
    contiguous view that starts one element past a 16-byte boundary."""
    flat = torch.randn(rows * n + 1, device=card, generator=g).to(dtype)
    return flat[1:].view(rows, n) if misaligned else flat[:-1].view(rows, n)


@pytest.mark.cuda
@pytest.mark.parametrize("w_dtype", RMS_DTYPES)
@pytest.mark.parametrize("x_dtype", RMS_DTYPES)
def test_rms_norm_paths_on_card(card, x_dtype, w_dtype):
    """Every path of the forward and backward (registers, staged, generic)
    for each pair of x and w types against the plain versions: y within
    2e-5 (fp32) / 2e-2 (16-bit), r within 2e-5, dx and dw each within
    ROW_TOL of their own type row by row; dw bit-identical over two
    calls; one launch counted per call."""
    g = torch.Generator(device=card).manual_seed(4)
    paths = set()
    for rows, n, misaligned in RMS_SHAPES:
        x = _rows_of(card, g, rows, n, x_dtype, misaligned)
        dy = _rows_of(card, g, rows, n, x_dtype, False)
        w = (1 + 0.1 * torch.randn(n, device=card, generator=g)).to(w_dtype)
        assert (x.data_ptr() % 16 != 0) == misaligned
        paths.add(rn.bwd_plan(x, w, dy, torch.empty_like(x)).path)
        f0, b0 = rn.rms_norm.launches, rn.rms_norm_bwd.launches
        y, r = rn.rms_norm(x, w, 1e-5, return_rstd=True)
        y_ref, r_ref = rn.rms_norm_ref(x, w, 1e-5, return_rstd=True)
        tol = 2e-5 if x_dtype == torch.float32 else 2e-2
        torch.testing.assert_close(y.float(), y_ref.float(), rtol=tol,
                                   atol=tol, msg=f"y {rows}x{n}")
        torch.testing.assert_close(r, r_ref, rtol=2e-5, atol=2e-5,
                                   msg=f"r {rows}x{n}")
        dx, dw = rn.rms_norm_bwd(x, w, r, dy)
        _, dw2 = rn.rms_norm_bwd(x, w, r, dy)
        dx_ref, dw_ref = rn.rms_norm_bwd_ref(x, w, r, dy)
        assert dx.dtype == x_dtype and dw.dtype == w_dtype
        assert _row_err(dx, dx_ref) < ROW_TOL[x_dtype], (rows, n)
        assert _row_err(dw, dw_ref) < ROW_TOL[w_dtype], (rows, n)
        assert torch.equal(dw, dw2), (rows, n)
        assert rn.rms_norm.launches == f0 + 1
        assert rn.rms_norm_bwd.launches == b0 + 2
    assert paths == {rn.REG, rn.STAGED, rn.GENERIC}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("neox", [True, False])
def test_rope_kernel_on_card(card, dtype, neox):
    """Forward and inverse equal the plain version exactly: the same fp32
    products and sums, each rounded on its own, then one rounding."""
    g = torch.Generator(device=card).manual_seed(3)
    for b, s, h, d in [(2, 37, 4, 64), (1, 128, 8, 128), (1, 5, 3, 6)]:
        t = torch.randn(b, s, h, d, device=card, generator=g).to(dtype)
        ang = torch.rand(s, d, device=card, generator=g) * 6.28
        cos, sin = ang.cos(), ang.sin()
        for inverse in (False, True):
            out = rp.rope(t, cos, sin, neox, inverse)
            want = rp.rope_ref(t, cos, sin, neox, inverse)
            assert torch.equal(out, want), (b, s, h, d, inverse)


def _attn_inputs(card, b, h, h_kv, s, d, dtype, head_major, seed):
    g = torch.Generator(device=card).manual_seed(seed)

    def mk(heads):
        shape = (b, heads, s, d) if head_major else (b, s, heads, d)
        return torch.randn(shape, device=card, generator=g).to(dtype)
    return mk(h), mk(h_kv), mk(h_kv), mk(h)


ATTN_CASES = [
    # b, h, h_kv, s, d, causal, head_major
    (2, 4, 2, 130, 64, True, True),       # GQA, ragged S, head-major
    (1, 8, 8, 256, 128, False, False),    # MHA, [B, S, H, D]
    (1, 4, 1, 77, 32, True, False),       # MQA, D 32, S < one tile pair
    (1, 2, 2, 1, 128, True, True),        # one token
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_flash_attention_kernels_on_card(card, dtype):
    """Forward (out, lse) against the plain version, and the backward
    kernels (dq, dk, dv) against the plain backward on the same inputs
    (the kernel's out and lse).  fp32: out and lse 2e-5; 16-bit: lse 1e-3;
    out and each gradient row by row within ROW_TOL of the row's own
    norm."""
    for i, (b, h, h_kv, s, d, causal, hm) in enumerate(ATTN_CASES):
        q, k, v, do = _attn_inputs(card, b, h, h_kv, s, d, dtype, hm, i)
        out, lse = fa.flash_attention_fwd(q, k, v, causal, None, hm)
        out_ref, lse_ref = fa.flash_attention_ref(q, k, v, causal, None, hm)
        if dtype == torch.float32:
            torch.testing.assert_close(out, out_ref, rtol=2e-5, atol=2e-5)
            torch.testing.assert_close(lse, lse_ref, rtol=2e-5, atol=2e-5)
        else:
            assert _row_err(out, out_ref) < ROW_TOL[dtype], i
            torch.testing.assert_close(lse, lse_ref, rtol=1e-3, atol=1e-3)
        grads = fa.flash_attention_bwd(q, k, v, out, lse, do, causal, None,
                                       hm)
        wants = fa.flash_attention_bwd_ref(q, k, v, out, lse, do, causal,
                                           None, hm)
        # the floor from the largest of the three: with one key, dq and dk
        # are 0 and only dv is not
        scale = max(_rms_row_norm(w) for w in wants)
        for got, want in zip(grads, wants):
            assert got.shape == want.shape and got.dtype == dtype
            err = _row_err(got, want, scale)
            assert err < ROW_TOL[dtype], (i, err)


@pytest.mark.cuda
def test_flash_attention_op_under_autograd_on_card(card):
    """The public op differentiates through the kernels: every flash
    launch count moves, and the gradients are the kernels' own for the
    forward's out and lse."""
    q, k, v, do = _attn_inputs(card, 1, 8, 2, 200, 128, torch.bfloat16,
                               True, 9)
    before = kernels.launch_counts()
    qa, ka, va = (t.clone().requires_grad_(True) for t in (q, k, v))
    fa.flash_attention(qa, ka, va, causal=True, head_major=True).backward(do)
    after = kernels.launch_counts()
    for name in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"):
        assert after[name] == before[name] + 1, name
    out, lse = fa.flash_attention_fwd(q, k, v, True, None, True)
    want = fa.flash_attention_bwd(q, k, v, out, lse, do, True, None, True)
    for got, w in zip((qa.grad, ka.grad, va.grad), want):
        assert torch.equal(got, w)


#: the tile edges of the Hopper flash kernels (128 keys or q rows a block,
#: 64-row warpgroups, 64- or 128-key and 64- or 32-row stages)
EDGE_LENGTHS = (1, 127, 128, 129, 1000)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [64, 128])
def test_flash_backward_tile_edges_on_card(card, dtype, d):
    """The whole backward (delta pass, dK/dV, dQ) at S on and around the
    new tiles' edges, causal and not, both layouts, n_rep 4, against the
    plain backward on the same out and lse: each gradient row within
    ROW_TOL of its own norm."""
    for s in EDGE_LENGTHS:
        for causal in (True, False):
            for hm in (True, False):
                b = 1 if s == 1000 else 2
                q, k, v, do = _attn_inputs(card, b, 8, 2, s, d, dtype, hm,
                                           s + 2 * causal + hm)
                out, lse = fa.flash_attention_fwd(q, k, v, causal, None, hm)
                grads = fa.flash_attention_bwd(q, k, v, out, lse, do, causal,
                                               None, hm)
                wants = fa.flash_attention_bwd_ref(q, k, v, out, lse, do,
                                                   causal, None, hm)
                scale = max(_rms_row_norm(w) for w in wants)
                for got, want in zip(grads, wants):
                    assert got.shape == want.shape and got.dtype == dtype
                    err = _row_err(got, want, scale)
                    assert err < ROW_TOL[dtype], (s, causal, hm, err)


@pytest.mark.cuda
@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_flash_backward_is_deterministic_on_card(card, dropout):
    """No atomics: the GQA heads of a kv head are summed inside one block,
    so two calls of the whole backward give the same bits (causal, n_rep
    4, a ragged S)."""
    q, k, v, do = _attn_inputs(card, 2, 8, 2, 1000, 128, torch.bfloat16,
                               True, 40)
    feats = dict(dropout=dropout, seed=77)
    out, lse = fa.flash_attention_fwd(q, k, v, True, None, True, **feats)
    first = fa.flash_attention_bwd(q, k, v, out, lse, do, True, None, True,
                                   **feats)
    second = fa.flash_attention_bwd(q, k, v, out, lse, do, True, None, True,
                                    **feats)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [64, 128])
def test_flash_forward_tile_edges_on_card(card, dtype, d):
    """The Hopper forward (128 q rows a block, 64-row warpgroups, 128-key
    stages) at S on and around its tiles' edges, causal and not, both
    layouts, n_rep 4, against the fp32 plain forward: out row by row
    within ROW_TOL, lse within 1e-3; one launch of the plain variant a
    call."""
    for s in EDGE_LENGTHS:
        for causal in (True, False):
            for hm in (True, False):
                b = 1 if s == 1000 else 2
                q, k, v, _ = _attn_inputs(card, b, 8, 2, s, d, dtype, hm,
                                          70 + s + 2 * causal + hm)
                before = fa.flash_attention_fwd.launches
                out, lse = fa.flash_attention_fwd(q, k, v, causal, None, hm)
                assert fa.flash_attention_fwd.launches == before + 1
                want, want_lse = fa.flash_attention_ref(q, k, v, causal,
                                                        None, hm)
                assert out.shape == want.shape and out.dtype == dtype
                err = _row_err(out, want)
                assert err < ROW_TOL[dtype], (s, causal, hm, err)
                torch.testing.assert_close(lse, want_lse, rtol=1e-3,
                                           atol=1e-3)


def _edge_features(card, kind, b, h, s, seed):
    """(features, the fully masked (batch, row) or None) of a forward edge
    case: dropout 0.1; an additive N(0, 1) fp32 bias [B, 1, S, S]; a
    key-padding mask (batch i keeps its first S - 7 i keys) with q row
    min(3, S - 1) of the last batch fully masked; four segments a row,
    their borders shifted by 5 tokens a batch."""
    g = torch.Generator(device=card).manual_seed(200 + seed)
    feats = dict(mask=None, segment_ids=None, dropout=0.0, seed=4321 + seed)
    dead = None
    if kind == "dropout":
        feats["dropout"] = 0.1
    elif kind == "bias":
        feats["mask"] = torch.randn(b, 1, s, s, device=card, generator=g)
    elif kind == "padding":
        keep = torch.ones(b, 1, s, s, dtype=torch.bool, device=card)
        for i in range(b):
            keep[i, :, :, max(1, s - 7 * i):] = False
        dead = (b - 1, min(3, s - 1))
        keep[dead[0], 0, dead[1]] = False
        feats["mask"] = fa.additive_mask(keep)
    elif kind == "segments":
        pos = torch.arange(s, device=card)
        feats["segment_ids"] = torch.stack(
            [((pos + 5 * i) * 4 // s).clamp_max(3) for i in range(b)]
        ).to(torch.int32)
    return feats, dead


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["dropout", "bias", "padding", "segments"])
def test_flash_forward_features_at_tile_edges_on_card(card, kind):
    """The forward's feature instantiation (mask tiles staged by TMA, the
    segment ids and the guard on every live score, the dropout hash beside
    the S product) at the tile edges, D 64 and 128, causal and not, both
    layouts, n_rep 4, bf16: the forward against the plain forward and the
    backward against the plain backward on the kernel's out and lse, both
    with the same features and seed, so each kernel drops exactly the
    plain version's elements; with dropout also the whole forward +
    backward against the plain pair (the plain backward on the plain
    forward's out and lse).  Out and every gradient row by row within
    ROW_TOL, lse within 1e-3; a fully masked row gives out 0 on both."""
    dtype = torch.bfloat16
    for s in EDGE_LENGTHS:
        for d in (64, 128):
            for causal in (True, False):
                for hm in (True, False):
                    b = 1 if s == 1000 else 2
                    seed = s + 2 * d + 4 * causal + hm
                    q, k, v, do = _attn_inputs(card, b, 8, 2, s, d, dtype,
                                               hm, 90 + seed)
                    feats, dead = _edge_features(card, kind, b, 8, s, seed)
                    out, lse = fa.flash_attention_fwd(q, k, v, causal, None,
                                                      hm, **feats)
                    want, want_lse = fa.flash_attention_ref(
                        q, k, v, causal, None, hm, **feats)
                    case = (s, d, causal, hm)
                    assert _row_err(out, want) < ROW_TOL[dtype], case
                    torch.testing.assert_close(lse, want_lse, rtol=1e-3,
                                               atol=1e-3)
                    grads = fa.flash_attention_bwd(q, k, v, out, lse, do,
                                                   causal, None, hm, **feats)
                    pairs = [(out, lse)]
                    if kind == "dropout":
                        pairs.append((want, want_lse))
                    for o, l in pairs:
                        wants = fa.flash_attention_bwd_ref(
                            q, k, v, o, l, do, causal, None, hm, **feats)
                        scale = max(_rms_row_norm(w) for w in wants)
                        for got, w in zip(grads, wants):
                            assert _row_err(got, w, scale) < ROW_TOL[dtype], \
                                case
                    if dead is not None:
                        bi, row = dead
                        for t in (out, want):
                            t_bh = t if hm else t.transpose(1, 2)
                            assert not t_bh[bi, :, row].any(), case


@pytest.mark.cuda
@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_flash_forward_is_deterministic_on_card(card, dropout):
    """No atomics in the forward: two calls give the same bits of out and
    lse (causal, n_rep 4, a ragged S, D 64 and 128)."""
    for d in (64, 128):
        q, k, v, _ = _attn_inputs(card, 2, 8, 2, 1000, d, torch.bfloat16,
                                  True, 41 + d)
        feats = dict(dropout=dropout, seed=78)
        first = fa.flash_attention_fwd(q, k, v, True, None, True, **feats)
        second = fa.flash_attention_fwd(q, k, v, True, None, True, **feats)
        for a, b in zip(first, second):
            assert torch.equal(a, b), d


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_flash_delta_pass_on_card(card, dtype):
    """The delta kernel against its plain version `_delta` (fp32 sums of D
    products in another order: within 2e-5 of the sum of the terms'
    magnitudes), both layouts and every head dim, one launch a call."""
    for i, (s, d, hm) in enumerate(((1000, 128, True), (77, 64, False),
                                    (5, 32, True))):
        _, _, _, out = _attn_inputs(card, 2, 6, 6, s, d, dtype, hm, 50 + i)
        _, _, _, dout = _attn_inputs(card, 2, 6, 6, s, d, dtype, hm, 60 + i)
        before = fa.flash_bwd_delta.launches
        got = fa.flash_bwd_delta(out, dout, hm)
        assert fa.flash_bwd_delta.launches == before + 1
        want = fa._delta(out, dout, hm)
        mag = fa._delta(out.abs(), dout.abs(), hm)
        assert got.shape == want.shape == (2, 6, s)
        assert got.dtype == torch.float32
        assert bool(((got - want).abs() <= 2e-5 * mag + 1e-30).all()), i


@pytest.mark.cuda
@pytest.mark.parametrize("p_dtype,master,decoupled,wd", [
    (torch.bfloat16, True, True, 0.01),     # O2 AdamW: bf16 + fp32 master
    (torch.float32, False, True, 0.01),     # fp32 AdamW
    (torch.float16, True, False, 0.1),      # Adam, L2-coupled decay
    (torch.bfloat16, False, True, 0.0),     # no master, no decay
])
def test_adam_kernel_on_card(card, p_dtype, master, decoupled, wd):
    """The kernel equals its plain version bit for bit (the same fp32 ops,
    each rounded on its own) on an aligned size, a ragged tail and a
    misaligned view (the one-element-per-thread kernel)."""
    g = torch.Generator(device=card).manual_seed(5)
    before = adam.adam_update.launches
    for n, offset in ((4096 * 3, 0), (1027, 0), (1001, 1)):
        def copy(t):                # a copy ``offset`` elements off
            buf = torch.empty(t.numel() + offset, device=card, dtype=t.dtype)
            return buf[offset:].copy_(t)
        w = torch.randn(n, device=card, generator=g)
        m1 = 1e-2 * torch.randn(n, device=card, generator=g)
        m2 = 1e-4 * torch.rand(n, device=card, generator=g)
        grad = torch.randn(n, device=card, generator=g).to(p_dtype)
        outs = []
        for fn in (adam.adam_update, adam.adam_update_ref):
            ww, a, b = copy(w), copy(m1), copy(m2)
            if master:
                p = torch.empty(n, device=card, dtype=p_dtype)
            elif p_dtype == torch.float32:
                p = None
            else:
                ww, p = ww.to(p_dtype).float(), torch.empty(
                    n, device=card, dtype=p_dtype)
            scal = torch.tensor([3e-4, 0.271, 0.002997, 1.0], device=card)
            fn(ww, grad, a, b, p, scal, b1=0.9, b2=0.999, eps=1e-8, wd=wd,
               decoupled=decoupled)
            outs.append([t for t in (ww, a, b, p) if t is not None])
        for got, want in zip(*outs):
            assert torch.equal(got, want), (n, offset)
    assert adam.adam_update.launches == before + 3


@pytest.mark.cuda
def test_adamw_step_launches_the_kernel_on_card(card):
    """`AdamW.step` on the card updates every parameter through the kernel,
    once a step, and matches the same step on the CPU (plain version)."""
    torch.manual_seed(0)
    params = [torch.randn(64, 48), torch.randn(48), torch.randn(7, 3)]
    grads = [torch.randn_like(t) for t in params]
    steps = {}
    for dev in ("cpu", card):
        ps = [torch.nn.Parameter(t.clone().to(dev)) for t in params]
        for p, gr in zip(ps, grads):
            p.grad = gr.to(dev)
        opt = AdamW(learning_rate=1e-3, parameters=ps, weight_decay=0.01)
        before = adam.adam_update.launches
        opt.step()
        opt.step()
        launched = adam.adam_update.launches - before
        steps[str(dev)] = ([p.detach().cpu() for p in ps], launched)
    (cpu, cpu_n), (gpu, gpu_n) = steps["cpu"], steps[str(card)]
    assert cpu_n == 0 and gpu_n == 2 * len(params)
    for a, b in zip(cpu, gpu):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_flash_attention_refuses_what_it_does_not_take(card):
    q = torch.zeros(1, 16, 2, 48, device=card, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim 48"):
        fa.flash_attention(q, q, q, causal=True)
    q = torch.zeros(1, 16, 2, 64, device=card, dtype=torch.bfloat16)
    # a mask that requires grad takes the plain version: no kernel runs
    mask = torch.zeros(1, 1, 16, 16, device=card, requires_grad=True)
    before = kernels.launch_counts()
    routes = fa.flash_attention.plain_routes
    fa.flash_attention(q, q, q, attn_mask=mask)
    assert kernels.launch_counts() == before
    assert fa.flash_attention.plain_routes == routes + 1
    with pytest.raises(ValueError, match="mask"):
        fa.flash_attention_fwd(q, q, q, mask=torch.zeros(1, 3, 16, 16,
                                                         device=card))


FEATURE_CASES = [
    # b, h, h_kv, s, d, causal, head_major, features
    (2, 4, 2, 130, 64, True, True, "dropout"),     # GQA, ragged S
    (2, 4, 4, 96, 32, False, False, "dropout"),
    (2, 4, 2, 130, 64, True, True, "bool"),        # padding, a dead row
    (1, 4, 2, 200, 128, False, False, "additive"),  # [1, H, S, S]
    (2, 4, 2, 130, 64, True, True, "segments"),
    (2, 4, 2, 130, 64, False, False, "all"),       # + a dead row
    # D 128 with features: 32-row q stages in dK/dV, the causal skip
    (2, 8, 2, 1000, 128, True, True, "dropout"),
    (2, 8, 2, 129, 128, True, False, "segments"),
    (2, 8, 2, 1000, 128, True, False, "all"),
    (2, 8, 2, 129, 128, True, True, "all"),
]


def _features(card, kind, b, h, s, seed):
    """(mask, segment_ids, dropout, dead row or None) of a case: a boolean
    key-padding mask as 0 / NEG_INF, an additive N(0, 1) bias, four
    segments a row, or all of them with dropout 0.1."""
    g = torch.Generator(device=card).manual_seed(100 + seed)
    mask = seg = dead = None
    dropout = 0.1 if kind in ("dropout", "all") else 0.0
    if kind in ("bool", "all"):
        keep = torch.ones(b, 1, s, s, dtype=torch.bool, device=card)
        keep[:, :, :, s - 20:] = False
        keep[b - 1, 0, 7] = False                  # a fully masked q row
        dead = (b - 1, 7)
        mask = fa.additive_mask(keep)
    if kind == "additive":
        mask = torch.randn(1, h, s, s, device=card, generator=g)
    if kind == "all":
        mask = mask + torch.randn(b, 1, s, s, device=card, generator=g)
    if kind in ("segments", "all"):
        seg = (torch.arange(s, device=card) * 4 // s).to(torch.int32)
        seg = seg[None].repeat(b, 1)
    return mask, seg, dropout, dead


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_flash_attention_features_on_card(card, dtype):
    """Dropout, masks and segment ids in the three kernels against their
    plain versions (the same seed, the same keep-mask): out and each
    gradient row by row within ROW_TOL of the row's own norm, lse 2e-5
    (fp32) or 1e-3; a fully masked row gives out 0 and dq 0 on both; each
    call counted under its variant; the plain version at seed + 1 is
    rejected."""
    for i, (b, h, h_kv, s, d, causal, hm, kind) in enumerate(FEATURE_CASES):
        q, k, v, do = _attn_inputs(card, b, h, h_kv, s, d, dtype, hm, 20 + i)
        mask, seg, p, dead = _features(card, kind, b, h, s, i)
        feats = dict(mask=mask, segment_ids=seg, dropout=p, seed=1234 + i)
        variant = "dropout" if kind == "dropout" else "masked"
        before = kernels.launch_counts()
        out, lse = fa.flash_attention_fwd(q, k, v, causal, None, hm, **feats)
        grads = fa.flash_attention_bwd(q, k, v, out, lse, do, causal, None,
                                       hm, **feats)
        after = kernels.launch_counts()
        for name in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"):
            assert after[f"{name}_{variant}"] == \
                before[f"{name}_{variant}"] + 1, (i, name)
            assert after[name] == before[name], (i, name)
        out_ref, lse_ref = fa.flash_attention_ref(q, k, v, causal, None, hm,
                                                  **feats)
        assert _row_err(out, out_ref) < ROW_TOL[dtype], (i, kind)
        tol = 2e-5 if dtype == torch.float32 else 1e-3
        torch.testing.assert_close(lse, lse_ref, rtol=tol, atol=tol)
        wants = fa.flash_attention_bwd_ref(q, k, v, out, lse, do, causal,
                                           None, hm, **feats)
        scale = max(_rms_row_norm(w) for w in wants)
        for got, want in zip(grads, wants):
            assert got.shape == want.shape and got.dtype == dtype
            assert _row_err(got, want, scale) < ROW_TOL[dtype], (i, kind)
        if dead is not None:
            bi, row = dead
            for t in (out, out_ref, grads[0], wants[0]):
                t_bh = t if hm else t.transpose(1, 2)
                assert not t_bh[bi, :, row].any(), (i, kind)
        if p:
            wrong, _ = fa.flash_attention_ref(q, k, v, causal, None, hm,
                                              **dict(feats, seed=1235 + i))
            assert _row_err(out, wrong) > 10 * ROW_TOL[dtype], (i, kind)


@pytest.mark.cuda
def test_flash_dropout_rescale_is_ieee_division_on_card(card):
    """The survivors' rescale of every flash kernel (one product in
    double) against numpy's float32 division by (float)(1 - p), bit for
    bit: random bit patterns over every exponent, subnormals, zeros,
    infinities and the overflow edge, at several p.  Multiplying by the
    float reciprocal instead differs on these inputs, so a 1-ulp split
    would show."""
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2 ** 32, 1 << 20, dtype=np.uint64)
    bits = bits.astype(np.uint32)
    bits = bits[((bits >> 23) & 0xFF) != 0xFF]         # no NaN, no inf
    tiny = np.arange(1, 4096, dtype=np.uint32)          # subnormals
    big = np.uint32(0x7F7FFFFF) - np.arange(4096, dtype=np.uint32)
    x = np.concatenate([bits, tiny, big, tiny | 0x80000000]).view(np.float32)
    x = np.concatenate([x, np.float32([0.0, -0.0, np.inf, -np.inf, 1.0])])
    x_card = torch.from_numpy(x).to(card)
    split = 0
    for p in (1e-7, 0.1, 0.25, 1 / 3, 0.5, 0.9, 0.999,
              *rng.uniform(0, 1, 8)):
        c = np.float32(1.0 - p)
        with np.errstate(over="ignore"):
            want = x / c
            split += int((x * (np.float32(1) / c) != want).sum())
        before = fa.dropout_rescale.launches
        got = fa.dropout_rescale(x_card, float(p)).cpu().numpy()
        assert fa.dropout_rescale.launches == before + 1
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32)), p
        assert np.array_equal(
            fa.dropout_rescale(torch.from_numpy(x), float(p)).numpy()
            .view(np.uint32), want.view(np.uint32)), p
    assert split > 0


@pytest.mark.cuda
def test_flash_dropout_op_under_autograd_on_card(card):
    """The public op with dropout: the seed comes from the CPU generator
    (equal generators, equal outputs on the CPU and the card), the
    backward reuses it, and the dropout variants are the ones launched."""
    q, k, v, do = _attn_inputs(card, 2, 4, 2, 128, 64, torch.float32, True,
                               30)
    res = {}
    for dev in ("cpu", card):
        gen = torch.Generator().manual_seed(7)
        qa, ka, va = (t.detach().to(dev).requires_grad_(True)
                      for t in (q, k, v))
        before = kernels.launch_counts()
        out = fa.flash_attention(qa, ka, va, dropout=0.1, causal=True,
                                 head_major=True, generator=gen)
        out.backward(do.to(dev))
        after = kernels.launch_counts()
        launched = {n: after[n] - before[n] for n in after if
                    after[n] != before[n]}
        res[str(dev)] = ([t.detach().cpu() for t in (out, qa.grad, ka.grad,
                                                     va.grad)], launched)
    (cpu, cpu_n), (gpu, gpu_n) = res["cpu"], res[str(card)]
    assert cpu_n == {} and gpu_n == {"flash_fwd_dropout": 1,
                                     "flash_bwd_dkv_dropout": 1,
                                     "flash_bwd_dq_dropout": 1,
                                     "flash_bwd_delta": 1}
    for a, b in zip(cpu, gpu):
        assert _row_err(b, a) < ROW_TOL[torch.float32]


def quant_pools(card, name, P, psz, h_kv, d, seed):
    """Pools of a quantized storage type holding the codes of N(0, 1)
    values, with their per-row scales (`quantize_kv_rows`)."""
    g = torch.Generator(device=card).manual_seed(seed)
    sd, qmax = Q.KV_QUANT_DTYPES[name]
    out = []
    for _ in range(2):
        x = torch.randn(P, psz, h_kv, d, device=card, generator=g)
        out.extend(Q.quantize_kv_rows(x, qmax, sd))
    k_pool, k_scale, v_pool, v_scale = out
    return k_pool, v_pool, k_scale, v_scale


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["int8", "fp8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quant_paged_decode_kernel_on_card(card, name, dtype):
    """int8 and fp8 pools with per-row scales against the plain version
    (dequantize, gather, fp32 softmax): GQA 4:1, MHA with a page edge and
    offset 0, MQA at D 128 and a 32-token page; each launch counted under
    its storage type."""
    before = kernels.launch_counts()
    for i, (h, h_kv, d, psz, off) in enumerate([
            (8, 2, 16, 8, (5, 17, 30)), (4, 4, 16, 8, (0, 8, 31)),
            (8, 1, 128, 32, (95, 0, 40))]):
        b, n = 3, 4
        k_pool, v_pool, k_scale, v_scale = quant_pools(
            card, name, 1 + b * n, psz, h_kv, d, i)
        q = torch.randn(b, h, d, device=card).to(dtype)
        pt = (torch.randperm(b * n, device=card) + 1).reshape(b, n) \
            .to(torch.int32)
        offs = torch.tensor(off, dtype=torch.int32, device=card)
        out = pd.paged_decode_attention(q, k_pool, v_pool, pt, offs,
                                        k_scale=k_scale, v_scale=v_scale)
        ref = pd.paged_decode_ref(q, k_pool, v_pool, pt, offs,
                                  k_scale=k_scale, v_scale=v_scale)
        assert out.dtype == dtype
        tol = 2e-5 if dtype == torch.float32 else 2e-2
        torch.testing.assert_close(out.float(), ref.float(), rtol=tol,
                                   atol=tol)
        with pytest.raises(ValueError, match="k_scale"):
            pd.paged_decode_attention(q, k_pool, v_pool, pt, offs)
    after = kernels.launch_counts()
    assert after["paged_decode_" + name] == before["paged_decode_" + name] + 3
    assert after["paged_decode"] == before["paged_decode"]


#: pool storage types of the split-decode cases, each with its query type
POOLS = {"fp32": (torch.float32, torch.float32),
         "bf16": (torch.bfloat16, torch.bfloat16),
         "fp16": (torch.float16, torch.float16),
         "int8": ("int8", torch.bfloat16),
         "fp8": ("fp8", torch.bfloat16)}


def split_inputs(card, pool, b, h, h_kv, d, psz, n, offs, seed=0,
                 free_row=None, q_dtype=None):
    """Pools of 1 + b * n pages of ``pool``'s storage type, a random page
    table and ``offs``; ``free_row`` gets an all-zero table at offset 0.
    Returns the positional arguments and the scales' keywords."""
    kv, qd = POOLS[pool]
    g = torch.Generator(device=card).manual_seed(seed)
    P = 1 + b * n
    if isinstance(kv, str):
        k_pool, v_pool, ks, vs = quant_pools(card, kv, P, psz, h_kv, d, seed)
        kw = dict(k_scale=ks, v_scale=vs)
    else:
        k_pool, v_pool = (torch.randn(P, psz, h_kv, d, device=card,
                                      generator=g).to(kv) for _ in range(2))
        kw = {}
    q = torch.randn(b, h, d, device=card, generator=g).to(q_dtype or qd)
    pt = (torch.randperm(P - 1, device=card, generator=g) + 1) \
        .reshape(b, n).to(torch.int32)
    off = torch.tensor(offs, dtype=torch.int32, device=card)
    if free_row is not None:
        pt[free_row] = 0
        off[free_row] = 0
    return (q, k_pool, v_pool, pt, off), kw


#: (b, h, h_kv, d, psz, n, offsets or "edges", free_row): offsets at a
#: split's edges, a 4000-token row beside short rows, every row at 0, a
#: free row, GQA 8:1 at D 128 and 256, 12 query heads a kv head (two
#: groups of a block), MHA at page sizes 8-64, D not a multiple of the
#: 16-byte vector (the scalar tail)
SPLIT_CASES = {
    "split-edges": (4, 8, 2, 64, 16, 32, "edges", None),
    "long-row": (4, 4, 4, 128, 16, 256, (4000, 3, 17, 100), None),
    "all-zero": (3, 8, 2, 64, 16, 16, (0, 0, 0), None),
    "free-row": (3, 8, 2, 64, 16, 16, (200, 0, 77), 1),
    "gqa8-d128": (2, 16, 2, 128, 16, 32, (511, 130), None),
    "gqa8-d256": (2, 16, 2, 256, 16, 32, (300, 64), None),
    "rep12": (2, 24, 2, 64, 16, 16, (255, 40), None),
    "psz8": (3, 4, 4, 64, 8, 64, (511, 64, 8), None),
    "psz16": (3, 4, 4, 64, 16, 32, (300, 63, 0), None),
    "psz32": (3, 4, 4, 64, 32, 16, (511, 128, 31), None),
    "psz64": (3, 4, 4, 64, 64, 8, (450, 64, 63), None),
    "tail-d20": (3, 4, 2, 20, 16, 16, (255, 70, 5), None),
    "tail-d24": (2, 4, 1, 24, 16, 16, (200, 9), None),
}


@pytest.mark.cuda
@pytest.mark.parametrize("pool", list(POOLS))
@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_split_paged_decode_on_card(card, case, pool):
    """The split kernel and its merge against the plain version, every
    pool type, one launch counted under the pool's storage type."""
    b, h, h_kv, d, psz, n, offs, free_row = SPLIT_CASES[case]
    split, n_splits = pd.split_plan(b, h, h_kv, psz, n, card)
    if offs == "edges":
        offs = (split - 1, split, split + 1, 2 * split)
    args, kw = split_inputs(card, pool, b, h, h_kv, d, psz, n, offs,
                            free_row=free_row)
    name = {"int8": "paged_decode_int8", "fp8": "paged_decode_fp8"} \
        .get(pool, "paged_decode")
    before = kernels.launch_counts()[name]
    out = pd.paged_decode_attention(*args, **kw)
    ref = pd.paged_decode_ref(*args, **kw)
    assert kernels.launch_counts()[name] == before + 1
    assert out.dtype == args[0].dtype and torch.isfinite(out).all()
    tol = 2e-5 if out.dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    if case == "split-edges":
        assert n_splits > 1


@pytest.mark.cuda
def test_split_paged_decode_fp32_query_on_bf16_pool(card):
    args, _ = split_inputs(card, "bf16", 3, 8, 2, 128, 16, 32,
                           (500, 64, 1), q_dtype=torch.float32)
    out = pd.paged_decode_attention(*args)
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, pd.paged_decode_ref(*args), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("pool", ["bf16", "int8"])
def test_split_paged_decode_is_deterministic_on_card(card, pool):
    """No atomics: two calls over many splits give the same bits."""
    args, kw = split_inputs(card, pool, 4, 32, 8, 128, 16, 64,
                            (1023, 700, 5, 300))
    assert pd.split_plan(4, 32, 8, 16, 64, card)[1] > 1
    first = pd.paged_decode_attention(*args, **kw)
    second = pd.paged_decode_attention(*args, **kw)
    assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("pool", ["bf16", "fp8"])
def test_split_paged_decode_in_a_cuda_graph_on_card(card, pool):
    """Captured once, replayed after the offsets and the table changed in
    place: the split plan does not depend on the offsets, so each replay
    equals the plain version at the new offsets (a row that grew into
    later splits included)."""
    (q, k_pool, v_pool, pt, off), kw = split_inputs(
        card, pool, 4, 8, 2, 64, 16, 32, (10, 100, 0, 64))
    assert pd.split_plan(4, 8, 2, 16, 32, card)[1] > 1
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        pd.paged_decode_attention(q, k_pool, v_pool, pt, off, **kw)
    torch.cuda.current_stream().wait_stream(s)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = pd.paged_decode_attention(q, k_pool, v_pool, pt, off, **kw)
    g = torch.Generator(device=card).manual_seed(11)
    for new_off in ((511, 3, 200, 64), (0, 0, 0, 0), (64, 511, 63, 130)):
        off.copy_(torch.tensor(new_off, dtype=torch.int32))
        pt.copy_((torch.randperm(pt.numel(), device=card, generator=g) + 1)
                 .reshape(pt.shape).to(torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        ref = pd.paged_decode_ref(q, k_pool, v_pool, pt, off, **kw)
        torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2,
                                   atol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lora_delta_kernel_on_card(card, dtype):
    """The gathered delta against its plain version at ragged shapes: S 1,
    17, 33; ranks 1, 8, 16; an input width past one 512-column chunk and
    an output width past one 256-column tile; idx with a repeat and 0.
    Each row within ROW_TOL of its own norm; slot 0 rows exactly 0."""
    g = torch.Generator(device=card).manual_seed(6)
    before = kl.lora_delta.launches
    cases = [(1, 8, 4096, 4096), (17, 1, 600, 300), (33, 16, 1030, 257)]
    for seq, rank, din, dout in cases:
        ns, P = 4, 3
        x = torch.randn(ns, seq, din, device=card, generator=g).to(dtype)
        a = (0.05 * torch.randn(P, din, rank, device=card, generator=g)
             ).to(dtype)
        b = (0.05 * torch.randn(P, rank, dout, device=card, generator=g)
             ).to(dtype)
        a[0], b[0] = 0, 0
        s = torch.tensor([0.0, 2.0, 0.5], device=card).to(dtype)
        idx = torch.tensor([2, 0, 1, 2], dtype=torch.int32, device=card)
        out = kl.lora_delta(x, a, b, s, idx)
        ref = kl.lora_delta_ref(x, a, b, s, idx)
        assert out.shape == (ns, seq, dout) and out.dtype == dtype
        live = idx.cpu() != 0
        assert _row_err(out[live], ref[live]) < ROW_TOL[dtype], \
            (seq, rank, din, dout)
        assert not out[1].any()
    assert kl.lora_delta.launches == before + len(cases)


def _lora_inputs(card, seq, rank, din, dout, dtype, seed, ns=4, pool=5):
    """x [ns, seq, din] and a pool of `pool` adapters with N(0, 0.05)
    factors, slot 0 the identity (A = B = 0), scales 0, 2, 0.5, 1, 1.5."""
    g = torch.Generator(device=card).manual_seed(seed)
    x = torch.randn(ns, seq, din, device=card, generator=g).to(dtype)
    a = (0.05 * torch.randn(pool, din, rank, device=card, generator=g)
         ).to(dtype)
    b = (0.05 * torch.randn(pool, rank, dout, device=card, generator=g)
         ).to(dtype)
    a[0], b[0] = 0, 0
    s = torch.tensor([0.0, 2.0, 0.5, 1.0, 1.5][:pool], device=card).to(dtype)
    return x, a, b, s


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_lora_delta_edges_on_card(card, dtype):
    """The one-launch delta at the sequence tile's edges (seq 1, 7, 8, 9,
    32), input widths 4096, 11008 and 1000 (not a multiple of a block's
    512-column share), ranks 8, 16 and 64: each row within ROW_TOL of the
    plain version, the identity slot 0 gives 0 rows, an idx outside the
    pool gives NaN rows, and a second call gives the same bits."""
    cases = [(seq, 16, 4096, 11008) for seq in (1, 7, 8, 9, 32)] + [
        (1, 8, 11008, 4096), (9, 64, 1000, 4096), (32, 64, 4096, 4096),
        (8, 8, 1000, 1000), (1, 16, 11008, 4096)]
    for i, (seq, rank, din, dout) in enumerate(cases):
        x, a, b, s = _lora_inputs(card, seq, rank, din, dout, dtype, 300 + i)
        idx = torch.tensor([3, 0, 1, 5], dtype=torch.int32, device=card)
        out = kl.lora_delta(x, a, b, s, idx)
        again = kl.lora_delta(x, a, b, s, idx)
        case = (seq, rank, din, dout)
        assert out.shape == (4, seq, dout) and out.dtype == dtype, case
        ok = torch.tensor([3, 0, 1, 1], dtype=torch.int32, device=card)
        want = kl.lora_delta_ref(x, a, b, s, ok)
        assert _row_err(out[[0, 2]], want[[0, 2]]) < ROW_TOL[dtype], case
        assert not out[1].any(), case
        assert bool(torch.isnan(out[3]).all()), case
        assert torch.equal(out[:3], again[:3]), case
        assert bool(torch.isnan(again[3]).all()), case


@pytest.mark.cuda
def test_lora_delta_is_one_launch_on_card(card):
    """One call is one device kernel (torch.profiler counts the CUDA
    kernels of the call; no scratch fill or second pass) and raises
    `lora_delta.launches` by one."""
    x, a, b, s = _lora_inputs(card, 1, 16, 4096, 11008, torch.bfloat16, 9)
    idx = torch.tensor([0, 1, 2, 3], dtype=torch.int32, device=card)
    kl.lora_delta(x, a, b, s, idx)                  # built and warm
    torch.cuda.synchronize()
    before = kl.lora_delta.launches
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        kl.lora_delta(x, a, b, s, idx)
        torch.cuda.synchronize()
    assert kl.lora_delta.launches == before + 1
    kernels_run = [e.name for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels_run) == 1 and "lora_delta" in kernels_run[0], \
        kernels_run


@pytest.mark.cuda
def test_fp8_pool_store_and_gather_on_card(card):
    """The fp8 store and the prefill gather (through uint8 views) on the
    card: the op writes the CPU's codes and scales bit for bit and gives
    its output within 1e-5; then a tiny fp8 engine serves on the card
    with the CPU's greedy outputs."""
    rng = np.random.default_rng(3)
    B, S, H, Hkv, D, psz, N = 2, 6, 4, 2, 16, 8, 3
    P = 1 + B * N
    q, k, v = (rng.normal(size=(B, S, h, D)).astype(np.float32)
               for h in (H, Hkv, Hkv))
    table = rng.permutation(np.arange(1, P)).reshape(B, N).astype(np.int32)
    off = np.array([0, 9], np.int32)
    res = {}
    for dev in ("cpu", card):
        kp, vp, ks, vs = quant_pools("cpu", "fp8", P, psz, Hkv, D, 0)
        t = [torch.from_numpy(a).to(dev) for a in (q, k, v, table, off)]
        out = IF.paged_masked_multihead_attention(
            t[0], t[1], t[2], kp.to(dev), vp.to(dev), t[3], t[4], psz,
            k_scale=ks.to(dev), v_scale=vs.to(dev))
        res[str(dev)] = [x.cpu() for x in out]
    cpu, gpu = res["cpu"], res[str(card)]
    torch.testing.assert_close(gpu[0], cpu[0], rtol=1e-5, atol=1e-5)
    for a, b in zip(cpu[1:], gpu[1:]):
        assert torch.equal(Q.as_bytes(a), Q.as_bytes(b))
    cfg = llama_config("tiny", max_seq_len=64)
    prompts = [rng.integers(0, 512, (n,)).astype(np.int32) for n in (5, 21)]
    outs = {}
    cpu_model = LlamaForCausalLM(cfg, device="cpu", seed=2)
    card_model = LlamaForCausalLM(cfg, device=card)
    card_model.load_state_dict(cpu_model.state_dict())
    for dev, m in (("cpu", cpu_model), (card, card_model)):
        with Engine(m, ServingConfig(num_slots=2, cache_dtype="fp8")) as eng:
            outs[str(dev)] = [eng.generate(p, max_new_tokens=6).output_ids
                              for p in prompts]
            assert eng.cache.layers[0]["k_pool"].dtype == torch.float8_e4m3fn
    for a, b in zip(outs["cpu"], outs[str(card)]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
def test_adapter_pool_hot_load_stays_on_card(card):
    """Stacks and index vector live on the card in the weight's dtype;
    a hot-load writes them in place; an active scope launches the delta
    kernel once per target projection."""
    m = LlamaForCausalLM(llama_config("tiny", max_seq_len=64), device=card,
                         dtype=torch.bfloat16, seed=3)
    pool = AdapterPool(m, 2, 8, 2)
    rng = np.random.default_rng(4)
    spec = {name: {"A": rng.normal(0, 0.1, (mod.weight.shape[0], 4)),
                   "B": rng.normal(0, 0.1, (4, mod.weight.shape[1])),
                   "rank": 4, "alpha": 8.0}
            for name, mod in m.named_modules() if name.endswith("q_proj")}
    pool.register("a", spec)
    stk = pool._stacks["llama.layers.0.self_attn.q_proj"]
    ptrs = (stk.A.data_ptr(), stk.B.data_ptr(), pool.idx.data_ptr())
    slot = pool.acquire("a")
    pool.set_row(1, slot)
    assert (stk.A.data_ptr(), stk.B.data_ptr(), pool.idx.data_ptr()) == ptrs
    assert stk.A.device.type == "cuda" and stk.A.dtype == torch.bfloat16
    assert pool.idx.device.type == "cuda" and pool.idx.tolist() == [0, slot]
    want = torch.from_numpy(spec["llama.layers.0.self_attn.q_proj"]["A"]) \
        .to(torch.bfloat16)
    assert torch.equal(stk.A[slot, :, :4].cpu(), want)
    assert not stk.A[slot, :, 4:].any() and not stk.A[0].any()
    ids = torch.randint(0, 512, (2, 3), device=card)
    before = kl.lora_delta.launches
    with torch.no_grad():
        base = m(ids)
        with pool.activate():
            adapted = m(ids)
    assert kl.lora_delta.launches == before + 7 * 2   # 7 projections a layer
    assert torch.equal(adapted[0], base[0])           # row 0: slot 0
    assert not torch.equal(adapted[1], base[1])


# ---------------------------------------------------------------- the tick
def _tiny_llama(device, seed=5, dtype=torch.float32):
    return LlamaForCausalLM(llama_config("tiny", max_seq_len=64),
                            device=device, dtype=dtype, seed=seed)


def _tick_prompts(seed=0, lens=(5, 9, 7)):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, (n,)).astype(np.int32) for n in lens]


def _serve_lane(model, cfg, subs, tick):
    """Run ``subs`` ((prompt, max_new, sampling, adapter_id)) through an
    Engine with FLAGS_compiled_tick = ``tick``: (outputs, engine)."""
    prev = tick_flags.get_flags("FLAGS_compiled_tick")
    tick_flags.set_flags({"FLAGS_compiled_tick": tick})
    try:
        with Engine(model, cfg) as eng:
            futs = [eng.submit(p, max_new_tokens=n, sampling=sp,
                               adapter_id=a) for p, n, sp, a in subs]
            outs = [f.result(timeout=300).output_ids for f in futs]
        return outs, eng
    finally:
        tick_flags.set_flags(prev)


def _mixed_subs(adapter=None):
    pa, pb, pc = _tick_prompts()
    return [(pa, 8, SamplingParams(), None),
            (pb, 8, SamplingParams(temperature=0.8, top_k=20, seed=3),
             adapter),
            (pc, 6, SamplingParams(temperature=1.0, top_p=0.9,
                                   repetition_penalty=1.3, seed=5), None),
            (pa, 5, SamplingParams(repetition_penalty=1.2), adapter)]


def _lora_spec(model, seed, rank=4, std=0.1):
    rng = np.random.default_rng(seed)
    return {n: {"A": rng.normal(0, std, (m.weight.shape[0], rank)),
                "B": rng.normal(0, std, (rank, m.weight.shape[1])),
                "rank": rank, "alpha": float(rank)}
            for n, m in model.named_modules()
            if n.rsplit(".", 1)[-1] in ("q_proj", "v_proj", "down_proj")}


@pytest.mark.cuda
def test_tick_captures_once_per_mode_and_replays_on_card(card):
    """Greedy traffic, then mixed traffic: one capture per mode, every
    decode step a replay, and a replay's launches are the model's (2L + 1
    RMS norms, L paged decodes)."""
    model = _tiny_llama(card)
    greedy = [(p, 6, SamplingParams(), None) for p in _tick_prompts()]
    cfg = ServingConfig(num_slots=2)
    with Engine(model, cfg) as eng:
        for p, n, sp, a in greedy:
            eng.generate(p, max_new_tokens=n, sampling=sp)
        futs = [eng.submit(p, max_new_tokens=n, sampling=sp)
                for p, n, sp, _ in _mixed_subs()]
        for f in futs:
            f.result(timeout=300)
        snap = eng.stats()
        graphs = eng._tick.graph_stats()
    assert set(graphs) == {"greedy", "mixed"}
    assert set(eng._tick.first_tick_ms) == set(graphs)
    assert all(cap == 1 and rep > 0 for cap, rep, _ in graphs.values())
    assert sum(rep for _, rep, _ in graphs.values()) == \
        snap["tick_compiled_hits"] == snap["decode_steps"]
    assert snap["tick_fallbacks"] == 0
    for _, _, launches in graphs.values():
        assert launches == {"rms_norm": 5, "paged_decode": 2}


def _set_tick_state(tick, cache, gen):
    """A hand-made scheduler state: three live rows at offsets 5, 17 and
    30 over pages of their own (row 1 seeded-sampled, row 2 at its length
    limit), a dead row 3 on the scratch page, random K/V in the pools."""
    st = tick._state
    n = cache.device_table.shape[1]
    table = torch.zeros_like(cache.device_table)
    table[:3] = torch.arange(1, 3 * n + 1, dtype=torch.int32).reshape(3, n)
    cache.device_table.copy_(table)
    cache.device_offsets.copy_(torch.tensor([5, 17, 30, 0]))
    for lay in cache.layers:
        lay["k_pool"].normal_(generator=gen)
        lay["v_pool"].normal_(generator=gen)
    st["alive"].copy_(torch.tensor([True, True, True, False]))
    st["last"].copy_(torch.tensor([11, 22, 33, 0]))
    st["counts"].copy_(torch.tensor([2, 0, 5, 0]))
    st["limits"].copy_(torch.tensor([50, 50, 6, 50]))
    st["eos"].fill_(-1)
    st["temp"].copy_(torch.tensor([0.0, 0.8, 0.0, 0.0]))
    st["topk"].copy_(torch.tensor([0, 20, 0, 0]))
    st["topp"].copy_(torch.tensor([1.0, 0.9, 1.0, 1.0]))
    st["pen"].copy_(torch.tensor([1.0, 1.0, 1.3, 1.0]))
    st["keys"].copy_(torch.tensor([[0, 0], [0, 3], [0, 0], [0, 0]]))


def _tick_snapshot(tick, cache):
    snap = {k: v.clone() for k, v in tick._state.items()}
    snap["offsets"] = cache.device_offsets.clone()
    for i, lay in enumerate(cache.layers):
        snap[f"k{i}"], snap[f"v{i}"] = lay["k_pool"].clone(), \
            lay["v_pool"].clone()
    return snap


def _tick_restore(tick, cache, snap):
    for k, v in tick._state.items():
        v.copy_(snap[k])
    cache.device_offsets.copy_(snap["offsets"])
    for i, lay in enumerate(cache.layers):
        lay["k_pool"].copy_(snap[f"k{i}"])
        lay["v_pool"].copy_(snap[f"v{i}"])


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["greedy", "mixed"])
def test_tick_replay_equals_eager_body_on_card(card, mode):
    """The 2-layer model's tick from one hand-made state, run as the
    eager body and as a graph replay: tokens, counts, seen, finish codes,
    offsets and the written K/V rows bit for bit."""
    model = _tiny_llama(card)
    with Engine(model, ServingConfig(num_slots=4)) as eng:
        eng.generate(_tick_prompts()[0], max_new_tokens=2)
    tick, cache = eng._tick, eng.cache
    _set_tick_state(tick, cache, torch.Generator(device=card).manual_seed(1))
    start = _tick_snapshot(tick, cache)
    with torch.no_grad():
        tick._body(mode)
        eager = _tick_snapshot(tick, cache)
        _tick_restore(tick, cache, start)
        tick._step_for(mode)()
    torch.cuda.synchronize()
    replay = _tick_snapshot(tick, cache)
    for name in eager:
        assert torch.equal(replay[name], eager[name]), name
    assert replay["offsets"].tolist() == [6, 18, 31, 0]
    assert replay["counts"].tolist() == [3, 1, 6, 0]
    assert replay["fin"].tolist() == [0, 0, 2, 0]
    assert replay["alive"].tolist() == [True, True, False, False]
    # the live rows wrote their K/V at their offsets, nothing else moved
    n = cache.device_table.shape[1]
    psz = cache.page_size
    for i in range(len(cache.layers)):
        moved = (replay[f"k{i}"] != start[f"k{i}"]).flatten(2).any(-1)
        written = {(int(p), int(r)) for p, r in moved.nonzero().tolist()}
        want = {(1 + row * n + off // psz, off % psz)
                for row, off in enumerate((5, 17, 30))}
        assert want <= written <= want | {(0, 0)}     # dead row: scratch


@pytest.mark.cuda
def test_tick_launch_counts_grow_per_replay_on_card(card):
    """A replay runs no wrapper, yet each adds its graph's launches to the
    wrappers' counts; the capture itself adds none."""
    model = _tiny_llama(card)
    with Engine(model, ServingConfig(num_slots=4)) as eng:
        eng.generate(_tick_prompts()[0], max_new_tokens=2)
    tick = eng._tick
    step = tick._step_for("greedy")
    graph = step.graph
    assert graph is not None and step.launches == {"rms_norm": 5,
                                                   "paged_decode": 2}
    _set_tick_state(tick, eng.cache,
                    torch.Generator(device=card).manual_seed(2))
    before = kernels.launch_counts()
    with torch.no_grad():
        for _ in range(3):
            step()
    after = kernels.launch_counts()
    assert {k: after[k] - before[k] for k in after
            if after[k] != before[k]} == {"rms_norm": 15, "paged_decode": 6}
    assert step.graph is graph and step.replays >= 4


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["adapters", "int8", "fp8"])
def test_tick_captures_with_adapters_and_quantized_pools_on_card(card, kv):
    """The tick with an adapter pool, int8 pools and fp8 pools: every
    decode step a replay, the tokens equal the uncompiled lane's, and the
    graphs launch the quantized decode and the LoRA delta."""
    model = _tiny_llama(card)
    kw = dict(num_slots=2)
    adapter = None
    if kv == "adapters":
        kw.update(max_adapters=2, adapter_rank_pool=4,
                  adapters={"a": _lora_spec(model, 1)})
        adapter = "a"
    else:
        kw["cache_dtype"] = kv
    subs = _mixed_subs(adapter)
    want, _ = _serve_lane(model, ServingConfig(**kw), subs, False)
    got, eng = _serve_lane(model, ServingConfig(**kw), subs, True)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    snap = eng.stats()
    assert snap["tick_compiled_hits"] == snap["decode_steps"] > 0
    assert snap["tick_fallbacks"] == 0
    kernel = {"adapters": "lora_delta", "int8": "paged_decode_int8",
              "fp8": "paged_decode_fp8"}[kv]
    for cap, rep, launches in eng._tick.graph_stats().values():
        assert cap == 1 and launches.get(kernel, 0) > 0


@pytest.mark.cuda
def test_adapter_hot_loaded_after_capture_reaches_the_replay_on_card(card):
    """The greedy graph is captured under the base request; an adapter
    registered and hot-loaded afterwards writes the stacks in place, so
    the next replays decode its tokens (those of the uncompiled lane)
    without a second capture."""
    model = _tiny_llama(card)
    cfg = ServingConfig(num_slots=2, max_adapters=2, adapter_rank_pool=8)
    p = _tick_prompts()[1]
    with Engine(model, cfg) as eng:
        base = eng.generate(p, max_new_tokens=8).output_ids
        eng.register_adapter("b", _lora_spec(model, 7, rank=8, std=0.3))
        adapted = eng.generate(p, max_new_tokens=8,
                               adapter_id="b").output_ids
        graphs = eng._tick.graph_stats()
        loaded = eng.stats()["adapters_loaded"]
    assert loaded == 1 and not np.array_equal(adapted, base)
    assert graphs["greedy"][0] == 1 and graphs["greedy"][1] >= 14
    tick_flags.set_flags({"FLAGS_compiled_tick": False})
    try:
        with Engine(model, cfg) as eng:
            eng.register_adapter("b", _lora_spec(model, 7, rank=8, std=0.3))
            want = eng.generate(p, max_new_tokens=8,
                                adapter_id="b").output_ids
    finally:
        tick_flags.set_flags({"FLAGS_compiled_tick": True})
    np.testing.assert_array_equal(adapted, want)


@pytest.mark.cuda
def test_adam_device_scalars_and_skip_flag_on_card(card):
    """The kernel reads [lr, bc1, bc2] from the device (`adam_scalars` of a
    device step counter) and equals its plain version bit for bit; with
    the skip flag set neither writes anything; with it clear both equal
    the flagless update."""
    g = torch.Generator(device=card).manual_seed(9)
    n = 4096 + 5
    w = torch.randn(n, device=card, generator=g)
    m1 = 1e-2 * torch.randn(n, device=card, generator=g)
    m2 = 1e-4 * torch.rand(n, device=card, generator=g)
    grad = torch.randn(n, device=card, generator=g).bfloat16()
    scal = adam.adam_scalars(torch.full((), 1e-3, device=card),
                             torch.full((), 7.0, device=card), 0.9, 0.999)
    assert scal.device.type == "cuda" and scal.dtype == torch.float32
    hyper = dict(b1=0.9, b2=0.999, eps=1e-8, wd=0.01, decoupled=True)

    def state():
        return [w.clone(), grad, m1.clone(), m2.clone(),
                torch.empty(n, device=card, dtype=torch.bfloat16)]
    plain = state()
    adam.adam_update(*plain[:4], plain[4], scal, **hyper)
    for flag in (True, False):
        skip = torch.full((), flag, device=card)
        for fn in (adam.adam_update, adam.adam_update_ref):
            got = state()
            fn(*got[:4], got[4], scal, skip=skip, **hyper)
            for a, b, o in zip(got[:4], plain[:4], state()[:4]):
                assert torch.equal(a, o if flag else b), (fn, flag)
    ref = state()
    adam.adam_update_ref(*ref[:4], ref[4], scal, **hyper)
    for a, b in zip(plain, ref):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_flash_seed_from_device_memory_on_card(card):
    """The dropout seed (2^31 + 3) as a host int and as a 0-dim device
    int64 gives the same forward, dK/dV and dQ bits; seed + 1 gives
    another forward; a seed tensor of another dtype or shape raises."""
    q, k, v, do = _attn_inputs(card, 2, 4, 4, 200, 64, torch.bfloat16, True,
                               12)
    seed = 2 ** 31 + 3

    def run(sd):
        out, lse = fa.flash_attention_fwd(q, k, v, True, None, True,
                                          dropout=0.1, seed=sd)
        return (out, lse) + fa.flash_attention_bwd(
            q, k, v, out, lse, do, True, None, True, dropout=0.1, seed=sd)
    host = run(seed)
    on_card = torch.full((), seed, dtype=torch.int64, device=card)
    for a, b in zip(run(on_card), host):
        assert torch.equal(a, b)
    other = run(on_card + 1)
    assert not torch.equal(other[0], host[0])
    for bad in (on_card.to(torch.int32), on_card.reshape(1)):
        with pytest.raises(ValueError, match="0-dim int64"):
            run(bad)


def _tiny_gpt_lane(card, compiled, batches, dtype=torch.float32,
                   scaler_kw=None, sched=False, accum=1, recompute=False):
    """A 2-layer GPT (D 64) with attention and residual dropout 0.1 built
    on the card from seed 4 (``recompute``: each block under activation
    recompute): eager or compiled over ``batches``; returns (losses, step
    counters, parameters and optimizer state, scaler state, the step
    object)."""
    cfg = GPTConfig(vocab_size=512, hidden_size=128, num_layers=2,
                    num_heads=2, max_seq_len=64, attn_dropout=0.1,
                    dropout=0.1, use_recompute=recompute)
    model = GPTForCausalLM(cfg, device=card, seed=4)
    opt = AdamW(learning_rate=1e-3, parameters=model.parameters(),
                grad_clip=ClipGradByGlobalNorm(1.0))
    if dtype != torch.float32:
        model, opt = amp.decorate(model, opt, level="O2", dtype=dtype)
    schedule = lrs.StepDecay(1e-3, step_size=1, gamma=0.5) if sched else None
    if schedule is not None:
        opt.set_lr_scheduler(schedule)
    scaler = amp.GradScaler(**scaler_kw) if scaler_kw else None
    opt._ensure_state()

    def fwd(x, y):
        loss = model(x, labels=y)[1]
        return loss * torch.where(y[0, 0] == -100, 1e4, 1.0)
    cs = CompiledTrainStep(fwd, opt, scaler=scaler, network=model,
                           accumulate_grad_batches=accum)
    losses, steps = [], []
    for i, (x, y) in enumerate(batches):
        update = (i + 1) % accum == 0
        if compiled:
            loss = cs(x, y, update)
        else:
            loss = cs._default_eager_step(x, y, update)
        if schedule is not None and update:
            schedule.step()
        losses.append(loss.detach().float().reshape(1))
        steps.append(opt._step_tensor.clone())
    cs.sync_scaler()
    state = [p.detach().clone() for p in model.parameters()]
    state += [v.clone() for vals in opt._state.values() for v in vals
              if v is not None]
    return (torch.cat(losses), torch.stack(steps), state,
            scaler.state_dict() if scaler else None, cs)


def _gpt_batches(card, n, marked=None, b=2, s=64):
    rng = np.random.default_rng(6)
    out = []
    for i in range(n):
        ids = torch.from_numpy(rng.integers(0, 512, (b, s + 1))).to(card)
        x, y = ids[:, :-1].contiguous(), ids[:, 1:].contiguous()
        if i == marked:
            y[0, 0] = -100            # the loss x 1e4: fp16 overflows
        out.append((x, y))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["fp32", "fp16-scaler-skip", "accum"])
def test_compiled_train_step_replay_equals_eager_on_card(card, case):
    """Replays equal the eager step bit for bit: losses, step counters,
    every parameter, moment and master; with attention and residual
    dropout (the flash seeds refilled, the dropout generator registered);
    in fp16 under a GradScaler whose fourth step overflows (skipped: the
    counter stays, the scale halves from 2^17 to 2^16 and grows back
    after two good steps, ``sync_scaler`` equals the eager scaler); with
    two-batch accumulation (a micro graph and a full graph)."""
    kw = {"fp32": dict(),
          "fp16-scaler-skip": dict(dtype=torch.float16, sched=True,
                                   scaler_kw=dict(init_loss_scaling=2.0 ** 16,
                                                  incr_every_n_steps=2)),
          "accum": dict(accum=2)}[case]
    batches = _gpt_batches(card, 6, marked=3 if "scaler_kw" in kw else None)
    eager = _tiny_gpt_lane(card, False, batches, **kw)
    fallbacks = _jit_fallbacks()
    comp = _tiny_gpt_lane(card, True, batches, **kw)
    cs = comp[4]
    assert cs.compiled and _jit_fallbacks() == fallbacks, cs.fallback_reason
    assert torch.equal(eager[0], comp[0]) and torch.equal(eager[1], comp[1])
    for a, b in zip(eager[2], comp[2]):
        assert torch.equal(a, b)
    assert eager[3] == comp[3]
    stats = cs.graph_stats()
    assert all(c == 1 for c, _, _ in stats.values()), stats
    assert len(stats) == (2 if case == "accum" else 1), stats
    if "scaler_kw" in kw:
        st = comp[1].tolist()
        assert st[3] == st[2] and st[4] == st[2] + 1, st
        assert comp[3] == {"scale": 2.0 ** 17, "good_steps": 0,
                           "bad_steps": 0}, comp[3]


@pytest.mark.cuda
def test_compiled_train_step_schedule_and_loss_on_card(card):
    """A scheduler's new rate reaches the next replay (the device lr
    scalar is rewritten before it), and the loss returned by replay n
    survives replay n + 1 (a clone of the graph's output)."""
    batches = _gpt_batches(card, 5)
    cfg = GPTConfig(vocab_size=512, hidden_size=128, num_layers=2,
                    num_heads=2, max_seq_len=64)
    model = GPTForCausalLM(cfg, device=card, seed=4)
    sched = lrs.StepDecay(1e-2, step_size=1, gamma=0.1)
    opt = AdamW(learning_rate=sched, parameters=model.parameters())
    cs = CompiledTrainStep(lambda x, y: model(x, labels=y)[1], opt)
    held, deltas = [], []
    for x, y in batches:
        before = model.gpt.wte.weight.detach().clone()
        loss = cs(x, y)
        held.append((loss, loss.item()))
        deltas.append(float((model.gpt.wte.weight.detach() - before).abs()
                            .max()))
        assert float(opt._lr_tensor) == np.float32(sched.last_lr)
        sched.step()
    assert cs.compiled
    for loss, value in held:
        assert loss.item() == value
    assert len({v for _, v in held}) == len(held)
    # each replay's step ~ lr: a tenth of the previous one's
    for a, b in zip(deltas[1:], deltas[2:]):
        assert b < 0.3 * a, deltas


@pytest.mark.cuda
@pytest.mark.parametrize("g_dtype", [torch.bfloat16, torch.float16,
                                     torch.float32])
def test_adam_clip_scale_on_card(card, g_dtype):
    """The global-norm clip's scale as the fourth device scalar: the
    kernel loads ``float(G(float(g) * gscale))`` and equals its plain
    version bit for bit, and the clip applied first (``(g.float() *
    s).to(G)``) followed by the unclipped update; ``gscale`` 1 is the
    update without a scale."""
    g = torch.Generator(device=card).manual_seed(10)
    n = 4096 * 3 + 7
    w = torch.randn(n, device=card, generator=g)
    m1 = 1e-2 * torch.randn(n, device=card, generator=g)
    m2 = 1e-4 * torch.rand(n, device=card, generator=g)
    grad = torch.randn(n, device=card, generator=g).to(g_dtype)
    lr = torch.full((), 1e-3, device=card)
    step = torch.full((), 4.0, device=card)
    gs = torch.full((), 0.2917, device=card)
    hyper = dict(b1=0.9, b2=0.999, eps=1e-8, wd=0.01, decoupled=True)
    p_dtype = torch.bfloat16 if g_dtype == torch.float32 else g_dtype

    def state(gr=grad):
        return [w.clone(), gr, m1.clone(), m2.clone(),
                torch.empty(n, device=card, dtype=p_dtype)]
    runs = []
    for fn, gr, s in ((adam.adam_update, grad, gs),
                      (adam.adam_update_ref, grad, gs),
                      (adam.adam_update, (grad.float() * gs).to(g_dtype),
                       None)):
        st = state(gr)
        fn(*st, adam.adam_scalars(lr, step, 0.9, 0.999, gscale=s), **hyper)
        runs.append(st)
    for other in runs[1:]:
        for i in (0, 2, 3, 4):
            assert torch.equal(runs[0][i], other[i]), i
    one, none = state(), state()
    adam.adam_update(*one, adam.adam_scalars(
        lr, step, 0.9, 0.999, gscale=torch.ones((), device=card)), **hyper)
    adam.adam_update(*none, adam.adam_scalars(lr, step, 0.9, 0.999),
                     **hyper)
    for i in (0, 2, 3, 4):
        assert torch.equal(one[i], none[i])
    assert not torch.equal(one[0], runs[0][0])


OTHER_OPTIMIZERS = {
    "SGD": lambda ps, clip: optim.SGD(0.1, parameters=ps, grad_clip=clip,
                                      weight_decay=0.01),
    "Momentum": lambda ps, clip: optim.Momentum(
        0.05, 0.9, parameters=ps, use_nesterov=True, grad_clip=clip),
    "Adagrad": lambda ps, clip: optim.Adagrad(
        0.05, parameters=ps, initial_accumulator_value=0.1, grad_clip=clip),
    "RMSProp": lambda ps, clip: optim.RMSProp(
        1e-3, centered=True, momentum=0.9, parameters=ps, grad_clip=clip),
    "Adadelta": lambda ps, clip: optim.Adadelta(1.0, parameters=ps,
                                                grad_clip=clip),
    "Adamax": lambda ps, clip: optim.Adamax(1e-3, parameters=ps,
                                            grad_clip=clip),
    "Lamb": lambda ps, clip: optim.Lamb(1e-3, parameters=ps, grad_clip=clip),
}


def _optimizer_lane(card, name, dtype, compiled, batches):
    """The tiny GPT of `_tiny_gpt_lane` (attention and residual dropout
    0.1, seed 4) under optimizer ``name`` with a global-norm clip of 0.5
    (its scale < 1): eager or compiled; (losses, state, the step)."""
    cfg = GPTConfig(vocab_size=512, hidden_size=128, num_layers=2,
                    num_heads=2, max_seq_len=64, attn_dropout=0.1,
                    dropout=0.1)
    model = GPTForCausalLM(cfg, device=card, seed=4)
    opt = OTHER_OPTIMIZERS[name](model.parameters(),
                                 ClipGradByGlobalNorm(0.5))
    if dtype != torch.float32:
        model, opt = amp.decorate(model, opt, level="O2", dtype=dtype)
    opt._ensure_state()
    cs = CompiledTrainStep(lambda x, y: model(x, labels=y)[1], opt,
                           network=model)
    losses = []
    for x, y in batches:
        loss = cs(x, y) if compiled else cs._default_eager_step(x, y, True)
        losses.append(loss.detach().float().reshape(1))
    state = [p.detach().clone() for p in model.parameters()]
    state += [v.clone() for vals in opt._state.values() for v in vals
              if v is not None]
    return torch.cat(losses), state, cs


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(OTHER_OPTIMIZERS))
def test_optimizer_compiled_replay_equals_eager_on_card(card, name, dtype):
    """Each optimizer besides Adam/AdamW under `CompiledTrainStep`: one
    capture, and replays equal to the eager step bit for bit (losses,
    parameters, every state tensor, fp32 masters in bf16)."""
    batches = _gpt_batches(card, 5)
    eager = _optimizer_lane(card, name, dtype, False, batches)
    fallbacks = _jit_fallbacks()
    comp = _optimizer_lane(card, name, dtype, True, batches)
    cs = comp[2]
    assert cs.compiled and _jit_fallbacks() == fallbacks, cs.fallback_reason
    assert [c for c, _, _ in cs.graph_stats().values()] == [1]
    assert torch.isfinite(eager[0]).all()
    assert torch.equal(eager[0], comp[0])
    for a, b in zip(eager[1], comp[1]):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_lbfgs_on_card_falls_back_with_one_warning(card):
    """LBFGS steps on the card (the loss falls over 2 closure steps);
    `CompiledTrainStep` falls back for it with one warning."""
    cfg = GPTConfig(vocab_size=512, hidden_size=128, num_layers=2,
                    num_heads=2, max_seq_len=64)
    model = GPTForCausalLM(cfg, device=card, seed=4)
    (x, y), = _gpt_batches(card, 1)
    opt = optim.LBFGS(learning_rate=1.0, max_iter=4, history_size=5,
                      line_search_fn="strong_wolfe",
                      parameters=model.parameters())

    def closure():
        opt.clear_grad()
        loss = model(x, labels=y)[1]
        loss.backward()
        return loss
    first = float(closure())
    for _ in range(2):
        opt.step(closure)
    assert float(closure()) < first
    with pytest.warns(UserWarning, match="LBFGS.step is overridden") as rec:
        cs = CompiledTrainStep(lambda a, b: model(a, labels=b)[1], opt,
                               network=model)
    assert len(rec) == 1 and not cs.compiled


@pytest.mark.cuda
def test_capture_keeps_garbage_collection_out_on_card(card):
    """A CUDA graph left in a reference cycle is destroyed when the
    garbage collector finds it; a collection inside another graph's
    capture destroyed one there and invalidated the capture (the card
    tests' full run failed so, in the schedule test above).  `CapturedStep`
    keeps the collector off during the capture: the captured forward
    sees it off, leaves a graph in a new cycle (collected at every
    allocation otherwise), and the step captures, replays and turns the
    collector back on; the cycle goes after the capture."""
    import gc
    import weakref
    x = torch.zeros(4, device=card)
    stale = torch.cuda.CUDAGraph()
    with torch.cuda.graph(stale):
        x.add_(1.0)
    stale.replay()
    gone = weakref.ref(stale)
    holder = [stale]
    del stale
    seen = []
    cfg = GPTConfig(vocab_size=512, hidden_size=128, num_layers=2,
                    num_heads=2, max_seq_len=64)
    model = GPTForCausalLM(cfg, device=card, seed=4)
    opt = AdamW(learning_rate=1e-3, parameters=model.parameters())

    def fwd(a, b):
        if torch.cuda.is_current_stream_capturing():
            seen.append(gc.isenabled())
            cycle = [holder.pop()]
            cycle.append(cycle)             # unreachable at return
        return model(a, labels=b)[1]
    cs = CompiledTrainStep(fwd, opt)
    old = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    try:
        for a, b in _gpt_batches(card, 3):
            loss = cs(a, b)
    finally:
        gc.set_threshold(*old)
    assert seen == [False]
    assert cs.compiled and torch.isfinite(loss).all()
    assert [c for c, _, _ in cs.graph_stats().values()] == [1]
    assert gc.isenabled()
    gc.collect()
    assert gone() is None


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_recompute_equals_plain_eager_and_compiled_on_card(card, dtype):
    """`use_recompute` with attention and residual dropout 0.1: eager and
    compiled lanes with recompute equal the eager lane without it bit for
    bit (losses, counters, parameters, moments, masters); the recompute
    runs each block's flash forward twice a step and its backward once."""
    batches = _gpt_batches(card, 4)
    plain = _tiny_gpt_lane(card, False, batches, dtype=dtype)
    kernels.reset_launch_counts()
    eager = _tiny_gpt_lane(card, False, batches, dtype=dtype,
                           recompute=True)
    counts = kernels.launch_counts()
    fallbacks = _jit_fallbacks()
    comp = _tiny_gpt_lane(card, True, batches, dtype=dtype, recompute=True)
    assert comp[4].compiled and _jit_fallbacks() == fallbacks
    for lane in (eager, comp):
        assert torch.equal(lane[0], plain[0]) and \
            torch.equal(lane[1], plain[1])
        for a, b in zip(lane[2], plain[2]):
            assert torch.equal(a, b)
    n = 2 * len(batches)                    # 2 layers a step
    assert counts["flash_fwd_dropout"] == 2 * n, counts
    assert counts["flash_bwd_dq_dropout"] == n, counts
    assert all(c == 1 for c, _, _ in comp[4].graph_stats().values())


@pytest.mark.cuda
def test_flash_trainable_mask_gradient_on_card(card):
    """A learned bias that requires grad, bf16 q/k/v at GPT-2's head dim:
    the op takes the plain version (no kernel launch, ``plain_routes``
    counted), and the bias gets the gradient of an fp64 autograd reference
    on the same bf16 inputs and the same bf16 gradient of the output (the
    plain version's fp32 sums: 1e-4 relative, 1e-5 absolute); the output
    is rounded to bf16 once."""
    g = torch.Generator(device=card).manual_seed(9)
    b, s, h, d = 2, 128, 4, 64
    q, k, v, do = (torch.randn(b, s, h, d, device=card, generator=g)
                   for _ in range(4))
    bias = torch.randn(1, h, s, s, device=card, generator=g)
    before = kernels.launch_counts()
    routes = fa.flash_attention.plain_routes
    tb = bias.clone().requires_grad_(True)
    out = fa.flash_attention(q.bfloat16(), k.bfloat16(), v.bfloat16(),
                             attn_mask=tb, causal=True)
    (out.float() * do).sum().backward()
    assert kernels.launch_counts() == before
    assert fa.flash_attention.plain_routes == routes + 1
    ref_b = bias.double().requires_grad_(True)
    qd, kd, vd = (t.bfloat16().double().transpose(1, 2) for t in (q, k, v))
    logits = qd @ kd.transpose(-1, -2) / d ** 0.5
    logits = logits.masked_fill(
        ~torch.ones(s, s, dtype=torch.bool, device=card).tril(),
        float("-inf")) + ref_b
    ref = (torch.softmax(logits, dim=-1) @ vd).transpose(1, 2)
    # out is bf16, so the gradient reaching it is do rounded to bf16
    (ref * do.bfloat16().double()).sum().backward()
    torch.testing.assert_close(out.double(), ref, rtol=1e-2, atol=1e-2)
    torch.testing.assert_close(tb.grad.double(), ref_b.grad, rtol=1e-4,
                               atol=1e-5)


def _gpt_on(card, cfg, seed):
    cpu = GPTForCausalLM(cfg, device="cpu", seed=seed).eval()
    on_card = GPTForCausalLM(cfg, device=card, seed=seed).eval()
    on_card.load_state_dict(cpu.state_dict())
    return cpu, on_card


@pytest.mark.cuda
def test_gpt_engine_on_card_equals_cpu(card):
    """The tiny GPT (fp32) behind the engine with the compiled tick on the
    card and on the CPU: greedy and seeded tokens equal; with int8 pools
    under a 2-adapter pool too, the adapter request differing from the
    base one; the card runs launch paged decode (float and int8) and the
    LoRA delta."""
    cfg = GPTConfig(vocab_size=512, hidden_size=128, num_layers=2,
                    num_heads=2, max_seq_len=64)
    cpu, on_card = _gpt_on(card, cfg, 3)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 512, (n,)).astype(np.int32)
               for n in (5, 40, 23)]
    subs = [(p, SamplingParams()) for p in prompts] + [
        (prompts[1], SamplingParams(temperature=0.8, top_k=50, seed=3))]
    spec = {n: {"A": rng.normal(0, 0.1, (m.weight.shape[0], 4)),
                "B": rng.normal(0, 0.1, (4, m.weight.shape[1])),
                "rank": 4, "alpha": 4.0}
            for n, m in cpu.named_modules()
            if n.rsplit(".", 1)[-1] in ("qkv_proj", "out_proj", "fc_in",
                                         "fc_out")}
    runs = {}
    for label, model in (("cpu", cpu), ("card", on_card)):
        kernels.reset_launch_counts()
        with Engine(model, ServingConfig(num_slots=4)) as eng:
            outs = [eng.submit(p, max_new_tokens=6, sampling=sp)
                    for p, sp in subs]
            outs = [f.result(timeout=300).output_ids for f in outs]
            st = eng.stats()
        assert st["tick_compiled_hits"] == st["decode_steps"] > 0
        kv = ServingConfig(num_slots=2, cache_dtype="int8", max_adapters=2,
                           adapter_rank_pool=4, adapters={"a": spec})
        with Engine(model, kv) as eng:
            futs = [eng.submit(prompts[1], max_new_tokens=6, adapter_id=a)
                    for a in (None, "a")]
            outs += [f.result(timeout=300).output_ids for f in futs]
        runs[label] = (outs, kernels.launch_counts())
    for a, b in zip(runs["cpu"][0], runs["card"][0]):
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(runs["card"][0][-2], runs["card"][0][-1])
    counts = runs["card"][1]
    assert min(counts["paged_decode"], counts["paged_decode_int8"],
               counts["lora_delta"]) > 0, counts


@pytest.mark.cuda
def test_generation_on_card_equals_cpu(card):
    """fp32 tiny GPT and GQA Llama: `generate` (cache and full forward),
    `speculative_generate` (K 3, a 1-layer draft) and `beam_search` give
    the same ids on the card as on the CPU, and the card's dense caches
    hold the kv heads only."""
    from paddle_tpu_torch.models import generation
    cfg = GPTConfig(vocab_size=512, hidden_size=128, num_layers=2,
                    num_heads=2, max_seq_len=64)
    cpu, on_card = _gpt_on(card, cfg, 5)
    dcfg = GPTConfig(vocab_size=512, hidden_size=128, num_layers=1,
                     num_heads=2, max_seq_len=64)
    d_cpu, d_card = _gpt_on(card, dcfg, 6)
    ids = torch.from_numpy(np.random.default_rng(3).integers(0, 512, (2, 9)))
    for a, b in ((cpu, on_card),):
        want = a.generate(ids, 8)
        assert torch.equal(b.generate(ids.to(card), 8).cpu(), want)
        assert torch.equal(b.generate(ids.to(card), 8,
                                      use_cache=False).cpu(), want)
        assert torch.equal(generation.speculative_generate(
            b, d_card, ids.to(card), 8, speculation_k=3).cpu(), want)
        assert torch.equal(generation.beam_search(b, ids.to(card), 4).cpu(),
                           generation.beam_search(a, ids, 4))
    lcfg = llama_config("tiny", max_seq_len=64)
    l_cpu = LlamaForCausalLM(lcfg, device="cpu", seed=7).eval()
    l_card = LlamaForCausalLM(lcfg, device=card, seed=7).eval()
    l_card.load_state_dict(l_cpu.state_dict())
    caches = generation.init_kv_caches(lcfg.num_layers, 2, 17,
                                       lcfg.num_kv_heads, lcfg.head_dim,
                                       device=card)
    assert caches[0]["k"].shape == (2, 17, 2, lcfg.head_dim)
    assert torch.equal(l_card.generate(ids.to(card), 8).cpu(),
                       l_cpu.generate(ids, 8))


# ---- the training runtime on the card ----

class _Ids:
    def __init__(self, n, seq, vocab=512, seed=0):
        rng = np.random.default_rng(seed)
        self.rows = rng.integers(0, vocab, (n, seq + 1))

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, i):
        return self.rows[i, :-1], self.rows[i, 1:]


@pytest.mark.cuda
def test_device_prefetch_equals_host_batches_under_a_busy_stream(card):
    """200 prefetched batches equal the host batches while a long matmul
    chain keeps the consumer's stream busy and each batch is read on that
    stream after the chain (the memory ``record_stream`` keeps).  A busy
    consumer hides a missing wait on the copy's event: the next test
    holds that wait."""
    from paddle_tpu_torch import data as D
    mk = lambda: D.pipeline(_Ids(800, 255)).shuffle(seed=1).batch(4)  # noqa
    host = [tuple(t.clone() for t in b) for b in mk()]
    pipe = mk().device_prefetch(3)
    a = torch.randn(2048, 2048, device=card)
    got = []
    for x, y in pipe:
        for _ in range(8):                 # the step the copy overlaps
            a = torch.tanh(a @ a)
        got.append((x + 0, y + 0))         # read on the current stream
    assert len(got) == len(host) == 200
    for (gx, gy), (hx, hy) in zip(got, host):
        assert gx.device.type == "cuda"
        assert torch.equal(gx.cpu(), hx) and torch.equal(gy.cpu(), hy)
    assert pipe.goodput.batches == 200


@pytest.mark.cuda
def test_device_prefetch_waits_for_a_slow_copy_on_an_idle_stream(
        card, monkeypatch):
    """Each copy is held back on the side stream by a sleep kernel queued
    before it (~15 ms a call, three calls a batch), and the consumer reads
    each batch at once on its idle stream: the batches still equal the
    host batches, because that stream waits on the copy's event.  Without
    the wait the first read takes memory not yet written."""
    from paddle_tpu_torch import data as D
    from paddle_tpu_torch.data import prefetch
    copy = prefetch.to_device_batch

    def slow(batch, device, non_blocking=False):
        torch.cuda._sleep(30_000_000)      # on the producer's side stream
        return copy(batch, device, non_blocking)

    monkeypatch.setattr(prefetch, "to_device_batch", slow)
    mk = lambda: D.pipeline(_Ids(80, 255, seed=4)).shuffle(seed=2).batch(4)  # noqa
    host = [tuple(t.clone() for t in b) for b in mk()]
    torch.cuda.synchronize()
    got = [(x + 0, y + 0) for x, y in mk().device_prefetch(2)]
    assert len(got) == len(host) == 20
    for (gx, gy), (hx, hy) in zip(got, host):
        assert torch.equal(gx.cpu(), hx) and torch.equal(gy.cpu(), hy)


def _hapi_gpt(card, seed=0):
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.nn import CrossEntropyLoss
    cfg = GPTConfig(vocab_size=512, hidden_size=128, num_layers=2,
                    num_heads=4, max_seq_len=128)
    net = GPTForCausalLM(cfg, device=card, seed=seed)
    return Model(net).prepare(AdamW(1e-3, parameters=net.parameters()),
                              CrossEntropyLoss(), amp_configs="O2")


@pytest.mark.cuda
def test_async_model_checkpoint_holds_its_step_on_card(card, tmp_path):
    """An async checkpoint of a compiled model holds the state of the
    step it was taken at although 3 replays run before its thread ends;
    its payload equals a synchronous save of that state."""
    from paddle_tpu_torch.hapi import ModelCheckpoint
    from paddle_tpu_torch.framework.checkpoint_manager import \
        CheckpointManager
    model = _hapi_gpt(card)
    ds = _Ids(8, 128)
    x, y = (torch.from_numpy(np.stack(v)).to(card)
            for v in zip(*[ds[i] for i in range(4)]))
    for _ in range(3):
        model.train_batch([x], [y])
    cb = ModelCheckpoint(save_dir=str(tmp_path / "async"), async_save=True)
    cb.set_model(model)
    gate = __import__("threading").Event()
    state, ready = cb._state(next_epoch=1)
    want = {k: v.detach().clone().cpu()
            for k, v in model.network.state_dict().items()}
    cb.manager.save(state, before_write=lambda: (gate.wait(),
                                                 ready.synchronize()))
    for _ in range(3):                     # replays while the save waits
        model.train_batch([x], [y])
    torch.cuda.synchronize()
    gate.set()
    cb.manager.wait()
    got, _ = CheckpointManager(str(tmp_path / "async"),
                               map_location="cpu").restore_latest()
    for k, v in want.items():
        assert torch.equal(got["model"][k].view(torch.int16),
                           v.view(torch.int16)), k
    changed = [k for k, v in model.network.state_dict().items()
               if not torch.equal(v.cpu(), want[k])]
    assert changed                         # training moved on
    assert model._compiled_step.compiled


@pytest.mark.cuda
def test_model_fit_compiled_step_captures_once(card):
    from paddle_tpu_torch import data as D
    model = _hapi_gpt(card)
    pipe = D.pipeline(_Ids(24, 128)).shuffle(seed=0).batch(4) \
        .device_prefetch(2)
    fallbacks = _jit_fallbacks()
    hist = model.fit(pipe, epochs=2, verbose=0, log_freq=1)
    cs = model._compiled_step
    assert cs.compiled and _jit_fallbacks() == fallbacks
    assert cs.fallback_reason is None
    stats = cs.graph_stats()
    assert len(stats) == 1
    (captures, replays, _), = stats.values()
    assert captures == 1 and replays == 11    # 12 steps, call 1 eager
    assert all(np.isfinite(hist["loss"]))


@pytest.mark.cuda
def test_load_map_location_none_lands_on_cuda(card, tmp_path):
    import paddle_tpu_torch as pt
    pt.save({"w": torch.ones(3).bfloat16(), "n": 1}, str(tmp_path / "s"))
    out = pt.load(str(tmp_path / "s"))
    assert out["w"].device.type == "cuda" and out["w"].dtype == \
        torch.bfloat16 and out["n"] == 1


def _sentinel_gpt(card, dropout=0.1):
    """A 2-layer GPT with dropout behind hapi.Model, with the training
    sentinel installed as fit installs it (the unit-scale scaler and a
    compiled step with the health output)."""
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.nn import CrossEntropyLoss
    cfg = GPTConfig(vocab_size=512, hidden_size=128, num_layers=2,
                    num_heads=4, max_seq_len=128, dropout=dropout,
                    attn_dropout=dropout)
    net = GPTForCausalLM(cfg, device=card, seed=0)
    model = Model(net).prepare(AdamW(1e-3, parameters=net.parameters()),
                               CrossEntropyLoss(), amp_configs="O2")
    saved = tick_flags.get_flags(["FLAGS_sentinel"])
    tick_flags.set_flags({"FLAGS_sentinel": True})
    try:
        model._install_sentinel(None)
    finally:
        tick_flags.set_flags(saved)
    return model


def _id_batches(card, n, seed=0):
    ds = _Ids(4 * n, 128, seed=seed)
    return [tuple(torch.from_numpy(np.stack(v)).to(card)
                  for v in zip(*[ds[4 * i + j] for j in range(4)]))
            for i in range(n)]


@pytest.mark.cuda
def test_sentinel_restore_into_the_graph_on_card(card):
    """A rollback writes the anchor into the tensors the captured graphs
    read (parameters, masters, moments, step, the scaler vector) and puts
    the generators back: the replays after it give the losses of the
    replays after the snapshot, bit for bit, with dropout on and no new
    capture (both graphs, the full and the cadence one, exist before the
    snapshot; the cadence falls on other steps after the restore, which
    changes no loss: the health pass writes nothing the update reads)."""
    model = _sentinel_gpt(card)
    batches = _id_batches(card, 14)
    fallbacks = _jit_fallbacks()
    for x, y in batches[:10]:
        model.train_batch([x], [y])
    cs = model._compiled_step
    svec_ptr = cs._svec.data_ptr()
    state = model._sentinel_snapshot()
    first = [model.train_batch([x], [y])[0] for x, y in batches[10:]]
    stats = {k: v[0] for k, v in cs.graph_stats().items()}
    model._sentinel_restore(state)
    again = [model.train_batch([x], [y])[0] for x, y in batches[10:]]
    assert again == first and all(np.isfinite(first))
    assert model._compiled_step is cs and cs._svec.data_ptr() == svec_ptr
    assert {k: v[0] for k, v in cs.graph_stats().items()} == stats
    assert len(stats) == 2 and all(n == 1 for n in stats.values())
    assert _jit_fallbacks() == fallbacks


@pytest.mark.cuda
def test_sentinel_health_per_call_on_card(card):
    """Each full call's health vector is its own tensor: read after ten
    calls, record k still holds call k's values (-1 off the cadence, the
    squared norm on call 9; the NaN batch of call 6 flagged and its update
    skipped)."""
    model = _sentinel_gpt(card, dropout=0.0)
    cs = None
    records = []
    batches = _id_batches(card, 10, seed=1)
    for i, (x, y) in enumerate(batches):
        if i == 5:
            w = model.network.gpt.wte.weight.detach().clone()
            with torch.no_grad():         # a NaN embedding row for this batch
                model.network.gpt.wte.weight[int(x[0, 0])] = float("nan")
            model._train_batch_device([x], [y])
            with torch.no_grad():
                model.network.gpt.wte.weight.copy_(w)
        else:
            model._train_batch_device([x], [y])
        cs = model._compiled_step
        records.append(cs.last_health)
    assert records[0] is None              # call 1 is eager
    vals = [r.tolist() for r in records[1:]]
    ptrs = {r.data_ptr() for r in records[1:]}
    assert len(ptrs) == 9
    for call, (gsq, skipped) in enumerate(vals, start=2):
        if call == 9:
            assert gsq > 0 and np.isfinite(gsq)
        elif call != 6:
            assert gsq == -1.0
        assert skipped == (1.0 if call == 6 else 0.0), (call, vals)
    assert all(n == 1 for _, (n, _r, _l) in cs.graph_stats().items())


@pytest.mark.cuda
def test_step_metrics_read_the_device_step_on_card(card):
    """StepMetrics times the device step with CUDA events read a step
    later: a step whose host call returns at once but whose kernel runs
    ~20 ms reads ~20 ms, not the launch time, and the pending steps are
    read without a host sync until ``flush``."""
    from paddle_tpu_torch.observability import MetricsRegistry, StepMetrics
    sm = StepMetrics(prefix="card.", registry=MetricsRegistry(),
                     device=card, peak_flops=1e15)
    sm.set_flops_per_step(1e12)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    start.record()
    torch.cuda._sleep(int(2e7))
    end.record()
    end.synchronize()
    per = start.elapsed_time(end)          # ms of one sleep kernel
    cycles = int(2e7 * 20.0 / per)
    import time
    host = []
    for _ in range(4):
        t0 = time.perf_counter()
        sm.begin_step()
        torch.cuda._sleep(cycles)
        sm.end_step(examples=8, tokens=1024)
        host.append((time.perf_counter() - t0) * 1e3)
    assert sm.step_time_ms.count < 4      # not all read back yet
    snap = sm.snapshot()                   # flush: waits for the rest
    assert snap["steps"] == 4 and snap["step_time_ms"]["count"] == 4
    assert 15.0 < snap["step_time_ms"]["p50"] < 40.0, snap
    assert max(host) < 5.0, host
    mfu = 1e12 / (snap["step_time_ms"]["p50"] / 1e3) / 1e15
    assert abs(snap["mfu"] - mfu) < 0.1 * mfu
    assert snap["memory"]["device0"]["peak_bytes"] > 0


def _llama_on(card, seed, **over):
    """A tiny fp32 Llama built on the CPU and copied onto the card (the
    generators differ: a seed alone gives other weights there)."""
    cfg = llama_config("tiny", max_seq_len=64, **over)
    cpu = LlamaForCausalLM(cfg, device="cpu", seed=seed).eval()
    on_card = LlamaForCausalLM(cfg, device=card, seed=seed).eval()
    on_card.load_state_dict(cpu.state_dict())
    return cpu, on_card


@pytest.mark.cuda
def test_spec_and_slot_engines_on_card_equal_cpu_plain(card):
    """Speculation (K 3, the target as its own draft, fp32 and int8
    pools) and the slot layout on the card give the CPU plain engine's
    greedy tokens; the draft steps launch paged decode, every model call
    the RMS-norm kernel, and both caches return every page."""
    import warnings
    cpu, on_card = _llama_on(card, 4)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 512, (n,)).astype(np.int32)
               for n in (7, 30, 19)]

    def serve(model, cfg):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")   # the tick's static fallback
            with Engine(model, cfg) as eng:
                futs = [eng.submit(p, max_new_tokens=9) for p in prompts]
                outs = [f.result(timeout=300).output_ids for f in futs]
                return outs, eng.stats(), eng

    want, _, _ = serve(cpu, ServingConfig(num_slots=2))
    for kw in (dict(speculation_k=3, draft_model=on_card),
               dict(speculation_k=3, draft_model=on_card,
                    cache_dtype="int8"),
               dict(kv_layout="slots")):
        kernels.reset_launch_counts()
        got, st, eng = serve(on_card, ServingConfig(num_slots=2, **kw))
        counts = kernels.launch_counts()
        if kw.get("cache_dtype") != "int8":
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
        assert counts["rms_norm"] > 0
        if "speculation_k" in kw:
            assert st["spec_windows"] > 0
            assert st["spec_acceptance_rate"] > 0.5
            name = "paged_decode_int8" if "cache_dtype" in kw \
                else "paged_decode"
            assert counts[name] >= 2 * 3 * st["spec_windows"], counts
            assert eng.draft_cache.pages_in_use == 0
            assert eng.cache.pages_in_use == \
                eng.prefix_tree.cached_pages()


class _FailOnce(torch.nn.Module):
    """A model whose next forward raises once ``arm`` is set."""

    def __init__(self, inner):
        super().__init__()
        self.inner = inner
        self.config = inner.config
        self.arm = False

    def forward(self, ids, caches=None):
        if self.arm:
            self.arm = False
            raise RuntimeError("injected model failure")
        return self.inner(ids, caches=caches)


@pytest.mark.cuda
def test_restarts_keep_memory_flat_on_card(card):
    """Three crashes in a row, each followed by a served request through
    the rebuilt cache and a newly captured tick: the memory allocated
    after each stays within 1% of the level after the first, so the old
    cache, tick and graphs are freed before the new ones are allocated."""
    _, on_card = _llama_on(card, 4)
    model = _FailOnce(on_card)
    prompt = np.arange(1, 20, dtype=np.int32)
    eng = Engine(model, ServingConfig(num_slots=2,
                                      max_scheduler_restarts=3)).start()
    try:
        want = eng.generate(prompt, max_new_tokens=6).output_ids
        levels = []
        for _ in range(3):
            model.arm = True
            fut = eng.submit(prompt, max_new_tokens=6)
            assert "injected" in str(fut.exception(timeout=60))
            out = eng.generate(prompt, max_new_tokens=6)
            np.testing.assert_array_equal(out.output_ids, want)
            torch.cuda.synchronize()
            levels.append(torch.cuda.memory_allocated(card))
        st = eng.stats()
        assert eng._tick.steps and st["tick_compiled_hits"] > 0
    finally:
        eng.shutdown()
    assert st["scheduler_restarts"] == 3
    for lv in levels[1:]:
        assert abs(lv - levels[0]) <= 0.01 * levels[0], levels


class _HostRead(torch.nn.Module):
    """A model whose decode forward reads one value to the host."""

    def __init__(self, inner):
        super().__init__()
        self.inner = inner
        self.config = inner.config

    def forward(self, ids, caches=None):
        logits = self.inner(ids, caches=caches)
        if ids.shape[1] == 1:
            float(logits[0, -1, 0].item())
        return logits


@pytest.mark.cuda
def test_tick_falls_back_on_a_host_read_on_card(card):
    """A decode forward that reads the host: the tick's first call finds
    the read in its warm-up, latches the uncompiled lane with one
    TickFallbackWarning and counts fallbacks; no graph or side-stream
    capture is left, the requests complete with the flag-off lane's
    tokens, and the memory allocated after the run (the engine alive,
    cuBLAS's workspaces cleared) is within 1 MiB of the flag-off run's."""
    import gc
    import warnings
    from paddle_tpu_torch.serving import TickFallbackWarning
    model = _HostRead(_tiny_llama(card).eval())
    subs = [(p, 6, None, None) for p in _tick_prompts()]
    lanes = {}
    for tick in (False, True):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            outs, eng = _serve_lane(model, ServingConfig(num_slots=2), subs,
                                    tick)
        gc.collect()
        torch.cuda.synchronize()
        # torch keeps a cuBLAS workspace for each stream cuBLAS ran on; the
        # tick's warm-up ran on the engine's side stream, the flag-off run
        # on none
        torch._C._cuda_clearCublasWorkspaces()
        warned = [w for w in caught
                  if issubclass(w.category, TickFallbackWarning)]
        with torch.cuda.stream(eng._tick_stream):
            capturing = torch.cuda.is_current_stream_capturing()
        # measured with this lane's engine alive and the other lane's gone
        lanes[tick] = (outs, eng.stats(), torch.cuda.memory_allocated(card),
                       warned, eng._tick, capturing)
        del eng
    off, _, mem_off, _, _, _ = lanes[False]
    on, st, mem_on, warned, tick, capturing = lanes[True]
    assert len(warned) == 1 and "host read" in str(warned[0].message)
    assert st["tick_compiled_hits"] == 0 and st["tick_fallbacks"] > 0
    assert tick.fallback_reason is not None and tick.steps == {}
    assert not capturing
    for a, b in zip(off, on):
        np.testing.assert_array_equal(a, b)
    assert abs(mem_on - mem_off) <= 2 ** 20, (mem_on, mem_off)


@pytest.mark.cuda
def test_traced_serve_on_card(card, tmp_path):
    """Request tracing under the compiled tick on the card: every decode
    step a replay, the tokens of the untraced run, and each request's
    trace one root with its queue, prefill and decode spans, one
    decision and one winner."""
    from paddle_tpu_torch.observability import tracing
    model = _tiny_llama(card).eval()
    subs = [(p, 8, None, None) for p in _tick_prompts(seed=3)]
    want, _ = _serve_lane(model, ServingConfig(num_slots=2), subs, True)
    tracing.reset()
    tick_flags.set_flags({"FLAGS_trace_dir": str(tmp_path),
                          "FLAGS_trace_latency_threshold_ms": 0.0})
    try:
        got, eng = _serve_lane(model, ServingConfig(num_slots=2), subs, True)
        st = eng.stats()
        merged = tracing.merge_spools(str(tmp_path))
    finally:
        tick_flags.set_flags({"FLAGS_trace_dir": "",
                              "FLAGS_trace_latency_threshold_ms": 250.0})
        tracing.reset()
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a, b)
    assert st["tick_compiled_hits"] == st["decode_steps"] > 0
    assert len(merged["traces"]) == len(subs)
    for tr in merged["traces"]:
        assert tr["decision_count"] == 1
        (root,) = [s for s in tr["spans"] if s["parent"] is None]
        assert root["name"] == "engine.request" and root.get("winner")
        assert sorted(s["name"] for s in tr["spans"] if s is not root) == \
            ["engine.decode", "engine.prefill", "engine.queue"]


# ---------------------------------------------------------------------------
# the dropout hash on global indices; the collectives on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("hm", [True, False])
def test_flash_dropout_offsets_on_card(card, hm):
    """The flash kernels with the hash's batch and head offsets: offsets
    ``(0, 0, H)`` give the bits of no offsets (forward out and lse, and
    the three gradients, bit for bit); nonzero offsets against the plain
    versions with the same offsets (row by row within ROW_TOL); and the
    dp x mp parts of a global call (2 rows of 2, 4 heads of 8, each with
    its offsets) put together equal the global call bit for bit."""
    dtype = torch.bfloat16
    b, h, s, d = 4, 8, 200, 64
    q, k, v, do = _attn_inputs(card, b, h, h, s, d, dtype, hm, 31)
    feats = dict(dropout=0.1, seed=777)
    out, lse = fa.flash_attention_fwd(q, k, v, True, None, hm, **feats)
    out0, lse0 = fa.flash_attention_fwd(q, k, v, True, None, hm, **feats,
                                        offsets=(0, 0, h))
    assert torch.equal(out, out0) and torch.equal(lse, lse0)
    g = fa.flash_attention_bwd(q, k, v, out, lse, do, True, None, hm,
                               **feats)
    g0 = fa.flash_attention_bwd(q, k, v, out, lse, do, True, None, hm,
                                **feats, offsets=(0, 0, h))
    assert all(torch.equal(a, c) for a, c in zip(g, g0))
    off = (6, 8, 16)
    out1, lse1 = fa.flash_attention_fwd(q, k, v, True, None, hm, **feats,
                                        offsets=off)
    want, want_lse = fa.flash_attention_ref(q, k, v, True, None, hm,
                                            **feats, offsets=off)
    assert not torch.equal(out1, out)
    assert _row_err(out1, want) < ROW_TOL[dtype]
    torch.testing.assert_close(lse1, want_lse, rtol=1e-3, atol=1e-3)
    grads = fa.flash_attention_bwd(q, k, v, out1, lse1, do, True, None, hm,
                                   **feats, offsets=off)
    wants = fa.flash_attention_bwd_ref(q, k, v, out1, lse1, do, True, None,
                                       hm, **feats, offsets=off)
    scale = max(_rms_row_norm(w) for w in wants)
    for got, w in zip(grads, wants):
        assert _row_err(got, w, scale) < ROW_TOL[dtype]
    hd = 1 if hm else 2                      # the head dim of the layout
    for r in range(2):                       # dp rank: rows 2r, 2r + 1
        for m in range(2):                   # mp rank: heads 4m .. 4m + 3
            part = [t[2 * r:2 * r + 2].narrow(hd, 4 * m, 4)
                    for t in (q, k, v, do)]
            po, pl = fa.flash_attention_fwd(*part[:3], True, None, hm,
                                            **feats, offsets=(2 * r, 4 * m, h))
            assert torch.equal(po, out[2 * r:2 * r + 2].narrow(hd, 4 * m, 4))
            assert torch.equal(pl, lse[2 * r:2 * r + 2, 4 * m:4 * m + 4])
            pg = fa.flash_attention_bwd(*part[:3], po, pl, part[3], True,
                                        None, hm, **feats,
                                        offsets=(2 * r, 4 * m, h))
            for got, whole in zip(pg, g):
                assert torch.equal(
                    got, whole[2 * r:2 * r + 2].narrow(hd, 4 * m, 4))


@pytest.mark.cuda
def test_world_one_nccl_collectives_on_card(card, tmp_path):
    """A world of one over NCCL on the card (a child process): every
    collective of `distributed.collective` leaves its tensor as the world
    of one computes it, and a CUDA graph replays a captured all_reduce."""
    import pathlib
    import subprocess
    import sys
    root = str(pathlib.Path(__file__).resolve().parent.parent)
    script = tmp_path / "one.py"
    script.write_text(
        "import sys, torch\n"
        f"sys.path.insert(0, {root!r})\n"
        "from paddle_tpu_torch.distributed import env, collective as C\n"
        "env.init_parallel_env(backend='nccl', init_method="
        f"'file://{tmp_path}/rdzv', world_size=1, rank=0)\n"
        "x = torch.arange(4., device='cuda')\n"
        "for op in ('sum', 'max', 'min', 'prod', 'avg'):\n"
        "    C.all_reduce(x, op=op)\n"
        "assert torch.equal(x, torch.arange(4., device='cuda'))\n"
        "assert torch.equal(C.all_gather(None, x)[0], x)\n"
        "C.broadcast(x, src=0); C.reduce(x, dst=0); C.barrier()\n"
        "t = torch.arange(3, device='cuda'); C.all_reduce(t, op='avg')\n"
        "assert t.dtype == torch.float32\n"
        "g = torch.cuda.CUDAGraph(); s = torch.cuda.Stream()\n"
        "s.wait_stream(torch.cuda.current_stream())\n"
        "with torch.cuda.graph(g, stream=s):\n"
        "    x.mul_(2); C.all_reduce(x)\n"
        "g.replay(); torch.cuda.synchronize()\n"
        "assert torch.equal(x, 2 * torch.arange(4., device='cuda'))\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, str(script)], capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


@pytest.fixture
def two_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA cards")


@pytest.mark.cuda
def test_hybrid_phase_on_two_cards(two_cards):
    """chip_smoke's train-hybrid phase with a card a rank for the first
    two ranks (plain NCCL between them): (a) compiled = eager bit for bit,
    (b) within its tolerance, (c) fit = the hand lane, (d) the tokens."""
    import pathlib
    import subprocess
    import sys
    root = pathlib.Path(__file__).resolve().parent.parent
    res = subprocess.run(
        [sys.executable, str(root / "chip_smoke.py"), "--phases",
         "device,build,train-hybrid"], capture_output=True, text=True,
        timeout=1200, cwd=str(root))
    assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-4000:]


def _launch_two(tmp_path, body, env_extra, timeout=300):
    """The port's launcher (``python -m paddle_tpu_torch.distributed.launch``)
    over two ranks of ``body`` sharing the card (``FLAGS_selected_gpus``,
    NCCL's socket transport); each rank gets ``tmp_path`` as its argument
    and leaves without a process-group teardown."""
    import os
    import pathlib
    import subprocess
    import sys
    root = str(pathlib.Path(__file__).resolve().parent.parent)
    script = tmp_path / "rank.py"
    script.write_text(
        "import json, os, sys, time, torch\n"
        "from paddle_tpu_torch.distributed import collective as C\n"
        "from paddle_tpu_torch.distributed import env, watchdog\n"
        "from paddle_tpu_torch.utils.flags import set_flags\n"
        "env.init_parallel_env()\n"
        "rank, dev, out = env.get_rank(), env.current_device(), sys.argv[1]\n"
        "x = torch.ones(1 << 20, device=dev)\n"
        "C.all_reduce(x)\n"
        "torch.cuda.synchronize()\n"
        + body +
        "sys.stdout.flush(); sys.stderr.flush(); os._exit(0)\n")
    env = dict(os.environ, PYTHONPATH=root,
               FLAGS_flight_recorder_path=str(tmp_path / "fr.json"),
               **env_extra)
    return subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc_per_node", "2", "--max_restart", "0", "--log_dir",
         str(tmp_path / "logs"), str(script), str(tmp_path)],
        env=env, cwd=root, capture_output=True, text=True, timeout=timeout)


@pytest.mark.cuda
def test_guarded_nccl_all_reduce_stays_in_flight_until_its_event(card,
                                                                 tmp_path):
    """NCCL returns at the enqueue: rank 0's guarded all_reduce, whose peer
    arrives 2 s late, is still in flight when the call returns, and is
    retired once its event completed (no host sync in the call)."""
    import json
    res = _launch_two(tmp_path, (
        "C.barrier()\n"
        "if rank == 1:\n"
        "    time.sleep(2.0)       # late, outside the guardian\n"
        "C.all_reduce(x)\n"
        "res = {}\n"
        "if rank == 0:\n"
        "    wd = watchdog.get_watchdog()\n"
        "    res['returned'] = wd.in_flight()\n"
        "    torch.cuda.synchronize()\n"
        "    deadline = time.monotonic() + 10\n"
        "    while wd.in_flight() and time.monotonic() < deadline:\n"
        "        time.sleep(0.05)\n"
        "    res['synced'] = wd.in_flight()\n"
        "    res['recent'] = wd.recent()[-1]\n"
        "    res['value'] = float(x[0])\n"
        "C.barrier()\n"
        "json.dump(res, open(f'{out}/r{rank}.json', 'w'))\n"),
        {"FLAGS_collective_timeout_s": "30"})
    assert res.returncode == 0, res.stderr[-4000:]
    got = json.load(open(tmp_path / "r0.json"))
    late = got["recent"]                 # the late call, once retired
    assert late["op"] == "all_reduce" and late["duration_s"] >= 1.0, got
    assert ["all_reduce", late["seq"]] in got["returned"], got
    assert got["synced"] == [] and got["value"] == 4.0, got


@pytest.mark.cuda
def test_stalled_nccl_peer_stall_dump_and_exit_107(card, tmp_path):
    """Rank 1 never arrives (its guardian off); rank 0 returns from the
    all_reduce's enqueue and blocks in C reading the result: its watchdog
    writes the stall dump blaming rank 1 and hard-exits 107, and the
    launcher's job ends with that code."""
    import json
    import os
    import sys
    res = _launch_two(tmp_path, (
        "if rank == 1:\n"
        "    watchdog.configure(store=None)\n"
        "    set_flags({'FLAGS_collective_timeout_s': 0.0})\n"
        "    time.sleep(120)\n"
        "C.all_reduce(x)\n"
        "print(float(x[0]))\n"),
        {"FLAGS_collective_timeout_s": "2",
         "FLAGS_stall_dump_path": str(tmp_path / "stall.json"),
         "PADDLE_GUARDIAN_TERM_GRACE_S": "5"})
    assert res.returncode == 107, res.stderr[-4000:]
    dump = tmp_path / "stall.rank0.json"
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, os.path.join(root, "tools"))
    try:
        from check_telemetry import check_stall_dump
    finally:
        sys.path.pop(0)
    assert check_stall_dump(str(dump)) == []
    st = json.load(open(dump))["stall"]
    assert (st["op"], st["missing_ranks"]) == ("all_reduce", [1])
    assert 2.0 <= st["waited_s"] < 4.0
    log0 = open(tmp_path / "logs" / "worker.0.log").read()
    assert "hard-aborting with exit code 107" in log0


@pytest.mark.cuda
def test_hot_spare_snapshot_is_its_step_while_replays_run(card, monkeypatch):
    """A hot-spare snapshot taken at step k equals the state after step k
    bit for bit while later steps run: the compiled step replays into the
    same parameter and moment tensors as the stream thread packs (slowed
    here), and the capture was finished at the step boundary."""
    import time

    from paddle_tpu_torch.framework import hot_spare
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.nn import CrossEntropyLoss
    make_record = hot_spare.make_record

    def slow(*a, **kw):
        time.sleep(0.5)
        return make_record(*a, **kw)
    monkeypatch.setattr(hot_spare, "make_record", slow)
    cfg = GPTConfig(vocab_size=512, hidden_size=128, num_layers=2,
                    num_heads=4, max_seq_len=128, dropout=0.1,
                    attn_dropout=0.1)
    net = GPTForCausalLM(cfg, device=card, dtype=torch.float32, seed=0)
    model = Model(net).prepare(AdamW(1e-3, parameters=net.parameters()),
                               CrossEntropyLoss(), amp_configs="O2")
    agent = hot_spare.HotSpareAgent("card", 0, 1, store=None, every=3,
                                    serve=False)
    g = torch.Generator().manual_seed(0)
    want = {}
    for it in range(1, 10):
        ids = torch.randint(0, 512, (4, 129), generator=g).to(card)
        model._train_batch_device(ids[:, :-1], ids[:, 1:])
        if agent.maybe_snapshot(it, model._hot_spare_state, {"it": it}):
            want[it] = {k: v.clone() for k, v in
                        model._hot_spare_state()["optimizer"].items()
                        if torch.is_tensor(v)}
            want[it].update({f"p.{k}": v.clone()
                             for k, v in net.state_dict().items()})
        if it in (4, 7):
            agent.wait()
            state, book = hot_spare.validated_state(agent.latest_record())
            ref = want[book["it"]]
            for k, v in ref.items():
                got = state["model"][k[2:]] if k.startswith("p.") \
                    else state["optimizer"][k]
                assert torch.equal(got, v.cpu()), (it, k)
                live = net.state_dict()[k[2:]] if k.startswith("p.") \
                    else model._optimizer.state_dict()[k]
                if k.startswith("p."):
                    assert not torch.equal(live.cpu(), v.cpu()), (it, k)
    assert sorted(want) == [3, 6, 9] and model._compiled_step.compiled
    agent.close(park=False)


@pytest.mark.cuda
def test_zero_shard_adam_takes_the_vector_path(card):
    """A ZeRO parameter whose state is its rows (rank 1 of 2, rows 3-5 of
    a [6, 1030] bf16 weight: a slice at byte 6180, off the 16-byte
    boundary): the rows' gradient (`aligned_rows`), the master and the
    moments (`_state_view`) and the update's buffer (`ZeroState.target`)
    are tensors of their own, so the Adam kernel takes its vector path,
    and its result equals the plain version's on the rows bit for bit;
    the misaligned slice itself takes the scalar path (the control)."""
    from types import SimpleNamespace
    from paddle_tpu_torch.distributed.fleet.sharding import (ZeroState,
                                                             aligned_rows)
    g0 = torch.Generator(device=card).manual_seed(0)
    w = torch.randn(6, 1030, device=card, generator=g0)
    grad = torch.randn(6, 1030, device=card, generator=g0).to(torch.bfloat16)
    p = torch.nn.Parameter(w.to(torch.bfloat16))
    zero = ZeroState(SimpleNamespace(nranks=2, rank=1), 1)
    assert zero.kind(p) == ("rows", 3, 6)
    opt = AdamW(1e-3, parameters=[p])
    opt._zero = zero
    opt._ensure_state()
    opt._lr_tensor.fill_(1e-3)
    state = {name: vals[0] for name, vals in opt._state.items()}
    assert state["moment1"].shape == (3, 1030)
    rows = aligned_rows(grad, 3, 6)
    assert grad[3:6].data_ptr() % 16 and rows.data_ptr() % 16 == 0
    plain = {k: v.clone() for k, v in state.items()}
    want = p.detach()[3:6].clone()
    scal = opt._scalars(opt._lr_tensor, torch.ones((), device=card), 1.0)
    kernels.reset_launch_counts()
    target = zero.target(p)
    opt._update(target, rows, state, scal, True)
    assert adam.adam_update.launches == 1
    assert adam.adam_update.scalar_launches == 0
    adam.adam_update_ref(plain["master"], rows, plain["moment1"],
                         plain["moment2"], want, scal, b1=0.9, b2=0.999,
                         eps=1e-8, wd=0.01, decoupled=True)
    assert torch.equal(target, want)
    assert torch.equal(state["master"], plain["master"])
    adam.adam_update(state["master"], grad[3:6], state["moment1"],
                     state["moment2"], None, scal, b1=0.9, b2=0.999,
                     eps=1e-8, wd=0.0, decoupled=True)
    assert adam.adam_update.scalar_launches == 1


@pytest.mark.cuda
def test_api_moves_on_cuda_tensors(card, tmp_path):
    """The semi-auto API's moves on CUDA tensors over NCCL (two ranks
    sharing the card): Shard(0) -> Replicate, the all-to-all Shard(0) ->
    Shard(1), unshard_dtensor, each bit for bit against the local slices
    of the global tensor; the gradient through Replicate -> Shard(0) ->
    Replicate comes back whole (the all-gather's backward averaged)."""
    import json
    res = _launch_two(tmp_path, (
        "import paddle_tpu_torch.distributed as dist\n"
        "from paddle_tpu_torch.distributed.placement import local_slice\n"
        "mesh = dist.ProcessMesh([0, 1], ['mp'])\n"
        "g = torch.Generator(device=dev).manual_seed(0)\n"
        "x = torch.randn(64, 96, device=dev, generator=g)\n"
        "S, R = dist.Shard, dist.Replicate\n"
        "t = dist.shard_tensor(x, mesh, [S(0)])\n"
        "r = dist.reshard(t, mesh, [R()])\n"
        "a = dist.reshard(t, mesh, [S(1)])\n"
        "w = x.clone().requires_grad_()\n"
        "full = dist.reshard(dist.shard_tensor(w, mesh, [S(0)]), mesh, [R()])\n"
        "(full * 3).sum().backward()\n"
        "res = {'part': torch.equal(t, local_slice(x, mesh, [S(0)])),\n"
        "       'whole': torch.equal(r, x),\n"
        "       'a2a': torch.equal(a, local_slice(x, mesh, [S(1)])),\n"
        "       'unshard': torch.equal(dist.unshard_dtensor(a), x),\n"
        "       'grad': torch.equal(w.grad, torch.full_like(x, 3.0)),\n"
        "       'cuda': t.is_cuda and a.is_cuda}\n"
        "C.barrier()\n"
        "json.dump(res, open(f'{out}/r{rank}.json', 'w'))\n"), {})
    assert res.returncode == 0, res.stderr[-4000:]
    for r in (0, 1):
        got = json.load(open(tmp_path / f"r{r}.json"))
        assert all(got.values()), (r, got)


@pytest.mark.cuda
def test_one_process_pipeline_launches_and_equals_the_whole_batch(card):
    """GPTForCausalLMPipe with 2 stages in one process (pp 1) on the
    card: `PipelineParallel.train_batch` over 2 micro-batches launches
    the flash kernels once a layer a micro-batch and Adam once a
    parameter, and its loss and parameters equal one SGD step on the
    whole batch by hand within fp32 sums in another order (1e-5)."""
    import warnings
    from paddle_tpu_torch.distributed.fleet import (DistributedStrategy,
                                                    PipelineParallel)
    from paddle_tpu_torch.models import GPTForCausalLMPipe, gpt_config
    from paddle_tpu_torch.optimizer import SGD
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = gpt_config("gpt2-124m", num_layers=2, hidden_size=128,
                     num_heads=2, vocab_size=512, max_seq_len=128)
    ids = torch.randint(0, 512, (4, 129), device=card,
                        generator=torch.Generator(device=card).manual_seed(0))
    x, y = ids[:, :-1], ids[:, 1:]
    ref = GPTForCausalLMPipe(cfg, device=card, seed=3)
    loss = ref._loss_fn(ref(x), y)
    loss.backward()
    SGD(0.1, parameters=ref.parameters()).step()
    s = DistributedStrategy()
    s.pipeline_configs = {"accumulate_steps": 2}
    m = GPTForCausalLMPipe(cfg, num_stages=2, device=card, seed=3)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        pp = PipelineParallel(m, strategy=s)
    opt = AdamW(1e-3, parameters=pp.parameters())
    kernels.reset_launch_counts()
    pp.train_batch((x, y), opt)
    counts = kernels.launch_counts()
    assert [counts.get(k, 0) for k in ("flash_fwd", "flash_bwd_dkv",
                                       "flash_bwd_dq")] == [4, 4, 4]
    assert counts.get("adam", 0) == len(list(pp.parameters()))
    m2 = GPTForCausalLMPipe(cfg, num_stages=2, device=card, seed=3)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        pp2 = PipelineParallel(m2, strategy=s)
    got = pp2.train_batch((x, y), SGD(0.1, parameters=pp2.parameters()))
    assert abs(float(got) - float(loss.detach())) <= 1e-5 * abs(float(got))
    want = ref.state_dict()
    for k, v in m2.state_dict().items():
        torch.testing.assert_close(v, want[k], rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_ring_block_merge_matches_flash_on_card(card, causal):
    """The ring body's block merge (`context_parallel.merge_block`) on the
    card, in one process: each of two sequence chunks in turn folds the
    K/V blocks in the order its ring visits them (its own, then the
    other's); the chunks' outputs joined equal the flash kernel on the
    whole sequence (bf16 inputs; the merge in fp32, the kernel's row
    tolerance of 1e-2 of a row's norm and 2e-2 absolute)."""
    from paddle_tpu_torch.distributed import context_parallel as CP
    g = torch.Generator(device=card).manual_seed(3)
    b, s, h, d = 2, 1024, 8, 128
    q, k, v = (torch.randn(b, s, h, d, device=card, generator=g)
               .to(torch.bfloat16) for _ in range(3))
    want = fa.flash_attention(q, k, v, causal=causal)
    c = s // 2
    pos = torch.arange(c, device=card)
    outs = []
    for me in range(2):
        qc = q[:, me * c:(me + 1) * c]
        state = CP.start_state(qc)
        qt = qc.float().transpose(1, 2)
        for t in range(2):
            j = (me - t) % 2
            rows, cols = (me * c + pos[:, None], j * c + pos[None, :]) \
                if causal else (None, None)
            state = CP.merge_block(state, qt, k[:, j * c:(j + 1) * c],
                                   v[:, j * c:(j + 1) * c], d ** -0.5,
                                   rows, cols)
        outs.append(CP.finish_state(state, q.dtype))
    got = torch.cat(outs, dim=1)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2,
                               atol=2e-2)


@pytest.mark.cuda
def test_moe_index_dispatch_equals_dense_triple_on_card(card):
    """`MoELayer`'s index dispatch (the buffer of each expert's kept
    tokens, combine by gather) on the card equals the dense form of its
    gate's routing (JAX's ``combine`` / ``dispatch`` einsums over the same
    experts) in fp32, with tokens dropped by the capacity, and the
    gradients of the input and the experts too (1e-5)."""
    from paddle_tpu_torch.framework import prng
    from paddle_tpu_torch.incubate.distributed.models.moe import MoELayer
    torch.backends.cuda.matmul.allow_tf32 = False
    layer = MoELayer(64, num_expert=4, d_hidden=128, device=card,
                     gate={"type": "gshard", "top_k": 2,
                           "capacity": (0.5, 0.5)})
    x = torch.randn(512, 64, device=card,
                    generator=torch.Generator(device=card).manual_seed(5))
    w = torch.randn_like(x)
    prng.seed(7)
    xi = x.clone().requires_grad_(True)
    y = layer(xi)
    (y * w).sum().backward()
    assert int(layer.last_dropped.sum()) > 0
    grads = [p.grad.clone() for p in layer._stacked.parameters()]
    layer.zero_grad()
    prng.seed(7)
    xd = x.clone().requires_grad_(True)
    combine, dispatch, _ = layer.gate.dispatch_info(xd, train=True)
    xe = torch.einsum("nec,nd->ecd", dispatch.float(), xd)
    yd = torch.einsum("nec,ecd->nd", combine, layer._stacked(xe))
    (yd * w).sum().backward()
    torch.testing.assert_close(y, yd, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(xi.grad, xd.grad, rtol=1e-5, atol=1e-5)
    for got, p in zip(grads, layer._stacked.parameters()):
        torch.testing.assert_close(got, p.grad, rtol=1e-5, atol=1e-5)
