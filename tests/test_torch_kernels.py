"""The port's kernels (paddle_tpu_torch/kernels/): each plain PyTorch
version against the JAX package's Pallas kernel in interpret mode, and
the CPU route of the wrappers.  The CUDA kernels themselves are held
against their plain versions by tests/test_torch_cuda.py on the card."""
import inspect

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
    counts = kernels.launch_counts()
    assert {"rms_norm", "paged_decode"} <= set(counts)
    assert all(n == 0 for n in counts.values()), counts


def test_rms_norm_ref_rounds_once_in_bf16():
    """bf16: x*r*w in fp32, one rounding (the TPU kernel's op order)."""
    x = torch.randn(3, 32).to(torch.bfloat16)
    w = (torch.rand(32) + 0.5).to(torch.bfloat16)
    xf = x.float()
    r = torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + 1e-6)
    want = (xf * r * w.float()).to(torch.bfloat16)
    assert torch.equal(rn.rms_norm_ref(x, w, 1e-6), want)


#: (capacity, page_size, batch, kv blocks a row, least waves of 132 SMs):
#: the 7B bf16 serving table (64 pages of 16) and its int8 one (32 of 32),
#: 70B's GQA heads at 4096 positions, a 32-row batch, page sizes 8 and 64,
#: tables shorter than one split, a capacity that is not a multiple of 64
PLAN_CASES = {
    "7b-serve": (1024, 16, 4, 32, 2),
    "7b-serve-int8": (1024, 32, 4, 32, 2),
    "70b-gqa": (4096, 16, 4, 8, 2),
    "7b-batch32": (1024, 16, 32, 32, 2),
    "psz8": (512, 8, 3, 4, 0),
    "psz64": (4032, 64, 2, 2, 0),
    "short": (32, 8, 3, 2, 0),
    "ragged": (208, 16, 1, 1, 0),
    "one-page": (64, 64, 1, 1, 0),
}


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_plan_splits_covers_the_table_in_whole_pages(case):
    capacity, psz, batch, kv_blocks, waves = PLAN_CASES[case]
    split, n = pd.plan_splits(capacity, psz, batch, kv_blocks, 132)
    # the plan never sees the offsets
    assert "offsets" not in inspect.signature(pd.plan_splits).parameters
    # split edges on page edges; each position in exactly one split
    assert split % psz == 0 and n >= 1
    covered = np.zeros(capacity, np.int64)
    for i in range(n):
        covered[i * split:min((i + 1) * split, capacity)] += 1
    assert (covered == 1).all() and (n - 1) * split < capacity
    # no split under 64 positions unless the whole table is shorter
    assert split >= min(pd.MIN_SPLIT_TOKENS, capacity)
    assert n * batch * kv_blocks >= waves * 132


def test_wrappers_refuse_other_devices():
    meta = torch.empty(2, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        rn.rms_norm(meta, torch.empty(8, device="meta"), 1e-6)
    with pytest.raises(ValueError, match="unsupported device"):
        pd.paged_decode_attention(torch.empty(1, 2, 8, device="meta"),
                                  None, None, None, None)


#: (rows, N): one row, the decode step, a prefill chunk, the training
#: shape, Llama-2 70B's width, the staged widths, odd widths, the extremes
RMS_PLAN_SHAPES = [(1, 1), (1, 4096), (4, 4096), (128, 4096), (4096, 4096),
                   (4096, 8192), (40, 16384), (3, 100), (7, 8200),
                   (65536, 1), (65536, 16384), (131, 4104), (1000, 16383)]


def _rms_plan_shapes(seed, count=40):
    rng = np.random.default_rng(seed)
    rows = rng.integers(1, 65537, count)
    n = rng.integers(1, 16385, count)
    return RMS_PLAN_SHAPES + list(zip(rows.tolist(), n.tolist()))


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("elem_size", [4, 2])
@pytest.mark.parametrize("sms", [132, 114])
def test_rms_plan_covers_every_row_once(backward, elem_size, sms):
    """Every row in exactly one block and every block non-empty; one
    workspace row a backward block; whole warps, 32-1024 threads; a
    thread's elements cover the row on the register path; the staged path
    within its shared memory; a bounded row count a block."""
    for rows, n in _rms_plan_shapes(elem_size * sms + backward):
        for aligned in (True, False):
            p = rn.plan(rows, n, elem_size, sms, aligned, backward)
            block_of = np.arange(rows) // p.rows_per_block
            assert block_of[-1] == p.blocks - 1, (rows, n, p)
            assert (np.bincount(block_of, minlength=p.blocks) >= 1).all()
            assert p.ws_rows == (p.blocks if backward else 0)
            assert 32 <= p.threads <= 1024 and p.threads % 32 == 0
            if backward:
                assert p.blocks <= rn.BWD_BLOCKS_PER_SM * sms
                assert p.rows_per_block == -(-rows // p.blocks)
            elif p.path == rn.GENERIC:
                assert p.rows_per_block == 1
            else:
                assert p.rows_per_block <= rn.FWD_ROWS_PER_BLOCK
            v = 16 // elem_size
            vec = aligned and n % v == 0
            if p.path == rn.REG:
                assert vec and n <= rn.REG_MAX_N and p.ept in rn.EPTS
                vpt, nv = p.ept // v, n // v
                assert p.threads * vpt >= nv > (p.threads - 32) * vpt
                assert p.threads <= (rn.BWD_MAX_THREADS if backward
                                     else rn.FWD_MAX_THREADS)
            elif p.path == rn.STAGED:
                assert vec and n > rn.REG_MAX_N and p.stages in (1, 2)
                assert p.smem <= rn.SMEM_LIMIT
                assert p.threads == rn.STAGED_THREADS
            else:
                assert p.path == rn.GENERIC
                assert not vec or n > rn.REG_MAX_N
            if not aligned:
                assert p.path == rn.GENERIC


@pytest.mark.parametrize("rows,n,path", [
    (4, 4096, "reg"), (4096, 4096, "reg"), (4, 8192, "reg"),
    (4, 16384, "staged"), (4096, 16384, "staged"), (3, 100, "generic")])
def test_rms_plan_paths_for_bf16(rows, n, path):
    """bf16 rows up to 8192 in registers, 16384 staged two rows deep in
    both directions, a width off the 16-byte vector on the generic loop."""
    want = {"reg": rn.REG, "staged": rn.STAGED, "generic": rn.GENERIC}[path]
    for backward in (False, True):
        p = rn.plan(rows, n, 2, 132, True, backward)
        assert p.path == want
        if path == "staged":
            assert p.stages == 2


def test_rms_plan_limits_match_the_kernels():
    """The plan's limits are the numbers csrc/rms_norm.cu checks."""
    src = (rn._build.CSRC / "rms_norm.cu").read_text()
    for const, value in (("kFwdMaxThreads", rn.FWD_MAX_THREADS),
                         ("kBwdMaxThreads", rn.BWD_MAX_THREADS),
                         ("kStagedThreads", rn.STAGED_THREADS),
                         ("kSmemLimit", rn.SMEM_LIMIT)):
        line = next(ln for ln in src.splitlines()
                    if f"constexpr int {const} =" in ln)
        factors = line.split("=")[1].split(";")[0].split("*")
        assert int(np.prod([int(f) for f in factors])) == value, const
    assert (rn.GENERIC, rn.REG, rn.STAGED) == (0, 1, 2)
    assert "enum Path : int { kGeneric = 0, kReg = 1, kStaged = 2 };" in src
