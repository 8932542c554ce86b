"""RMS norm: the CUDA kernels ``csrc/rms_norm.cu`` (forward and backward)
and their plain versions (port of paddle_tpu/pallas/fused.py
``rms_norm_pallas`` and its VJP).

The forward computes ``y = (x * r * w)`` in fp32 with ``r = rsqrt(mean(x^2)
+ eps)`` and rounds once to x's dtype, the op order of the TPU kernel.  (The
JAX package's jnp fallback rounds before ``* w``; in fp32 the two agree,
in bf16 they differ by rounding.)  The backward takes the forward's ``r``
and computes ``dx = r * (g*w - x^ * mean(g*w*x^))`` and ``dw = sum_rows
g*x^`` in fp32 with ``x^ = x*r``; `RMSNormFunction` ties the two together
for autograd.

`plan` chooses every launch on the host from the shape, the dtype's size,
the pointers' alignment and the SM count: the path (a row held in
registers, staged in shared memory, or the generic loop), the threads,
the elements of a row a thread holds, the rows a block walks, the blocks
and, in the backward, the workspace rows of dw's partial sums.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build, check_cuda, dtype_code

#: the kernel paths (csrc/rms_norm.cu ``Path``)
GENERIC, REG, STAGED = 0, 1, 2
#: elements of a row one thread may hold on the register path
EPTS = (8, 16, 32)
#: the register path takes rows of at most this many elements
REG_MAX_N = 8192
#: threads of a block: the register path's forward and backward, the
#: staged path's, the generic loop's (csrc/rms_norm.cu keeps the same)
FWD_MAX_THREADS = 512
BWD_MAX_THREADS = 256
STAGED_THREADS = 512
GENERIC_MAX_THREADS = 512
#: dynamic shared memory a staged block may take (csrc: kSmemLimit)
SMEM_LIMIT = 220 * 1024
#: the fewest elements a thread holds on the register path (the least of
#: EPTS at or above it whose block fits), chosen on the card
FWD_EPT = 16
BWD_EPT = 16
#: rows a forward block walks once the rows outnumber the SMs
FWD_ROWS_PER_BLOCK = 2
#: backward blocks an SM (a persistent grid; one workspace row a block)
BWD_BLOCKS_PER_SM = 2


class Plan(NamedTuple):
    """One launch of csrc/rms_norm.cu: block b walks rows ``b *
    rows_per_block`` up to the next block's first; ``ept`` elements a
    thread on the register path; ``stages`` rows staged ahead on the
    staged path; ``smem`` its dynamic shared-memory bytes; ``ws_rows`` the
    backward's workspace rows (one a block; 0 in the forward)."""
    path: int
    threads: int
    ept: int
    stages: int
    rows_per_block: int
    blocks: int
    smem: int
    ws_rows: int


def _warps(units):
    return 32 * -(-units // 32)


def plan(rows, n, elem_size, sms, aligned=True, backward=False):
    """The `Plan` of a forward (or ``backward``) call on ``rows`` rows of
    ``n`` elements of ``elem_size`` bytes on a card of ``sms`` SMs.
    ``aligned``: every pointer the kernel reads or writes is 16-byte
    aligned.  Rows of 16-byte vectors up to `REG_MAX_N` elements go
    through registers, longer ones through shared memory where a row
    (two, where they fit) can be staged; other shapes take the generic
    loop."""
    if rows < 1 or n < 1:
        raise ValueError(f"rms_norm plan: {rows} rows of {n}")
    v = 16 // elem_size
    vec = aligned and n % v == 0
    if backward:
        blocks = min(rows, BWD_BLOCKS_PER_SM * sms)
        per = -(-rows // blocks)
    else:
        per = max(1, min(FWD_ROWS_PER_BLOCK, rows // sms))
    blocks = -(-rows // per)
    ws_rows = blocks if backward else 0
    if vec and n <= REG_MAX_N:
        nv = n // v
        want, most = (BWD_EPT, BWD_MAX_THREADS) if backward else \
            (FWD_EPT, FWD_MAX_THREADS)
        for ept in EPTS:
            threads = _warps(-(-nv // (ept // v)))
            if ept >= want and threads <= most:
                return Plan(REG, threads, ept, 0, per, blocks, 0, ws_rows)
    if vec:
        row_bytes = n * elem_size * (2 if backward else 1)
        for stages in (2, 1):
            smem = stages * row_bytes + (4 * n if backward else 0)
            if smem <= SMEM_LIMIT:
                return Plan(STAGED, STAGED_THREADS, 0, stages, per, blocks,
                            smem, ws_rows)
    threads = min(GENERIC_MAX_THREADS,
                  _warps(n // v if vec else n))
    if not backward:        # the generic forward: one block a row
        per, blocks = 1, rows
    return Plan(GENERIC, threads, 0, 0, per, blocks, 0, ws_rows)


@functools.lru_cache(maxsize=None)
def _sms(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _cached_plan(rows, n, elem_size, index, aligned, backward):
    return plan(rows, n, elem_size, _sms(index), aligned, backward)


def device_plan(x, rows, n, aligned, backward=False):
    """`plan` for a call on the CUDA tensor ``x``'s card (cached)."""
    index = x.device.index
    if index is None:
        index = torch.cuda.current_device()
    return _cached_plan(rows, n, x.element_size(), index, aligned, backward)


def _aligned(*tensors):
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def rms_norm_ref(x, weight, eps, return_rstd=False):
    """Plain PyTorch version, same op order as the kernel."""
    xf = x.float()
    r = torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + eps)
    y = (xf * r * weight.float()).to(x.dtype)
    return (y, r.squeeze(-1)) if return_rstd else y


def rms_norm(x, weight, eps, return_rstd=False):
    """x: [..., N], weight: [N] → y like x (and fp32 ``r`` [...] with
    ``return_rstd``).  CPU tensors take `rms_norm_ref`; CUDA tensors
    launch the kernel."""
    if x.device.type == "cpu":
        return rms_norm_ref(x, weight, eps, return_rstd)
    if x.device.type != "cuda":
        raise ValueError(f"rms_norm: unsupported device {x.device}")
    check_cuda("rms_norm", x, weight)
    n = x.shape[-1]
    if weight.dim() != 1 or weight.shape[0] != n:
        raise ValueError(f"rms_norm: weight {tuple(weight.shape)} does not "
                         f"match x's last dim {n}")
    rows = x.numel() // n if n else 0
    y = torch.empty_like(x)
    r = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device) \
        if return_rstd else None
    if rows:
        p = device_plan(x, rows, n, _aligned(x, weight, y))
        fn = _build.function("ptt_rms_norm_fwd", [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.c_int, ctypes.c_int, *[ctypes.c_int] * 6,
            ctypes.c_void_p])
        with torch.cuda.device(x.device):
            err = fn(_build.ptr(x), _build.ptr(weight), _build.ptr(y),
                     _build.ptr(r) if r is not None else None, rows, n,
                     float(eps), dtype_code(x), dtype_code(weight), p.path,
                     p.threads, p.ept, p.stages, p.rows_per_block, p.blocks,
                     _build.stream(x.device))
        _build.check(err, "ptt_rms_norm_fwd")
        rms_norm.launches += 1
    return (y, r) if return_rstd else y


rms_norm.launches = 0


def rms_norm_bwd_ref(x, weight, r, g):
    """Plain PyTorch backward, the TPU kernel's op order: x: [..., N],
    r: fp32 [...] from the forward, g like x → (dx like x, dw like w)."""
    n = x.shape[-1]
    xf = x.reshape(-1, n).float()
    gf = g.reshape(-1, n).float()
    rr = r.reshape(-1, 1)
    xhat = xf * rr
    gw = gf * weight.float()
    m = (gw * xhat).mean(dim=-1, keepdim=True)
    dx = (rr * (gw - xhat * m)).to(x.dtype).reshape(x.shape)
    dw = (gf * xhat).sum(dim=0).to(weight.dtype)
    return dx, dw


def launch_bwd_rows(x, weight, r, g, dx, ws, p):
    """The backward's first launch, by the plan ``p``: ``dx``, and dw's
    partial sums of each block's rows into its row of the fp32 workspace
    ``ws`` [p.ws_rows, N].  Counts no launch (`rms_norm_bwd` does)."""
    n = x.shape[-1]
    fn = _build.function("ptt_rms_norm_bwd", [
        *[ctypes.c_void_p] * 6, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, *[ctypes.c_int] * 6, ctypes.c_void_p])
    with torch.cuda.device(x.device):
        err = fn(_build.ptr(x), _build.ptr(weight), _build.ptr(r),
                 _build.ptr(g), _build.ptr(dx), _build.ptr(ws),
                 x.numel() // n, n, dtype_code(x), dtype_code(weight),
                 p.path, p.threads, p.ept, p.stages, p.rows_per_block,
                 p.blocks, _build.stream(x.device))
    _build.check(err, "ptt_rms_norm_bwd")


def launch_dw_sum(ws, dw):
    """The backward's second launch: ``dw`` = the column sums of the fp32
    workspace ``ws`` [parts, N] in a fixed order, cast to dw's dtype.
    Counts no launch (`rms_norm_bwd` does)."""
    fn = _build.function("ptt_rms_norm_dw", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p])
    with torch.cuda.device(ws.device):
        err = fn(_build.ptr(ws), _build.ptr(dw), ws.shape[0], ws.shape[1],
                 dtype_code(dw), _build.stream(ws.device))
    _build.check(err, "ptt_rms_norm_dw")


def bwd_plan(x, weight, g, dx):
    """The backward's `Plan` for these tensors (x: [..., N])."""
    n = x.shape[-1]
    return device_plan(x, x.numel() // n, n, _aligned(x, weight, g, dx),
                       backward=True)


def rms_norm_bwd(x, weight, r, g):
    """x, g: [..., N]; weight: [N]; r: fp32 [...] (the forward's
    ``return_rstd``) → (dx like x, dw like weight).  CPU tensors take
    `rms_norm_bwd_ref`; CUDA tensors launch the two kernels (dx with
    per-block partial sums of dw, then their column sums in a fixed
    order)."""
    if x.device.type == "cpu":
        return rms_norm_bwd_ref(x, weight, r, g)
    if x.device.type != "cuda":
        raise ValueError(f"rms_norm_bwd: unsupported device {x.device}")
    x, g, r = x.contiguous(), g.contiguous(), r.contiguous()
    check_cuda("rms_norm_bwd", x, weight, r, g)
    n = x.shape[-1]
    rows = x.numel() // n if n else 0
    if g.shape != x.shape or r.numel() != rows or r.dtype != torch.float32:
        raise ValueError(f"rms_norm_bwd: g {tuple(g.shape)} / r "
                         f"{tuple(r.shape)} {r.dtype} do not match x "
                         f"{tuple(x.shape)}")
    if weight.dim() != 1 or weight.shape[0] != n:
        raise ValueError(f"rms_norm_bwd: weight {tuple(weight.shape)} does "
                         f"not match x's last dim {n}")
    dx = torch.empty_like(x)
    dw = torch.empty_like(weight)
    if not rows:
        return dx, dw.zero_()
    p = bwd_plan(x, weight, g, dx)
    ws = torch.empty(p.ws_rows, n, dtype=torch.float32, device=x.device)
    launch_bwd_rows(x, weight, r, g, dx, ws, p)
    launch_dw_sum(ws, dw)
    rms_norm_bwd.launches += 1
    return dx, dw


rms_norm_bwd.launches = 0


class RMSNormFunction(torch.autograd.Function):
    """y = rms_norm(x, w, eps) under autograd: the forward kernel saves
    its fp32 ``r`` and the backward kernel consumes it (the custom VJP of
    paddle_tpu/pallas/fused.py ``rms_norm_pallas``)."""

    @staticmethod
    def forward(ctx, x, weight, eps):
        y, r = rms_norm(x, weight, eps, return_rstd=True)
        ctx.save_for_backward(x, weight, r)
        return y

    @staticmethod
    def backward(ctx, g):
        x, weight, r = ctx.saved_tensors
        dx, dw = rms_norm_bwd(x, weight, r, g)
        return dx, dw, None
