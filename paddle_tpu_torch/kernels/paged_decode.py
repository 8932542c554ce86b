"""Paged decode attention: the CUDA kernel ``csrc/paged_decode.cu`` and its
plain version (port of paddle_tpu/pallas/flash_attention.py
``paged_decode_attention``, float and quantized pools).

One new query token per row attends the row's cached positions
``0..offsets[b]`` through its page table.  GQA is native: query head
``i`` reads kv head ``i // (H / H_kv)``.  An int8 or float8 (e4m3) pool
comes with ``k_scale``/``v_scale``, float32 ``[P, page_size]``: one scale
per cached token row, multiplied in fp32 before the dot.

The kernel cuts the cached sequence into splits (flash-decoding): one
block per (split, kv head, row) and a second launch that merges each
row's live splits.  `plan_splits` picks the split from what the host
knows (the table's capacity, the batch, the heads, the SM count), never
from ``offsets``, so a captured call stays right when the offsets change
between replays.

Each storage type keeps its own launch count: `paged_decode_attention`'s
``launches`` counts float pools, ``QUANT_LAUNCHES[torch.int8]`` and
``QUANT_LAUNCHES[torch.float8_e4m3fn]`` the quantized ones; one call
counts one, whatever the number of kernels it takes.
"""
from __future__ import annotations

import ctypes
import functools
import math
from types import SimpleNamespace

import torch

from . import _build, check_cuda, dtype_code
from ..quantization import as_bytes, dequantize_kv

MAX_HEAD_DIM = 256
MAX_PAGE_SIZE = 64
#: kernel dtype codes of the quantized storage types (csrc/common.cuh)
QUANT_CODES = {torch.int8: 3, torch.float8_e4m3fn: 4}
#: launch counts of the quantized variants, by storage type
QUANT_LAUNCHES = {dt: SimpleNamespace(launches=0) for dt in QUANT_CODES}
#: the fewest positions a split holds (rounded up to whole pages)
MIN_SPLIT_TOKENS = 64
#: blocks a full-capacity batch should give, in waves of one block an SM
SPLIT_WAVES = 8
#: query heads one block serves (csrc/paged_decode.cu: at most 8)
MAX_REP_PER_BLOCK = 8


def plan_splits(capacity, page_size, batch, kv_blocks, sms):
    """``(split_tokens, n_splits)`` for a page table of ``capacity``
    positions: splits of whole pages, each at least `MIN_SPLIT_TOKENS`
    (or the whole capacity), as many as a full-capacity batch of
    ``batch`` rows x ``kv_blocks`` blocks a row needs for `SPLIT_WAVES`
    waves over ``sms`` SMs.  The splits cover ``0..capacity`` once."""
    unit = page_size * -(-MIN_SPLIT_TOKENS // page_size)
    want = -(-SPLIT_WAVES * sms // (batch * kv_blocks))
    n = max(1, min(want, -(-capacity // unit)))
    split = page_size * -(-(-(-capacity // n)) // page_size)
    return split, -(-capacity // split)


@functools.lru_cache(maxsize=None)
def split_plan(b, h, h_kv, page_size, n_pages, device):
    """The wrapper's ``(split_tokens, n_splits)`` for a call of this
    geometry on the CUDA ``device`` (cached: the decode loop asks the same
    question every layer)."""
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    groups = -(-(h // h_kv) // MAX_REP_PER_BLOCK)
    return plan_splits(n_pages * page_size, page_size, b, h_kv * groups, sms)


def gather_pages(pool, pt):
    """``pool[pt]``, through a uint8 view for a float8 pool."""
    return as_bytes(pool)[pt].view(pool.dtype)


def paged_decode_ref(q, k_pool, v_pool, page_table, offsets, scale=None,
                     k_scale=None, v_scale=None):
    """Plain PyTorch version: gather ``pool[page_table]`` (dequantized by
    the gathered scales for a quantized pool, the JAX gather path's
    ``dequantize_kv(kp[pt], ks[pt])``) and take the masked softmax in fp32
    (the reference of tests/test_paged_kv.py)."""
    b, h, d = q.shape
    psz, h_kv = k_pool.shape[1], k_pool.shape[2]
    n = page_table.shape[1]
    rep = h // h_kv
    sc = scale if scale is not None else 1.0 / math.sqrt(d)
    pt = page_table.long()
    kf, vf = gather_pages(k_pool, pt), gather_pages(v_pool, pt)
    if k_scale is not None:
        kf, vf = dequantize_kv(kf, k_scale[pt]), dequantize_kv(vf, v_scale[pt])
    kf = kf.reshape(b, n * psz, h_kv, d).float()
    vf = vf.reshape(b, n * psz, h_kv, d).float()
    qg = q.float().reshape(b, h_kv, rep, d)
    s = torch.einsum("bhrd,bkhd->bhrk", qg, kf) * sc
    k_pos = torch.arange(n * psz, device=q.device)
    live = k_pos[None, :] <= offsets.long()[:, None]           # [b, k]
    s = s.masked_fill(~live[:, None, None, :], -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhrk,bkhd->bhrd", p, vf)
    return out.reshape(b, h, d).to(q.dtype)


def paged_decode_attention(q, k_pool, v_pool, page_table, offsets,
                           scale=None, k_scale=None, v_scale=None):
    """q: [B, H, D]; k_pool/v_pool: [P, page_size, H_kv, D]; page_table:
    int32 [B, N]; offsets: int32 [B] → [B, H, D] like q.  An int8 or
    float8 pool needs ``k_scale``/``v_scale`` (float32 [P, page_size]), a
    float pool takes none.  CPU tensors take `paged_decode_ref`; CUDA
    tensors launch the kernel."""
    if q.device.type == "cpu":
        return paged_decode_ref(q, k_pool, v_pool, page_table, offsets,
                                scale, k_scale, v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: unsupported device "
                         f"{q.device}")
    quant = k_pool.dtype in QUANT_CODES
    scales = (k_scale, v_scale) if quant else ()
    if quant != (k_scale is not None) or (k_scale is None) != (v_scale is None):
        raise ValueError("paged_decode_attention: an int8/fp8 pool takes "
                         "k_scale and v_scale, a float pool neither")
    check_cuda("paged_decode_attention", q, k_pool, v_pool, page_table,
               offsets, *scales)
    if q.dim() != 3 or k_pool.dim() != 4 or v_pool.shape != k_pool.shape:
        raise ValueError(
            f"paged_decode_attention: q {tuple(q.shape)} must be [B, H, D] "
            f"and the pools {tuple(k_pool.shape)}/{tuple(v_pool.shape)} "
            "equal [P, page_size, H_kv, D]")
    b, h, d = q.shape
    psz, h_kv = k_pool.shape[1], k_pool.shape[2]
    if k_pool.shape[3] != d or h % h_kv:
        raise ValueError(f"paged_decode_attention: head dims {d} vs "
                         f"{k_pool.shape[3]}, heads {h} vs kv heads {h_kv}")
    if d > MAX_HEAD_DIM or psz > MAX_PAGE_SIZE:
        raise ValueError(f"paged_decode_attention: head_dim {d} (max "
                         f"{MAX_HEAD_DIM}) or page_size {psz} (max "
                         f"{MAX_PAGE_SIZE}) out of range")
    if page_table.dtype != torch.int32 or offsets.dtype != torch.int32 \
            or page_table.dim() != 2 or page_table.shape[0] != b \
            or tuple(offsets.shape) != (b,):
        raise ValueError("paged_decode_attention: page_table must be int32 "
                         "[B, N] and offsets int32 [B]")
    if v_pool.dtype != k_pool.dtype:
        raise TypeError("paged_decode_attention: k_pool and v_pool dtypes "
                        "differ")
    if quant and any(t.dtype != torch.float32 or
                     tuple(t.shape) != tuple(k_pool.shape[:2])
                     for t in scales):
        raise ValueError("paged_decode_attention: k_scale and v_scale must "
                         f"be float32 {tuple(k_pool.shape[:2])}")
    n_pages = page_table.shape[1]
    if n_pages < 1:
        raise ValueError("paged_decode_attention: the page table has no "
                         "pages")
    sc = scale if scale is not None else 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    split, n_splits = split_plan(b, h, h_kv, psz, n_pages, q.device)
    # fp32 partials of every split, scratch for the merge: acc [b, h,
    # n_splits, d], then m and l [b, h, n_splits, 2]; with one split the
    # first kernel writes ``out`` itself
    parts = [None, None]
    if n_splits > 1:
        n_acc = b * h * n_splits * d
        scratch = torch.empty(n_acc + 2 * b * h * n_splits, device=q.device,
                              dtype=torch.float32)
        parts = [_build.ptr(scratch),
                 ctypes.c_void_p(scratch.data_ptr() + 4 * n_acc)]
    fn = _build.function("ptt_paged_decode", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    kv_code = QUANT_CODES[k_pool.dtype] if quant else dtype_code(k_pool)
    scale_ptrs = [_build.ptr(t) for t in scales] if quant else [None, None]
    with torch.cuda.device(q.device):
        err = fn(_build.ptr(q), _build.ptr(k_pool), _build.ptr(v_pool),
                 *scale_ptrs, _build.ptr(page_table), _build.ptr(offsets),
                 _build.ptr(out), *parts, b, h, h_kv, d, psz, n_pages, split,
                 n_splits, float(sc), dtype_code(q), kv_code,
                 _build.stream(q.device))
    _build.check(err, "ptt_paged_decode")
    if quant:
        QUANT_LAUNCHES[k_pool.dtype].launches += 1
    else:
        paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
