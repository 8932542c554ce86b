"""Paged decode attention: the CUDA kernel ``csrc/paged_decode.cu`` and its
plain version (port of paddle_tpu/pallas/flash_attention.py
``paged_decode_attention``, float pools).

One new query token per row attends the row's cached positions
``0..offsets[b]`` through its page table.  GQA is native: query head
``i`` reads kv head ``i // (H / H_kv)``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build, check_cuda, dtype_code

MAX_HEAD_DIM = 256
MAX_PAGE_SIZE = 64


def paged_decode_ref(q, k_pool, v_pool, page_table, offsets, scale=None):
    """Plain PyTorch version: gather ``pool[page_table]`` and take the
    masked softmax in fp32 (the reference of tests/test_paged_kv.py)."""
    b, h, d = q.shape
    psz, h_kv = k_pool.shape[1], k_pool.shape[2]
    n = page_table.shape[1]
    rep = h // h_kv
    sc = scale if scale is not None else 1.0 / math.sqrt(d)
    pt = page_table.long()
    kf = k_pool[pt].reshape(b, n * psz, h_kv, d).float()
    vf = v_pool[pt].reshape(b, n * psz, h_kv, d).float()
    qg = q.float().reshape(b, h_kv, rep, d)
    s = torch.einsum("bhrd,bkhd->bhrk", qg, kf) * sc
    k_pos = torch.arange(n * psz, device=q.device)
    live = k_pos[None, :] <= offsets.long()[:, None]           # [b, k]
    s = s.masked_fill(~live[:, None, None, :], -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhrk,bkhd->bhrd", p, vf)
    return out.reshape(b, h, d).to(q.dtype)


def paged_decode_attention(q, k_pool, v_pool, page_table, offsets,
                           scale=None):
    """q: [B, H, D]; k_pool/v_pool: [P, page_size, H_kv, D]; page_table:
    int32 [B, N]; offsets: int32 [B] → [B, H, D] like q.  CPU tensors
    take `paged_decode_ref`; CUDA tensors launch the kernel."""
    if q.device.type == "cpu":
        return paged_decode_ref(q, k_pool, v_pool, page_table, offsets,
                                scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: unsupported device "
                         f"{q.device}")
    check_cuda("paged_decode_attention", q, k_pool, v_pool, page_table,
               offsets)
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
    sc = scale if scale is not None else 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    fn = _build.function("ptt_paged_decode", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    with torch.cuda.device(q.device):
        err = fn(_build.ptr(q), _build.ptr(k_pool), _build.ptr(v_pool),
                 _build.ptr(page_table), _build.ptr(offsets), _build.ptr(out),
                 b, h, h_kv, d, psz, page_table.shape[1], float(sc),
                 dtype_code(q), dtype_code(k_pool), _build.stream(q.device))
    _build.check(err, "ptt_paged_decode")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
