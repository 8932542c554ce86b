"""Gathered multi-LoRA delta: the CUDA kernel ``csrc/lora_delta.cu`` and
its plain version (port of paddle_tpu/serving/adapters.py
``_pallas_delta``).

``lora_delta(x, a_stack, b_stack, scale, idx)`` returns, for each batch
row ``i``, ``(x[i] @ A[idx[i]]) @ B[idx[i]] * scale[idx[i]]`` computed in
fp32 and rounded once to ``x``'s dtype, as the Pallas kernel does; the
caller adds it to the base projection's output.  The stacks stay where
they are: the kernel reads each row's adapter slot from ``idx`` (the
Pallas kernel's scalar prefetch) and never builds a gathered copy.  One
launch a call (thread-block clusters sum x·A through distributed shared
memory, in a fixed order: two calls give the same bits) and no scratch
tensor.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, check_cuda, dtype_code

MAX_RANK = 256


def lora_delta_ref(x, a_stack, b_stack, scale, idx):
    """Plain PyTorch version: the fp32 formula on gathered stacks."""
    i = idx.long()
    xa = torch.bmm(x.float(), a_stack[i].float())
    d = torch.bmm(xa, b_stack[i].float())
    return (d * scale[i].float()[:, None, None]).to(x.dtype)


def lora_delta(x, a_stack, b_stack, scale, idx):
    """x: [ns, seq, din]; a_stack: [P, din, rp]; b_stack: [P, rp, dout];
    scale: [P] (all of one float dtype); idx: int32 [ns] → [ns, seq, dout]
    like x.  CPU tensors take `lora_delta_ref`; CUDA tensors launch the
    kernel."""
    if x.device.type == "cpu":
        return lora_delta_ref(x, a_stack, b_stack, scale, idx)
    if x.device.type != "cuda":
        raise ValueError(f"lora_delta: unsupported device {x.device}")
    x = x.contiguous()
    check_cuda("lora_delta", x, a_stack, b_stack, scale, idx)
    if x.dim() != 3 or a_stack.dim() != 3 or b_stack.dim() != 3 \
            or scale.dim() != 1:
        raise ValueError(f"lora_delta: x {tuple(x.shape)} must be [ns, seq, "
                         f"din], the stacks [P, din, rp] / [P, rp, dout] and "
                         f"scale [P]")
    ns, seq, din = x.shape
    n_pool, _, rp = a_stack.shape
    dout = b_stack.shape[2]
    if a_stack.shape[1] != din or tuple(b_stack.shape[:2]) != (n_pool, rp) \
            or scale.shape[0] != n_pool or rp > MAX_RANK:
        raise ValueError(f"lora_delta: stacks {tuple(a_stack.shape)} / "
                         f"{tuple(b_stack.shape)} / scale "
                         f"{tuple(scale.shape)} do not fit x "
                         f"{tuple(x.shape)} (rank at most {MAX_RANK})")
    if idx.dtype != torch.int32 or tuple(idx.shape) != (ns,):
        raise ValueError(f"lora_delta: idx must be int32 [{ns}]")
    if not (x.dtype == a_stack.dtype == b_stack.dtype == scale.dtype):
        raise TypeError(f"lora_delta: x {x.dtype} and the stacks "
                        f"{a_stack.dtype} / {b_stack.dtype} / {scale.dtype} "
                        "must share one dtype")
    out = torch.empty(ns, seq, dout, device=x.device, dtype=x.dtype)
    fn = _build.function("ptt_lora_delta", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p])
    with torch.cuda.device(x.device):
        err = fn(_build.ptr(x), _build.ptr(a_stack), _build.ptr(b_stack),
                 _build.ptr(scale), _build.ptr(idx), _build.ptr(out), ns, seq,
                 din, dout, rp, n_pool, dtype_code(x),
                 _build.stream(x.device))
    _build.check(err, "ptt_lora_delta")
    lora_delta.launches += 1
    return out


lora_delta.launches = 0
