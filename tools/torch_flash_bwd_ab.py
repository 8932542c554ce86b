#!/usr/bin/env python3
"""Time the flash attention backward of whichever paddle_tpu_torch is first
on the path, so that two checkouts can be compared on one card in one call:

    PYTHONPATH=<checkout a> python3 tools/torch_flash_bwd_ab.py --label a
    PYTHONPATH=<checkout b> python3 tools/torch_flash_bwd_ab.py --label b

Each run builds that checkout's kernels and prints one JSON line: the
card (nvidia-smi name and power limit) and, for each case, the device ms
of one call of the whole backward (``flash_attention_bwd``: delta, dK/dV
and dQ), of the dK/dV kernel and of the dQ kernel alone (on a delta
computed once by torch), and of SDPA's backward on the same inputs,
timed as (forward + backward) - forward, by torch_paged_decode_ab.py's
`device_ms` (chip_smoke.py's method: calls captured in a CUDA graph, a
64 MB write flushing L2 before each, the median of 5 replays, the
flushes' time subtracted).  Only the wrappers' public signatures are
used, so it runs against any checkout of the port since the flash
features landed.
"""
from __future__ import annotations

import argparse
import json
import subprocess

import torch
from torch_paged_decode_ab import device_ms

from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import flash_attention as fa

#: (label, b, h, s, d, features): causal, head-major, bf16, H = H_kv.
#: llama is the Llama-2 7B training shape, gpt2 GPT-2 124M's; dropout is
#: GPT-2's attention dropout, bias an additive N(0, 1) [B, 1, S, S] mask.
CASES = [
    ("llama", 1, 32, 4096, 128, None),
    ("gpt2", 8, 12, 1024, 64, None),
    ("gpt2-dropout", 8, 12, 1024, 64, "dropout"),
    ("gpt2-bias", 8, 12, 1024, 64, "bias"),
]
SEED = 20261016


def inputs(dev, gen, b, h, s, d, kind):
    def mk():
        return torch.randn(b, h, s, d, device=dev,
                           generator=gen).to(torch.bfloat16)
    q, k, v, do = mk(), mk(), mk(), mk()
    feats = dict(mask=None, segment_ids=None, dropout=0.0, seed=SEED)
    lib = dict(is_causal=True)
    if kind == "dropout":
        feats["dropout"] = lib["dropout_p"] = 0.1
    elif kind == "bias":
        bias = torch.randn(b, 1, s, s, device=dev,
                           generator=gen).to(torch.bfloat16)
        feats["mask"] = fa.additive_mask(bias)
        causal = torch.ones(s, s, dtype=torch.bool, device=dev).tril()
        lib = dict(attn_mask=bias.masked_fill(~causal, float("-inf")))
    return (q, k, v, do), feats, lib


def time_case(dev, gen, flush, b, h, s, d, kind):
    (q, k, v, do), feats, lib = inputs(dev, gen, b, h, s, d, kind)
    out, lse = fa.flash_attention_fwd(q, k, v, True, None, True, **feats)
    delta = (do.float() * out.float()).sum(-1).contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))

    def lib_fwd_bwd():
        o = sdpa(qg, kg, vg, **lib)
        torch.autograd.grad(o, (qg, kg, vg), do)
    res = dict(
        bwd=device_ms(lambda: fa.flash_attention_bwd(
            q, k, v, out, lse, do, True, None, True, **feats), flush),
        dkv=device_ms(lambda: fa.flash_bwd_dkv(
            q, k, v, do, lse, delta, True, None, True, **feats), flush),
        dq=device_ms(lambda: fa.flash_bwd_dq(
            q, k, v, do, lse, delta, True, None, True, **feats), flush),
        sdpa_bwd=device_ms(lib_fwd_bwd, flush)
        - device_ms(lambda: sdpa(q, k, v, **lib), flush))
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", required=True)
    ap.add_argument("--cases", default=",".join(c[0] for c in CASES),
                    help="comma-separated subset of the cases")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_flash_bwd_ab: needs an NVIDIA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout
    dev = torch.device("cuda", 0)
    _build.build()
    gen = torch.Generator(device=dev)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    wanted = args.cases.split(",")
    ms = {}
    for label, b, h, s, d, kind in CASES:
        if label in wanted:
            gen.manual_seed(0)
            ms[label] = time_case(dev, gen, flush, b, h, s, d, kind)
    print(json.dumps({"label": args.label, "source": _build.CSRC.as_posix(),
                      "card": card.strip().splitlines()[0], "ms": ms}),
          flush=True)


if __name__ == "__main__":
    main()
