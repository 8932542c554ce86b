#!/usr/bin/env python3
"""Time the flash attention forward and the LoRA delta of whichever
paddle_tpu_torch is first on the path, so that two checkouts can be
compared on one card in one call:

    PYTHONPATH=<checkout a> python3 tools/torch_fwd_lora_ab.py --label a
    PYTHONPATH=<checkout b> python3 tools/torch_fwd_lora_ab.py --label b

Each run builds that checkout's kernels and prints one JSON line: the
card (nvidia-smi name and power limit) and, for each case, the device ms
of one call of ``flash_attention_fwd`` and of SDPA on the same inputs
(Llama's and GPT-2's training shapes, GPT-2's with dropout 0.1 and with an
additive bias) with the forward's worst row error against the fp32 plain
version (``row_err``: a row's error over the row's own norm), and of
``lora_delta`` at Llama-2 7B's three projection geometries (a decode step
of 4 rows, four distinct adapters of rank 16) and one at a 32-token
prefill chunk, and of two ``bmm`` over stacks gathered beforehand, by
torch_paged_decode_ab.py's `device_ms` (chip_smoke.py's method: calls
captured in a CUDA graph, a 64 MB write flushing L2 before each, the
median of 5 replays, the flushes' time subtracted).  Only the wrappers'
public signatures are used, so it runs against any checkout of the port
since the flash features landed.
"""
from __future__ import annotations

import argparse
import json
import subprocess

import torch
from torch_flash_bwd_ab import CASES as FLASH_CASES
from torch_flash_bwd_ab import inputs as flash_inputs
from torch_paged_decode_ab import device_ms

from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.kernels.lora import lora_delta

#: (label, rows, tokens, din, dout): the q/k/v/o, gate/up and down
#: projections of Llama-2 7B at a decode step, and gate/up at a 32-token
#: prefill chunk, rank pool 16
LORA_CASES = [
    ("lora-4096-4096", 4, 1, 4096, 4096),
    ("lora-4096-11008", 4, 1, 4096, 11008),
    ("lora-11008-4096", 4, 1, 11008, 4096),
    ("lora-4096-11008-prefill", 4, 32, 4096, 11008),
]
RANK = 16


def row_err(got, want):
    """chip_smoke.py's `row_err`: the largest error of a row against the
    row's own norm (floored at 1e-2 of the RMS row norm)."""
    g = got.float().reshape(-1, got.shape[-1])
    w = want.float().reshape(-1, want.shape[-1])
    norm = w.norm(dim=-1)
    floor = max(1e-2 * float(norm.square().mean().sqrt()), 1e-30)
    return float(((g - w).norm(dim=-1) / norm.clamp_min(floor)).max())


def time_flash(dev, gen, flush, b, h, s, d, kind):
    (q, k, v, _), feats, lib = flash_inputs(dev, gen, b, h, s, d, kind)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out, _ = fa.flash_attention_fwd(q, k, v, True, None, True, **feats)
    want, _ = fa.flash_attention_ref(q, k, v, True, None, True, **feats)
    err = row_err(out, want)
    del out, want
    return dict(
        fwd=device_ms(lambda: fa.flash_attention_fwd(
            q, k, v, True, None, True, **feats), flush),
        sdpa=device_ms(lambda: sdpa(q, k, v, **lib), flush), row_err=err)


def time_lora(dev, gen, flush, ns, seq, din, dout):
    bf = torch.bfloat16
    x = torch.randn(ns, seq, din, device=dev, generator=gen).to(bf)
    a = (0.02 * torch.randn(5, din, RANK, device=dev, generator=gen)).to(bf)
    b = (0.02 * torch.randn(5, RANK, dout, device=dev, generator=gen)).to(bf)
    sc = torch.tensor([0.0, 1.0, 2.0, 0.5, 1.0], device=dev).to(bf)
    idx = torch.arange(ns, dtype=torch.int32, device=dev)
    i = idx.long()
    ag, bg = a[i], b[i] * sc[i][:, None, None]
    return dict(
        kernel=device_ms(lambda: lora_delta(x, a, b, sc, idx), flush),
        bmm=device_ms(lambda: torch.bmm(torch.bmm(x, ag), bg), flush))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", required=True)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_fwd_lora_ab: needs an NVIDIA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout
    dev = torch.device("cuda", 0)
    _build.build()
    gen = torch.Generator(device=dev)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    ms = {}
    for label, b, h, s, d, kind in FLASH_CASES:
        gen.manual_seed(0)
        ms[label] = time_flash(dev, gen, flush, b, h, s, d, kind)
    for label, *shape in LORA_CASES:
        gen.manual_seed(0)
        ms[label] = time_lora(dev, gen, flush, *shape)
    print(json.dumps({"label": args.label, "source": _build.CSRC.as_posix(),
                      "card": card.strip().splitlines()[0], "ms": ms}),
          flush=True)


if __name__ == "__main__":
    main()
