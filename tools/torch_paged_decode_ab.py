#!/usr/bin/env python3
"""Time paged_decode_attention of whichever paddle_tpu_torch is first on
the path, so that two checkouts can be compared on one card in one call:

    PYTHONPATH=<checkout a> python3 tools/torch_paged_decode_ab.py --label a
    PYTHONPATH=<checkout b> python3 tools/torch_paged_decode_ab.py --label b

Each run builds that checkout's kernels and prints one JSON line: the
card (nvidia-smi name and power limit) and, for each case, the device ms
of one call (chip_smoke.py's method: calls captured in a CUDA graph, a
64 MB write flushing L2 before each, the median of 5 replays, the
flushes' time subtracted).  It uses only the wrapper's public signature,
so it runs against any checkout of the port.  ``--waves N`` overrides the
split plan's target (``SPLIT_WAVES``) where the checkout has one.
"""
from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import paged_decode
from paddle_tpu_torch.kernels.paged_decode import paged_decode_attention
from paddle_tpu_torch.quantization import KV_QUANT_DTYPES, quantize_kv_rows

#: (label, pool type, b, h, h_kv, page size, pages a row, offsets); D 128.
#: 7b-long is a decode step of chip_smoke.py's [profile-long] run: one
#: 4-slot batch, one row ~900 tokens long, three free rows at 0.
CASES = [
    ("7b-serve", "bf16", 4, 32, 32, 16, 64, (100, 300, 500, 620)),
    ("7b-batch32", "bf16", 32, 32, 32, 16, 64,
     tuple(900 + 4 * i for i in range(31)) + (1023,)),
    ("70b-gqa", "bf16", 4, 64, 8, 16, 256, (3000, 1, 256, 77)),
    ("7b-serve-int8", "int8", 4, 32, 32, 32, 32, (100, 300, 500, 620)),
    ("7b-serve-fp8", "fp8", 4, 32, 32, 32, 32, (100, 300, 500, 620)),
    ("7b-long", "bf16", 4, 32, 32, 16, 64, (908, 0, 0, 0)),
]


def device_ms(fn, flush, reps=20):
    def replay_ms(body):
        for _ in range(3):
            flush.zero_()
            body()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                flush.zero_()
                body()
        times = []
        for _ in range(5):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return float(np.median(times)) / reps
    return max(replay_ms(fn) - replay_ms(lambda: None), 0.0)


def inputs(dev, gen, pool, b, h, h_kv, psz, n, offsets, d=128):
    pages = 1 + b * n
    kw = {}
    if pool == "bf16":
        k_pool, v_pool = (torch.randn(pages, psz, h_kv, d, device=dev,
                                      generator=gen).to(torch.bfloat16)
                          for _ in range(2))
    else:
        sd, qmax = KV_QUANT_DTYPES[pool]
        k_pool, ks = quantize_kv_rows(torch.randn(
            pages, psz, h_kv, d, device=dev, generator=gen), qmax, sd)
        v_pool, vs = quantize_kv_rows(torch.randn(
            pages, psz, h_kv, d, device=dev, generator=gen), qmax, sd)
        kw = dict(k_scale=ks, v_scale=vs)
    q = torch.randn(b, h, d, device=dev, generator=gen).to(torch.bfloat16)
    table = (torch.randperm(pages - 1, device=dev, generator=gen) + 1) \
        .reshape(b, n).to(torch.int32)
    off = torch.tensor(offsets, dtype=torch.int32, device=dev)
    return (q, k_pool, v_pool, table, off), kw


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", required=True)
    ap.add_argument("--waves", type=int, default=None)
    args = ap.parse_args()
    if args.waves is not None:
        paged_decode.SPLIT_WAVES = args.waves
    if not torch.cuda.is_available():
        raise SystemExit("torch_paged_decode_ab: needs an NVIDIA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout
    dev = torch.device("cuda", 0)
    _build.build()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    ms = {}
    for label, pool, *geometry in CASES:
        a, kw = inputs(dev, gen, pool, *geometry)
        ms[label] = device_ms(lambda: paged_decode_attention(*a, **kw),
                              flush)
    print(json.dumps({"label": args.label, "waves": args.waves,
                      "source": _build.CSRC.as_posix(),
                      "card": card.strip().splitlines()[0], "ms": ms}),
          flush=True)


if __name__ == "__main__":
    main()
