#!/usr/bin/env python3
"""Time the RMS-norm forward and backward of whichever paddle_tpu_torch is
first on the path, so that two checkouts can be compared on one card in
one call:

    PYTHONPATH=<checkout a> python3 tools/torch_rms_norm_ab.py --label a
    PYTHONPATH=<checkout b> python3 tools/torch_rms_norm_ab.py --label b

Each run builds that checkout's kernels and prints one JSON line: the
card (nvidia-smi name and power limit), the Timer's floor (one in-place
add on a 4-element tensor: the least a captured launch costs here) and,
in bf16 and fp32, the device ms of ``rms_norm`` at 4, 128 and 4096 rows of
4096 (a decode step, a prefill chunk, the training shape, the last with
``return_rstd`` as training calls it) beside ``F.rms_norm``, and of
``rms_norm_bwd`` at 4096 x 4096 beside the autograd of ``F.rms_norm``
(its forward and backward captured together, less its forward), by
the median of five readings of torch_paged_decode_ab.py's `device_ms`
(calls captured in a CUDA graph, a 64 MB write flushing L2 before each,
the median of 5 replays, the flushes' time subtracted).  Only the wrappers' public signatures are
used, so it runs against any checkout of the port.

``--sweep`` (a checkout whose kernels/rms_norm.py has ``plan``) prints a
second line: the forward at each elements-a-thread target and rows a
block, and the backward at each elements-a-thread target and blocks an
SM, the numbers the plan's constants were chosen by.
"""
from __future__ import annotations

import argparse
import itertools
import json
import subprocess

import numpy as np
import torch
import torch.nn.functional as F
from torch_paged_decode_ab import device_ms

from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import rms_norm as rn

N = 4096
FWD_ROWS = (4, 128, 4096)
DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}
EPS = 1e-5


def ms_of(fn, flush, runs=5):
    """The median of ``runs`` `device_ms` readings: a call of a few us
    sits beside a 64 MB flush whose subtracted time varies by a few
    tenths of a us."""
    return float(np.median([device_ms(fn, flush) for _ in range(runs)]))


def inputs(dev, gen, rows, dtype):
    x = torch.randn(rows, N, device=dev, generator=gen).to(dtype)
    w = (1.0 + 0.1 * torch.randn(N, device=dev, generator=gen)).to(dtype)
    g = torch.randn(rows, N, device=dev, generator=gen).to(dtype)
    return x, w, g


def time_fwd(x, w, flush):
    rstd = x.shape[0] == 4096
    return dict(
        kernel=ms_of(lambda: rn.rms_norm(x, w, EPS, return_rstd=rstd),
                     flush),
        library=ms_of(lambda: F.rms_norm(x, (N,), w, EPS), flush))


def time_bwd(x, w, g, flush):
    _, r = rn.rms_norm(x, w, EPS, return_rstd=True)
    xg, wg = x.clone().requires_grad_(True), w.clone().requires_grad_(True)

    def lib_fwd_bwd():
        y = F.rms_norm(xg, (N,), wg, EPS)
        torch.autograd.grad(y, (xg, wg), g)
    lib_fwd = ms_of(lambda: F.rms_norm(x, (N,), w, EPS), flush)
    return dict(kernel=ms_of(lambda: rn.rms_norm_bwd(x, w, r, g), flush),
                library=ms_of(lib_fwd_bwd, flush) - lib_fwd)


def sweep(dev, gen, flush):
    """Forward and backward times at each setting of the plan's knobs."""
    keep = (rn.FWD_EPT, rn.FWD_ROWS_PER_BLOCK, rn.BWD_EPT,
            rn.BWD_BLOCKS_PER_SM)
    out = {}
    try:
        for name, dtype in DTYPES.items():
            for rows in FWD_ROWS:
                gen.manual_seed(0)
                x, w, _ = inputs(dev, gen, rows, dtype)
                per = (1, 2, 4, 8) if rows == 4096 else (1,)
                for ept, rpb in itertools.product(rn.EPTS, per):
                    rn.FWD_EPT, rn.FWD_ROWS_PER_BLOCK = ept, rpb
                    rn._cached_plan.cache_clear()
                    p = rn.device_plan(x, rows, N, True)
                    out[f"fwd-{rows}-{name}-ept{ept}-rpb{rpb}"] = dict(
                        threads=p.threads, ept=p.ept, blocks=p.blocks,
                        ms=ms_of(lambda: rn.rms_norm(x, w, EPS,
                                                     return_rstd=rows == 4096),
                                 flush))
            gen.manual_seed(0)
            x, w, g = inputs(dev, gen, 4096, dtype)
            _, r = rn.rms_norm(x, w, EPS, return_rstd=True)
            for ept, bps in itertools.product((16, 32), (1, 2, 3)):
                rn.BWD_EPT, rn.BWD_BLOCKS_PER_SM = ept, bps
                rn._cached_plan.cache_clear()
                p = rn.bwd_plan(x, w, g, x)
                out[f"bwd-4096-{name}-ept{ept}-bps{bps}"] = dict(
                    threads=p.threads, ept=p.ept, blocks=p.blocks,
                    ms=ms_of(lambda: rn.rms_norm_bwd(x, w, r, g), flush))
    finally:
        (rn.FWD_EPT, rn.FWD_ROWS_PER_BLOCK, rn.BWD_EPT,
         rn.BWD_BLOCKS_PER_SM) = keep
        rn._cached_plan.cache_clear()
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", required=True)
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_rms_norm_ab: needs an NVIDIA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout
    dev = torch.device("cuda", 0)
    _build.build()
    gen = torch.Generator(device=dev)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    tiny = torch.zeros(4, device=dev)
    ms = {"floor": ms_of(lambda: tiny.add_(1.0), flush)}
    for name, dtype in DTYPES.items():
        for rows in FWD_ROWS:
            gen.manual_seed(0)
            x, w, _ = inputs(dev, gen, rows, dtype)
            ms[f"fwd-{rows}-{name}"] = time_fwd(x, w, flush)
        gen.manual_seed(0)
        ms[f"bwd-4096-{name}"] = time_bwd(*inputs(dev, gen, 4096, dtype),
                                          flush)
    print(json.dumps({"label": args.label, "source": _build.CSRC.as_posix(),
                      "card": card.strip().splitlines()[0], "ms": ms}),
          flush=True)
    if args.sweep:
        print(json.dumps({"label": args.label, "sweep": sweep(dev, gen,
                                                              flush)}),
              flush=True)


if __name__ == "__main__":
    main()
