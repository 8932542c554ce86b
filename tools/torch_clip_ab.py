#!/usr/bin/env python3
"""Time the global-norm clip and the clipped AdamW step of the port on one
card, at the parameter shapes of the train phase's Llama (7B width, 8 of
32 layers, 1.88 B bf16 parameters with fp32 masters; 75 tensors).

Run it once per checkout, parent and change in one call, in turns:

    PYTHONPATH=<parent> python3 tools/torch_clip_ab.py --label parent
    PYTHONPATH=$PWD python3 tools/torch_clip_ab.py --label change

It times (CUDA events around the call, median of 5 after 2 warm-ups; the
host's launches included, as the eager step pays them):
- ``clip``: what the optimizer's step runs for the clip: the checkout's
  ``ClipGradByGlobalNorm.scale`` where it has one (the scale the update
  applies), else ``__call__`` (scaled copies of every gradient);
- ``clip_call``: ``__call__`` (new clipped gradients), in both;
- ``step``: ``AdamW(weight_decay=0.01, grad_clip=ClipGradByGlobalNorm
  (1.0)).step()`` over all 75 parameters, and the memory it allocates
  above what it started with (peak);
and prints one JSON line with the card's name and power limit
(nvidia-smi).
"""
from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
from paddle_tpu_torch.optimizer import AdamW


def llama_shapes(layers=8, hidden=4096, inter=11008, vocab=32000):
    shapes = [(vocab, hidden)]
    for _ in range(layers):
        shapes += [(hidden, hidden)] * 4 + [(hidden, inter)] * 2 + \
            [(inter, hidden), (hidden,), (hidden,)]
    return shapes + [(hidden,), (hidden, vocab)]


def timed(fn, reps=5, warmup=2):
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times)), times


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", required=True)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_clip_ab: needs an NVIDIA card")
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    gen = torch.Generator(device=dev).manual_seed(0)
    params = []
    for shape in llama_shapes():
        p = torch.nn.Parameter(torch.empty(shape, device=dev,
                                           dtype=torch.bfloat16))
        with torch.no_grad():
            p.normal_(0.0, 0.02, generator=gen)
        p.grad = (1e-3 * torch.randn(shape, device=dev, generator=gen)
                  ).bfloat16()
        params.append(p)
    n = sum(p.numel() for p in params)
    pg = [(p, p.grad) for p in params]
    clip = ClipGradByGlobalNorm(1.0)
    has_scale = hasattr(ClipGradByGlobalNorm, "scale")
    out = dict(label=args.label, card=card, params=n, tensors=len(params),
               clip_api="scale" if has_scale else "__call__")
    with torch.no_grad():
        out["clip_ms"], out["clip_all"] = timed(
            (lambda: clip.scale(pg)) if has_scale else (lambda: clip(pg)))
        out["clip_call_ms"], _ = timed(lambda: clip(pg))
    opt = AdamW(learning_rate=3e-4, parameters=params, weight_decay=0.01,
                grad_clip=clip)
    opt.step()                          # the state: masters, moments
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    out["step_ms"], out["step_all"] = timed(opt.step)
    out["step_extra_gb"] = (torch.cuda.max_memory_allocated(dev) - base) \
        / 1e9
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
