#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printed as it ends; any failure exits non-zero before the
last line:

1. device   the card's name and power limit (nvidia-smi); no card → exit 1
2. build    both CUDA kernels built with nvcc for sm_90a from csrc/
3. kernels  each kernel against its plain PyTorch version on the card at
            the serving path's shapes, with its time, the plain version's,
            one PyTorch library call's and the bound from bytes moved
4. serve    Llama-2 7B at full width (32 layers, bf16, random weights
            from a seed) behind the paged Engine: 8 requests, both
            kernels' launch counts checked against the steps taken; then
            torch.profiler over a short serving run (device busy share,
            device time by kernel)
5. parity   a 2-layer model at the 7B widths in fp32 with the same
            weights served on the CPU (plain versions) and on the card
            (kernels): greedy outputs must be identical

The second-to-last line is the kernels' JSON summary, the last line
``{"ok": true, "device": {...}}``.  ``--phases`` runs a subset.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from paddle_tpu_torch import kernels
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels.paged_decode import (paged_decode_attention,
                                                   paged_decode_ref)
from paddle_tpu_torch.kernels.rms_norm import rms_norm, rms_norm_ref
from paddle_tpu_torch.models import LlamaForCausalLM, llama_config
from paddle_tpu_torch.serving import Engine, SamplingParams, ServingConfig

HBM_BYTES_PER_S = 3.35e12                   # H100 SXM data sheet
PEAK_OPS = {torch.bfloat16: 989e12, torch.float16: 989e12,
            torch.float32: 67e12}           # dense; fp32 outside tensor cores
PHASES = ("device", "build", "kernels", "serve", "parity")


def log(msg):
    print(msg, flush=True)


# ---------------------------------------------------------------- timing
class Timer:
    """Device time of one call: ``reps`` calls, each after a write of
    64 MB that flushes the 50 MB L2 (the serving path finds K/V cold),
    are captured in one CUDA graph and replayed between CUDA events, so
    no host launch time sits between them; a graph of the flushes alone
    is subtracted.  The median of 5 replays, per call."""

    def __init__(self, dev, reps=20):
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
        self.reps = reps
        self.flush_ms = self._replay_ms(lambda: None)

    def _replay_ms(self, fn):
        for _ in range(3):                  # warm up outside the capture
            self.flush.zero_()
            fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(self.reps):
                self.flush.zero_()
                fn()
        times = []
        for _ in range(5):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        del graph
        return float(np.median(times))

    def __call__(self, fn):
        return max(self._replay_ms(fn) - self.flush_ms, 0.0) / self.reps


def bound(bytes_moved, ops, dtype):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def check_close(name, got, want, dtype):
    """fp32: rtol = atol = 2e-5.  bf16: compared in fp32 with atol 2e-2
    and rtol 1e-2 (one bf16 ulp is 2^-7 relative; the kernel and the
    plain version sum in different orders and may round a value to the
    neighbouring bf16)."""
    tol = dict(rtol=2e-5, atol=2e-5) if dtype == torch.float32 else \
        dict(rtol=1e-2, atol=2e-2)
    if not torch.allclose(got.float(), want.float(), **tol):
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version, max abs err {max_err(got, want)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite output")


# ---------------------------------------------------------------- phases
def phase_device():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; the port's smoke run needs "
                 "an NVIDIA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    log(card)
    log(f"[device] {name}, {torch.cuda.device_count()} card(s), torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return name, card


def phase_build():
    t0 = time.monotonic()
    path = _build.build()
    _build.library()
    log(f"[build] {path.name} built in {time.monotonic() - t0:.2f} s "
        f"(nvcc, sm_90a, sources {[p.name for p in _build.sources()]})")


def rms_case(dev, rows, n, dtype, gen, timer=None):
    x = torch.randn(rows, n, device=dev, generator=gen).to(dtype)
    w = (1.0 + 0.1 * torch.randn(n, device=dev, generator=gen)).to(dtype)
    eps = 1e-5
    y = rms_norm(x, w, eps)
    torch.cuda.synchronize()
    want = rms_norm_ref(x, w, eps)
    check_close(f"rms_norm[{rows}x{n} {dtype}]", y, want, dtype)
    err = max_err(y, want)
    if timer is None:
        return err, None
    es = x.element_size()
    b_ms, b_by = bound(2 * rows * n * es + n * w.element_size(),
                       4 * rows * n, dtype)
    res = dict(ms=timer(lambda: rms_norm(x, w, eps)),
               plain_ms=timer(lambda: rms_norm_ref(x, w, eps)),
               library_ms=timer(lambda: torch.nn.functional.rms_norm(
                   x, (n,), w, eps)),
               bound_ms=b_ms, bound_by=b_by)
    return err, res


def paged_case(dev, b, h, h_kv, d, psz, n_pages, offsets, dtype, gen,
               free_row=None, timer=None):
    """Pools of b * n_pages + 1 pages, a random page table; ``free_row``
    gets an all-zero table at offset 0 (a free slot on scratch page 0)."""
    pool_pages = 1 + b * n_pages
    k_pool = torch.randn(pool_pages, psz, h_kv, d, device=dev,
                         generator=gen).to(dtype)
    v_pool = torch.randn(pool_pages, psz, h_kv, d, device=dev,
                         generator=gen).to(dtype)
    q = torch.randn(b, h, d, device=dev, generator=gen).to(dtype)
    perm = torch.randperm(pool_pages - 1, device=dev, generator=gen) + 1
    table = perm.reshape(b, n_pages).to(torch.int32)
    off = torch.tensor(offsets, dtype=torch.int32, device=dev)
    if free_row is not None:
        table[free_row] = 0
    out = paged_decode_attention(q, k_pool, v_pool, table, off)
    torch.cuda.synchronize()
    want = paged_decode_ref(q, k_pool, v_pool, table, off)
    name = (f"paged_decode[B={b} H={h} Hkv={h_kv} D={d} psz={psz} "
            f"off={list(offsets)} {dtype}]")
    check_close(name, out, want, dtype)
    err = max_err(out, want)
    if timer is None:
        return err, None
    es = k_pool.element_size()
    tokens = sum(o + 1 for o in offsets)
    live_pages = sum(o // psz + 1 for o in offsets)
    bytes_moved = (2 * b * h * d * q.element_size()          # q, out
                   + 2 * tokens * h_kv * d * es                # K, V
                   + 4 * live_pages + 4 * b)                   # table, offsets
    b_ms, b_by = bound(bytes_moved, 4 * h * d * tokens, dtype)
    # the library yardstick: SDPA over the cache gathered beforehand
    # (gather not timed), heads expanded for GQA, a boolean mask per row
    s = n_pages * psz
    kg = k_pool[table.long()].reshape(b, s, h_kv, d).transpose(1, 2)
    vg = v_pool[table.long()].reshape(b, s, h_kv, d).transpose(1, 2)
    kg = kg.repeat_interleave(h // h_kv, dim=1).contiguous()
    vg = vg.repeat_interleave(h // h_kv, dim=1).contiguous()
    mask = (torch.arange(s, device=dev)[None, :] <= off.long()[:, None]) \
        [:, None, None, :]
    q4 = q[:, :, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    res = dict(ms=timer(lambda: paged_decode_attention(q, k_pool, v_pool,
                                                       table, off)),
               plain_ms=timer(lambda: paged_decode_ref(q, k_pool, v_pool,
                                                       table, off)),
               library_ms=timer(lambda: sdpa(q4, kg, vg, attn_mask=mask)),
               bound_ms=b_ms, bound_by=b_by)
    return err, res


def fmt(res):
    return (f"kernel {res['ms']:.4f} ms, plain {res['plain_ms']:.4f} ms, "
            f"library {res['library_ms']:.4f} ms, bound {res['bound_ms']:.5f}"
            f" ms ({res['bound_by']})")


def phase_kernels(dev):
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    timer = Timer(dev)
    errs = {"rms_norm": 0.0, "paged_decode": 0.0}
    timed = {}
    # RMS norm: a decode step (4 rows), a 4 x 32 prefill chunk, 4096 rows
    for dtype in (torch.float32, torch.bfloat16):
        for rows in (4, 128, 4096):
            err, res = rms_case(dev, rows, 4096, dtype, gen, timer)
            errs["rms_norm"] = max(errs["rms_norm"], err)
            log(f"[kernels] rms_norm rows={rows} N=4096 {dtype}: max abs err"
                f" {err:.3e}; {fmt(res)}")
            timed[("rms_norm", rows, dtype)] = res
        err, _ = rms_case(dev, 3, 100, dtype, gen)    # scalar tail path
        errs["rms_norm"] = max(errs["rms_norm"], err)
    # paged decode: Llama-2 7B heads (32/32, D 128, page 16) and 70B's
    # GQA heads (64/8); ragged offsets with a free row at 0, page edges,
    # a 4000-token row, and the serving run's 1024-token table
    cases = [
        ("7b-serve", dict(b=4, h=32, h_kv=32, d=128, psz=16, n_pages=64,
                          offsets=(100, 300, 500, 620))),
        ("7b-edges", dict(b=4, h=32, h_kv=32, d=128, psz=16, n_pages=256,
                          offsets=(0, 15, 496, 4000), free_row=0)),
        ("7b-bounds", dict(b=4, h=32, h_kv=32, d=128, psz=16, n_pages=64,
                           offsets=(511, 512, 1023, 16))),
        ("70b-gqa", dict(b=4, h=64, h_kv=8, d=128, psz=16, n_pages=256,
                         offsets=(3000, 1, 256, 77))),
    ]
    for dtype in (torch.float32, torch.bfloat16):
        for label, kw in cases:
            err, res = paged_case(dev, dtype=dtype, gen=gen, timer=timer,
                                  **kw)
            errs["paged_decode"] = max(errs["paged_decode"], err)
            log(f"[kernels] paged_decode {label} {dtype}: max abs err "
                f"{err:.3e}; {fmt(res)}")
            timed[("paged_decode", label, dtype)] = res
    return errs, {"rms_norm": timed[("rms_norm", 4, torch.bfloat16)],
                  "paged_decode": timed[("paged_decode", "7b-serve",
                                         torch.bfloat16)]}


def serve_requests(vocab, seed=0):
    """8 requests: 17..600-token prompts, two sharing a 64-token prefix,
    six greedy and two seeded-sampled, 32 new tokens each."""
    rng = np.random.default_rng(seed)
    lens = [17, 600] + [int(n) for n in rng.integers(65, 600, 6)]
    prompts = [rng.integers(0, vocab, (n,)).astype(np.int32) for n in lens]
    # request 5 shares request 2's first 64 tokens (4 pages): it is
    # admitted after a slot frees, by when request 2's prompt pages sit
    # in the prefix tree
    prompts[5][:64] = prompts[2][:64]
    sampling = [SamplingParams() for _ in lens]
    sampling[3] = SamplingParams(temperature=0.8, top_k=50, top_p=0.95,
                                 seed=3)
    sampling[6] = SamplingParams(temperature=1.0, top_p=0.9,
                                 repetition_penalty=1.1, seed=6)
    return prompts, sampling


def profile_decode(model, dev, vocab):
    """torch.profiler over a short serving run (2 greedy requests, one
    chunk of prefill, 16 decode steps): device time by kernel and the
    device's busy share of the wall time."""
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, vocab, (n,)).astype(np.int32)
               for n in (20, 30)]
    with Engine(model, ServingConfig(num_slots=4, max_seq_len=1024,
                                     cache_dtype="bfloat16")) as eng:
        eng.generate(prompts[0], max_new_tokens=2)      # warm
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            futs = [eng.submit(p, max_new_tokens=17) for p in prompts]
            for f in futs:
                f.result(timeout=300)
            wall_ms = (time.monotonic() - t0) * 1e3
        st = eng.stats()
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.self_device_time_total > 0]
    busy_ms = sum(r[1] for r in rows)
    log(f"[profile] wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
        f"({100 * busy_ms / wall_ms:.1f}%), decode steps "
        f"{st['decode_steps']}, prefill calls {st['prefill_calls']}")
    for key, ms, count in sorted(rows, key=lambda r: -r[1])[:12]:
        log(f"[profile]   {ms:9.3f} ms  {count:6d}x  {key[:90]}")


def phase_serve(dev):
    cfg = llama_config("llama2-7b")
    t0 = time.monotonic()
    model = LlamaForCausalLM(cfg, device=dev, dtype=torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    log(f"[serve] Llama-2 7B ({model.num_params() / 1e9:.2f} B params, "
        f"bf16, random weights, seed 0) built in "
        f"{time.monotonic() - t0:.1f} s")
    prompts, sampling = serve_requests(cfg.vocab_size)
    scfg = ServingConfig(num_slots=4, max_seq_len=1024,
                         cache_dtype="bfloat16")
    eng = Engine(model, scfg)
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launch_counts()
    t0 = time.monotonic()
    with eng:
        futs = [eng.submit(p, max_new_tokens=32, sampling=s)
                for p, s in zip(prompts, sampling)]
        outs = [f.result(timeout=900) for f in futs]
    wall = time.monotonic() - t0
    counts = kernels.launch_counts()
    st = eng.stats()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    for o in outs:
        if o.output_ids.size != 32 or o.finish_reason != "length":
            raise AssertionError(f"request {o.request_id}: {o.output_ids.size}"
                                 f" tokens, finish {o.finish_reason}")
        if not ((o.output_ids >= 0) & (o.output_ids < cfg.vocab_size)).all():
            raise AssertionError(f"request {o.request_id}: token outside "
                                 "the vocab")
    decode_steps = st["decode_steps"]
    prefill_calls = st["prefill_calls"]
    calls = decode_steps + prefill_calls
    need = {"paged_decode": cfg.num_layers * decode_steps,
            "rms_norm": (2 * cfg.num_layers + 1) * calls}
    for name, n in need.items():
        if counts[name] < n or counts[name] == 0:
            raise AssertionError(f"{name}: {counts[name]} launches, expected"
                                 f" >= {n}")
    if st.get("prefix_cache_hits", 0) < 1:
        raise AssertionError("the shared 64-token prefix was not reused")
    log(f"[serve] 8 requests ({sum(p.size for p in prompts)} prompt tokens,"
        f" {st['tokens_generated']} generated) in {wall:.2f} s: TTFT p50 "
        f"{st['ttft_ms_p50']:.1f} ms, decode {st['decode_ms_p50']:.2f} "
        f"ms/step p50 ({st['decode_ms_avg']:.2f} avg) over {decode_steps} "
        f"steps, prefill chunk {st['prefill_chunk_ms_p50']:.2f} ms p50 over "
        f"{prefill_calls} calls, {st['tokens_generated'] / wall:.1f} "
        f"tokens/s wall ({st['tokens_per_sec']:.1f} engine), prefix hits "
        f"{st['prefix_cache_hits']}, peak memory {peak_gb:.2f} GB")
    log(f"[serve] launches {counts} (needed >= {need})")
    profile_decode(model, dev, cfg.vocab_size)
    del eng, model
    torch.cuda.empty_cache()
    return counts


def phase_parity(dev):
    """The same 2-layer fp32 model on the CPU and on the card."""
    cfg = llama_config("llama2-7b", num_layers=2, max_seq_len=256)
    t0 = time.monotonic()
    cpu_model = LlamaForCausalLM(cfg, device="cpu", seed=1)
    card_model = LlamaForCausalLM(cfg, device=dev, seed=1)
    card_model.load_state_dict(cpu_model.state_dict())
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in (5, 40, 23)]
    outs = {}
    before = kernels.launch_counts()
    for label, model in (("cpu", cpu_model), ("card", card_model)):
        with Engine(model, ServingConfig(num_slots=4)) as eng:
            futs = [eng.submit(p, max_new_tokens=8) for p in prompts]
            outs[label] = [f.result(timeout=600).output_ids for f in futs]
    after = kernels.launch_counts()
    for a, b in zip(outs["cpu"], outs["card"]):
        if not np.array_equal(a, b):
            raise AssertionError(f"greedy outputs differ: cpu {a.tolist()} "
                                 f"card {b.tolist()}")
    if any(after[k] == before[k] for k in after):
        raise AssertionError(f"the card run skipped a kernel: {before} → "
                             f"{after}")
    log(f"[parity] 2-layer 7B-width fp32: greedy outputs identical on the "
        f"CPU and the card for 3 prompts ({time.monotonic() - t0:.1f} s): "
        f"{[o.tolist() for o in outs['card']]}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    name, card = phase_device()
    dev = torch.device("cuda", 0)
    if "build" in phases:
        phase_build()
    errs, timed = {}, {}
    if "kernels" in phases:
        errs, timed = phase_kernels(dev)
    counts = None
    if "serve" in phases:
        counts = phase_serve(dev)
    if "parity" in phases:
        phase_parity(dev)
    if timed and counts is not None:
        meta = {"rms_norm": ("csrc/rms_norm.cu", "paddle_tpu/pallas/fused.py:92"),
                "paged_decode": ("csrc/paged_decode.cu",
                                 "paddle_tpu/pallas/flash_attention.py:860")}
        summary = [dict(name=k, route="cuda",
                        source="paddle_tpu_torch/" + meta[k][0],
                        replaces=meta[k][1], launches=counts[k],
                        max_abs_err=errs[k], **timed[k])
                   for k in ("rms_norm", "paged_decode")]
        log(json.dumps({"kernels": summary}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
