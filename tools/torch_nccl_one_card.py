#!/usr/bin/env python3
"""Several ranks on one CUDA card through NCCL, as the port runs them.

    python3 tools/torch_nccl_one_card.py [--world 2] [--mb 16]
        [--timeout 90] [--log-dir DIR]

NCCL refuses two ranks on one device ("Duplicate GPU detected").  Each
rank joins through `distributed.env.init_parallel_env` with the card
named, which gives ranks that outnumber the cards an NCCL host id each
and NCCL's socket transport on the loopback interface
(`distributed.env.one_card_nccl_env`).  Other ``NCCL_*`` variables in the
environment pass through to the ranks.

Each rank logs every phase with its time into ``DIR/nccl-w<world>/
<rank>.log`` as it goes: the process group's start, all_reduce,
all_gather_into_tensor, reduce_scatter_tensor, broadcast and a send/recv
ring against their sums, an all_reduce of ``--mb`` MB of bf16 (eager, 3
times), and an all_reduce captured in a CUDA graph between two
elementwise ops, replayed 3 times and then timed over 10 replays.  The
parent waits at most ``--timeout`` seconds, kills the ranks that are
left, prints every rank's log and one JSON line ``{"world", "ok",
"wall_s", "error", "phases"}`` (``phases``: the phases every rank
finished), and exits 0 only when all of them passed.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

PHASES = ("init", "all_reduce", "all_gather", "reduce_scatter", "broadcast",
          "send_recv", "big_all_reduce", "graph_all_reduce", "done")


def _rank(rank, world, init, mb, log_dir):
    from paddle_tpu_torch.distributed import env
    log = open(os.path.join(log_dir, f"{rank}.log"), "w", buffering=1)
    t0 = time.monotonic()

    def note(phase, ok=True, extra=""):
        log.write(f"{time.monotonic() - t0:8.3f}s {phase} "
                  f"{'ok' if ok else 'FAILED'} {extra}\n")

    dev = torch.device("cuda", 0)
    env.init_parallel_env(backend="nccl", device=dev, init_method=init,
                          world_size=world, rank=rank)
    note("init")
    want = world * (world + 1) / 2
    x = torch.full((1024,), float(rank + 1), device=dev)
    dist.all_reduce(x)
    torch.cuda.synchronize()
    note("all_reduce", bool((x == want).all()))
    parts = torch.empty(world * 8, device=dev)
    dist.all_gather_into_tensor(parts, torch.full((8,), float(rank),
                                                  device=dev))
    torch.cuda.synchronize()
    note("all_gather", bool(torch.equal(parts, torch.arange(
        world, device=dev, dtype=torch.float32).repeat_interleave(8))))
    rs = torch.empty(8, device=dev)
    dist.reduce_scatter_tensor(rs, torch.arange(world * 8, device=dev,
                                                dtype=torch.float32))
    torch.cuda.synchronize()
    note("reduce_scatter", bool(torch.equal(rs, world * torch.arange(
        rank * 8, rank * 8 + 8, device=dev, dtype=torch.float32))))
    b = torch.full((4,), float(rank), device=dev)
    dist.broadcast(b, src=world - 1)
    torch.cuda.synchronize()
    note("broadcast", bool((b == world - 1).all()))
    buf = torch.full((4,), float(rank), device=dev)
    got = torch.empty_like(buf)
    for w in dist.batch_isend_irecv([
            dist.P2POp(dist.isend, buf, (rank + 1) % world),
            dist.P2POp(dist.irecv, got, (rank - 1) % world)]):
        w.wait()
    torch.cuda.synchronize()
    note("send_recv", bool((got == (rank - 1) % world).all()))
    big = torch.ones(mb * (1 << 19), dtype=torch.bfloat16, device=dev)
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t1 = time.monotonic()
        dist.all_reduce(big)
        torch.cuda.synchronize()
        times.append((time.monotonic() - t1) * 1e3)
    note("big_all_reduce", True, f"{mb} MB ms {[round(t, 2) for t in times]}")
    # one eager call on the capture stream, then the capture
    y = torch.full((1024,), float(rank + 1), device=dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        dist.all_reduce(y)
    torch.cuda.current_stream(dev).wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=side):
        y.mul_(2.0)
        dist.all_reduce(y)
        y.add_(1.0)
    ok = True
    for _ in range(3):
        y.fill_(float(rank + 1))
        g.replay()
        torch.cuda.synchronize()
        ok &= bool((y == 2 * want + 1).all())
    t1 = time.monotonic()
    for _ in range(10):
        g.replay()
    torch.cuda.synchronize()
    note("graph_all_reduce", ok,
         f"replay ms {(time.monotonic() - t1) * 100:.3f}")
    # torch's NCCL barrier and the process group's teardown hang ranks
    # that share a card: a token all-reduce, then an exit without one
    tok = torch.zeros(1, device=dev)
    dist.all_reduce(tok)
    torch.cuda.synchronize()
    note("done")
    log.close()
    os._exit(0)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--mb", type=int, default=16)
    ap.add_argument("--timeout", type=float, default=90.0)
    ap.add_argument("--log-dir", default="chiprun_out/nccl_probe")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        sys.exit(1)
    log_dir = os.path.join(args.log_dir, f"nccl-w{args.world}")
    os.makedirs(log_dir, exist_ok=True)
    print(f"[nccl-w{args.world}] torch {torch.__version__} cuda "
          f"{torch.version.cuda} nccl {torch.cuda.nccl.version()} card "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}",
          flush=True)
    finished, err = False, None
    with tempfile.TemporaryDirectory() as tmp:
        os.environ.setdefault("NCCL_DEBUG", "WARN")
        t0 = time.monotonic()
        ctx = mp.start_processes(
            _rank, args=(args.world, "file://" + os.path.join(tmp, "rdzv"),
                         args.mb, log_dir),
            nprocs=args.world, join=False, start_method="spawn")
        while time.monotonic() - t0 < args.timeout:
            try:
                if ctx.join(timeout=1.0):
                    finished = True
                    break
            except Exception as e:  # noqa: BLE001 — reported below
                err = f"{type(e).__name__}: {e}"
                break
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
        wall = time.monotonic() - t0
    done = None
    for r in range(args.world):
        path = os.path.join(log_dir, f"{r}.log")
        lines = open(path).read().splitlines() if os.path.exists(path) \
            else []
        print(f"[nccl-w{args.world}] rank {r}:", flush=True)
        for ln in lines:
            print(f"    {ln}", flush=True)
        ok_phases = [ln.split()[1] for ln in lines if ln.split()[2] == "ok"]
        done = ok_phases if done is None else \
            [p for p in done if p in ok_phases]
    ok = finished and done == list(PHASES)
    print(json.dumps({"world": args.world, "ok": ok, "wall_s": round(wall, 1),
                      "error": err, "phases": done}), flush=True)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
