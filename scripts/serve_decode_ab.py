"""A/B of serve's decode ms/step between two checkouts, on one card.

Each checkout's own ``chip_smoke.py`` serves the serve phase's prompts cut
to their first 64 tokens, all greedy (every tick the greedy graph), on
Llama-2 7B in bf16 with 4 slots (``serve_cfg``), through its
``serve_run``: one process a turn, in the order A B B A repeated
``--rounds`` times, each process one untimed lane and then ``--lanes``
timed ones.  Each lane prints one JSON line (decode and tick ms/step p50
and avg from that checkout's stats); the last line holds the mean and the
median of each side's lane p50s, decode and tick, and B - A.  Each
checkout builds its kernels into its own ``csrc/build``.

    python3 scripts/serve_decode_ab.py --a PARENT_CHECKOUT --b . --rounds 2
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys


def lane(root, tag, lanes):
    sys.path.insert(0, root)
    os.chdir(root)
    import torch
    import chip_smoke as cs
    if hasattr(cs, "SERVE_RECORD"):          # its exact percentiles
        cs.SERVE_RECORD.install()
    cs.phase_device()                        # exits without a card
    cs._build.build()
    cs._build.library()
    dev = torch.device("cuda", 0)
    model = cs.build_7b(dev)
    prompts, _ = cs.serve_requests(model.config.vocab_size)
    prompts = [p[:64] for p in prompts]
    greedy = [cs.SamplingParams()] * len(prompts)
    cs.serve_run(model, dev, cs.serve_cfg(), prompts, greedy)
    for i in range(lanes):
        st = cs.serve_run(model, dev, cs.serve_cfg(), prompts, greedy)[1]
        print("AB " + json.dumps(dict(
            side=tag, lane=i, decode_ms_p50=st["decode_ms_p50"],
            decode_ms_avg=st["decode_ms_avg"], tick_ms_p50=st["tick_ms_p50"],
            tick_ms_avg=st["tick_ms_avg"], decode_steps=st["decode_steps"],
            compiled_hits=st["tick_compiled_hits"])), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--a", help="checkout A (the parent)")
    ap.add_argument("--b", help="checkout B (the change)")
    ap.add_argument("--rounds", type=int, default=2,
                    help="repeats of the order A B B A")
    ap.add_argument("--lanes", type=int, default=4,
                    help="timed lanes a process")
    ap.add_argument("--lane", nargs=3, metavar=("ROOT", "SIDE", "LANES"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.lane:
        lane(os.path.abspath(args.lane[0]), args.lane[1],
             int(args.lane[2]))
        return
    if not (args.a and args.b):
        ap.error("--a and --b are required")
    rows = []
    for side in "ABBA" * args.rounds:
        root = os.path.abspath(args.a if side == "A" else args.b)
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--lane", root,
             side, str(args.lanes)], capture_output=True, text=True,
            timeout=600)
        mine = [json.loads(line[3:]) for line in out.stdout.splitlines()
                if line.startswith("AB ")]
        for r in mine:
            print(json.dumps(r), flush=True)
        if out.returncode != 0 or len(mine) != args.lanes:
            sys.exit(f"side {side} ({root}) exited {out.returncode}:\n"
                     f"{out.stdout[-3000:]}{out.stderr[-3000:]}")
        rows += mine
    summary = {}
    for stat in ("decode_ms_p50", "tick_ms_p50"):
        for name, fn in (("mean", statistics.mean),
                         ("median", statistics.median)):
            got = {s: fn([r[stat] for r in rows if r["side"] == s])
                   for s in "AB"}
            summary[f"{stat}_{name}"] = dict(a=got["A"], b=got["B"],
                                             b_minus_a=got["B"] - got["A"])
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
