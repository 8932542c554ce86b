"""Hang-guardian drill worker of the port (tests/_guardian_worker.py's
loop over gloo; torch, numpy and paddle_tpu_torch only).

A 2-process data-parallel training loop: each step all-reduces every
gradient (AVG) and the loss (AVG), rank 0 checkpoints through
CheckpointManager, and a barrier closes the step: 6 collectives a step,
so ``at_seq=6`` is step 1's first all-reduce and ``at_seq=18`` step 3's.
The guardian's fault points (``FLAGS_fault_inject``) drive the drills:

- ``collective_delay:op=all_reduce,at_seq=6,delay_s=...,rank=1`` stalls
  rank 1; rank 0's watchdog times out, writes the stall dump blaming
  rank 1 and aborts;
- ``rank_crash:at_seq=18,rank=1,once_file=...`` kills rank 1 after
  recording its error; rank 0 aborts with rank 1's original error and
  exits 101, the controller relaunches, and the run resumes from the
  newest checkpoint.

``argv[2] == "off"`` turns the guardian off (no trap, no timeout) for the
armed-against-off comparison.  Each incarnation appends its first step to
``incarnations.{rank}.log``; a completed run writes ``losses.{rank}.json``
(each step's global mean loss, exact floats).
"""
import json
import os
import sys

import numpy as np
import torch

from paddle_tpu_torch import distributed as dist
from paddle_tpu_torch.distributed import watchdog
from paddle_tpu_torch.framework.checkpoint_manager import CheckpointManager
from paddle_tpu_torch.optimizer import SGD

TOTAL_STEPS = 6


def main():
    outdir = sys.argv[1]
    torch.set_num_threads(1)
    dist.init_parallel_env(backend="gloo")
    rank = dist.get_rank()
    assert dist.get_world_size() == 2
    if len(sys.argv) > 2 and sys.argv[2] == "off":
        watchdog.configure(store=None)
        assert watchdog.begin("all_reduce", dist.get_group()) is None

    mgr = CheckpointManager(os.path.join(outdir, "ckpts"), max_to_keep=3,
                            map_location="cpu")
    torch.manual_seed(7)
    model = torch.nn.Sequential(torch.nn.Linear(4, 8), torch.nn.Tanh(),
                                torch.nn.Linear(8, 2))
    opt = SGD(0.05, parameters=model.parameters())

    start_step, losses = 0, []
    restored = mgr.restore_latest()
    if restored is not None:
        state, _step = restored
        model.load_state_dict(state["model"])
        opt.set_state_dict(state["optimizer"])
        start_step = int(state["step"]) + 1
        losses = list(state["losses"])

    with open(os.path.join(outdir, f"incarnations.{rank}.log"), "a") as f:
        f.write(f"{start_step}\n")

    for step in range(start_step, TOTAL_STEPS):
        # the batch is keyed on (step, rank): a resumed incarnation
        # replays the same one
        rng = np.random.default_rng(1000 * step + rank)
        x = torch.from_numpy(rng.standard_normal((4, 4)).astype(np.float32))
        y = torch.from_numpy(rng.standard_normal((4, 2)).astype(np.float32))
        loss = ((model(x) - y) ** 2).mean()
        loss.backward()
        for p in model.parameters():
            dist.all_reduce(p.grad, op=dist.ReduceOp.AVG)
        opt.step()
        opt.clear_grad()
        # the global mean loss: the same on every rank, so the trajectory
        # rank 0 checkpoints restores on either
        lt = loss.detach().reshape(1).clone()
        dist.all_reduce(lt, op=dist.ReduceOp.AVG)
        losses.append(float(lt[0]))
        if rank == 0:
            mgr.save({"model": model.state_dict(),
                      "optimizer": opt.state_dict(),
                      "step": step, "losses": losses}, step=step)
            mgr.wait()
        dist.barrier()

    with open(os.path.join(outdir, f"losses.{rank}.json"), "w") as f:
        json.dump(losses, f)
    print(f"[rank {rank}] guardian worker finished {TOTAL_STEPS} steps")
    sys.stdout.flush()


if __name__ == "__main__":
    main()
