"""``paddle.distributed.spawn`` (port of paddle_tpu/distributed/spawn.py;
reference: python/paddle/distributed/spawn.py): start ``nprocs``
processes running ``func(*args)`` with the parallel environment's
contract set (``PADDLE_TRAINER_*``, ``RANK``, ``WORLD_SIZE``, the
master), so ``func`` calls `env.init_parallel_env` as a launched worker
would."""
from __future__ import annotations

import multiprocessing as mp
import os

from .launch.context import free_port


def _worker(func, rank, nprocs, master, args, backend):
    os.environ.update({
        "PADDLE_TRAINER_ID": str(rank),
        "PADDLE_TRAINERS_NUM": str(nprocs),
        "PADDLE_MASTER": master,
        "RANK": str(rank),
        "WORLD_SIZE": str(nprocs),
        "COORDINATOR_ADDRESS": master,
    })
    func(*args)


def spawn(func, args=(), nprocs=1, join=True, daemon=False, backend=None,
          **options):
    """Run ``func`` in ``nprocs`` processes (one: in this process);
    returns the processes (None for one).  With ``join`` it waits and
    raises when a worker exits other than 0."""
    if nprocs == 1:
        _worker(func, 0, 1, "", args, backend)
        return None
    ctx = mp.get_context("spawn")
    master = f"127.0.0.1:{free_port()}"
    procs = []
    for rank in range(nprocs):
        p = ctx.Process(target=_worker,
                        args=(func, rank, nprocs, master, args, backend),
                        daemon=daemon)
        p.start()
        procs.append(p)
    if join:
        for p in procs:
            p.join()
        bad = [p.exitcode for p in procs if p.exitcode != 0]
        if bad:
            raise RuntimeError(f"spawned workers failed: exit codes {bad}")
    return procs
