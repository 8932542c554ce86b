"""Training-sentinel blame drill worker of the port (tests/_sentinel_worker.py's
``blame`` mode over gloo; torch, numpy and paddle_tpu_torch only).

Two ranks launched by the port's CollectiveController fit a tiny
regression MLP with the sentinel armed while ``grad_bitflip`` corrupts
rank 1's gradients six times: both ranks skip the poisoned steps (the
found-inf is the world's), rank 1 counts the anomalies as local, the
blame lands on the guardian store and the escalation raises
`SentinelError`.  Each rank writes ``blame_report.<rank>.json``; a rank
relaunched on a shrunk world (``PADDLE_ELASTIC_RESIZED``) writes
``relaunch.<rank>.json`` and exits.  With ``argv[2] == "raise"`` the
`SentinelError` leaves the process after the report (exit 1), for the
controller's quarantine relaunch.
"""
import json
import os
import sys

import numpy as np
import torch

from paddle_tpu_torch import distributed as dist
from paddle_tpu_torch.framework.sentinel import SentinelError
from paddle_tpu_torch.hapi import Model
from paddle_tpu_torch.nn import Linear, MSELoss
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.utils.flags import set_flags

OUTDIR = sys.argv[1]


class ToyData:
    """Deterministic regression rows keyed on the index."""

    def __init__(self, n=32):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        rng = np.random.default_rng(i)
        x = rng.normal(size=(8,)).astype(np.float32)
        return x, np.tanh(np.sum(x, keepdims=True)).astype(np.float32)


def main():
    torch.set_num_threads(1)
    if os.environ.get("PADDLE_ELASTIC_RESIZED"):
        rank = int(os.environ["PADDLE_TRAINER_ID"])
        with open(os.path.join(OUTDIR, f"relaunch.{rank}.json"), "w") as f:
            json.dump({"world": int(os.environ["PADDLE_TRAINERS_NUM"]),
                       "resized": os.environ["PADDLE_ELASTIC_RESIZED"]}, f)
        return 0
    dist.init_parallel_env(backend="gloo")
    rank = dist.get_rank()
    set_flags({
        "FLAGS_sentinel": True,
        "FLAGS_compiled_train_step": False,     # grad_bitflip is a seam
        # of the eager step (the compiled step's body replays no seam)
        "FLAGS_sentinel_check_every": 2,
        "FLAGS_sentinel_max_skips": 3,
        "FLAGS_fault_inject": "grad_bitflip:rank=1,count=6",
    })
    torch.manual_seed(3)
    net = torch.nn.Sequential(Linear(8, 16, device="cpu"), torch.nn.Tanh(),
                              Linear(16, 1, device="cpu"))
    model = Model(net)
    model.prepare(optimizer=AdamW(0.01, parameters=net.parameters()),
                  loss=MSELoss())
    holder = {}
    orig = Model._install_sentinel

    def grab(self, cb):
        holder["sentinel"] = orig(self, cb)
        return holder["sentinel"]

    Model._install_sentinel = grab
    outcome = "completed"
    try:
        model.fit(ToyData(32), batch_size=4, epochs=2, verbose=0,
                  shuffle=False)
    except SentinelError as e:
        outcome = f"sentinel-error: {e}"
        error = e
    else:
        error = None
    with open(os.path.join(OUTDIR, f"blame_report.{rank}.json"), "w") as f:
        json.dump({"rank": rank, "outcome": outcome,
                   "report": holder["sentinel"].report()}, f)
    if error is not None and sys.argv[2:] == ["raise"]:
        raise error
    return 0


if __name__ == "__main__":
    sys.exit(main())
