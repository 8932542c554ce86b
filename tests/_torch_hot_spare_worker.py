"""Hot-spare drill worker of the port (tests/_hot_spare_worker.py's drill
through `hapi.Model.fit`; torch, numpy and paddle_tpu_torch only).

A tiny GPT (dropout 0.1) at dp 2 over gloo, trained by ``Model.fit`` for
STEPS epochs of one batch each: a sharded ``ModelCheckpoint`` every epoch
(the disk rung) and, under ``FLAGS_hot_spare`` (the environment), a
snapshot every ``FLAGS_hot_spare_every`` steps streamed to the buddy.
Each global step draws its rank's rows from a numpy seed and reseeds the
generators the forward draws from, so a resumed incarnation replays what
an uninterrupted run did.  ``FLAGS_fault_inject=step:crash_at=3,rank=1,
once_file=...`` hard-kills rank 1 at the top of step 3 (the callback
calls ``check_step``); the survivor parks its snapshots as its fit
unwinds, and the relaunch climbs the ladder.

Each incarnation appends ``rank:world:first_step:restored_from`` to
``incarnations.log`` (``restored_from``: ``peer``, ``self``, ``disk`` or
``none``); every step appends ``{"step", "loss"}`` to
``losses.<rank>.jsonl``.  With ``HOT_SPARE_SETTLE_AT`` (the environment)
each rank waits out its agent's transfer in flight before that step, so
a committed replica stands at the buddy when the step starts (as
chip_smoke.py's ``GUARD_SETTLE_AT``).
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from paddle_tpu_torch import distributed as dist  # noqa: E402
from paddle_tpu_torch.framework import hot_spare  # noqa: E402
from paddle_tpu_torch.hapi import Model  # noqa: E402
from paddle_tpu_torch.hapi.callbacks import Callback  # noqa: E402
from paddle_tpu_torch.hapi.model import _generators  # noqa: E402
from paddle_tpu_torch.io import DataLoader  # noqa: E402
from paddle_tpu_torch.models import GPTForCausalLM, gpt_config  # noqa: E402
from paddle_tpu_torch.nn import CrossEntropyLoss  # noqa: E402
from paddle_tpu_torch.optimizer import AdamW  # noqa: E402
from paddle_tpu_torch.utils import fault_injection  # noqa: E402

STEPS, ROWS, SEQ, VOCAB = 6, 2, 16, 128


class Rows:
    """Item ``i``: row ``i % ROWS`` of global step ``i // ROWS`` of this
    rank, from a numpy seed keyed on both."""

    def __init__(self, rank):
        self.rank = rank

    def __len__(self):
        return STEPS * ROWS

    def __getitem__(self, i):
        step, row = divmod(int(i), ROWS)
        ids = np.random.default_rng(1000 * step + self.rank).integers(
            0, VOCAB, (ROWS, SEQ + 1))[row]
        return ids[:-1], ids[1:]


class EpochSteps:
    """Epoch ``e``'s one batch: global step ``e``'s rows."""

    def __init__(self):
        self.epoch = 0

    def set_epoch(self, epoch):
        self.epoch = int(epoch)

    def __len__(self):
        return 1

    def __iter__(self):
        yield [self.epoch * ROWS + j for j in range(ROWS)]


class Drill(Callback):
    def __init__(self, outdir, rank, world):
        super().__init__()
        self.outdir, self.rank, self.world = outdir, rank, world
        self.epoch, self.first = 0, True
        self.settle_at = int(os.environ.get("HOT_SPARE_SETTLE_AT", "-1"))

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch

    def on_train_batch_begin(self, step, logs=None):
        g = self.epoch + step
        if self.first:
            self.first = False
            src = (self.model.last_resume or {}).get("source") or "none"
            with open(os.path.join(self.outdir, "incarnations.log"),
                      "a") as f:
                f.write(f"{self.rank}:{self.world}:{g}:{src}\n")
        if g == self.settle_at:
            agent = hot_spare.current_agent()
            if agent is not None:
                agent.wait()
        fault_injection.check_step(g)
        for i, gen in enumerate(_generators(self.model.network)):
            gen.manual_seed(1_000_003 * g + 1009 * self.rank + i)

    def on_train_batch_end(self, step, logs=None):
        with open(os.path.join(self.outdir, f"losses.{self.rank}.jsonl"),
                  "a") as f:
            f.write(json.dumps({"step": self.epoch + step,
                                "loss": logs["loss"]}) + "\n")


def main():
    outdir = sys.argv[1]
    torch.set_num_threads(1)
    dist.init_parallel_env(backend="gloo")
    rank, world = dist.get_rank(), dist.get_world_size()
    cfg = gpt_config("gpt2-124m", num_layers=2, hidden_size=32, num_heads=4,
                     vocab_size=VOCAB, max_seq_len=SEQ, dropout=0.1,
                     attn_dropout=0.1)
    net = GPTForCausalLM(cfg, device="cpu", seed=0)
    model = Model(net).prepare(AdamW(1e-3, parameters=net.parameters()),
                               CrossEntropyLoss())
    loader = DataLoader(Rows(rank), batch_sampler=EpochSteps())
    model.fit(loader, epochs=STEPS, log_freq=1, verbose=0,
              save_dir=os.path.join(outdir, "ckpt"), max_to_keep=2,
              resume=True, callbacks=[Drill(outdir, rank, world)])
    print(f"[rank {rank}] hot-spare worker finished {STEPS} steps")
    sys.stdout.flush()


if __name__ == "__main__":
    main()
