"""Launch context (port of paddle_tpu/distributed/launch/context.py):
argument parsing, the node's description and the ``PADDLE_TRAINER_*``
contract `distributed.env.init_parallel_env` and ``fleet.init`` read
(reference: python/paddle/distributed/launch/context/__init__.py)."""
from __future__ import annotations

import argparse
import os
import socket


def free_port():
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="paddle_tpu_torch.distributed.launch",
        description="Launch distributed training "
                    "(reference: paddle.distributed.launch)")
    p.add_argument("--master", default=None,
                   help="coordinator ip:port (defaults to local free port);"
                        " with --nnodes it selects TCPStore rendezvous"
                        " (multi-pod elastic mode)")
    p.add_argument("--nnodes", default="1",
                   help="node count N, or elastic range MIN:MAX")
    p.add_argument("--node_rank", type=int, default=0,
                   help="in elastic mode only designates the store host"
                        " (rank 0); worker ranks come from rendezvous")
    p.add_argument("--pod_id", default=None,
                   help="stable pod identity for rendezvous ordering"
                        " (default: ip-pid)")
    p.add_argument("--elastic_quiet", type=float, default=1.0,
                   help="seconds membership must be stable before an"
                        " elastic rendezvous commits below MAX nodes")
    p.add_argument("--nproc_per_node", type=int, default=1)
    p.add_argument("--log_dir", default=None)
    p.add_argument("--job_id", default="default")
    p.add_argument("--devices", default=None,
                   help="visible device ids for each local process")
    p.add_argument("--max_restart", type=int, default=3)
    p.add_argument("--elastic_timeout", type=int, default=30)
    p.add_argument("training_script")
    p.add_argument("training_script_args", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


class Context:
    def __init__(self, args=None, argv=None):
        self.args = args or parse_args(argv)
        self.node_ip = os.environ.get("POD_IP", "127.0.0.1")

    def nnodes_range(self):
        """(min, max) node count: ``--nnodes 2`` is (2, 2), ``1:4``
        (1, 4)."""
        spec = str(self.args.nnodes)
        if ":" in spec:
            lo, hi = spec.split(":", 1)
            return int(lo), int(hi)
        n = int(spec)
        return n, n

    def world_size(self):
        return self.nnodes_range()[0] * self.args.nproc_per_node

    def global_rank(self, local_rank):
        return self.args.node_rank * self.args.nproc_per_node + local_rank

    def proc_env(self, local_rank, master, rank=None, world=None):
        """The ``PADDLE_TRAINER_*`` contract and the torch-style names.
        ``rank``/``world`` override the static node_rank arithmetic when a
        rendezvous assigned them (elastic mode)."""
        if rank is None:
            rank = self.global_rank(local_rank)
        if world is None:
            world = self.world_size()
        env = dict(os.environ)
        env.update({
            "PADDLE_TRAINER_ID": str(rank),
            "PADDLE_TRAINERS_NUM": str(world),
            "PADDLE_MASTER": master,
            "PADDLE_LOCAL_RANK": str(local_rank),
            "PADDLE_JOB_ID": self.args.job_id,
            "RANK": str(rank),
            "WORLD_SIZE": str(world),
            "COORDINATOR_ADDRESS": master,
        })
        # workers import the port even when it is not installed (a
        # script gets only its own directory on sys.path)
        import paddle_tpu_torch

        pkg_root = os.path.dirname(os.path.dirname(
            os.path.abspath(paddle_tpu_torch.__file__)))
        existing = env.get("PYTHONPATH")
        if not existing:
            # unset or empty: the root alone (a trailing separator would
            # put the working directory on sys.path)
            env["PYTHONPATH"] = pkg_root
        elif pkg_root not in existing.split(os.pathsep):
            env["PYTHONPATH"] = pkg_root + os.pathsep + existing
        return env
