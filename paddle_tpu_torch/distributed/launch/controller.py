"""Collective controller (port of
paddle_tpu/distributed/launch/controller.py): start, watch and restart
the local worker processes (reference: launch/controllers/collective.py,
controllers/watcher.py, master.py's KV rendezvous, and the
fleet/elastic ``ELASTIC_EXIT_CODE`` relaunch protocol).

    python -m paddle_tpu_torch.distributed.launch --nproc_per_node 2 \\
        --max_restart 1 --log_dir logs train.py --lr 0.1

Each worker gets the ``PADDLE_TRAINER_*`` contract (`context.Context.
proc_env`), ``LOCAL_WORLD_SIZE`` (this host's ranks) and, when the host's
ranks outnumber its cards, ``FLAGS_selected_gpus`` (local rank modulo
the cards, or ``--devices``): such ranks share a card, and
`distributed.env.init_parallel_env` gives them NCCL's socket transport
(`env.one_card_nccl_env`).

**The hang and failure guardian.**  The controller exports a cross-rank
error-trap store to its workers (``PADDLE_GUARDIAN_DIR``, a shared
directory; the elastic controller exports its TCP store's endpoint as
``PADDLE_GUARDIAN_STORE`` instead).  A failing rank records its
exception there before dying; the controller prints that original error
as the blame line, the healthy peers' watchdogs abort their blocked
collectives with it and exit ``ELASTIC_EXIT_CODE``, and the restart loop
relaunches into the workers' resume.  After a worker fails the others
get ``PADDLE_GUARDIAN_PEER_GRACE_S`` (0) seconds to exit on their own;
reaping then escalates SIGTERM → SIGKILL after
``PADDLE_GUARDIAN_TERM_GRACE_S`` (10) seconds, so a worker wedged in a
collective never hangs the controller.  A rank the training sentinel
blamed (``{job}/sentinel/blame``) is quarantined at the relaunch: the
world shrinks by one and the workers get ``PADDLE_ELASTIC_RESIZED``.

The hot-spare buddy map (`_advertise_hot_spare`) is not ported: with
``FLAGS_hot_spare`` set it raises (ROADMAP A8), else it does nothing.
"""
from __future__ import annotations

import os
import signal
import subprocess
import sys
import tempfile
import time

from .context import Context, free_port

ELASTIC_EXIT_CODE = 101  # reference: fleet/elastic/manager.py:32
_HOT_SPARE = ("FLAGS_hot_spare: the hot-spare buddy map is not ported "
              "(ROADMAP A8)")


def _fault_level():
    """reference: manager.py:178, env PADDLE_ELASTIC_FAULT_TOLERANC_LEVEL
    (the reference's spelling): 0 = only ELASTIC_EXIT_CODE relaunches;
    above 0 = any worker failure relaunches (up to max_restart)."""
    return int(os.environ.get("PADDLE_ELASTIC_FAULT_TOLERANC_LEVEL", "0"))


def _card_count():
    import torch
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


class CollectiveController:
    def __init__(self, ctx: Context):
        self.ctx = ctx
        self.procs = []
        master = ctx.args.master
        if master is None:
            master = f"127.0.0.1:{free_port()}"
        self.master = master
        self._trap = None

    # ---- guardian plumbing ----
    def _guardian_env(self):
        """The environment entries that point workers at the error trap."""
        if self._trap is None:
            args = self.ctx.args
            root = os.path.join(args.log_dir, "guardian") if args.log_dir \
                else tempfile.mkdtemp(prefix="pt_guardian_")
            from ..store import FileKVStore
            from ..watchdog import ErrorTrap
            # rank=-1: every worker's record reads as a "peer" here
            self._trap = ErrorTrap(FileKVStore(root),
                                   job=args.job_id, rank=-1)
            self._guardian = {"PADDLE_GUARDIAN_DIR": root}
        return self._guardian

    def _guardian_blame(self):
        """Print (and return) the trapped errors of the ranks: the blame
        lines a human reads instead of N interleaved tracebacks."""
        errs = self._trap.peers() if self._trap is not None else []
        for e in errs:
            where = f" at collective {e.get('op')!r} seq {e.get('seq')}" \
                if e.get("op") else ""
            sys.stderr.write(
                f"[launch] rank {e.get('rank')} failed with "
                f"{e.get('type')}: {e.get('message')}{where}\n")
        sys.stderr.flush()
        return errs

    def _advertise_hot_spare(self, world):
        """JAX publishes the hot-spare buddy ring of the incarnation here;
        the port has no hot-spare layer (ROADMAP A8)."""
        from ...utils.flags import flag
        if flag("FLAGS_hot_spare", False):
            raise NotImplementedError(_HOT_SPARE)

    def _device_env(self, local_rank, nlocal):
        """``LOCAL_WORLD_SIZE``, and the card of a rank that shares one."""
        env = {"LOCAL_WORLD_SIZE": str(nlocal)}
        devices = self.ctx.args.devices
        if devices:
            ids = [d for d in str(devices).split(",") if d.strip()]
            env["FLAGS_selected_gpus"] = ids[local_rank % len(ids)].strip()
        else:
            cards = _card_count()
            if 0 < cards < nlocal:
                env["FLAGS_selected_gpus"] = str(local_rank % cards)
        return env

    def _spawn_one(self, local_rank, rank=None, world=None, nlocal=None):
        args = self.ctx.args
        env = self.ctx.proc_env(local_rank, self.master,
                                rank=rank, world=world)
        env.update(self._device_env(local_rank,
                                    nlocal or args.nproc_per_node))
        env.update(self._guardian_env())
        env.update(getattr(self, "_extra_env", {}))
        cmd = [sys.executable, args.training_script,
               *args.training_script_args]
        stdout = stderr = None
        if args.log_dir:
            os.makedirs(args.log_dir, exist_ok=True)
            r = rank if rank is not None \
                else self.ctx.global_rank(local_rank)
            log = open(os.path.join(args.log_dir, f"worker.{r}.log"), "ab")
            stdout = stderr = log
        return subprocess.Popen(cmd, env=env, stdout=stdout, stderr=stderr)

    def run(self):
        args = self.ctx.args
        restarts = 0
        while True:
            self._guardian_env()
            # stale error records must not re-trip the new incarnation's
            # watchdogs at once
            self._trap.clear()
            world = getattr(self, "_world", None)
            self._advertise_hot_spare(world or args.nproc_per_node)
            if world is None:
                self.procs = [self._spawn_one(i)
                              for i in range(args.nproc_per_node)]
            else:
                # the sentinel's quarantined world: fewer workers, an
                # explicit rank and world
                self.procs = [self._spawn_one(i, rank=i, world=world,
                                              nlocal=world)
                              for i in range(world)]
            codes = self._watch()
            if all(c == 0 for c in codes):
                return 0
            self._guardian_blame()
            if (any(c == ELASTIC_EXIT_CODE for c in codes)
                    or _fault_level() > 0) \
                    and restarts < args.max_restart:
                restarts += 1
                self._apply_quarantine()
                continue
            return max(codes)

    def _apply_quarantine(self):
        """Shrink the next incarnation's world by one when the training
        sentinel blamed a rank for repeated local gradient anomalies
        (``{job}/sentinel/blame`` on the guardian store)."""
        if self._trap is None:
            return
        from ...framework.sentinel import clear_blame, read_blame
        rec = read_blame(self._trap.store, self._trap.job)
        if not rec:
            return
        world = getattr(self, "_world", None) or \
            self.ctx.args.nproc_per_node
        if world <= 1:
            return
        clear_blame(self._trap.store, self._trap.job)
        self._world = world - 1
        self._extra_env = dict(getattr(self, "_extra_env", {}))
        self._extra_env["PADDLE_ELASTIC_RESIZED"] = f"{world}:{self._world}"
        sys.stderr.write(
            f"[launch] sentinel blamed rank {rec.get('rank')} "
            f"(local anomalies: {rec.get('anomalies')}); quarantining "
            f"it: relaunching on {self._world} worker(s)\n")
        sys.stderr.flush()

    def _watch(self):
        """Wait for every worker; once one fails, give the healthy peers
        ``PADDLE_GUARDIAN_PEER_GRACE_S`` seconds to abort on their own
        (their watchdogs trap the failing rank's error and exit with the
        relaunch code), then terminate and reap the rest (the
        watcher's pod-failure policy, controllers/watcher.py)."""
        codes = [None] * len(self.procs)
        peer_grace = float(os.environ.get(
            "PADDLE_GUARDIAN_PEER_GRACE_S", "0") or 0)
        grace_until = None
        try:
            while any(c is None for c in codes):
                for i, p in enumerate(self.procs):
                    if codes[i] is None:
                        codes[i] = p.poll()
                if not any(c not in (None, 0) for c in codes):
                    time.sleep(0.2)
                    continue
                if all(c is not None for c in codes):
                    return codes
                if grace_until is None:
                    grace_until = time.time() + peer_grace
                if time.time() >= grace_until:
                    self._terminate()
                    self._reap(codes)
                    return codes
                time.sleep(0.2)
        except KeyboardInterrupt:
            self._terminate()
            self._reap(codes)
            raise
        return codes

    def _terminate(self, exclude=None):
        for i, p in enumerate(self.procs):
            if i != exclude and p.poll() is None:
                try:
                    p.send_signal(signal.SIGTERM)
                except OSError:
                    pass

    def _reap(self, codes, grace=None):
        """SIGTERM was sent: wait up to ``grace`` seconds, then SIGKILL the
        survivors.  A rank wedged in a collective defers its signal
        handlers indefinitely: without the escalation the controller
        inherits the hang it exists to end."""
        if grace is None:
            grace = float(os.environ.get(
                "PADDLE_GUARDIAN_TERM_GRACE_S", "10") or 10)
        deadline = time.time() + grace
        for i, p in enumerate(self.procs):
            if codes[i] is not None:
                continue
            try:
                codes[i] = p.wait(timeout=max(0.1, deadline - time.time()))
            except subprocess.TimeoutExpired:
                sys.stderr.write(
                    f"[launch] worker {i} ignored SIGTERM for {grace:g}s "
                    "(wedged in a collective?); sending SIGKILL\n")
                sys.stderr.flush()
                try:
                    p.kill()
                except OSError:
                    pass
                codes[i] = p.wait()
        return codes


class ElasticCollectiveController(CollectiveController):
    """Multi-pod controller: a TCP store rendezvous assigns pod and worker
    ranks, a watcher restarts the pod's workers when membership changes
    (a joiner's scale-out request, or a member pod's heartbeat expiring),
    and each rebuild re-runs rendezvous so ranks and world stay
    contiguous (reference: HTTPMaster/ETCDMaster rendezvous,
    launch/controllers/master.py:73,186; the pod and job model,
    launch/job/pod.py; controllers/watcher.py; elastic scale-in/out,
    fleet/elastic/manager.py:487,510)."""

    def __init__(self, ctx: Context):
        from .master import KVMaster
        self.ctx = ctx
        self.procs = []
        args = ctx.args
        self.master = args.master
        self._trap = None
        self.min_nodes, self.max_nodes = ctx.nnodes_range()
        pod_id = args.pod_id or f"{ctx.node_ip}-{os.getpid()}"
        self.kv = KVMaster(args.master, pod_id,
                           np=args.nproc_per_node,
                           is_host=(args.node_rank == 0),
                           job_id=args.job_id,
                           ttl=max(3.0, args.elastic_timeout / 5.0),
                           timeout=float(args.elastic_timeout * 10))

    def _guardian_env(self):
        # pods may share no filesystem: workers dial the rendezvous TCP
        # store (the KV the KVMaster heartbeat loop polls)
        return {"PADDLE_GUARDIAN_STORE": self.master}

    def _guardian_blame(self):
        errs = self.kv.peer_errors()
        for e in errs:
            where = f" at collective {e.get('op')!r} seq {e.get('seq')}" \
                if e.get("op") else ""
            sys.stderr.write(
                f"[launch] rank {e.get('rank')} failed with "
                f"{e.get('type')}: {e.get('message')}{where}\n")
        sys.stderr.flush()
        return errs

    def run(self):
        from . import master as M
        args = self.ctx.args
        restarts = 0
        level = _fault_level()
        self.kv.start_heartbeat()
        prev_world = None
        try:
            while True:
                self.kv.clear_errors()
                r, pods, my_idx = self.kv.rendezvous(
                    self.min_nodes, self.max_nodes,
                    quiet=args.elastic_quiet)
                offset = sum(p["np"] for p in pods[:my_idx])
                world = sum(p["np"] for p in pods)
                self._extra_env = {}
                if prev_world is not None and world != prev_world:
                    # tell the relaunched workers what changed
                    sys.stderr.write(
                        f"[launch] elastic resize: world {prev_world} -> "
                        f"{world}; workers will reshard on resume\n")
                    sys.stderr.flush()
                    self._extra_env["PADDLE_ELASTIC_RESIZED"] = \
                        f"{prev_world}:{world}"
                prev_world = world
                self._advertise_hot_spare(world)
                self.procs = [
                    self._spawn_one(i, rank=offset + i, world=world)
                    for i in range(args.nproc_per_node)]
                status, codes = self._watch_elastic()
                if status == "done":
                    return 0
                self._guardian_blame()
                if status == M.RESTART or \
                        (level > 0 and status == "failed") or \
                        any(c == ELASTIC_EXIT_CODE for c in codes
                            if c is not None):
                    self._terminate()
                    self._reap(codes)
                    if restarts >= args.max_restart:
                        return 1   # workers reaped, not orphaned
                    restarts += 1
                    continue
                return max(c for c in codes if c is not None)
        finally:
            if self.ctx.args.node_rank == 0:
                self.kv.wait_peers_gone()
            self.kv.stop()

    def _watch_elastic(self):
        """Poll the workers and the membership; returns ("done" | RESTART
        | "failed", exit codes)."""
        from . import master as M
        codes = [None] * len(self.procs)
        while True:
            for i, p in enumerate(self.procs):
                if codes[i] is None:
                    codes[i] = p.poll()
            live = [c for c in codes if c is not None]
            if len(live) == len(codes):
                if all(c == 0 for c in codes):
                    return "done", codes
                return "failed", codes
            if any(c not in (None, 0) for c in codes):
                self._terminate()
                self._reap(codes)
                if any(c == ELASTIC_EXIT_CODE for c in codes):
                    return M.RESTART, codes
                return "failed", codes
            if self.kv.watch() == M.RESTART:
                return M.RESTART, codes
            time.sleep(0.25)


def launch(argv=None):
    ctx = Context(argv=argv)
    if ctx.args.master is not None:
        return ElasticCollectiveController(ctx).run()
    return CollectiveController(ctx).run()
