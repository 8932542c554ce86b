"""Training sentinel (port of paddle_tpu/framework/sentinel.py): anomaly
detection, last-known-good rollback and the quarantine of the batches
and of the ranks that caused it.

1. **Detection.**  The compiled train step (`framework.train_step`,
   ``sentinel=True``) gives each call a health vector ``[grad_norm_sq,
   skipped]`` on the device; the eager step stashes the same two values
   (`note_eager`: one ``torch._foreach_norm`` pass and one found-inf
   reduction).  Every ``FLAGS_sentinel_check_every`` updates the sentinel
   reads the window's losses and health values in one device→host
   transfer and evaluates them: a non-finite loss or gradient norm, the
   loss's z-score over a rolling window of accepted losses, the gradient
   norm against its EMA.
2. **Response.**  A non-finite step is skipped inside the step by the
   found-inf machinery, armed for runs without loss scaling by a
   unit-scale ``GradScaler`` (`hapi.Model.fit` installs it); an anomaly
   that already reached the weights (a finite spike is only seen after
   the fact), or a streak of ``FLAGS_sentinel_max_skips`` skips, rolls the
   model back to the pinned anchor (in host memory, or
   ``CheckpointManager.save_anchor``) and returns a `RollbackDirective`:
   fit replays from the anchor and skips the quarantined iterations.
   After ``FLAGS_sentinel_max_rollbacks`` rollbacks it stands down.
3. **Dumps.**  Each action writes a flight-recorder dump with reason
   ``sentinel`` (`dump`; ``tools/check_telemetry.py --sentinel-dump``).

4. **Blame across ranks.**  With more than one rank each check publishes
   the rank's health (local anomaly count, skips, the gradient norm's
   EMA) under ``{job}/sentinel/health/r{rank}`` on the guardian store
   (`distributed.watchdog`'s trap; `publish_health`, `read_health`).  A
   non-finite step counts as local only when the rank's own gradients
   (taken before the dp all-reduce) were non-finite (`_local_source`).
   A rank that shows repeated local anomalies while every peer is clean
   is blamed (`decide_blame`) under ``{job}/sentinel/blame``
   (`publish_blame`) and named in a dump; there is no world-wide rewind,
   so a rollback's escalation raises `SentinelError` on a rank that
   knows the blame, and the launch controller relaunches without the
   blamed rank (`distributed.launch.controller._apply_quarantine`).

5. **The peer-snapshot rung.**  With ``FLAGS_hot_spare`` a rollback
   prefers the hot-spare agent's newest validated own snapshot over the
   anchor when it is fresher (`_peer_candidate`,
   `framework.hot_spare.sentinel_candidate`; ``ckpt.peer.restores``); a
   staler one is skipped and counted (``ckpt.peer.stale_skipped``).
"""
from __future__ import annotations

import json
import os
import time
from collections import deque

import numpy as np
import torch

from ..amp import found_inf
from ..observability import flight_recorder as _fr
from ..observability import registry as _registry
from ..utils import monitor as _monitor
from ..utils.flags import flag as _flag
from ..utils.log import get_logger

BLAME_MIN_ANOMALIES = 2


def sentinel_enabled():
    return bool(_flag("FLAGS_sentinel", False))


@torch.no_grad()
def _eager_health(grads):
    """``(grad_norm_sq, found_inf)`` over a list of gradients, on their
    device: one ``torch._foreach_norm`` pass (summed in fp32) and one
    found-inf reduction (``GradScaler.unscale_``'s: a sum a gradient)."""
    norms = torch._foreach_norm(grads, 2.0, dtype=torch.float32)
    return torch.stack(norms).square().sum(), found_inf(grads)


def sentinel_dump_path(rank=0, nranks=1):
    """Where a sentinel dump goes: ``FLAGS_sentinel_dump_path`` (with
    ``.rank<R>`` before the extension when there are several ranks, as
    the stall dump), else ``sentinel_dump.<pid>.json`` under
    ``FLAGS_dump_dir``."""
    p = str(_flag("FLAGS_sentinel_dump_path", "") or "")
    if not p:
        return os.path.join(os.getcwd(),
                            str(_flag("FLAGS_dump_dir") or "."),
                            f"sentinel_dump.{os.getpid()}.json")
    if nranks <= 1:
        return p
    root, ext = os.path.splitext(p)
    return f"{root}.rank{rank}{ext or '.json'}"


class RollbackDirective:
    """What ``Model.fit`` does after the sentinel restored the anchor:
    set the iteration counter to ``it``, redo epoch ``epoch`` skipping the
    batches before ``next_step`` (a ``data.Pipeline`` is rewound onto the
    anchor's position instead) and the quarantined iterations."""

    __slots__ = ("it", "epoch", "next_step", "reason")

    def __init__(self, it, epoch, next_step, reason):
        self.it = int(it)
        self.epoch = int(epoch)
        self.next_step = int(next_step)
        self.reason = str(reason)

    def __repr__(self):
        return (f"RollbackDirective(it={self.it}, epoch={self.epoch}, "
                f"next_step={self.next_step}, reason={self.reason!r})")


# ---------------------------------------------------------------------------
# blame records over the guardian store (JAX's keys and JSON)
# ---------------------------------------------------------------------------


def _loads(val):
    return json.loads(val if isinstance(val, str) else bytes(val).decode())


def publish_health(trap, record):
    """Write this rank's health record (never raises: telemetry)."""
    try:
        trap.store.set(f"{trap.job}/sentinel/health/r{trap.rank}",
                       json.dumps(record))
    except Exception:
        pass


def read_health(trap):
    """{rank: health record} of every rank that published one."""
    try:
        raw = trap.store.list_prefix(f"{trap.job}/sentinel/health/")
    except Exception:
        return {}
    out = {}
    for key, val in raw.items():
        try:
            out[int(key.rsplit("/r", 1)[-1])] = _loads(val)
        except (ValueError, TypeError):
            continue
    return out


def publish_blame(trap, rank, info=None):
    try:
        payload = dict(info or {}, rank=int(rank), ts=time.time())
        trap.store.set(f"{trap.job}/sentinel/blame", json.dumps(payload))
    except Exception:
        pass


def read_blame(store, job="default"):
    """The recorded blame record (``{"rank": ...}``), or None."""
    try:
        raw = store.get(f"{job}/sentinel/blame")
    except Exception:
        return None
    if not raw:
        return None
    try:
        return _loads(raw)
    except (ValueError, TypeError):
        return None


def clear_blame(store, job="default"):
    try:
        store.delete_key(f"{job}/sentinel/blame")
    except Exception:
        pass


def decide_blame(health, min_anomalies=BLAME_MIN_ANOMALIES):
    """The rank to quarantine, or None: exactly one rank shows
    ``min_anomalies`` or more local anomalies while every other shows
    none (a pathology every rank sees, bad data or a bad learning rate,
    blames nobody)."""
    if len(health) < 2:
        return None
    guilty = [r for r, h in health.items()
              if int(h.get("local_anomalies", 0)) >= min_anomalies]
    clean = [r for r, h in health.items()
             if int(h.get("local_anomalies", 0)) == 0]
    if len(guilty) == 1 and len(clean) == len(health) - 1:
        return guilty[0]
    return None


class SentinelError(RuntimeError):
    """A persistent anomaly with a blamed rank in a world above one rank:
    the rank exits so the controller relaunches without the blamed one."""


class TrainingSentinel:
    """Per-fit watchdog over the loss and gradient stream.

    ``model`` is the ``hapi.Model`` being guarded (its
    ``_sentinel_snapshot()`` / ``_sentinel_restore()``); ``manager`` an
    optional `framework.checkpoint_manager.CheckpointManager` whose
    ``save_anchor`` pins the anchor on disk (without one, anchors are
    host-memory copies: the same semantics, not crash-persistent);
    ``nranks`` and ``rank`` the world and this rank; ``trap`` the
    guardian's `distributed.watchdog.ErrorTrap` (None: the process's,
    read at the first exchange)."""

    def __init__(self, model=None, manager=None, nranks=1, rank=0,
                 trap=None):
        self.model = model
        self.manager = manager
        self.nranks = int(nranks)
        self.rank = int(rank)
        self.enabled = True
        self.window = int(_flag("FLAGS_sentinel_window", 32))
        self.check_every = max(int(_flag("FLAGS_sentinel_check_every", 8)),
                               1)
        self.spike_z = float(_flag("FLAGS_sentinel_spike_zscore", 6.0))
        self.max_skips = int(_flag("FLAGS_sentinel_max_skips", 3))
        self.rollback_after = int(_flag("FLAGS_sentinel_rollback_after", 1))
        self.anchor_every = int(_flag("FLAGS_sentinel_anchor_every", 32))
        self.grad_factor = float(_flag("FLAGS_sentinel_grad_factor", 100.0))
        self.max_rollbacks = int(_flag("FLAGS_sentinel_max_rollbacks", 3))
        self._log = get_logger()
        self._losses = deque(maxlen=max(self.window, 4))  # accepted losses
        self._pending = []            # unread per-step device records
        self._quarantine = set()      # global iterations never replayed
        self._anomalies = []          # [{step, signal, value}] (bounded)
        self._skip_streak = 0
        self._applied_since_anchor = 0
        self._local_anomalies = 0
        self._skips_total = 0
        self._rollbacks = 0
        self._gema = None             # grad-norm EMA (healthy steps)
        self._gema_n = 0
        self._anchor = None           # in-memory anchor (state, book)
        self._last_anchor_it = None
        self._last_gnorm_dev = None   # eager lane stash (device scalar)
        self._last_skip = None        # eager lane stash (host bool)
        self._trap_obj = trap
        self._trap_tried = trap is not None
        self._blamed = None

    # ---- guardian store ------------------------------------------------
    def _trap(self):
        if not self._trap_tried:
            self._trap_tried = True
            from ..distributed.watchdog import get_watchdog
            self._trap_obj = get_watchdog().trap
        return self._trap_obj

    # ---- anchors -------------------------------------------------------
    def begin(self, it=0, epoch=0, next_step=0):
        """Pin the state before training, so a fault before the first
        check has a rescue point."""
        self._save_anchor(it, epoch, next_step)

    def _save_anchor(self, next_it, epoch, next_step):
        from .checkpoint_manager import (NonFiniteCheckpointError,
                                         validate_finite_state)
        if self.model is None:
            return                    # nothing to snapshot
        state = self.model._sentinel_snapshot()
        book = {"it": int(next_it), "epoch": int(epoch),
                "next_step": int(next_step)}
        try:
            if self.manager is not None:
                self.manager.save_anchor(state, step=next_it, meta=book)
            else:
                validate_finite_state(state)
                self._anchor = (state, book)
        except NonFiniteCheckpointError as e:
            # the live weights are poisoned already: the previous anchor
            # stays (overwriting the rescue point cannot be undone)
            self._log.warning("sentinel: refusing anchor update: %s", e)
            return
        self._last_anchor_it = int(next_it)
        _monitor.incr("train.anomaly.anchor_saves")

    def _load_anchor(self):
        """``(state, bookkeeping)`` of the pinned anchor, or None."""
        if self.manager is not None:
            restored = self.manager.restore_anchor()
            if restored is None:
                return None
            state, _step = restored
            from .checkpoint_manager import ANCHOR_DIR_NAME, read_manifest
            manifest = read_manifest(os.path.join(self.manager.root,
                                                  ANCHOR_DIR_NAME)) or {}
            return state, manifest.get("meta") or {}
        return self._anchor

    # ---- per-step feeds ------------------------------------------------
    def note_eager(self, optimizer):
        """Eager-lane health of this step's gradients, kept on the device;
        returns the device found-inf flag, which the caller plants in a
        unit-scale GradScaler instead of reducing every gradient twice."""
        grads = [p.grad for p in optimizer._all_params()
                 if p.grad is not None]
        if not grads:
            self._last_gnorm_dev = None
            return None
        self._last_gnorm_dev, found = _eager_health(grads)
        return found

    def note_eager_skip(self, skipped):
        """Eager-lane skip flag (the scaler's found-inf decision, a host
        bool the step read already)."""
        self._last_skip = bool(skipped)

    def quarantined(self, it):
        return it in self._quarantine

    def after_step(self, it, epoch, step, loss_t, update=True):
        """Record one completed train step; at the check cadence read and
        evaluate the window.  Returns a `RollbackDirective` when the model
        was just rolled back, else None."""
        if not self.enabled or not update:
            return None
        cs = getattr(self.model, "_compiled_step", None)
        health = getattr(cs, "last_health", None) \
            if cs not in (None, False) else None
        if health is not None:
            gnorm, skip = health[0], health[1]
            cs.last_health = None
        else:
            gnorm, skip = self._last_gnorm_dev, self._last_skip
        self._last_gnorm_dev = self._last_skip = None
        self._pending.append({"it": int(it), "epoch": int(epoch),
                              "step": int(step), "loss": loss_t,
                              "gnorm": gnorm, "skip": skip})
        if len(self._pending) >= self.check_every:
            return self._check()
        return None

    def flush(self):
        """Evaluate the records not read yet (an epoch's end)."""
        if not self.enabled:
            return None
        return self._check()

    # ---- the cadence check --------------------------------------------
    @staticmethod
    def _fetch(pending):
        """The window's device values, read in one transfer."""
        devicey, idx = [], []
        for i, rec in enumerate(pending):
            for key in ("loss", "gnorm", "skip"):
                v = rec[key]
                if torch.is_tensor(v):
                    devicey.append(v.detach().reshape(()).float())
                    idx.append((i, key))
        fetched = torch.stack(devicey).tolist() if devicey else []
        out = [dict(r) for r in pending]
        for (i, key), v in zip(idx, fetched):
            out[i][key] = v
        return out

    def _check(self):
        pending, self._pending = self._pending, []
        if not pending:
            return None
        recs = self._fetch(pending)
        rollback_reason = None
        last_healthy = None
        for rec in recs:
            it = rec["it"]
            loss = float(rec["loss"]) if rec["loss"] is not None else None
            gsq = rec["gnorm"]
            if gsq is not None and np.isfinite(gsq) and float(gsq) < 0:
                gsq = None       # compiled lane: not sampled on this call
            gnorm = float(np.sqrt(max(float(gsq), 0.0))) \
                if gsq is not None and np.isfinite(gsq) else \
                (float("inf") if gsq is not None else None)
            skipped = bool(rec["skip"]) if rec["skip"] is not None \
                else False
            if skipped:
                self._skip_streak += 1
                self._skips_total += 1
                self._quarantine.add(it)
                self._note_anomaly(it, "nonfinite_step", gnorm or loss,
                                   local=self._local_source(gsq))
                _monitor.incr("train.anomaly.steps_skipped")
                if self._skip_streak >= self.max_skips:
                    rollback_reason = rollback_reason or "skip_streak"
                continue
            signal = value = None
            if loss is None or not np.isfinite(loss):
                signal, value = "nonfinite_loss", loss
            else:
                z = self._zscore(loss)
                if z is not None and z > self.spike_z:
                    signal, value = "loss_spike", z
            if signal is None and gnorm is not None \
                    and self.grad_factor > 0:
                if not np.isfinite(gnorm):
                    signal, value = "grad_nonfinite", gnorm
                elif self._gema_n >= 5 and self._gema > 0 \
                        and gnorm > self.grad_factor * self._gema:
                    signal, value = "grad_explosion", gnorm / self._gema
            if signal is not None:
                # the update was applied before it could be seen: the
                # weights are suspect from this iteration on
                self._quarantine.add(it)
                self._applied_since_anchor += 1
                self._note_anomaly(it, signal, value, local=True)
                if self._applied_since_anchor >= self.rollback_after:
                    rollback_reason = rollback_reason or signal
                continue
            self._skip_streak = 0
            self._losses.append(loss)
            if gnorm is not None:
                self._gema = gnorm if self._gema is None \
                    else 0.9 * self._gema + 0.1 * gnorm
                self._gema_n += 1
                _monitor.set_value("train.anomaly.grad_norm_ema",
                                   self._gema)
            last_healthy = rec
        if self.nranks > 1:
            self._exchange_health(recs[-1]["it"])
        if rollback_reason is not None:
            return self._escalate(rollback_reason, recs[-1])
        if last_healthy is not None and last_healthy is recs[-1] \
                and (self._last_anchor_it is None
                     or recs[-1]["it"] + 1 - self._last_anchor_it
                     >= self.anchor_every):
            self._save_anchor(recs[-1]["it"] + 1, recs[-1]["epoch"],
                              recs[-1]["step"] + 1)
        return None

    def _local_source(self, gsq):
        """Whether THIS rank's own gradients look like the source of a
        non-finite step (not a peer's Inf that arrived through the dp
        all-reduce).  One rank: always."""
        if self.nranks <= 1:
            return True
        return gsq is not None and not np.isfinite(gsq)

    def _zscore(self, loss):
        if len(self._losses) < max(self.window // 4, 4):
            return None
        arr = np.asarray(self._losses, np.float64)
        std = max(float(arr.std()), abs(float(arr.mean())) * 1e-3, 1e-8)
        z = (loss - float(arr.mean())) / std
        _monitor.set_value("train.anomaly.loss_zscore", float(z))
        return z

    def _note_anomaly(self, it, signal, value, local):
        rec = {"step": int(it), "signal": str(signal),
               "value": None if value is None else float(value)}
        self._anomalies.append(rec)
        del self._anomalies[:-64]
        if local:
            self._local_anomalies += 1
        _registry.counter("train.anomaly.detected",
                          "sentinel anomalies by signal",
                          labelnames=("signal",)) \
            .labels(signal=str(signal)).inc()
        _monitor.incr("train.anomaly.total")
        _fr.record("sentinel", str(signal), step=int(it))
        self._log.warning(
            "sentinel: anomaly at iteration %d: %s (value=%s)", it,
            signal, value)

    # ---- blame ---------------------------------------------------------
    def _exchange_health(self, it):
        trap = self._trap()
        if trap is None:
            return
        publish_health(trap, {
            "local_anomalies": self._local_anomalies,
            "skips": self._skips_total,
            "grad_norm_ema": self._gema,
            "it": int(it), "ts": time.time()})
        health = read_health(trap)
        blamed = decide_blame(health)
        if blamed is not None and self._blamed != blamed:
            self._blamed = blamed
            publish_blame(trap, blamed,
                          {"anomalies": health.get(blamed, {})
                           .get("local_anomalies"), "by": self.rank})
            _monitor.incr("train.anomaly.ranks_blamed")
            self._log.warning(
                "sentinel: rank %d blamed for repeated local gradient "
                "anomalies (health=%s)", blamed, health)
            self.dump(action="blame", step=it, per_rank=health,
                      blamed_rank=blamed)

    # ---- escalation ----------------------------------------------------
    def _escalate(self, reason, last_rec):
        it = last_rec["it"]
        if self._rollbacks >= self.max_rollbacks:
            self.enabled = False
            self.dump(action="disabled", step=it)
            self._log.warning(
                "sentinel: anomaly persists after %d rollbacks "
                "(%s); sentinel standing down: investigate the data "
                "pipeline or the hardware", self._rollbacks, reason)
            return None
        if self.nranks > 1 or self.model is None:
            # more than one rank: no world-wide rewind; the recovery is
            # skip, blame and the controller's quarantine relaunch
            trap = self._trap()
            if trap is not None:
                blame = read_blame(trap.store, trap.job)
                if blame is not None:
                    self._blamed = int(blame.get("rank", -1))
            self.dump(action="quarantine", step=it,
                      blamed_rank=self._blamed)
            self._applied_since_anchor = 0   # re-arm instead of
            self._skip_streak = 0            # escalating every check
            if self.nranks > 1 and self._blamed is not None:
                raise SentinelError(
                    f"persistent training anomaly ({reason}); rank "
                    f"{self._blamed} blamed for local gradient "
                    "corruption: exiting so the controller can relaunch "
                    "without it")
            return None
        anchor = self._load_anchor()
        # the hot-spare rung: a validated own snapshot fresher than the
        # anchor redoes fewer iterations; a staler one never rewinds past
        # the anchor
        restored_from = "anchor"
        candidate = self._peer_candidate()
        if candidate is not None:
            cand_it = int(candidate[1].get("it", 0))
            anchor_it = int(anchor[1].get("it", -1)) if anchor else -1
            if cand_it > anchor_it:
                anchor = candidate
                restored_from = "peer-snapshot"
                _registry.counter("ckpt.peer.restores").inc()
            else:
                _registry.counter("ckpt.peer.stale_skipped").inc()
        if anchor is None:
            self.dump(action="no-anchor", step=it)
            self._log.warning("sentinel: rollback wanted (%s) but no "
                              "valid anchor exists", reason)
            return None
        state, book = anchor
        self.model._sentinel_restore(state)
        self._rollbacks += 1
        self._applied_since_anchor = 0
        self._skip_streak = 0
        self._losses.clear()          # statistics restart at the anchor
        self._gema, self._gema_n = None, 0
        _monitor.incr("train.anomaly.rollbacks")
        directive = RollbackDirective(book.get("it", 0),
                                      book.get("epoch", 0),
                                      book.get("next_step", 0), reason)
        self.dump(action="rollback", step=it, anchor_step=directive.it)
        self._log.warning(
            "sentinel: %s at iteration %d: rolled back to the %s "
            "(it=%d, epoch=%d), %d iteration(s) quarantined", reason, it,
            restored_from, directive.it, directive.epoch,
            len(self._quarantine))
        return directive

    def _peer_candidate(self):
        """The hot-spare agent's newest validated own snapshot as
        ``(state, book)``, or None (the flag off, no agent, no snapshot,
        or a failed check, which warned)."""
        if not _flag("FLAGS_hot_spare", False):
            return None
        from . import hot_spare
        return hot_spare.sentinel_candidate()

    # ---- dump ----------------------------------------------------------
    def dump(self, action, step, anchor_step=None, per_rank=None,
             blamed_rank=None):
        """Write the sentinel dump (flight-recorder framing, reason
        ``sentinel``; schema: ``tools/check_telemetry.py
        --sentinel-dump``).  Returns its path; never raises."""
        section = {
            "action": str(action),
            "step": int(step),
            "window": int(self.window),
            "check_every": int(self.check_every),
            "anomalies": list(self._anomalies),
            "quarantined": sorted(self._quarantine),
            "rollbacks": int(self._rollbacks),
            "skip_streak": int(self._skip_streak),
            "anchor_step": (int(anchor_step)
                            if anchor_step is not None
                            else self._last_anchor_it),
            "per_rank": {str(k): v
                         for k, v in (per_rank or {}).items()},
            "blamed_rank": blamed_rank,
            "recent_losses": [float(v) for v in list(self._losses)[-8:]],
        }
        try:
            return _fr.dump(path=sentinel_dump_path(self.rank, self.nranks),
                            reason="sentinel", extra={"sentinel": section})
        except Exception:
            return None

    # ---- introspection -------------------------------------------------
    def report(self):
        return {
            "enabled": self.enabled,
            "anomalies": list(self._anomalies),
            "quarantined": sorted(self._quarantine),
            "rollbacks": self._rollbacks,
            "skips": self._skips_total,
            "local_anomalies": self._local_anomalies,
            "blamed_rank": self._blamed,
            "anchor_it": self._last_anchor_it,
        }
