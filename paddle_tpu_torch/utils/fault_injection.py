"""Flag-driven fault injection (port of the points of
paddle_tpu/utils/fault_injection.py that the training runtime and the
serving fleet reach).

``FLAGS_fault_inject`` holds a spec string::

    spec       := point_spec (";" point_spec)*
    point_spec := POINT ":" param ("," param)*
    param      := KEY "=" VALUE

e.g. ``"ckpt_write:after_bytes=128"`` truncates the next checkpoint
payload write after 128 bytes and hard-exits (a torn write), and
``"step:sigterm_at=3"`` delivers SIGTERM when a training loop reports
step 3.  Unknown points or keys and unparseable values raise
`FaultSpecError`: a malformed spec never silently injects nothing.

The points, with the JAX package's parameters:

- ``ckpt_write`` (`write_bytes`): every checkpoint payload goes through it;
- ``step`` (`check_step`): a preemption notice at a training step;
- ``data_slow`` / ``data_corrupt`` (`data_fetch_delay`,
  `data_record_corrupt`): the input pipeline's record fetch;
- the training sentinel's drills, each filtered on fit's global
  iteration (``at_step``) and the rank, with a ``count`` budget of fires
  (re-armed when the spec changes): ``bad_batch`` (`corrupt_batch`, the
  batch before the step, so it rides the compiled lane too),
  ``loss_spike`` (`spike_loss`, after the forward) and ``grad_bitflip``
  (`corrupt_grads`, after the backward).  The last two are seams of the
  eager step: the compiled step's graph replays neither, in the JAX
  package too;
- the serving fleet's drills (`check_rpc`), each filtered on a substring
  of the target worker's name (``to``), with a ``count`` budget and a
  ``once_file``: ``rpc_drop`` and ``rpc_delay`` at the rpc client's
  connect (before a call could have been delivered), ``rpc_slow`` in the
  call after the request went out, and ``engine_slow`` once a scheduler
  iteration of the engine whose replica the name matches.

- the hang guardian's drills (`distributed.watchdog`), consulted in
  each guarded collective before it starts and filtered on its ``op``,
  its per-group sequence number (``at_seq``) and the global ``rank``,
  each with a ``once_file``: ``collective_delay`` stalls the call for
  ``delay_s`` seconds (in short sleeps the watchdog's asynchronous
  exception can interrupt), ``rank_crash`` records an `InjectedFault`
  in the cross-rank error trap and hard-exits with ``exit`` (or raises
  it, ``mode=raise``).

- the hot-spare drills (`framework.hot_spare`), each filtered on fit's
  iteration (``at_step``) and the global ``rank`` with a ``count``
  budget: ``peer_snap_drop`` (`check_peer_snap_drop`) stops a snapshot
  stream after ``after_chunks`` chunks (default 1) without a commit;
  ``buddy_crash`` (`check_buddy_crash`) makes the peer-restore rung see a
  dead buddy, so the ladder falls through to the disk.

The ``step`` point takes JAX's keys: ``crash_at`` hard-exits with
``exit`` at that step, ``sigterm_at`` sends SIGTERM, ``rank`` filters on
the global rank and ``once_file`` fires once a path (a relaunched
incarnation that resumes at the step does not die there again).  With
the flag unset every helper returns on one falsy check.
"""
from __future__ import annotations

import os
import re
import signal
import time

import torch

from .flags import flag

#: the points the port consults, with their typed params.  ``mode``
#: selects crash semantics: "exit" hard-kills the process by os._exit
#: (subprocess drills), "raise" raises InjectedFault in-process.
KNOWN_POINTS = {
    "ckpt_write": {"after_bytes": int, "mode": str, "file": str,
                   "exit": int},
    "step": {"crash_at": int, "sigterm_at": int, "exit": int,
             "rank": int, "once_file": str},
    "data_slow": {"delay_s": float, "every": int, "count": int},
    "data_corrupt": {"at_sample": int, "every": int, "count": int},
    "bad_batch": {"at_step": int, "rank": int, "mode": str,
                  "scale": float, "count": int},
    "loss_spike": {"at_step": int, "rank": int, "scale": float,
                   "count": int},
    "grad_bitflip": {"at_step": int, "rank": int, "value": float,
                     "param": int, "count": int},
    "collective_delay": {"op": str, "at_seq": int, "delay_s": float,
                         "rank": int, "once_file": str},
    "rank_crash": {"op": str, "at_seq": int, "rank": int, "exit": int,
                   "mode": str, "once_file": str},
    "rpc_drop": {"to": str, "count": int, "once_file": str},
    "rpc_delay": {"to": str, "delay_s": float, "count": int,
                  "once_file": str},
    "rpc_slow": {"to": str, "delay_s": float, "count": int,
                 "once_file": str},
    "engine_slow": {"to": str, "delay_s": float, "count": int,
                    "once_file": str},
    "peer_snap_drop": {"at_step": int, "rank": int, "count": int,
                       "after_chunks": int},
    "buddy_crash": {"at_step": int, "rank": int, "count": int},
}

_IDENT = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*$")

#: exit code distinct from ELASTIC_EXIT_CODE: an injected crash must look
#: like a hard fault, not a cooperative relaunch request.
DEFAULT_EXIT_CODE = 23


class FaultSpecError(ValueError):
    """Malformed FLAGS_fault_inject value."""


class InjectedFault(RuntimeError):
    """Raised by an armed injection point in ``mode=raise``."""


def parse(spec):
    """``spec`` string → {point: {key: typed value}}.  Raises
    FaultSpecError on anything it does not fully understand."""
    out = {}
    if not spec or not spec.strip():
        return out
    for item in spec.split(";"):
        item = item.strip()
        if not item:
            raise FaultSpecError(
                f"FLAGS_fault_inject: empty point spec in {spec!r}")
        name, sep, rest = item.partition(":")
        name = name.strip()
        if not _IDENT.match(name):
            raise FaultSpecError(
                f"FLAGS_fault_inject: bad point name {name!r} in {item!r}")
        if name not in KNOWN_POINTS:
            raise FaultSpecError(
                f"FLAGS_fault_inject: unknown point {name!r} "
                f"(known: {sorted(KNOWN_POINTS)})")
        if not sep or not rest.strip():
            raise FaultSpecError(
                f"FLAGS_fault_inject: point {name!r} needs "
                f"'key=value' params (got {item!r})")
        params = {}
        for param in rest.split(","):
            key, psep, value = param.partition("=")
            key, value = key.strip(), value.strip()
            if not psep or not _IDENT.match(key) or not value:
                raise FaultSpecError(
                    f"FLAGS_fault_inject: bad param {param!r} for point "
                    f"{name!r} (want key=value)")
            want = KNOWN_POINTS[name].get(key)
            if want is None:
                raise FaultSpecError(
                    f"FLAGS_fault_inject: unknown key {key!r} for point "
                    f"{name!r} (known: {sorted(KNOWN_POINTS[name])})")
            try:
                params[key] = want(value)
            except ValueError:
                raise FaultSpecError(
                    f"FLAGS_fault_inject: {name}:{key} wants "
                    f"{want.__name__}, got {value!r}") from None
        out[name] = params
    return out


_PARSED = ("", {})  # (raw string, parsed): re-parsed only when raw changes


def active(name):
    """Params dict for ``name`` if that point is armed, else None."""
    raw = flag("FLAGS_fault_inject", "") or ""
    if not raw:
        return None
    global _PARSED
    if _PARSED[0] != raw:
        _PARSED = (raw, parse(raw))
    return _PARSED[1].get(name)


def _crash(params):
    os._exit(int(params.get("exit", DEFAULT_EXIT_CODE)))


def write_bytes(f, data, filename=None):
    """Write ``data`` to the open binary file ``f``: the one point every
    checkpoint payload goes through.  When ``ckpt_write`` is armed
    (optionally filtered to paths containing ``file=<substr>``), writes
    only ``after_bytes`` bytes, fsyncs the torn prefix, then crashes
    (``mode=exit``, the default) or raises InjectedFault
    (``mode=raise``)."""
    params = active("ckpt_write")
    if params is not None and "after_bytes" in params:
        substr = params.get("file")
        if substr is None or substr in (filename or getattr(f, "name", "")):
            n = max(0, params["after_bytes"])
            f.write(data[:n])
            f.flush()
            os.fsync(f.fileno())
            if params.get("mode", "exit") == "raise":
                raise InjectedFault(
                    f"ckpt_write: injected torn write after {n} bytes "
                    f"of {filename or getattr(f, 'name', '?')}")
            _crash(params)
    f.write(data)


#: the rpc points' remaining fires; re-armed whenever the spec string
#: changes, so one test's spent `count` cannot leak into the next
_RPC_STATE = {"raw": "", "counts": {}}


def check_rpc(point, worker_name):
    """Consult an armed rpc point for ``worker_name``: ``rpc_drop`` and
    ``rpc_delay`` from the rpc client before it dials, ``rpc_slow`` from
    ``rpc_sync`` after the request went out, ``engine_slow`` from each
    scheduler iteration (``worker_name`` is then the hosting replica's).
    Returns True when an armed ``rpc_drop`` says this connect must fail
    (the caller raises ``ConnectionError``), else False; the delay points
    sleep ``delay_s`` here and return False."""
    params = active(point)
    if params is None:
        return False
    substr = params.get("to")
    if substr is not None and substr not in str(worker_name):
        return False
    raw = flag("FLAGS_fault_inject", "") or ""
    if _RPC_STATE["raw"] != raw:
        _RPC_STATE["raw"] = raw
        _RPC_STATE["counts"] = {}
    if "count" in params:
        left = _RPC_STATE["counts"].get(point, params["count"])
        if left <= 0:
            return False
        _RPC_STATE["counts"][point] = left - 1
    once = params.get("once_file")
    if once and not claim_once(once):
        return False
    if point in ("rpc_delay", "rpc_slow", "engine_slow"):
        time.sleep(float(params.get("delay_s", 0.0)))
        return False
    return True


def claim_once(path):
    """True the first time ``path`` is claimed (the file is created then),
    False after: a ``once_file`` fires once a path, across processes."""
    try:
        fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
    except FileExistsError:
        return False
    os.close(fd)
    return True


def check_step(step):
    """Training loops call this once a step.  ``crash_at=N`` hard-exits
    at step N (a hard fault) with ``exit``; ``sigterm_at=N`` delivers
    SIGTERM to this process at step N (a preemption notice), so an
    installed PreemptionHandler runs end to end.  ``rank=R`` filters on
    the global rank and ``once_file=PATH`` fires once a path (JAX's
    `check_step`)."""
    params = active("step")
    if params is None:
        return
    if "rank" in params:
        if params["rank"] != int(os.environ.get("PADDLE_TRAINER_ID", "0")):
            return
    if params.get("crash_at") == step or params.get("sigterm_at") == step:
        path = params.get("once_file")
        if path and not claim_once(path):
            return
        if params.get("crash_at") == step:
            _crash(params)
        os.kill(os.getpid(), signal.SIGTERM)


#: remaining-fire budgets of the sentinel points; re-armed when the spec
#: string changes
_SENTINEL_STATE = {"raw": "", "counts": {}}


def _sentinel_point(point, step):
    """Params of an armed sentinel point firing at global iteration
    ``step`` on this rank, else None (one dict lookup with the flag
    unset)."""
    params = active(point)
    if params is None or step is None:
        return None
    if "at_step" in params and params["at_step"] != int(step):
        return None
    if "rank" in params:
        if params["rank"] != int(os.environ.get("PADDLE_TRAINER_ID", "0")):
            return None
    raw = flag("FLAGS_fault_inject", "") or ""
    if _SENTINEL_STATE["raw"] != raw:
        _SENTINEL_STATE["raw"] = raw
        _SENTINEL_STATE["counts"] = {}
    if "count" in params:
        left = _SENTINEL_STATE["counts"].get(point, params["count"])
        if left <= 0:
            return None
        _SENTINEL_STATE["counts"][point] = left - 1
    return params


def corrupt_batch(x, step):
    """The ``bad_batch`` seam: fit passes every input batch through here
    with its global iteration.  Armed, it returns a corrupted copy:
    ``mode=scale`` (default) times ``scale`` (default 1e6), ``mode=nan``
    times NaN.  As in the JAX package the product of integer token ids
    is floating, which the embedding refuses with ``ValueError``."""
    params = _sentinel_point("bad_batch", step)
    if params is None:
        return x
    if params.get("mode", "scale") == "nan":
        return x * float("nan")
    return x * params.get("scale", 1e6)


def spike_loss(loss, step):
    """The ``loss_spike`` seam (the eager step, after the forward): armed,
    the loss times ``scale`` (default 1e6), so the backward applies a
    finite but huge update."""
    params = _sentinel_point("loss_spike", step)
    if params is None:
        return loss
    return loss * params.get("scale", 1e6)


def corrupt_grads(optimizer, step):
    """The ``grad_bitflip`` seam (the eager step, after the backward):
    armed, element 0 of gradient ``param`` (an index into the parameters
    with a gradient, default 0) becomes ``value`` (default +inf), a
    flipped exponent bit.  Returns True when it fired."""
    params = _sentinel_point("grad_bitflip", step)
    if params is None:
        return False
    with_grads = [p for p in optimizer._all_params() if p.grad is not None]
    if not with_grads:
        return False
    p = with_grads[min(params.get("param", 0), len(with_grads) - 1)]
    with torch.no_grad():
        p.grad[(0,) * p.grad.dim()] = params.get("value", float("inf"))
    return True


#: fetch counter and remaining-fire budgets of the data points; re-armed
#: when the spec string changes.
_DATA_STATE = {"raw": "", "counts": {}, "fetches": 0}


def _data_point(point):
    params = active(point)
    if params is None:
        return None
    raw = flag("FLAGS_fault_inject", "") or ""
    if _DATA_STATE["raw"] != raw:
        _DATA_STATE["raw"] = raw
        _DATA_STATE["counts"] = {}
        _DATA_STATE["fetches"] = 0
    return params


def _data_spend(point, params):
    if "count" not in params:
        return True
    left = _DATA_STATE["counts"].get(point, params["count"])
    if left <= 0:
        return False
    _DATA_STATE["counts"][point] = left - 1
    return True


def data_fetch_delay():
    """The ``data_slow`` point: the pipeline's source calls this once a
    record fetch.  Armed, it sleeps ``delay_s`` (default 0.05) on every
    ``every``-th fetch: a slow storage host."""
    params = _data_point("data_slow")
    if params is None:
        return
    seq = _DATA_STATE["fetches"]
    _DATA_STATE["fetches"] = seq + 1
    if seq % max(params.get("every", 1), 1) != 0:
        return
    if not _data_spend("data_slow", params):
        return
    time.sleep(params.get("delay_s", 0.05))


def data_record_corrupt(sample_id):
    """The ``data_corrupt`` point: True when the record at dataset index
    ``sample_id`` is to be treated as corrupt (``at_sample`` one index,
    ``every`` each index divisible by it).  Matching is on the dataset
    index, so a resumed run skips the same records."""
    params = _data_point("data_corrupt")
    if params is None:
        return False
    sid = int(sample_id)
    if "at_sample" in params:
        if params["at_sample"] != sid:
            return False
    elif "every" in params:
        if sid % max(params["every"], 1) != 0:
            return False
    return _data_spend("data_corrupt", params)


#: remaining-fire budgets of the hot-spare points; re-armed when the spec
#: string changes
_LADDER_STATE = {"raw": "", "counts": {}}


def _ladder_point(point, step):
    """Params of an armed hot-spare point, else None: the sentinel points'
    ``at_step`` / ``rank`` / ``count`` rules, except that ``step=None`` (a
    restore, where no step exists yet) matches a point without
    ``at_step``."""
    params = active(point)
    if params is None:
        return None
    if "at_step" in params:
        if step is None or params["at_step"] != int(step):
            return None
    if "rank" in params:
        if params["rank"] != int(os.environ.get("PADDLE_TRAINER_ID", "0")):
            return None
    raw = flag("FLAGS_fault_inject", "") or ""
    if _LADDER_STATE["raw"] != raw:
        _LADDER_STATE["raw"] = raw
        _LADDER_STATE["counts"] = {}
    if "count" in params:
        left = _LADDER_STATE["counts"].get(point, params["count"])
        if left <= 0:
            return None
        _LADDER_STATE["counts"][point] = left - 1
    return params


def check_peer_snap_drop(step):
    """The ``peer_snap_drop`` seam (a snapshot stream): not None makes the
    sender stop after ``after_chunks`` chunks (default 1) without a
    commit, which the buddy's double buffer must survive."""
    return _ladder_point("peer_snap_drop", step)


def check_buddy_crash(step=None):
    """The ``buddy_crash`` seam (the peer-restore rung): not None means
    the buddy holding this rank's replica is to be treated as dead."""
    return _ladder_point("buddy_crash", step)
