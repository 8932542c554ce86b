"""Runtime flags of the port (port of paddle_tpu/utils/flags.py): a typed
registry seeded from ``FLAGS_*`` environment variables at import, read
with `flag` and changed with `set_flags`.

Only the flags the port reads are declared, with the JAX package's
defaults:

- ``FLAGS_compiled_tick`` (True): the paged engine's decode iteration
  runs as one captured program over device-resident scheduler state
  (`serving.compiled_tick.CompiledServingTick`; one CUDA graph replay a
  tick on the card).  Off: the engine builds no tick and runs the
  uncompiled iteration.
- ``FLAGS_serving_fused_sampling`` (True): on the uncompiled iteration,
  when every active request is greedy or seeded, one vectorized call
  samples every slot.  Off: each sampled row is drawn by a call of its
  own.  Either way a seeded request's draws come from its key stream
  ``fold_in(PRNGKey(seed), n_generated)``, so the flag changes no token
  (the JAX engine's off state draws seeded rows from its global RNG).
- ``FLAGS_compiled_train_step`` (True): `framework.train_step.
  CompiledTrainStep` runs each training step after the first as one
  captured program (one CUDA graph replay on the card).  Off: every step
  runs the eager step.
- ``FLAGS_fault_inject`` (""): the fault-injection spec
  (`utils.fault_injection`): checkpoint torn writes, a preemption
  signal at a training step, slow or corrupt data records.  Empty: every
  injection point returns at once.
- ``FLAGS_sentinel`` (False) and its knobs ``FLAGS_sentinel_window``
  (32), ``_spike_zscore`` (6.0), ``_check_every`` (8), ``_max_skips``
  (3), ``_rollback_after`` (1), ``_anchor_every`` (32), ``_grad_factor``
  (100.0), ``_max_rollbacks`` (3), ``_dump_path`` (""): the training
  sentinel `hapi.Model.fit` installs (`framework.sentinel`).  Off:
  training is bit for bit what it is without the module.
- ``FLAGS_hot_spare`` (False): `hapi.Model.fit` raises
  `NotImplementedError` when it is on (hot-spare recovery is not
  ported, ROADMAP A8).
- ``FLAGS_collective_timeout_s`` (0.0): a collective stuck longer than
  this gets a stall dump and a `CollectiveTimeoutError`, then the rank's
  hard abort (`distributed.watchdog`); 0 with no guardian store and no
  collective fault point leaves the guardian off.
  ``FLAGS_collective_hard_abort`` (True): exit with the abort code when
  the blocked thread does not unwind; ``FLAGS_stall_dump_path`` (""):
  the dump's file (``.rank<R>`` inserted; empty: under
  ``FLAGS_dump_dir``); ``FLAGS_desync_check_every`` (16): every N-th
  collective of a group compares the peers' arrival records.
- ``FLAGS_collective_backend`` ("auto"): ``host`` routes the collectives
  through the store-mediated gather (`distributed.host_collectives`);
  ``auto`` and ``xla`` run them on the process group.
- ``FLAGS_metrics_export_path`` ("") and
  ``FLAGS_metrics_export_interval_s`` (10.0): the exporter's snapshot
  file (`observability.exporter`); empty starts no thread.
- ``FLAGS_peak_flops`` (0.0): the peak FLOP/s `observability.StepMetrics`
  divides by for MFU; 0 takes the card's from its table.
- ``FLAGS_flight_recorder_size`` (512), ``FLAGS_flight_recorder_path``
  ("") and ``FLAGS_dump_dir`` (".paddle_tpu_dumps"): the flight
  recorder's ring and where it and the sentinel dump.
- ``FLAGS_trace_dir`` (""): request tracing (`observability.tracing`)
  records spans and spools them under this directory as atomic JSONL.
  Empty: no context objects, no spans, no I/O; each instrumented seam
  pays one falsy check.
- ``FLAGS_trace_sample_rate`` (0.05): the tail sampler's floor, the
  share of fast, healthy traces kept anyway (by a hash of the trace id,
  so a rerun keeps the same ones).  Errors, evictions and traces slower
  than ``FLAGS_trace_latency_threshold_ms`` (250.0; 0 keeps every trace)
  are always kept.
- ``FLAGS_trace_buffer_cap`` (4096): a process's span ring; completed
  spans past it are dropped oldest first, and counted.
- ``FLAGS_serving_request_label_cap`` (1024): at most this many
  ``request_id``-labelled children a serving family keeps
  (`serving.stats.request_observe`; the oldest request's child goes
  first), so a long-lived engine's registry stops growing.
"""
from __future__ import annotations

import os
from typing import Any

_FLAGS: dict[str, Any] = {
    "FLAGS_compiled_tick": True,
    "FLAGS_serving_fused_sampling": True,
    "FLAGS_compiled_train_step": True,
    "FLAGS_fault_inject": "",
    "FLAGS_sentinel": False,
    "FLAGS_sentinel_window": 32,
    "FLAGS_sentinel_spike_zscore": 6.0,
    "FLAGS_sentinel_check_every": 8,
    "FLAGS_sentinel_max_skips": 3,
    "FLAGS_sentinel_rollback_after": 1,
    "FLAGS_sentinel_anchor_every": 32,
    "FLAGS_sentinel_grad_factor": 100.0,
    "FLAGS_sentinel_max_rollbacks": 3,
    "FLAGS_sentinel_dump_path": "",
    "FLAGS_hot_spare": False,
    "FLAGS_collective_timeout_s": 0.0,
    "FLAGS_collective_hard_abort": True,
    "FLAGS_stall_dump_path": "",
    "FLAGS_desync_check_every": 16,
    "FLAGS_collective_backend": "auto",
    "FLAGS_metrics_export_path": "",
    "FLAGS_metrics_export_interval_s": 10.0,
    "FLAGS_peak_flops": 0.0,
    "FLAGS_flight_recorder_size": 512,
    "FLAGS_flight_recorder_path": "",
    "FLAGS_dump_dir": ".paddle_tpu_dumps",
    "FLAGS_trace_dir": "",
    "FLAGS_trace_sample_rate": 0.05,
    "FLAGS_trace_latency_threshold_ms": 250.0,
    "FLAGS_trace_buffer_cap": 4096,
    "FLAGS_serving_request_label_cap": 1024,
}


def _coerce(old, new):
    if isinstance(old, bool):
        if isinstance(new, str):
            return new.lower() in ("1", "true", "yes")
        return bool(new)
    if isinstance(old, int):
        return int(new)
    if isinstance(old, float):
        return float(new)
    return new


# environment overrides at import
for _k in list(_FLAGS):
    if _k in os.environ:
        _FLAGS[_k] = _coerce(_FLAGS[_k], os.environ[_k])


def set_flags(flags: dict):
    for k, v in flags.items():
        _FLAGS[k] = _coerce(_FLAGS[k], v) if k in _FLAGS else v


def get_flags(keys=None):
    if keys is None:
        return dict(_FLAGS)
    if isinstance(keys, str):
        return {keys: _FLAGS.get(keys)}
    return {k: _FLAGS.get(k) for k in keys}


def flag(name, default=None):
    return _FLAGS.get(name, default)
