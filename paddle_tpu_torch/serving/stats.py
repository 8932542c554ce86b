"""Serving counters, gauges and histograms (port of
paddle_tpu/serving/stats.py, without an exporter).

Each `Engine` owns one `ServingStats`; the scheduler thread writes while
clients read `snapshot()`, so every access takes the lock.  The names are
the JAX engine's: ``ttft_ms``, ``decode_ms``, ``prefill_chunk_ms``,
``decode_steps``, ``tokens_generated``, ...  The adapter pool's counters
(``adapters_loaded``, ``adapter_evictions``, ``requests_routed_adapter``
and its per-adapter series) read 0 until they move, as the JAX engine
declares them at start; so do the compiled tick's families
(`declare_tick_stats`), speculation's and the scheduler's resilience
counters.  A dotted counter name reads with underscores in the snapshot
(``tick.compiled_hits`` → ``tick_compiled_hits``).
"""
from __future__ import annotations

import threading

import numpy as np


class ServingStats:
    def __init__(self):
        self._lock = threading.Lock()
        self._counters = {}
        self._gauges = {}
        self._hists = {}
        self._labeled = {}

    def reset(self):
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()
            self._labeled.clear()

    def incr(self, name, value=1):
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + value

    def incr_labeled(self, name, label_name, label, value=1):
        """One series of a labeled counter, ``name{label_name=label}``;
        the snapshot carries the series as ``name_by_<label_name>``."""
        with self._lock:
            series = self._labeled.setdefault(f"{name}_by_{label_name}", {})
            series[label] = series.get(label, 0) + value

    def set_value(self, name, value):
        with self._lock:
            self._gauges[name] = value

    def declare_tick_stats(self):
        """The compiled tick's families at 0 before the first iteration:
        ``tick.compiled_hits`` (iterations one captured tick ran),
        ``tick.fallbacks`` (iterations a blocker sent to the uncompiled
        lane) and the ``tick_ms`` histogram (one whole scheduler
        iteration, either lane)."""
        with self._lock:
            for name in ("tick.compiled_hits", "tick.fallbacks"):
                self._counters.setdefault(name, 0)
            self._hists.setdefault("tick_ms", [])

    def observe(self, name, value):
        with self._lock:
            self._hists.setdefault(name, []).append(float(value))

    def snapshot(self):
        """Counters and gauges by name, plus for each histogram its
        ``_avg``, ``_p50`` and ``_p99`` and the derived quantities:
        ``per_token_ms_avg`` (mean decode-step wall time),
        ``slot_occupancy`` (active slot steps / slot steps) and
        ``tokens_per_sec`` (generated tokens / prefill, decode and
        speculation wall).
        Adapter pool: ``adapters_loaded`` (hot-loads into pool slots),
        ``adapter_evictions`` (LRU evictions of idle adapters),
        ``adapter_load_ms_avg`` (None before the first load),
        ``requests_routed_adapter`` (admitted adapter requests) and
        ``requests_routed_adapter_by_adapter`` ({adapter_id: count}).
        Compiled tick: ``tick_compiled_hits``, ``tick_fallbacks`` and
        ``tick_ms_avg`` / ``_p50`` / ``_p99`` (None before the first
        iteration).  Speculative decoding (0 or None without it):
        ``spec_windows`` (draft → verify → rollback iterations),
        ``spec_proposed_tokens``, ``spec_accepted_tokens``,
        ``spec_acceptance_rate`` and ``spec_{draft,verify,rollback}_ms_avg``;
        their time counts in ``tokens_per_sec``'s busy time.  Resilience:
        ``scheduler_restarts``, ``scheduler_stalls`` and
        ``requests_cancelled_drain`` (queued requests a drain failed)."""
        with self._lock:
            out = {"adapters_loaded": 0, "adapter_evictions": 0,
                   "requests_routed_adapter": 0,
                   "requests_routed_adapter_by_adapter": {},
                   "adapter_load_ms_avg": None,
                   "spec_windows": 0, "spec_proposed_tokens": 0,
                   "spec_accepted_tokens": 0, "spec_draft_ms_avg": None,
                   "spec_verify_ms_avg": None, "spec_rollback_ms_avg": None,
                   "scheduler_restarts": 0, "scheduler_stalls": 0,
                   "requests_cancelled_drain": 0}
            out.update({k.replace(".", "_"): v
                        for k, v in self._counters.items()})
            out.update(self._gauges)
            out.update({k: dict(v) for k, v in self._labeled.items()})
            hists = {k: list(v) for k, v in self._hists.items()}
        for name, vals in hists.items():
            arr = np.asarray(vals)
            empty = arr.size == 0       # declared, not observed yet
            out[name + "_avg"] = None if empty else float(arr.mean())
            out[name + "_p50"] = None if empty else \
                float(np.percentile(arr, 50))
            out[name + "_p99"] = None if empty else \
                float(np.percentile(arr, 99))
        busy_s = sum(sum(hists.get(name, ())) for name in (
            "prefill_ms", "decode_ms", "spec_draft_ms", "spec_verify_ms",
            "spec_rollback_ms")) / 1e3
        tokens = out.get("tokens_generated", 0)
        slot_steps = out.get("slot_steps", 0)
        out["per_token_ms_avg"] = out.get("decode_ms_avg")
        out["slot_occupancy"] = (out.get("slot_steps_active", 0)
                                 / slot_steps) if slot_steps else 0.0
        out["tokens_per_sec"] = tokens / busy_s if busy_s > 0 else 0.0
        proposed = out["spec_proposed_tokens"]
        out["spec_acceptance_rate"] = (out["spec_accepted_tokens"]
                                       / proposed) if proposed else None
        return out
