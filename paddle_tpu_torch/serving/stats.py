"""Serving counters, gauges and histograms (port of
paddle_tpu/serving/stats.py, without an exporter).

Each `Engine` owns one `ServingStats`; the scheduler thread writes while
clients read `snapshot()`, so every access takes the lock.  The names are
the JAX engine's: ``ttft_ms``, ``decode_ms``, ``prefill_chunk_ms``,
``decode_steps``, ``tokens_generated``, ...
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

    def reset(self):
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()

    def incr(self, name, value=1):
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + value

    def set_value(self, name, value):
        with self._lock:
            self._gauges[name] = value

    def observe(self, name, value):
        with self._lock:
            self._hists.setdefault(name, []).append(float(value))

    def snapshot(self):
        """Counters and gauges by name, plus for each histogram its
        ``_avg``, ``_p50`` and ``_p99`` and the derived quantities:
        ``per_token_ms_avg`` (mean decode-step wall time),
        ``slot_occupancy`` (active slot steps / slot steps) and
        ``tokens_per_sec`` (generated tokens / prefill + decode wall)."""
        with self._lock:
            out = dict(self._counters)
            out.update(self._gauges)
            hists = {k: list(v) for k, v in self._hists.items()}
        for name, vals in hists.items():
            arr = np.asarray(vals)
            out[name + "_avg"] = float(arr.mean())
            out[name + "_p50"] = float(np.percentile(arr, 50))
            out[name + "_p99"] = float(np.percentile(arr, 99))
        busy_s = (sum(hists.get("prefill_ms", ()))
                  + sum(hists.get("decode_ms", ()))) / 1e3
        tokens = out.get("tokens_generated", 0)
        slot_steps = out.get("slot_steps", 0)
        out["per_token_ms_avg"] = out.get("decode_ms_avg")
        out["slot_occupancy"] = (out.get("slot_steps_active", 0)
                                 / slot_steps) if slot_steps else 0.0
        out["tokens_per_sec"] = tokens / busy_s if busy_s > 0 else 0.0
        return out
