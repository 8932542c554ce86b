"""Goodput accounting for the input pipeline (port of
paddle_tpu/data/goodput.py): is the card waiting on the host?

`GoodputMeter` publishes, through the metrics registry (so Prometheus and
the exporter), the series of the JAX package's meter:

* ``data.fetch_ms``            — histogram, the host's cost to produce a
  batch
* ``data.prefetch_occupancy``  — gauge, the prefetch buffer's fill (0..1)
  when the consumer arrives
* ``data.starved_steps``       — counter, consumer arrivals that found
  the buffer empty and had to block (and ``data.batches``, every arrival)
* ``data.input_bound``         — gauge (0..1), EMA fraction of the step
  interval spent blocked on data; ~0 is compute-bound, →1 is
  input-bound

The family is declared at 0 when a meter is made.  `snapshot` returns the
meter's own view (``batches``, ``starved_steps``, the EMAs) as one dict.
"""
from __future__ import annotations

import time

from ..observability import registry as _registry
from ..utils import monitor as _monitor

_EMA = 0.2  # smoothing for the input-bound gauge


class GoodputMeter:
    def __init__(self):
        self.batches = 0
        self.starved_steps = 0
        self._ema_wait_ms = 0.0
        self._ema_interval_ms = 0.0
        self._ema_fetch_ms = 0.0
        self._last_consume = None
        self._occupancy = 0.0
        # the family at 0: "no starvation" reads as a 0 sample, never as
        # an absent series
        _monitor.incr("data.batches", 0)
        _monitor.incr("data.starved_steps", 0)
        _monitor.set_value("data.prefetch_occupancy", 0.0)
        _monitor.set_value("data.input_bound", 0.0)
        if _registry.REGISTRY.get("data.fetch_ms") is None:
            _registry.REGISTRY.histogram(
                "data.fetch_ms", "host cost to produce one batch")

    def record_fetch(self, ms):
        ms = float(ms)
        self._ema_fetch_ms = (ms if self._ema_fetch_ms == 0.0
                              else (1 - _EMA) * self._ema_fetch_ms
                              + _EMA * ms)
        _monitor.observe("data.fetch_ms", ms)

    def record_consume(self, wait_ms, occupancy):
        """One consumer arrival: how long it blocked and how full the
        prefetch buffer was when it arrived."""
        now = time.perf_counter()
        wait_ms = float(wait_ms)
        self.batches += 1
        _monitor.incr("data.batches")
        self._occupancy = float(occupancy)
        _monitor.set_value("data.prefetch_occupancy", self._occupancy)
        if occupancy <= 0.0 and wait_ms > 0.0:
            self.starved_steps += 1
            _monitor.incr("data.starved_steps")
        if self._last_consume is not None:
            interval_ms = (now - self._last_consume) * 1e3
            self._ema_interval_ms = (
                interval_ms if self._ema_interval_ms == 0.0
                else (1 - _EMA) * self._ema_interval_ms
                + _EMA * interval_ms)
            self._ema_wait_ms = ((1 - _EMA) * self._ema_wait_ms
                                 + _EMA * wait_ms)
            _monitor.set_value("data.input_bound", self.input_bound)
        self._last_consume = now

    @property
    def input_bound(self):
        """EMA fraction of the inter-batch interval spent blocked on
        the pipeline; 0.0 until two batches have been consumed."""
        if self._ema_interval_ms <= 0.0:
            return 0.0
        return max(0.0, min(1.0,
                            self._ema_wait_ms / self._ema_interval_ms))

    def snapshot(self):
        return {
            "batches": int(self.batches),
            "starved_steps": int(self.starved_steps),
            "prefetch_occupancy": round(self._occupancy, 4),
            "fetch_ms_ema": round(self._ema_fetch_ms, 3),
            "wait_ms_ema": round(self._ema_wait_ms, 3),
            "input_bound": round(self.input_bound, 4),
        }
