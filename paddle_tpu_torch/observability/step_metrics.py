"""Training step telemetry (port of
paddle_tpu/observability/step_metrics.py): step time, throughput, MFU
and memory watermarks, published into the metrics registry:

- ``<prefix>step_time_ms``      histogram (p50/p99 through the exposition)
- ``<prefix>examples_total`` / ``<prefix>tokens_total``  counters
- ``<prefix>examples_per_sec`` / ``<prefix>tokens_per_sec``  gauges (the
  last step whose time is known)
- ``<prefix>mfu``               gauge: the step's analytic FLOPs
  (`ops.flops.FlopsCounter.train_step_flops`) / its time / the peak
- ``<prefix>steps_total``       counter
- ``device.memory.peak_bytes{device=i}`` (and ``limit_bytes``): the card's
  allocator high-watermark, ``torch.cuda.max_memory_allocated`` and
  ``memory_stats``; on the CPU ``host.peak_rss_bytes``, the process's
  RSS high-watermark, as the JAX package falls back to.

**Step time on an asynchronous device.**  The JAX module times
``begin_step`` to ``end_step`` on the host.  On the card a compiled step
is one graph replay that returns at once, so that interval is launch
time.  Here, on a CUDA device, ``begin_step`` and ``end_step`` record a
pair of CUDA events on the current stream, and the step's time is the
device time between them, read a step later: each ``end_step`` reads
the pairs whose end event has completed (``Event.query``, no host
sync); `flush` (and `snapshot`) waits for the rest.  The interval starts
when the card reaches the step's first work (after the previous step's
last kernel, or after the host queued it, whichever is later) and ends
with the step's last kernel: the device step, host launch gaps inside
it included, host time between steps not.  On the CPU the host clock
times the step, as in JAX; the two agree there.

**Peak FLOP/s.**  ``FLAGS_peak_flops`` wins; otherwise the card's dense
bf16 peak from `PEAK_FLOPS`, keyed by ``torch.cuda.get_device_name()``.
A card that is not in the table, and the CPU, report no MFU.

    sm = StepMetrics(device=dev)
    sm.set_flops_per_step(fc.train_step_flops)
    for batch in loader:
        with sm.step(examples=batch_size, tokens=batch_size * seq):
            train_step(batch)
    sm.snapshot()
"""
from __future__ import annotations

import collections
import time

import torch

from ..utils.flags import flag as _flag
from . import registry as _registry

#: dense bf16 tensor-core peak FLOP/s by ``torch.cuda.get_device_name()``
#: (NVIDIA H100 SXM5 data sheet: 989.4 TFLOP/s without sparsity)
PEAK_FLOPS = {
    "NVIDIA H100 80GB HBM3": 989.4e12,
    "NVIDIA H100 SXM5 80GB": 989.4e12,
}

#: step events kept unread before `end_step` waits for the oldest
_MAX_PENDING = 64


class StepMetrics:
    def __init__(self, prefix="train.", registry=None, peak_flops=None,
                 tokens_per_example=None, memory_every=16, *, device=None):
        reg = registry or _registry.REGISTRY
        self.registry = reg
        self.prefix = prefix
        self.tokens_per_example = tokens_per_example
        self.memory_every = max(int(memory_every), 1)
        self.flops_per_step = None
        self.device = torch.device(device) if device is not None \
            else torch.device("cpu")
        self._cuda = self.device.type == "cuda"
        self._peak = peak_flops
        self._t0 = None
        self._start = None
        self._pending = collections.deque()
        self._free = []
        self._steps_seen = 0
        self.step_time_ms = reg.histogram(
            prefix + "step_time_ms", "training step wall time (ms)")
        self.examples_total = reg.counter(
            prefix + "examples_total", "examples consumed")
        self.tokens_total = reg.counter(
            prefix + "tokens_total", "tokens consumed")
        self.examples_per_sec = reg.gauge(
            prefix + "examples_per_sec", "throughput of the last step")
        self.tokens_per_sec = reg.gauge(
            prefix + "tokens_per_sec", "token throughput of the last step")
        self.mfu = reg.gauge(
            prefix + "mfu", "achieved / peak FLOPs of the last step")
        self.steps = reg.counter(prefix + "steps_total", "steps completed")
        # the input pipeline's goodput (data.GoodputMeter), attached by fit
        # when it trains on a data.Pipeline
        self._data_goodput = None

    def attach_data(self, goodput):
        self._data_goodput = goodput

    # ---- configuration ----
    def set_flops_per_step(self, flops):
        """Analytic FLOPs of one optimizer step (forward and backward,
        e.g. ``FlopsCounter.train_step_flops``); turns the mfu gauge on."""
        self.flops_per_step = flops if flops else None

    def peak_flops(self):
        """``FLAGS_peak_flops`` wins; else the card's `PEAK_FLOPS` entry;
        else None."""
        if self._peak:
            return float(self._peak)
        configured = float(_flag("FLAGS_peak_flops", 0.0) or 0.0)
        if configured > 0:
            return configured
        if self._cuda:
            return PEAK_FLOPS.get(torch.cuda.get_device_name(self.device))
        return None

    # ---- the per-step hot path ----
    def _event(self):
        if self._free:
            return self._free.pop()
        return torch.cuda.Event(enable_timing=True)

    def begin_step(self):
        if self._cuda:
            self._start = self._event()
            self._start.record(torch.cuda.current_stream(self.device))
        else:
            self._t0 = time.perf_counter()

    def end_step(self, examples=0, tokens=None):
        """Close the step begun by `begin_step`.  Returns its time in
        seconds on the CPU; on the card None (the time is read later)."""
        if tokens is None and self.tokens_per_example and examples:
            tokens = examples * self.tokens_per_example
        if not self._cuda:
            if self._t0 is None:
                return None
            dt = time.perf_counter() - self._t0
            self._t0 = None
            self._observe(dt, examples, tokens)
            return dt
        if self._start is None:
            return None
        end = self._event()
        end.record(torch.cuda.current_stream(self.device))
        self._pending.append((self._start, end, examples, tokens))
        self._start = None
        self._drain(wait=len(self._pending) > _MAX_PENDING)
        return None

    def _drain(self, wait=False):
        """Observe every pending step whose end event has completed (all
        of them with ``wait``; else only as many as have, in order)."""
        while self._pending:
            start, end, examples, tokens = self._pending[0]
            if wait:
                end.synchronize()
            elif not end.query():
                return
            self._pending.popleft()
            dt = start.elapsed_time(end) / 1e3
            self._free += [start, end]
            self._observe(dt, examples, tokens)

    def flush(self):
        """Wait for the steps still on the card and observe them."""
        self._drain(wait=True)

    def _observe(self, dt, examples, tokens):
        ms = dt * 1e3
        self.step_time_ms.observe(ms)
        self.steps.inc()
        if examples:
            self.examples_total.inc(examples)
            self.examples_per_sec.set(examples / max(dt, 1e-12))
        if tokens:
            self.tokens_total.inc(tokens)
            self.tokens_per_sec.set(tokens / max(dt, 1e-12))
        if self.flops_per_step:
            peak = self.peak_flops()
            if peak:
                self.mfu.set(self.flops_per_step / max(dt, 1e-12) / peak)
        self._steps_seen += 1
        if self._steps_seen % self.memory_every == 1:
            sample_memory_watermarks(self.registry)
        from . import flight_recorder as _fr
        _fr.record("step", self.prefix + "step",
                   step=self._steps_seen, dur_ms=round(ms, 3))

    class _StepScope:
        __slots__ = ("sm", "examples", "tokens")

        def __init__(self, sm, examples, tokens):
            self.sm, self.examples, self.tokens = sm, examples, tokens

        def __enter__(self):
            self.sm.begin_step()
            return self

        def __exit__(self, *exc):
            if exc[0] is None:
                self.sm.end_step(self.examples, self.tokens)
            return False

    def step(self, examples=0, tokens=None):
        """Context manager timing one step."""
        return self._StepScope(self, examples, tokens)

    # ---- read side ----
    def snapshot(self):
        self.flush()
        snap = {
            "steps": self.steps.value,
            "step_time_ms": self.step_time_ms.snapshot(),
            "examples_total": self.examples_total.value,
            "tokens_total": self.tokens_total.value,
            "examples_per_sec": self.examples_per_sec.value,
            "tokens_per_sec": self.tokens_per_sec.value,
            "mfu": self.mfu.value if self.flops_per_step else None,
            "flops_per_step": self.flops_per_step,
            "peak_flops": self.peak_flops() if self.flops_per_step
            else None,
        }
        snap["memory"] = sample_memory_watermarks(self.registry)
        if self._data_goodput is not None:
            snap["data"] = self._data_goodput.snapshot()
        return snap


def sample_memory_watermarks(registry=None):
    """Record the memory high-watermarks into gauges; returns the sampled
    dict.  Each card: ``torch.cuda.max_memory_allocated`` (the caching
    allocator's peak), ``memory_allocated`` and the card's total memory;
    without a card, the process's max RSS."""
    reg = registry or _registry.REGISTRY
    out = {}
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    for i in range(n):
        if not torch.cuda.is_initialized():
            break
        peak = int(torch.cuda.max_memory_allocated(i))
        in_use = int(torch.cuda.memory_allocated(i))
        limit = int(torch.cuda.get_device_properties(i).total_memory)
        reg.gauge("device.memory.peak_bytes",
                  "per-device allocator high-watermark",
                  labelnames=("device",)).labels(device=str(i)).max(peak)
        reg.gauge("device.memory.limit_bytes",
                  "per-device allocator capacity",
                  labelnames=("device",)).labels(device=str(i)).set(limit)
        out[f"device{i}"] = {"peak_bytes": peak, "bytes_in_use": in_use,
                             "bytes_limit": limit}
    if not out:
        rss = _max_rss_bytes()
        if rss:
            reg.gauge("host.peak_rss_bytes",
                      "process RSS high-watermark (CPU fallback for "
                      "backends without memory_stats)").max(rss)
            out["host"] = {"peak_rss_bytes": rss}
    return out


def _max_rss_bytes():
    import resource
    import sys
    ru = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    # linux reports KiB, macOS bytes
    return ru if sys.platform == "darwin" else ru * 1024
