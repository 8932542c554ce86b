"""Monitor counters (port of paddle_tpu/utils/monitor.py): the flat-dict
stats API as a shim over the typed registry (`observability.registry`).
``incr`` names are Counters, ``set_value`` names Gauges, ``observe`` names
Histograms, so every counter bumped here is also in
``render_prometheus()`` / ``dump_json()``.  ``all_stats()`` keeps the flat
shape: counters and gauges as ``name: value``, histograms as the derived
``<name>.sum`` / ``<name>.count`` pair, labelled series as
``name{k=v,...}``; ``reset(name)`` clears the metric and its derived keys.
"""
from __future__ import annotations

from ..observability import registry as _registry

_SUFFIXES = (".sum", ".count")


def _reg():
    return _registry.REGISTRY


def incr(name, value=1):
    """Atomically add `value`; returns the new total (registry metric
    locks make read-modify-write safe against concurrent incr/all_stats
    — e.g. the serving scheduler thread vs. client stat readers)."""
    m = _reg().get(name)
    if m is None:
        m = _reg().counter(name, "legacy monitor counter")
    if isinstance(m, _registry.Counter) and value < 0:
        # the registry Counter is monotonic; the legacy API was not
        with m._lock:
            m.set(m.value + value)
            return m.value
    return m.inc(value)


def set_value(name, value):
    m = _reg().get(name)
    if m is None:
        m = _reg().gauge(name, "legacy monitor gauge")
    m.set(value)


def observe(name, value):
    """Record one observation into the histogram registered under
    ``name`` — surfaced in ``all_stats()`` as the historical
    ``<name>.sum`` / ``<name>.count`` pair (averages derive as
    sum/count at read time, e.g. serving ttft/per-token latency), and
    as a full bucket histogram in the Prometheus/JSON exposition."""
    m = _reg().get(name)
    if not isinstance(m, _registry.Histogram):
        m = _reg().histogram(name, "legacy monitor observation") \
            if m is None else m
    if isinstance(m, _registry.Histogram):
        m.observe(value)
    else:                             # name already taken by a scalar
        m.inc(value)


def get_monitor_value(name, default=0):
    m = _reg().get(name)
    if m is not None and not isinstance(m, _registry.Histogram):
        return m.value
    for suffix in _SUFFIXES:
        if name.endswith(suffix):
            parent = _reg().get(name[:-len(suffix)])
            if isinstance(parent, _registry.Histogram):
                return parent.sum if suffix == ".sum" else parent.count
    return default


def all_stats():
    """Flat snapshot of the whole registry (legacy shape)."""
    out = {}
    for m in _reg().metrics():
        for labelvalues, leaf in m._samples():
            key = m.name
            if labelvalues:
                key += "{" + ",".join(
                    f"{k}={v}"
                    for k, v in zip(m.labelnames, labelvalues)) + "}"
            if isinstance(leaf, _registry.Histogram):
                out[key + ".sum"] = leaf.sum
                out[key + ".count"] = leaf.count
            else:
                out[key] = leaf.value
    return out


def _resolve(name):
    """Map a legacy flat key back to its registry metric: strips the
    ``{labels}`` suffix and the histogram-derived ``.sum``/``.count``."""
    base = name.split("{", 1)[0] if "{" in name else name
    m = _reg().get(base)
    if m is not None:
        return m
    for suffix in _SUFFIXES:
        if base.endswith(suffix):
            parent = _reg().get(base[:-len(suffix)])
            if parent is not None:
                return parent
    return None


def reset(name=None):
    """Zero a metric (or all of them).  Clearing ``name`` also clears
    its derived ``.sum``/``.count`` keys and any labeled children —
    the pre-registry implementation popped only the exact key and left
    ``observe()``'s pair orphaned."""
    if name is None:
        for m in _reg().metrics():
            m.reset()
        return
    m = _resolve(name)
    if m is not None:
        m.reset()
