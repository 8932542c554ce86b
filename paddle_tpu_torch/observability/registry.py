"""Typed metrics registry (port of paddle_tpu/observability/registry.py,
pure Python): ``Counter`` (monotonic totals), ``Gauge`` (last-write-wins
levels) and ``Histogram`` (fixed log-spaced buckets with sum, count, min,
max and percentile estimates), each optionally labelled, exported as
Prometheus text format 0.0.4 (`render_prometheus`) or a JSON snapshot
(`dump_json`).  The same operations give the JAX registry's exposition
text, line for line.  `utils.monitor` is the flat-dict shim over it.

A counter bump is one lock and one add; an observation one lock, a bisect
into ~30 static bounds and five adds.  Nothing here starts a thread or
touches a file (the background writer is `observability.exporter`).
"""
from __future__ import annotations

import math
import threading
from bisect import bisect_left
from collections import OrderedDict


def log_buckets(lo=0.001, hi=1e6, per_decade=3):
    """Log-spaced bucket upper bounds covering [lo, hi]: ``per_decade``
    bounds per power of ten.  The defaults span microsecond-scale op
    costs to ~17-minute step times when observing milliseconds."""
    if lo <= 0 or hi <= lo:
        raise ValueError(f"need 0 < lo < hi, got lo={lo!r} hi={hi!r}")
    k0 = math.floor(math.log10(lo) * per_decade)
    k1 = math.ceil(math.log10(hi) * per_decade)
    # 6 significant digits: stable, readable `le` bounds in exposition
    return tuple(float(f"{10.0 ** (k / per_decade):.6g}")
                 for k in range(k0, k1 + 1))


_DEFAULT_BUCKETS = log_buckets()


class _Metric:
    """Common shell: identity, lock, and one level of label children."""

    kind = "untyped"

    def __init__(self, name, help="", labelnames=(), _parent=None):  # noqa: A002
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        # children share the family lock: a labeled bump is still one
        # lock acquisition, and snapshot() sees a consistent family
        self._lock = _parent._lock if _parent is not None \
            else threading.RLock()
        self._children: OrderedDict[tuple, _Metric] = OrderedDict()

    def labels(self, *values, **kw):
        """Child metric for one label-value combination.  Accepts
        positional values (in ``labelnames`` order) or keywords."""
        if kw:
            if values:
                raise ValueError("pass label values positionally OR by "
                                 "keyword, not both")
            try:
                values = tuple(str(kw[k]) for k in self.labelnames)
            except KeyError as e:
                raise ValueError(
                    f"metric {self.name!r} has labels "
                    f"{self.labelnames}, missing {e.args[0]!r}") from None
        else:
            values = tuple(str(v) for v in values)
        if len(values) != len(self.labelnames):
            raise ValueError(
                f"metric {self.name!r} expects {len(self.labelnames)} "
                f"label value(s) {self.labelnames}, got {len(values)}")
        with self._lock:
            child = self._children.get(values)
            if child is None:
                child = type(self)(self.name, self.help, (), _parent=self,
                                   **self._child_kwargs())
                child.labelvalues = values
                self._children[values] = child
            return child

    def labels_lru(self, cap, *values, **kw):
        """``labels()`` with LRU rotation: the touched child moves to
        the MRU end of the family and, when the family holds more than
        ``cap`` children, the least-recently-touched ones are dropped
        (their series vanish from the exposition).  This bounds the
        cardinality of per-request label families — a long-lived engine
        otherwise grows one child per request forever.  ``cap <= 0``
        disables rotation (plain ``labels()``)."""
        child = self.labels(*values, **kw)
        if cap is not None and cap > 0:
            with self._lock:
                key = getattr(child, "labelvalues", None)
                if key in self._children:
                    self._children.move_to_end(key)
                while len(self._children) > cap:
                    self._children.popitem(last=False)
        return child

    def _child_kwargs(self):
        return {}

    def _samples(self):
        """[(labelvalues tuple, self)] — the family's leaf series."""
        with self._lock:
            if self.labelnames:
                return [(vals, c) for vals, c in self._children.items()]
            return [((), self)]

    def reset(self):
        with self._lock:
            self._children.clear()
            self._reset_values()


class Counter(_Metric):
    """Monotonically increasing total.  ``inc`` returns the new total so
    legacy ``monitor.incr`` callers keep their read-modify-write
    atomicity."""

    kind = "counter"

    def __init__(self, name, help="", labelnames=(), _parent=None):  # noqa: A002
        super().__init__(name, help, labelnames, _parent)
        self._value = 0

    def inc(self, value=1):
        if value < 0:
            raise ValueError(f"Counter {self.name!r} cannot decrease "
                             f"(inc({value!r})); use a Gauge")
        with self._lock:
            self._value += value
            return self._value

    def set(self, value):
        """Legacy-monitor compatibility only (``monitor.set_value`` on a
        name that was first used as a counter); not a Prometheus op."""
        with self._lock:
            self._value = value

    @property
    def value(self):
        with self._lock:
            return self._value

    def _reset_values(self):
        self._value = 0


class Gauge(_Metric):
    """Last-write-wins level; may go up and down."""

    kind = "gauge"

    def __init__(self, name, help="", labelnames=(), _parent=None):  # noqa: A002
        super().__init__(name, help, labelnames, _parent)
        self._value = 0

    def set(self, value):
        with self._lock:
            self._value = value

    def inc(self, value=1):
        with self._lock:
            self._value += value
            return self._value

    def dec(self, value=1):
        return self.inc(-value)

    def max(self, value):
        """Raise the gauge to ``value`` if higher (watermark update)."""
        with self._lock:
            if value > self._value:
                self._value = value
            return self._value

    @property
    def value(self):
        with self._lock:
            return self._value

    def _reset_values(self):
        self._value = 0


class Histogram(_Metric):
    """Fixed-bucket histogram: counts per log-spaced bucket plus
    sum/count/min/max, with percentile ESTIMATES (log-interpolated within
    the bucket, clamped to the observed min/max — exact at the bucket
    resolution, never wider than the data)."""

    kind = "histogram"

    def __init__(self, name, help="", labelnames=(), buckets=None,  # noqa: A002
                 _parent=None):
        super().__init__(name, help, labelnames, _parent)
        self.buckets = tuple(buckets) if buckets is not None \
            else _DEFAULT_BUCKETS
        if list(self.buckets) != sorted(self.buckets):
            raise ValueError("histogram buckets must be sorted")
        self._counts = [0] * (len(self.buckets) + 1)   # +1: overflow
        self._sum = 0.0
        self._count = 0
        self._min = None
        self._max = None

    def _child_kwargs(self):
        return {"buckets": self.buckets}

    def observe(self, value):
        value = float(value)
        i = bisect_left(self.buckets, value)
        with self._lock:
            self._counts[i] += 1
            self._sum += value
            self._count += 1
            if self._min is None or value < self._min:
                self._min = value
            if self._max is None or value > self._max:
                self._max = value

    @property
    def count(self):
        with self._lock:
            return self._count

    @property
    def sum(self):
        with self._lock:
            return self._sum

    @property
    def min(self):
        with self._lock:
            return self._min

    @property
    def max(self):
        with self._lock:
            return self._max

    @property
    def avg(self):
        with self._lock:
            return (self._sum / self._count) if self._count else None

    def percentile(self, q):
        """Estimate the q-th percentile (q in [0, 100])."""
        if not 0 <= q <= 100:
            raise ValueError(f"percentile wants 0<=q<=100, got {q!r}")
        with self._lock:
            if not self._count:
                return None
            target = q / 100.0 * self._count
            cum = 0
            for i, n in enumerate(self._counts):
                if n == 0:
                    continue
                prev_cum, cum = cum, cum + n
                if cum >= target:
                    # bucket i spans (lower, upper]; interpolate the
                    # target's position log-linearly inside it
                    lower = self.buckets[i - 1] if i > 0 else None
                    upper = self.buckets[i] if i < len(self.buckets) \
                        else self._max
                    frac = (target - prev_cum) / n
                    if lower is None or lower <= 0 or upper <= 0:
                        est = upper if upper is not None else self._max
                    else:
                        est = lower * (upper / lower) ** frac
                    return min(max(est, self._min), self._max)
            return self._max

    def snapshot(self):
        """One consistent dict: count/sum/min/max/avg + p50/p90/p99."""
        with self._lock:
            return {
                "count": self._count,
                "sum": self._sum,
                "min": self._min,
                "max": self._max,
                "avg": (self._sum / self._count) if self._count else None,
                "p50": self.percentile(50),
                "p90": self.percentile(90),
                "p99": self.percentile(99),
            }

    def _reset_values(self):
        self._counts = [0] * (len(self.buckets) + 1)
        self._sum = 0.0
        self._count = 0
        self._min = None
        self._max = None


class MetricsRegistry:
    """Name → metric map with get-or-create constructors.  Re-requesting
    a name returns the existing metric; requesting it as a DIFFERENT
    type raises — two subsystems silently sharing a name with different
    semantics is the bug class the typed registry exists to kill."""

    def __init__(self):
        self._lock = threading.RLock()
        self._metrics: OrderedDict[str, _Metric] = OrderedDict()

    def _get_or_create(self, cls, name, help, labelnames, **kw):  # noqa: A002
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if type(m) is not cls:
                    raise TypeError(
                        f"metric {name!r} already registered as "
                        f"{m.kind}, cannot re-register as "
                        f"{cls.kind}")
                return m
            m = cls(name, help=help, labelnames=labelnames, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name, help="", labelnames=()):  # noqa: A002
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name, help="", labelnames=()):  # noqa: A002
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name, help="", labelnames=(), buckets=None):  # noqa: A002
        return self._get_or_create(Histogram, name, help, labelnames,
                                   buckets=buckets)

    def get(self, name):
        with self._lock:
            return self._metrics.get(name)

    def unregister(self, name):
        with self._lock:
            return self._metrics.pop(name, None)

    def metrics(self):
        with self._lock:
            return list(self._metrics.values())

    def clear(self):
        with self._lock:
            self._metrics.clear()

    # ------------------------------------------------------------------
    # exposition
    # ------------------------------------------------------------------
    def render_prometheus(self):
        """Prometheus text exposition format 0.0.4."""
        out = []
        for m in self.metrics():
            pname = _prom_name(m.name)
            if m.help:
                out.append(f"# HELP {pname} {_escape_help(m.help)}")
            out.append(f"# TYPE {pname} {m.kind}")
            for labelvalues, leaf in m._samples():
                base = list(zip(m.labelnames, labelvalues))
                if isinstance(leaf, Histogram):
                    cum = 0
                    with leaf._lock:
                        counts = list(leaf._counts)
                        hsum, hcount = leaf._sum, leaf._count
                    for bound, n in zip(leaf.buckets, counts):
                        cum += n
                        out.append(
                            f"{pname}_bucket"
                            f"{_labelstr(base + [('le', _fmt(bound))])}"
                            f" {cum}")
                    cum += counts[-1]
                    out.append(f"{pname}_bucket"
                               f"{_labelstr(base + [('le', '+Inf')])}"
                               f" {cum}")
                    out.append(f"{pname}_sum{_labelstr(base)} "
                               f"{_fmt(hsum)}")
                    out.append(f"{pname}_count{_labelstr(base)} "
                               f"{hcount}")
                else:
                    out.append(f"{pname}{_labelstr(base)} "
                               f"{_fmt(leaf.value)}")
        return "\n".join(out) + "\n"

    def dump_json(self):
        """JSON-ready snapshot: counters/gauges as ``{series: value}``,
        histograms as ``{series: snapshot dict}``.  Labeled series are
        keyed ``name{k=v,...}``."""
        counters, gauges, histograms = {}, {}, {}
        for m in self.metrics():
            for labelvalues, leaf in m._samples():
                key = m.name
                if labelvalues:
                    key += "{" + ",".join(
                        f"{k}={v}" for k, v in
                        zip(m.labelnames, labelvalues)) + "}"
                if isinstance(leaf, Histogram):
                    histograms[key] = leaf.snapshot()
                elif isinstance(leaf, Gauge):
                    gauges[key] = leaf.value
                else:
                    counters[key] = leaf.value
        return {"counters": counters, "gauges": gauges,
                "histograms": histograms}


def _prom_name(name):
    """Sanitize to Prometheus's [a-zA-Z_:][a-zA-Z0-9_:]* (dots in our
    hierarchical names become underscores)."""
    out = []
    for i, ch in enumerate(name):
        ok = ch.isascii() and (ch.isalpha() or ch == "_" or ch == ":"
                               or (ch.isdigit() and i > 0))
        out.append(ch if ok else "_")
    s = "".join(out)
    return s if s and not s[0].isdigit() else "_" + s


def _escape_help(s):
    return str(s).replace("\\", "\\\\").replace("\n", "\\n")


def _escape_label(s):
    return (str(s).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _labelstr(pairs):
    if not pairs:
        return ""
    return ("{" + ",".join(f'{_prom_name(k)}="{_escape_label(v)}"'
                           for k, v in pairs) + "}")


def _fmt(v):
    if v is None:
        return "NaN"
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


# the process-wide default registry every framework seam publishes into
REGISTRY = MetricsRegistry()


def counter(name, help="", labelnames=()):  # noqa: A002
    return REGISTRY.counter(name, help, labelnames)


def gauge(name, help="", labelnames=()):  # noqa: A002
    return REGISTRY.gauge(name, help, labelnames)


def histogram(name, help="", labelnames=(), buckets=None):  # noqa: A002
    return REGISTRY.histogram(name, help, labelnames, buckets=buckets)


def render_prometheus(registry=None):
    return (registry or REGISTRY).render_prometheus()


def dump_json(registry=None):
    return (registry or REGISTRY).dump_json()
