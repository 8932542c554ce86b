"""Request tracing with tail-based sampling (port of
paddle_tpu/observability/tracing.py): it answers "why was THIS p99
request slow?", which the registry's histograms cannot.

- A `TraceContext` (trace_id, span_id, parent_span_id, sampled) is
  minted at ``ServingRouter.submit`` / ``Engine.submit`` and carried by
  the rpc plane's envelope (`current_wire` / `bind_wire`; across the
  raw-bytes path inside the migration meta dict), so a routed, migrated
  or resubmitted request stays one trace across processes.
- Each hop records `Span` objects into a bounded per-process ring
  (``FLAGS_trace_buffer_cap``); every span carries both clocks
  (``time.time()`` at start, ``time.monotonic()`` t0 and t1) so dumps of
  several processes can be aligned.
- **Tail-based sampling**: the keep/drop decision is made once, at the
  root request's completion (`decide`).  Every error, eviction and
  deadline trace is kept, every trace slower than
  ``FLAGS_trace_latency_threshold_ms`` is kept, and a hash of the trace
  id keeps a ``FLAGS_trace_sample_rate`` floor of the rest, so a trace
  id's fate never depends on RNG state.
- Each process spools its records as atomic JSONL (tmp and
  ``os.replace``) under ``FLAGS_trace_dir``; `merge_spools` collects
  them, and `chrome_events` / `export_chrome` turn a merged set into
  Perfetto-loadable chrome-trace events with cross-process flow arrows,
  through the profiler's `write_chrome_trace`.

Off by default: with ``FLAGS_trace_dir`` empty no context object, span or
file exists; each instrumented seam pays one falsy flag check or an
``is None`` compare.  The module reads only the standard library and the
flags.
"""
from __future__ import annotations

import contextlib
import hashlib
import itertools
import json
import os
import threading
import time
from collections import deque

from ..utils.flags import flag as _flag

SCHEMA_VERSION = 1

# spool a process's ring after this many local tail-sampling decisions
# (crash robustness between explicit collector visits)
_SPOOL_EVERY = 64

_lock = threading.Lock()
_tls = threading.local()
_ids = itertools.count(1)
_buffer: deque = deque()          # completed span/decision records
_spooled: list = []               # drained records awaiting/already on disk
_decided: dict = {}               # trace_id -> decision record (first wins)
_proc_name: str | None = None
_decisions_since_spool = 0


def enabled():
    """Tracing is armed iff ``FLAGS_trace_dir`` names a directory."""
    return bool(_flag("FLAGS_trace_dir"))


def set_process_name(name, default=False):
    """Stamp this process's row label in spans and spool names (a
    replica's name).  ``default=True`` sets only an unset label: the
    router claims its host process that way without clobbering a
    replica's label when both share one process (thread-mode fleets)."""
    global _proc_name
    if default and _proc_name is not None:
        return
    _proc_name = str(name) if name else None


def _proc():
    """This process's row label in spans and spool names."""
    return _proc_name or f"pid{os.getpid()}"


def _incr(name, value=1):
    from ..utils import monitor
    monitor.incr("serving.trace." + name, value)


class TraceContext:
    """The propagated identity of one request's trace: which trace the
    next span belongs to and which span is its parent.  ``sampled`` is
    the tail-sampling decision once known (None until the root
    decides); it rides the wire form so late hops of an already-decided
    trace could skip recording (currently informational)."""

    __slots__ = ("trace_id", "span_id", "parent_span_id", "sampled")

    def __init__(self, trace_id, span_id, parent_span_id=None,
                 sampled=None):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_span_id = parent_span_id
        self.sampled = sampled

    def wire(self):
        """Compact tuple for the rpc envelope slot / migration meta."""
        return (self.trace_id, self.span_id, self.parent_span_id,
                self.sampled)

    @staticmethod
    def from_wire(w):
        if w is None:
            return None
        return TraceContext(w[0], w[1], w[2] if len(w) > 2 else None,
                            w[3] if len(w) > 3 else None)

    def __repr__(self):     # pragma: no cover - debugging aid
        return (f"TraceContext(trace={self.trace_id!r}, "
                f"span={self.span_id!r})")


class Span:
    """One timed hop of a trace.  Created by :func:`start_span`; call
    :meth:`event` for point annotations (breaker skips, shed/hedge
    decisions, prefill chunks) and :meth:`end` exactly once — ending
    pushes the record into the process ring.  Both clocks are captured:
    ``wall`` (epoch seconds at start) anchors cross-process alignment,
    ``t0``/``t1`` (monotonic) give drift-free durations."""

    __slots__ = ("ctx", "name", "wall", "t0", "t1", "status", "winner",
                 "attrs", "events", "_ended")

    def __init__(self, name, trace_id, parent_span_id, attrs):
        sid = f"{os.getpid():x}.{next(_ids):x}"
        self.ctx = TraceContext(trace_id, sid, parent_span_id)
        self.name = name
        self.wall = time.time()
        self.t0 = time.monotonic()
        self.t1 = None
        self.status = "ok"
        self.winner = False
        self.attrs = dict(attrs) if attrs else {}
        self.events = []
        self._ended = False

    def event(self, name, **attrs):
        """Append one point annotation at the current time."""
        ev = {"name": name,
              "t_ms": round((time.monotonic() - self.t0) * 1e3, 3)}
        if attrs:
            ev.update(attrs)
        self.events.append(ev)
        return self

    def set(self, **attrs):
        self.attrs.update(attrs)
        return self

    def end(self, status="ok", winner=None, **attrs):
        """Close the span and push its record into the process ring.
        Idempotent: a second end is ignored (the first outcome wins —
        the same discipline as first-answer-wins futures)."""
        if self._ended:
            return self
        self._ended = True
        self.t1 = time.monotonic()
        self.status = status
        if winner is not None:
            self.winner = bool(winner)
        if attrs:
            self.attrs.update(attrs)
        rec = {"kind": "span", "trace": self.ctx.trace_id,
               "span": self.ctx.span_id,
               "parent": self.ctx.parent_span_id,
               "name": self.name, "proc": _proc(), "pid": os.getpid(),
               "wall": self.wall, "t0": self.t0, "t1": self.t1,
               "status": self.status}
        if self.winner:
            rec["winner"] = True
        if self.attrs:
            rec["attrs"] = self.attrs
        if self.events:
            rec["events"] = self.events
        _record(rec)
        _incr("spans")
        return self


def _record(rec):
    cap = int(_flag("FLAGS_trace_buffer_cap", 4096) or 0)
    with _lock:
        while cap > 0 and len(_buffer) >= cap:
            _buffer.popleft()
            _incr("spans_dropped")
        _buffer.append(rec)


def start_span(name, parent=None, **attrs):
    """Open one span, or return None with tracing off (callers guard
    every later touch with ``span is not None``).  ``parent`` is a
    :class:`Span`, a :class:`TraceContext`, or None — None falls back
    to the thread-bound context (:func:`current`), and with no context
    anywhere a fresh root trace is minted."""
    if not enabled():
        return None
    if isinstance(parent, Span):
        parent = parent.ctx
    if parent is None:
        parent = current()
    if parent is not None:
        return Span(name, parent.trace_id, parent.span_id, attrs)
    trace_id = f"{_proc()}-{os.getpid():x}-{next(_ids):x}"
    return Span(name, trace_id, None, attrs)


# ---------------- thread-bound context (rpc propagation) ----------------
def current():
    """The context bound to this thread (rpc handlers run under
    :func:`bind`), or None."""
    return getattr(_tls, "ctx", None)


@contextlib.contextmanager
def bind(ctx):
    """Bind ``ctx`` (a TraceContext / Span / None) as this thread's
    current context for the duration of the with-block."""
    if isinstance(ctx, Span):
        ctx = ctx.ctx
    prev = getattr(_tls, "ctx", None)
    _tls.ctx = ctx
    try:
        yield ctx
    finally:
        _tls.ctx = prev


def current_wire():
    """The current thread context's wire form, or None — what the rpc
    client attaches to the call envelope (one attribute read when
    tracing is off)."""
    ctx = getattr(_tls, "ctx", None)
    return ctx.wire() if ctx is not None else None


def bind_wire(w):
    """with-block binding a wire-form context (the rpc server side);
    a no-op null context when ``w`` is None."""
    if w is None:
        return contextlib.nullcontext()
    return bind(TraceContext.from_wire(w))


# ---------------- tail-based sampling ----------------
def _hash_floor(trace_id):
    h = hashlib.sha256(trace_id.encode()).hexdigest()[:8]
    return int(h, 16) / float(1 << 32)


def decide(trace_id, status="ok", latency_ms=0.0):
    """The tail-sampling decision, made ONCE at root-request completion
    by whoever owns the root span.  Keeps: every non-ok trace (error /
    evicted / deadline / cancelled), every trace slower than
    ``FLAGS_trace_latency_threshold_ms`` (0 keeps all), and a
    deterministic-hash floor of ``FLAGS_trace_sample_rate``.  Returns
    the keep decision (bool), or None with tracing off.  A second
    decision for the same trace is ignored (first wins) — the merged
    output and the chaos gate both assert exactly one per trace."""
    global _decisions_since_spool
    if not enabled():
        return None
    with _lock:
        prev = _decided.get(trace_id)
    if prev is not None:
        return bool(prev["keep"])
    thr = float(_flag("FLAGS_trace_latency_threshold_ms", 250.0) or 0.0)
    rate = float(_flag("FLAGS_trace_sample_rate", 0.05) or 0.0)
    if status != "ok":
        keep, reason = True, f"status:{status}"
    elif thr <= 0 or latency_ms >= thr:
        keep, reason = True, "latency"
    elif rate > 0 and _hash_floor(trace_id) < rate:
        keep, reason = True, "floor"
    else:
        keep, reason = False, "sampled_out"
    rec = {"kind": "decision", "trace": trace_id, "keep": keep,
           "reason": reason, "status": status,
           "latency_ms": round(float(latency_ms), 3),
           "proc": _proc(), "pid": os.getpid(),
           "wall": time.time(), "mono": time.monotonic()}
    spool = False
    with _lock:
        if trace_id in _decided:        # lost the race: first wins
            return bool(_decided[trace_id]["keep"])
        _decided[trace_id] = rec
        _decisions_since_spool += 1
        if _decisions_since_spool >= _SPOOL_EVERY:
            _decisions_since_spool = 0
            spool = True
    _record(rec)
    _incr("decisions")
    if keep:
        _incr("decisions_kept")
    if spool:
        spool_now()
    return keep


# ---------------- spool / collect ----------------
def spool_path(trace_dir=None):
    d = str(trace_dir or _flag("FLAGS_trace_dir") or "")
    safe = "".join(c if c.isalnum() or c in "-_." else "_"
                   for c in _proc())
    return os.path.join(d, f"spool-{safe}-{os.getpid()}.jsonl")


def spool_now(trace_dir=None):
    """Atomically (re)write this process's spool file with every record
    seen so far (ring drained into the spooled accumulator, itself
    bounded at 8x the ring cap).  tmp+``os.replace`` — a crash mid-
    write never leaves a torn file, and the collector always reads a
    consistent JSONL.  Returns the path, or None when disabled/empty;
    never raises (telemetry must not take the serving path down)."""
    if not enabled() and trace_dir is None:
        return None
    with _lock:
        while _buffer:
            _spooled.append(_buffer.popleft())
        cap = int(_flag("FLAGS_trace_buffer_cap", 4096) or 0)
        bound = max(cap * 8, 1024)
        while len(_spooled) > bound:
            _spooled.pop(0)
            _incr("spans_dropped")
        records = list(_spooled)
    if not records:
        return None
    path = spool_path(trace_dir)
    try:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            for rec in records:
                f.write(json.dumps(rec, default=str) + "\n")
        os.replace(tmp, path)
    except OSError:
        return None
    _incr("spools")
    return path


def reset():
    """Drop every buffered/spooled record and decision in THIS process
    (tests; fresh campaigns).  On-disk spool files are untouched."""
    global _decisions_since_spool
    with _lock:
        _buffer.clear()
        _spooled.clear()
        _decided.clear()
        _decisions_since_spool = 0
    _tls.ctx = None


def merge_spools(trace_dir=None):
    """Collector: read every ``spool-*.jsonl`` under ``trace_dir``
    (default ``FLAGS_trace_dir``), group spans by trace id, attach each
    trace's tail-sampling decision, and return the merged document::

        {"schema_version": 1,
         "traces": [{"trace_id", "sampled", "decision", "decision_count",
                     "span_count", "spans": [...]}, ...]}

    Spans of explicitly dropped traces (decision keep=False) are
    elided (the span_count remains) — that IS the sampling.  Undecided
    traces (a request lost mid-flight) keep their spans for
    post-mortem.  Torn/alien lines are skipped, never fatal."""
    d = str(trace_dir or _flag("FLAGS_trace_dir") or "")
    spans: dict = {}          # trace_id -> {span_id: record}
    decisions: dict = {}      # trace_id -> [records]
    if d and os.path.isdir(d):
        for fn in sorted(os.listdir(d)):
            if not (fn.startswith("spool-") and fn.endswith(".jsonl")):
                continue
            try:
                with open(os.path.join(d, fn)) as f:
                    lines = f.readlines()
            except OSError:
                continue
            for line in lines:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                tid = rec.get("trace")
                if not tid:
                    continue
                if rec.get("kind") == "span" and rec.get("span"):
                    spans.setdefault(tid, {})[rec["span"]] = rec
                elif rec.get("kind") == "decision":
                    decisions.setdefault(tid, []).append(rec)
    traces = []
    for tid in sorted(set(spans) | set(decisions)):
        ds = decisions.get(tid, [])
        ss = spans.get(tid, {})
        decision = ds[0] if ds else None
        sampled = bool(decision["keep"]) if decision is not None else None
        entry = {"trace_id": tid, "sampled": sampled,
                 "decision": decision, "decision_count": len(ds),
                 "span_count": len(ss)}
        if sampled is not False:
            entry["spans"] = sorted(
                ss.values(), key=lambda r: (r.get("wall", 0.0),
                                            r.get("span", "")))
        traces.append(entry)
    return {"schema_version": SCHEMA_VERSION,
            "generator": "paddle_tpu_torch.observability.tracing",
            "traces": traces}


def write_merged(merged, path):
    """Atomic JSON dump of a :func:`merge_spools` document."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(merged, f, indent=1, default=str)
    os.replace(tmp, path)
    return path


def load_merged(path):
    with open(path) as f:
        return json.load(f)


# ---------------- chrome-trace export ----------------
def chrome_events(merged):
    """Merged traces -> (chrome-trace events, proc_names): one "X"
    duration event per span (wall-clock microseconds — the per-span
    wall anchor aligns processes; durations come from the monotonic
    pair) plus "s"/"f" flow events for every parent->child edge that
    crosses a process, so Perfetto draws the request's hop arrows
    router -> prefill -> transfer -> decode."""
    events = []
    proc_ids: dict = {}       # (proc, pid) -> row id
    proc_names: dict = {}
    span_index: dict = {}     # span_id -> record

    def row(rec):
        key = (rec.get("proc", "?"), rec.get("pid", 0))
        if key not in proc_ids:
            proc_ids[key] = len(proc_ids) + 1
            proc_names[proc_ids[key]] = f"{key[0]} (pid {key[1]})"
        return proc_ids[key]

    for tr in merged.get("traces", []):
        for rec in tr.get("spans", []) or []:
            span_index[rec["span"]] = rec
    flow = itertools.count(1)
    for tr in merged.get("traces", []):
        for rec in tr.get("spans", []) or []:
            dur_us = max((rec.get("t1", 0.0) - rec.get("t0", 0.0))
                         * 1e6, 1.0)
            args = {"trace_id": rec["trace"], "span_id": rec["span"],
                    "parent": rec.get("parent"),
                    "status": rec.get("status", "ok")}
            if rec.get("winner"):
                args["winner"] = True
            if rec.get("attrs"):
                args.update(rec["attrs"])
            if rec.get("events"):
                args["events"] = rec["events"]
            events.append({"name": rec["name"], "cat": "trace",
                           "ph": "X",
                           "ts": rec.get("wall", 0.0) * 1e6,
                           "dur": dur_us, "pid": row(rec), "tid": 1,
                           "args": args})
            parent = span_index.get(rec.get("parent"))
            if parent is not None and \
                    (parent.get("proc"), parent.get("pid")) != \
                    (rec.get("proc"), rec.get("pid")):
                fid = next(flow)
                events.append({"name": "hop", "cat": "trace",
                               "ph": "s", "id": fid,
                               "ts": parent.get("wall", 0.0) * 1e6,
                               "pid": row(parent), "tid": 1})
                events.append({"name": "hop", "cat": "trace",
                               "ph": "f", "bp": "e", "id": fid,
                               "ts": rec.get("wall", 0.0) * 1e6,
                               "pid": row(rec), "tid": 1})
    return events, proc_names


def export_chrome(merged, path):
    """Write a merged trace set as Perfetto-loadable chrome-trace JSON
    through the profiler's shared writer (cross-process flow events
    included)."""
    from ..profiler import write_chrome_trace
    events, proc_names = chrome_events(merged)
    return write_chrome_trace(
        events, path,
        metadata={"trace_schema_version": SCHEMA_VERSION,
                  "traces": len(merged.get("traces", []))},
        proc_names=proc_names)
