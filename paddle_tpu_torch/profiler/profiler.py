"""The chrome-trace writer of paddle_tpu/profiler/profiler.py
(`write_chrome_trace` and the metadata rows it prepends), the port's own
copy.  The JAX package's `Profiler`, `RecordEvent` and their exports are
not ported (ROADMAP A9)."""
from __future__ import annotations

import json
import os
import threading


def _metadata_rows(events, proc_names=None):
    """``process_name`` / ``thread_name`` metadata events (``"ph": "M"``)
    for every pid and (pid, tid) the events reference, so Perfetto and
    chrome://tracing label the rows.  ``proc_names`` maps pid -> label
    (request tracing labels rows with process names, not raw pids)."""
    pids, tids = set(), set()
    for e in events:
        if e.get("ph") == "M":
            continue
        pids.add(e.get("pid", 0))
        tids.add((e.get("pid", 0), e.get("tid", 0)))
    rows = []
    main_tid = threading.main_thread().ident
    main_tid = main_tid % 2 ** 31 if main_tid is not None else None
    proc_names = proc_names or {}
    for pid in sorted(pids):
        label = proc_names.get(pid, f"paddle_tpu host (pid {pid})")
        rows.append({"name": "process_name", "ph": "M", "pid": pid,
                     "args": {"name": label}})
    for pid, tid in sorted(tids):
        label = "main thread" if tid in (0, main_tid) else f"thread {tid}"
        rows.append({"name": "thread_name", "ph": "M", "pid": pid,
                     "tid": tid, "args": {"name": label}})
    return rows


def write_chrome_trace(events, path, metadata=None, proc_names=None):
    """Write a chrome://tracing / Perfetto-loadable trace file, the
    metadata rows of every pid and tid the events reference first."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    trace = {"traceEvents": _metadata_rows(events, proc_names) + events,
             "displayTimeUnit": "ms"}
    if metadata is not None:
        trace["metadata"] = metadata
    with open(path, "w") as f:
        json.dump(trace, f)
    return path
