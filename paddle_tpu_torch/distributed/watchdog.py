"""Thread helpers of the watchdogs (the port's own copy of ``async_raise``
and ``all_thread_stacks`` from paddle_tpu/distributed/watchdog.py).

The serving engine's stall monitor (`serving.engine.Engine`, armed by
``ServingConfig.step_timeout_s``) uses them: it raises into a wedged
scheduler thread and dumps every thread's stack with the flight recorder.
The collective guardian of the JAX module (``CollectiveWatchdog``, blame
across ranks, stall dumps of collectives) is not ported yet (ROADMAP A8,
the head of its queue): the port's collectives
(`distributed.collective`) run without it.
"""
from __future__ import annotations

import ctypes
import sys
import threading
import traceback


def async_raise(thread_ident, exc_type):
    """Schedule ``exc_type`` to be raised in the thread with the given
    ident at its next bytecode boundary.  A thread inside a C call (a
    ``torch.cuda.synchronize``, a sleep) gets it when the call returns.
    Returns False when the thread is gone."""
    res = ctypes.pythonapi.PyThreadState_SetAsyncExc(
        ctypes.c_ulong(thread_ident), ctypes.py_object(exc_type))
    if res > 1:    # pragma: no cover - "affected more than one thread"
        ctypes.pythonapi.PyThreadState_SetAsyncExc(
            ctypes.c_ulong(thread_ident), None)
        return False
    return res == 1


def all_thread_stacks():
    """Stacks of every live thread: name, ident, daemon flag and the
    formatted stack, the heart of a stall dump."""
    names = {t.ident: t for t in threading.enumerate()}
    out = []
    for ident, frame in sys._current_frames().items():
        t = names.get(ident)
        out.append({
            "name": getattr(t, "name", f"thread-{ident}"),
            "ident": ident,
            "daemon": bool(getattr(t, "daemon", False)),
            "stack": traceback.format_stack(frame),
        })
    return out
