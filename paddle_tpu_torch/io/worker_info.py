"""Worker introspection (port of paddle_tpu/io/worker_info.py): inside a
DataLoader worker it describes the worker; elsewhere it returns None.
The description is thread-local: a worker process sets it in its main
thread, a worker thread (the threaded lane) in its own."""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any


@dataclass
class WorkerInfo:
    id: int  # noqa: A003
    num_workers: int
    dataset: Any = None
    seed: int = 0


_LOCAL = threading.local()


def get_worker_info():
    return getattr(_LOCAL, "info", None)


def _set_worker_info(info):
    _LOCAL.info = info
