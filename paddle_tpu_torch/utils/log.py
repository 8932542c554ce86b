"""Rank-stamped framework logger (port of ``get_logger`` of
paddle_tpu/utils/log.py): one ``logging.Logger`` ("paddle_tpu") whose
lines carry the rank (``PADDLE_TRAINER_ID``, else the ``torch.distributed``
rank when a process group is up, else "-"), its level from
``PADDLE_LOG_LEVEL`` or `set_log_level`; `log_every_n` logs every n-th
call of one message site (the glog idiom)."""
from __future__ import annotations

import logging
import os
import sys
import threading

_LOGGERS: dict = {}
_COUNTS: dict = {}
_COUNTS_LOCK = threading.Lock()


def _rank():
    rank = os.environ.get("PADDLE_TRAINER_ID")
    if rank is not None:
        return rank
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return str(dist.get_rank())
    return "-"


class _RankFormatter(logging.Formatter):
    def format(self, record):
        record.rank = _rank()
        return super().format(record)


class _DynamicStderrHandler(logging.StreamHandler):
    """A StreamHandler that resolves ``sys.stderr`` when it emits: the
    logger is made by whichever module logs first, and a stream bound
    then would strand later lines on a stale, redirected stderr."""

    def __init__(self):
        logging.Handler.__init__(self)

    @property
    def stream(self):
        return sys.stderr


def get_logger(name="paddle_tpu"):
    logger = _LOGGERS.get(name)
    if logger is None:
        logger = logging.getLogger(name)
        if not logger.handlers:
            h = _DynamicStderrHandler()
            h.setFormatter(_RankFormatter(
                "%(asctime)s [rank %(rank)s] %(levelname)s "
                "%(name)s: %(message)s"))
            logger.addHandler(h)
        logger.setLevel(os.environ.get("PADDLE_LOG_LEVEL", "INFO").upper())
        logger.propagate = False
        _LOGGERS[name] = logger
    return logger



def set_log_level(level):
    get_logger().setLevel(
        level.upper() if isinstance(level, str) else level)


def log_every_n(level, msg, n=100, *args):
    """Emit the 1st, (n+1)-th, ... call of this (level, message) site."""
    key = f"{level}:{msg}"
    with _COUNTS_LOCK:
        c = _COUNTS.get(key, 0)
        _COUNTS[key] = c + 1
    if c % n == 0:
        get_logger().log(getattr(logging, level.upper(), logging.INFO),
                         msg, *args)
