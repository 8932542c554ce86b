"""Exponential backoff with jitter (port of paddle_tpu/utils/retry.py):
the one retry policy of every transient-failure loop (the TCP store's
connect, the rpc plane's dial, rendezvous polls).
"""
from __future__ import annotations

import random
import time


def backoff_delays(base=0.05, factor=2.0, max_delay=2.0, jitter=0.5,
                   tries=None):
    """Yield sleep durations: ``base * factor**n`` capped at ``max_delay``,
    each multiplied by ``1 ± uniform(0, jitter)`` so a fleet of workers
    retrying the same endpoint spreads out instead of stampeding.
    Infinite when ``tries`` is None (callers bound by deadline)."""
    n = 0
    while tries is None or n < tries:
        d = min(float(max_delay), float(base) * float(factor) ** n)
        if jitter:
            d *= 1.0 + random.uniform(-jitter, jitter)
        yield max(d, 0.0)
        n += 1


def decorrelated_delays(base=0.05, max_delay=2.0, tries=None, rng=None):
    """Yield decorrelated-jitter sleep durations: each delay is
    ``uniform(base, 3 * previous)`` capped at ``max_delay``.  Unlike the
    multiplicative jitter of :func:`backoff_delays` (where every client
    still clusters around ``base * factor**n``), successive delays carry
    no shared schedule at all — a fleet of workers mass-reconnecting
    after a store blip spreads across the whole window instead of
    thundering-herding one replica in loose waves.  Infinite when
    ``tries`` is None (callers bound by deadline)."""
    draw = (rng.uniform if rng is not None else random.uniform)
    prev = float(base)
    n = 0
    while tries is None or n < tries:
        prev = min(float(max_delay), draw(float(base), prev * 3.0))
        yield max(prev, 0.0)
        n += 1


def retry_call(fn, *args, tries=5, retry_on=(OSError,), base=0.05,
               factor=2.0, max_delay=2.0, jitter=0.5, deadline=None,
               sleep=time.sleep, on_retry=None, decorrelated=False,
               **kwargs):
    """Call ``fn(*args, **kwargs)``, retrying on ``retry_on`` exceptions
    with exponential backoff.  Gives up (re-raising the last exception)
    after ``tries`` attempts or once ``deadline`` (absolute time.time())
    passes — whichever comes first.  ``decorrelated=True`` swaps the
    schedule for :func:`decorrelated_delays` (AWS-style decorrelated
    jitter; ``factor``/``jitter`` are then ignored)."""
    if decorrelated:
        delays = decorrelated_delays(base=base, max_delay=max_delay)
    else:
        delays = backoff_delays(base=base, factor=factor,
                                max_delay=max_delay, jitter=jitter)
    attempt = 0
    while True:
        try:
            return fn(*args, **kwargs)
        except retry_on as e:
            attempt += 1
            if attempt >= tries:
                raise
            if deadline is not None and time.time() >= deadline:
                raise
            if on_retry is not None:
                on_retry(attempt, e)
            sleep(next(delays))

