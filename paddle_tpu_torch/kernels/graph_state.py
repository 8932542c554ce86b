"""What an op needs to know of a CUDA graph capture, kept apart from the
capture itself (`framework.capture`), so that the kernel wrappers and the
functional ops import nothing of the framework.

- `device_seed`: a seed drawn on the host for a kernel on the card.
  Outside a capture it is written into a new 0-dim int64 device tensor;
  while a step is recorded (`capturing`) it takes the step's next
  persistent slot, which the step refills with a fresh draw before every
  replay, in the order the body drew them.
- `note_generator`: a device generator an op drew from, noted in the
  current `recording` so the step registers it with its graph.
- `recording`: counts the seeds and collects the generators of a body
  run eagerly, which the capture of that body then provides for.
- `allow_host_reads`: a scope whose host reads are made on purpose (a
  seed's draw); the capture's host-read probe does not report them.
- `logged_draw` and `draw_log`: the random draws of a region that
  activation recompute runs twice (`distributed.fleet.utils.recompute`):
  the first run records each draw (a flash seed, a dropout mask), the
  recompute takes them back in the same order and draws nothing, so the
  generators move once and the recomputed region sees the first run's
  seeds and masks.
"""
from __future__ import annotations

import contextlib

import torch

M32 = 0xFFFFFFFF
#: the step whose graph is being recorded (it hands out seed slots)
_capturing = None
#: the `Recording` of the innermost `recording` scope, or None
_recording = None
#: > 0 while a host read is allowed (a draw made on purpose)
_allowed = 0
#: the `DrawLog` of the innermost `draw_log` scope, or None
_draws = None


def host_reads_allowed():
    return _allowed > 0


@contextlib.contextmanager
def allow_host_reads():
    """Host reads inside this scope are not reported by the capture's
    host-read probe (a value the caller draws on the host on purpose)."""
    global _allowed
    _allowed += 1
    try:
        yield
    finally:
        _allowed -= 1


@contextlib.contextmanager
def capturing(step):
    """The scope in which ``step`` records its graph: `device_seed` takes
    its seeds from ``step.take_slot(draw)``."""
    global _capturing
    _capturing = step
    try:
        yield
    finally:
        _capturing = None


def device_seed(draw, device):
    """A host-drawn integer seed for a kernel on ``device``: ``draw()`` on
    the CPU; on the card a 0-dim int64 tensor holding its low 32 bits, or,
    while a step records its graph, that step's next persistent slot,
    which it refills with ``draw()`` before each replay."""
    device = torch.device(device)
    with allow_host_reads():
        if device.type != "cuda":
            return draw()
        if _capturing is not None and \
                torch.cuda.is_current_stream_capturing():
            return _capturing.take_slot(draw)
        if _recording is not None:
            _recording.seeds += 1
        return torch.full((), draw() & M32, dtype=torch.int64,
                          device=device)


def note_generator(gen):
    """Record that a body drew from the device generator ``gen`` (inside
    `recording`; otherwise nothing)."""
    if _recording is not None and gen.device.type == "cuda" and \
            not any(g is gen for g in _recording.generators):
        _recording.generators.append(gen)


class Recording:
    """What a body run eagerly needs from a capture of it: the device
    generators it drew from (in first-draw order) and the number of
    seeds it drew on the host for the card (`device_seed`)."""

    def __init__(self):
        self.generators = []
        self.seeds = 0


@contextlib.contextmanager
def recording():
    """Yields a `Recording` of the scope."""
    global _recording
    outer, _recording = _recording, Recording()
    try:
        yield _recording
    finally:
        _recording = outer


class DrawLog:
    """The random draws of one region's first run, in order; a recompute
    of the region reads them back from the start (`draw_log`)."""

    def __init__(self):
        self.values = []
        #: the next value a recompute takes; None while recording
        self.replay_at = None


@contextlib.contextmanager
def draw_log(log, replay=False):
    """The scope of one run of a recomputed region: the first run
    (``replay=False``) records its draws into ``log``, a recompute
    (``replay=True``) takes them back."""
    global _draws
    outer, _draws = _draws, log
    log.replay_at = 0 if replay else None
    try:
        yield log
    finally:
        _draws = outer


def recomputing():
    """Whether the code runs inside a recompute of a region (the second
    run of `draw_log`'s scope)."""
    return _draws is not None and _draws.replay_at is not None


def logged_draw(draw):
    """``draw()``, a random value an op draws (a seed, a dropout mask):
    inside a `draw_log` scope recorded on the first run and taken back,
    without a draw, by the recompute."""
    log = _draws
    if log is None:
        return draw()
    if log.replay_at is None:
        value = draw()
        log.values.append(value)
        return value
    if log.replay_at >= len(log.values):
        raise RuntimeError(
            "recompute: the recomputed region draws more random values "
            f"than its first run ({len(log.values)})")
    value = log.values[log.replay_at]
    log.replay_at += 1
    return value
