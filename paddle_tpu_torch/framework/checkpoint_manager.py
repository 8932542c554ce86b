"""Crash-consistent checkpoints with auto-resume (port of
paddle_tpu/framework/checkpoint_manager.py).

Layout::

    <root>/ckpt-00000012/
        state.pkl          payload file(s)
        manifest.json      {"version", "step", "files": {name: {size, crc32}},
                            "meta"?, "layout"?}
    <root>/anchor/         the last-known-good anchor (never retained away)

Protocol: the payload files are written first (each itself written to a
temporary name and moved into place by `framework.io.save`), then
``manifest.json`` is written to a temporary name and moved into place:
**the manifest is the commit point**.  A directory without a valid
manifest, or whose files fail their size and crc32, is torn:
`CheckpointManager.restore_latest` skips it (logged), removes it, and
falls back to the next-newest valid one.  Retention keeps the newest
``max_to_keep`` valid checkpoints and never deletes the last valid one.

Telemetry, at the JAX package's points: the counters ``ckpt.saves``,
``ckpt.restores``, ``ckpt.anchor_saves``, ``ckpt.torn_skipped``,
``ckpt.torn_gcd`` and ``ckpt.retention_deleted`` (`utils.monitor`), the
``ckpt.save_ms`` histogram (each committed save) and, with
``async_save``, ``ckpt.save_blocked_ms`` (how long a ``save`` waited for
the one in flight; declared at construction), and a flight-recorder
``ckpt`` / ``save`` event per committed save.
"""
from __future__ import annotations

import json
import logging
import os
import re
import shutil
import threading
import time
import zlib

from ..observability import flight_recorder as _fr
from ..observability import registry as _registry
from ..utils import monitor as _monitor

MANIFEST_NAME = "manifest.json"
MANIFEST_VERSION = 1
ANCHOR_DIR_NAME = "anchor"
_STEP_RE = re.compile(r"^ckpt-(\d+)$")

_log = logging.getLogger("paddle_tpu_torch")


class CheckpointError(RuntimeError):
    pass


class NonFiniteCheckpointError(CheckpointError):
    """``save(..., validate_finite=True)`` (or `save_anchor`) found a NaN
    or Inf in the payload: nothing was committed.  ``key`` names the
    first offending leaf."""

    def __init__(self, message, key=None):
        super().__init__(message)
        self.key = key


def step_dir_name(step):
    return f"ckpt-{int(step):08d}"


def _walk_state(state, prefix=""):
    """Depth-first (key path, leaf) pairs over nested dict/list state."""
    if isinstance(state, dict):
        for k, v in state.items():
            yield from _walk_state(v, f"{prefix}{k}.")
    elif isinstance(state, (list, tuple)):
        for i, v in enumerate(state):
            yield from _walk_state(v, f"{prefix}{i}.")
    else:
        yield prefix.rstrip("."), state


def validate_finite_state(state):
    """Raise `NonFiniteCheckpointError` naming the first key whose
    floating payload (a tensor or numpy array) holds a NaN or Inf;
    other leaves are ignored.  A tensor on the card costs one host
    read."""
    import numpy as np
    import torch
    for key, leaf in _walk_state(state):
        if torch.is_tensor(leaf):
            if not leaf.is_floating_point() or leaf.numel() == 0:
                continue
            finite = bool(torch.isfinite(leaf.detach()).all())
        else:
            try:
                a = np.asarray(leaf)
            except Exception:
                continue
            if a.dtype.kind != "f" or a.size == 0:
                continue
            finite = bool(np.isfinite(a).all())
        if not finite:
            raise NonFiniteCheckpointError(
                f"checkpoint payload contains non-finite values at "
                f"{key!r}; refusing to commit a poisoned checkpoint",
                key=key)


def _crc32_file(path, chunk=1 << 20):
    crc, size = 0, 0
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                break
            crc = zlib.crc32(block, crc)
            size += len(block)
    return crc & 0xFFFFFFFF, size


def write_manifest(dirpath, step=None, meta=None, files=None,
                   manifest_path=None, layout=None):
    """Commit ``dirpath``: record the size and crc32 of every payload
    file (``files``, default every file but the manifest and
    temporaries) and move the manifest into place.  ``manifest_path``
    puts the manifest outside the directory; ``layout`` is the JAX
    package's shard-layout section, written as given.  Returns the
    manifest."""
    if files is None:
        files = []
        for base, _dirs, names in os.walk(dirpath):
            for name in names:
                rel = os.path.relpath(os.path.join(base, name), dirpath)
                if rel == MANIFEST_NAME or name.endswith(".tmp") \
                        or ".tmp." in name:
                    continue
                files.append(rel)
    entries = {}
    for rel in sorted(files):
        crc, size = _crc32_file(os.path.join(dirpath, rel))
        entries[rel] = {"size": size, "crc32": crc}
    manifest = {"version": MANIFEST_VERSION, "files": entries}
    if step is not None:
        manifest["step"] = int(step)
    if meta:
        manifest["meta"] = meta
    if layout:
        manifest["layout"] = layout
    target = manifest_path or os.path.join(dirpath, MANIFEST_NAME)
    tmp = target + f".tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, target)
    return manifest


def read_manifest(dirpath, manifest_path=None):
    """The parsed manifest, or None when absent or undecodable."""
    target = manifest_path or os.path.join(dirpath, MANIFEST_NAME)
    try:
        with open(target) as f:
            m = json.load(f)
        return m if isinstance(m, dict) and "files" in m else None
    except (OSError, ValueError):
        return None


def verify_checkpoint(dirpath, manifest_path=None):
    """True iff the manifest exists and every recorded file matches its
    recorded size and crc32."""
    manifest = read_manifest(dirpath, manifest_path=manifest_path)
    if manifest is None:
        return False
    for rel, want in manifest["files"].items():
        path = os.path.join(dirpath, rel)
        try:
            if os.path.getsize(path) != want["size"] \
                    or _crc32_file(path)[0] != want["crc32"]:
                return False
        except OSError:
            return False
    return True


def scan_steps(root):
    """[(step, dirpath)] newest first for every ckpt-N directory under
    ``root``, valid or not (callers verify)."""
    out = []
    try:
        names = os.listdir(root)
    except OSError:
        return out
    for name in names:
        m = _STEP_RE.match(name)
        if m:
            out.append((int(m.group(1)), os.path.join(root, name)))
    out.sort(key=lambda x: x[0], reverse=True)
    return out


def _rmtree_quiet(path):
    try:
        shutil.rmtree(path)
    except OSError:
        pass


class CheckpointManager:
    """Atomic step-numbered checkpoints with latest-valid restore.

    ``save_fn(state, dirpath)`` writes ``state`` into payload files under
    ``dirpath``; ``load_fn(dirpath)`` reads it back.  The defaults are
    `framework.io.save` / `load` of ``state.pkl``; ``map_location`` is
    the default loader's device (None: the card).

    ``async_save=True`` writes and commits on a background thread; a
    failure there is raised again at the next ``save()`` or ``wait()``.
    The caller must not change the tensors of a state handed to an async
    save before it ends (`hapi.callbacks.ModelCheckpoint` hands it
    clones).
    """

    def __init__(self, root, max_to_keep=5, async_save=False,
                 save_fn=None, load_fn=None, *, map_location=None):
        self.root = str(root)
        self.max_to_keep = max_to_keep  # None/0 = keep everything
        self.async_save = async_save
        self.map_location = map_location
        self._save_fn = save_fn or _default_save_fn
        self._load_fn = load_fn or self._default_load
        self._lock = threading.Lock()   # serialises save and GC
        self._thread = None
        self._error = None
        os.makedirs(self.root, exist_ok=True)
        if async_save:
            # at 0 from the start: a save that waits for the one in flight
            # stalls the step loop, and that shows as its own series
            _registry.histogram(
                "ckpt.save_blocked_ms",
                "step-loop stall waiting for the prior async "
                "checkpoint save")

    def _default_load(self, dirpath):
        from .io import load
        return load(os.path.join(dirpath, "state.pkl"),
                    map_location=self.map_location)

    def _check_device(self):
        """The default loader's device resolved before any directory is
        read: without CUDA and no ``map_location`` a restore raises
        instead of skipping every checkpoint as unreadable."""
        if self._load_fn == self._default_load:
            from ..device import resolve_device
            resolve_device(self.map_location)

    # ---- save ----
    def save(self, state, step=None, meta=None, layout=None,
             validate_finite=False, *, before_write=None):
        """Checkpoint ``state`` as step ``step`` (default: one past the
        newest existing step).  ``validate_finite`` refuses a payload
        holding a NaN or Inf (`NonFiniteCheckpointError`) before anything
        is written.  ``before_write`` (async only) runs on the save
        thread before the payload is written: the hook
        `hapi.callbacks.ModelCheckpoint` waits on its clones' event
        with.  Returns the committed directory, or None when async
        (resolve with ``wait()``)."""
        self._reraise()
        if validate_finite:
            validate_finite_state(state)
        if self.async_save:
            blocked = self._thread is not None and self._thread.is_alive()
            t0 = time.perf_counter()
            self.wait()       # one save in flight at a time
            if blocked:
                _registry.histogram("ckpt.save_blocked_ms").observe(
                    (time.perf_counter() - t0) * 1e3)
        if step is None:
            # after the wait: the save in flight has made its ckpt-N,
            # so this one takes N + 1 and does not overwrite it
            steps = scan_steps(self.root)
            step = (steps[0][0] + 1) if steps else 0
        step = int(step)
        if self.async_save:
            self._thread = threading.Thread(
                target=self._save_guarded,
                args=(state, step, meta, layout, before_write),
                daemon=True, name=f"ckpt-save-{step}")
            self._thread.start()
            return None
        return self._save_impl(state, step, meta, layout)

    # ---- last-known-good anchor ----
    # `anchor/` sits beside the ckpt-N steps; scan_steps does not match
    # it, so retention never deletes it.

    def save_anchor(self, state, step, meta=None):
        """Pin ``state`` as the last-known-good anchor (finiteness always
        validated; the previous anchor is replaced only after the new one
        commits)."""
        validate_finite_state(state)
        with self._lock:
            final = os.path.join(self.root, ANCHOR_DIR_NAME)
            tmp = final + f".tmp.{os.getpid()}"
            _rmtree_quiet(tmp)
            os.makedirs(tmp, exist_ok=True)
            try:
                self._save_fn(state, tmp)
                write_manifest(tmp, step=step,
                               meta=dict(meta or {}, anchor=True))
            except BaseException:
                _rmtree_quiet(tmp)
                raise
            _rmtree_quiet(final)
            os.replace(tmp, final)
            _monitor.incr("ckpt.anchor_saves")
            return final

    def restore_anchor(self):
        """``(state, step)`` from the anchor, or None when it is absent or
        torn (then fall back to the ckpt-N scan)."""
        self._check_device()
        path = os.path.join(self.root, ANCHOR_DIR_NAME)
        if not verify_checkpoint(path):
            return None
        try:
            state = self._load_fn(path)
        except Exception as e:
            _log.warning("anchor %s failed to load (%s)", path, e)
            return None
        manifest = read_manifest(path) or {}
        return state, int(manifest.get("step", -1))

    def _save_guarded(self, state, step, meta, layout, before_write):
        try:
            if before_write is not None:
                before_write()
            self._save_impl(state, step, meta, layout)
        except BaseException as e:  # noqa: BLE001 — raised at wait()
            self._error = e

    def _save_impl(self, state, step, meta, layout=None):
        t0 = time.perf_counter()
        with self._lock:
            final = os.path.join(self.root, step_dir_name(step))
            if os.path.exists(final):
                # a torn leftover or an explicit overwrite
                _rmtree_quiet(final)
            os.makedirs(final, exist_ok=True)
            try:
                self._save_fn(state, final)
                write_manifest(final, step=step, meta=meta, layout=layout)
            except BaseException:
                # an injected os._exit never gets here: that is the torn
                # checkpoint restore_latest handles
                _rmtree_quiet(final)
                raise
            _monitor.incr("ckpt.saves")
            save_ms = (time.perf_counter() - t0) * 1e3
            _monitor.observe("ckpt.save_ms", save_ms)
            _fr.record("ckpt", "save", step=step, dur_ms=round(save_ms, 3))
            self._retain()
            return final

    def wait(self):
        """Block until the async save in flight (if any) ends; then raise
        its error, if it failed."""
        t = self._thread
        if t is not None:
            t.join()
            self._thread = None
        self._reraise()

    def _reraise(self):
        if self._error is not None:
            e, self._error = self._error, None
            raise CheckpointError(
                f"async checkpoint save failed: {e}") from e

    # ---- restore ----
    def restore_latest(self, gc_invalid=True):
        """``(state, step)`` from the newest valid checkpoint, or None.
        Torn or corrupt directories are skipped (logged) and, with
        ``gc_invalid``, deleted."""
        self.wait()
        self._check_device()
        for step, path in scan_steps(self.root):
            if not verify_checkpoint(path):
                _log.warning("checkpoint %s is torn/corrupt; skipping%s",
                             path, " and removing" if gc_invalid else "")
                _monitor.incr("ckpt.torn_skipped")
                if gc_invalid:
                    with self._lock:
                        _rmtree_quiet(path)
                continue
            try:
                state = self._load_fn(path)
            except Exception as e:
                _log.warning("checkpoint %s failed to load (%s); skipping",
                             path, e)
                _monitor.incr("ckpt.torn_skipped")
                continue
            _monitor.incr("ckpt.restores")
            return state, step
        return None

    def restore(self, step):
        """The state of the checkpoint at exactly ``step`` (validated)."""
        self._check_device()
        path = os.path.join(self.root, step_dir_name(step))
        if not verify_checkpoint(path):
            raise CheckpointError(
                f"checkpoint step {step} at {path} is missing or invalid")
        return self._load_fn(path)

    def latest_step(self):
        for step, path in scan_steps(self.root):
            if verify_checkpoint(path):
                return step
        return None

    def all_steps(self, valid_only=True):
        return sorted(s for s, p in scan_steps(self.root)
                      if not valid_only or verify_checkpoint(p))

    # ---- retention ----
    def _retain(self):
        """Keep the newest ``max_to_keep`` valid checkpoints; torn
        directories older than the newest valid one go too.  The last
        valid checkpoint is never deleted."""
        if not self.max_to_keep or self.max_to_keep < 1:
            return
        kept_valid = 0
        for _step, path in scan_steps(self.root):      # newest first
            if verify_checkpoint(path):
                kept_valid += 1
                if kept_valid > self.max_to_keep:
                    _rmtree_quiet(path)
                    _monitor.incr("ckpt.retention_deleted")
            elif kept_valid >= 1:
                _rmtree_quiet(path)
                _monitor.incr("ckpt.torn_gcd")


def _default_save_fn(state, dirpath):
    from .io import save
    save(state, os.path.join(dirpath, "state.pkl"))
