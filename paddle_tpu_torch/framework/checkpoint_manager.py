"""The checkpoint manifest protocol (port of the manifest functions of
paddle_tpu/framework/checkpoint_manager.py): what writing and reading a
``save_adapter`` artifact needs.

A directory is committed by ``manifest.json``, ``{"version", "files":
{name: {size, crc32}}, "meta"?}``, written to a temporary name
and moved into place after the payload files.  `verify_checkpoint` holds
every recorded file to its size and crc32.  ``CheckpointManager`` itself
(retention, auto-resume) is not ported.
"""
from __future__ import annotations

import json
import os
import zlib

MANIFEST_NAME = "manifest.json"
MANIFEST_VERSION = 1


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


def write_manifest(dirpath, meta=None):
    """Commit ``dirpath``: record the size and crc32 of every payload file
    (all files but the manifest and temporaries) and move the manifest
    into place.  Returns the manifest."""
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
    if meta:
        manifest["meta"] = meta
    target = os.path.join(dirpath, MANIFEST_NAME)
    tmp = target + f".tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, target)
    return manifest


def read_manifest(dirpath):
    """The parsed manifest, or None when absent or undecodable."""
    try:
        with open(os.path.join(dirpath, MANIFEST_NAME)) as f:
            m = json.load(f)
        return m if isinstance(m, dict) and "files" in m else None
    except (OSError, ValueError):
        return None


def verify_checkpoint(dirpath):
    """True iff the manifest exists and every recorded file matches its
    recorded size and crc32."""
    manifest = read_manifest(dirpath)
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
