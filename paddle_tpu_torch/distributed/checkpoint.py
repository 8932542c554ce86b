"""Distributed (sharded) checkpointing with reshard-on-load (port of
paddle_tpu/distributed/checkpoint.py; reference: `DistributedSaver`,
auto_parallel/static/dist_saver.py).

The JAX package writes these through orbax.  The port writes them through
`distributed.reshard`'s pickle-shard lane, with the same names, arguments
and `validate_layout` errors: every rank of the world writes its shard
file into the checkpoint directory and rank 0 commits the manifest with
its layout section.  The state is flattened to ``{dotted key: array}``
with JAX's keys (a number leaf, such as an optimizer's step count, is a
0-dim array, as JAX saves it), so a layout this module writes names the
keys and global shapes JAX's `validate_layout` checks.

The layout's ``"format"`` is ``"pickle-shards"``; a JAX checkpoint of
the ``"orbax"`` format is refused with a `reshard.LayoutError` naming it
(the port does not depend on orbax; ROADMAP Queue C).
"""
from __future__ import annotations

import os
import shutil

import numpy as np
import torch

from ..framework.checkpoint_manager import (  # noqa: F401 — re-exported
    CheckpointError, CheckpointManager, read_manifest, scan_steps,
    step_dir_name, verify_checkpoint, write_manifest)
from ..utils.log import get_logger
from .reshard import (  # noqa: F401 — re-exported
    LAYOUT_VERSION, LayoutError, LayoutMismatchError, MeshSpec,
    read_layout, restore_resharded, save_sharded)


def _world(process_group):
    """``(rank, world)`` of the saving group (the default: the world)."""
    if process_group is not None:
        return int(process_group.rank), int(process_group.nranks)
    from . import env
    return env.get_rank(), env.get_world_size()


def validate_layout(path, targets):
    """Check a saved layout section against the restore targets (flat
    ``{key: anything with .shape}``).  No layout (a pre-elastic
    checkpoint) passes; a layout that disagrees on keys or global shapes
    raises `LayoutMismatchError` naming the saved and requested
    layouts."""
    layout = read_layout(path)
    if layout is None:
        return None
    saved = layout.get("arrays", {})
    saved_mesh = layout.get("mesh", {})
    mesh_str = "×".join(
        f"{a}={s}" for a, s in zip(saved_mesh.get("axes", []),
                                   saved_mesh.get("shape", [])))
    missing = sorted(set(targets) - set(saved))
    extra = sorted(set(saved) - set(targets))
    if missing or extra:
        raise LayoutMismatchError(
            f"checkpoint {path} (saved on mesh {mesh_str or 'world=1'}, "
            f"world={layout.get('world_size')}) does not match the "
            f"requested state: missing keys {missing[:5]}, unexpected "
            f"keys {extra[:5]}")
    for key, meta in saved.items():
        want = tuple(int(s) for s in targets[key].shape)
        got = tuple(int(s) for s in meta["global_shape"])
        if want != got:
            raise LayoutMismatchError(
                f"checkpoint {path}: array {key!r} was saved with global "
                f"shape {list(got)} (mesh {mesh_str or 'world=1'}, "
                f"partition {meta.get('partition')}, world="
                f"{layout.get('world_size')}) but the requested layout "
                f"wants {list(want)} — saved and requested layouts are "
                "incompatible")
    return layout


def _flatten_state(obj, prefix=""):
    """Nested dict/list state → flat ``{key: leaf}`` (tensors, and every
    other non-None leaf), JAX's keys."""
    flat = {}
    if torch.is_tensor(obj):
        flat[prefix or "value"] = obj
    elif isinstance(obj, dict):
        for k, v in obj.items():
            flat.update(_flatten_state(v, f"{prefix}.{k}" if prefix
                                       else str(k)))
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            flat.update(_flatten_state(v, f"{prefix}.{i}" if prefix
                                       else str(i)))
    elif obj is not None and prefix:
        flat[prefix] = obj
    return flat


def _restore_into(obj, restored, prefix=""):
    """Write restored values back into the nested structure: a tensor
    leaf takes its value in place (``copy_``), a number leaf the
    restored value as its own Python type."""
    if torch.is_tensor(obj):
        with torch.no_grad():
            obj.copy_(restored[prefix or "value"])
        return obj
    if isinstance(obj, dict):
        for k in obj:
            key = f"{prefix}.{k}" if prefix else str(k)
            obj[k] = _restore_into(obj[k], restored, key)
        return obj
    if isinstance(obj, list):
        for i in range(len(obj)):  # in place: callers may hold aliases
            obj[i] = _restore_into(obj[i], restored,
                                   f"{prefix}.{i}" if prefix else str(i))
        return obj
    if isinstance(obj, tuple):
        items = [_restore_into(v, restored,
                               f"{prefix}.{i}" if prefix else str(i))
                 for i, v in enumerate(obj)]
        if hasattr(obj, "_fields"):
            return type(obj)(*items)
        return type(obj)(items)
    if obj is not None and prefix and prefix in restored:
        val = restored[prefix]
        if isinstance(obj, (bool, int, float)):
            return type(obj)(np.asarray(val).item())
        return val
    return obj


def save_state_dict(state_dict, path, process_group=None,
                    coordinator_rank=0, async_save=False):
    """Sharded save: every rank of the group writes its shard file into
    ``path`` and ``coordinator_rank`` commits the manifest (size and
    crc32 of each file, the layout section), so a rank preempted mid-save
    leaves a torn directory.  ``async_save`` is accepted for JAX's
    signature; the save is synchronous."""
    rank, world = _world(process_group)
    flat = {k: (v if torch.is_tensor(v) else np.asarray(v))
            for k, v in _flatten_state(state_dict).items()}
    path = os.path.abspath(path)
    save_sharded(path, flat, MeshSpec(("dp",), (world,)), rank,
                 coordinator_rank=coordinator_rank)
    return path


def load_state_dict(state_dict, path, process_group=None,
                    coordinator_rank=0, offload=False):
    """In-place load: every tensor of ``state_dict`` takes the saved
    global value (resharded from whatever world saved it), every number
    leaf its saved value.  The layout is validated first
    (`validate_layout`)."""
    rank, world = _world(process_group)
    flat = _flatten_state(state_dict)
    path = os.path.abspath(path)
    targets = {k: (v if torch.is_tensor(v) else np.asarray(v))
               for k, v in flat.items()}
    validate_layout(path, targets)
    restored, _report = restore_resharded(
        path, MeshSpec(("dp",), (world,)), rank, map_location="cpu")
    return _restore_into(state_dict, restored)


def save_checkpoint(state_dict, root, step, max_to_keep=None,
                    process_group=None, coordinator_rank=0):
    """A step-numbered sharded checkpoint ``root/ckpt-<step>`` with the
    manifest commit and last-N retention (the last valid checkpoint is
    never deleted)."""
    root = os.path.abspath(root)
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, step_dir_name(step))
    save_state_dict(state_dict, path, process_group=process_group,
                    coordinator_rank=coordinator_rank)
    rank, _ = _world(process_group)
    if max_to_keep and rank == coordinator_rank:
        kept = 0
        for _step, p in scan_steps(root):      # newest first
            if verify_checkpoint(p):
                kept += 1
                if kept > max_to_keep:
                    shutil.rmtree(p, ignore_errors=True)
            elif kept >= 1:
                shutil.rmtree(p, ignore_errors=True)
    return path


def restore_latest(state_dict, root, process_group=None,
                   coordinator_rank=0):
    """Load the newest VALID checkpoint under ``root`` into
    ``state_dict`` in place; torn or corrupt directories are skipped
    (logged).  A layout error (a mismatch, another format) raises.
    Returns the step, or None when nothing valid exists."""
    log = get_logger()
    for step, path in scan_steps(os.path.abspath(root)):
        if not verify_checkpoint(path):
            log.warning("distributed checkpoint %s is torn/corrupt; "
                        "skipping", path)
            continue
        try:
            load_state_dict(state_dict, path, process_group=process_group,
                            coordinator_rank=coordinator_rank)
        except LayoutError:
            raise      # another topology or format: loud, never an
            #            older checkpoint instead
        except Exception as e:
            log.warning("distributed checkpoint %s failed to load (%s); "
                        "skipping", path, e)
            continue
        return step
    return None


class DistributedSaver:
    """reference: auto_parallel/static/dist_saver.py:53."""

    def save(self, path, state_dict=None, program=None, **kwargs):
        return save_state_dict(state_dict or {}, path)

    def load(self, path, state_dict=None, load_optimizer=True, **kwargs):
        return load_state_dict(state_dict or {}, path)


def save_model_and_optimizer(model, optimizer, path, async_save=False):
    """One sharded checkpoint of the model's and the optimizer's state."""
    state = {"model": model.state_dict(),
             "optimizer": optimizer.state_dict() if optimizer else {}}
    return save_state_dict(state, path, async_save=async_save)


def load_model_and_optimizer(model, optimizer, path):
    state = {"model": model.state_dict(),
             "optimizer": optimizer.state_dict() if optimizer else {}}
    load_state_dict(state, path)
    model.load_state_dict(state["model"])
    if optimizer:
        optimizer.set_state_dict(state["optimizer"])
    return model, optimizer
