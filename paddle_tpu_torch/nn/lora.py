"""LoRA adapter artifacts on the serving side (port of the reading half of
paddle_tpu/nn/lora.py).

An adapter is ``{layer_name: {"A": [in, rank], "B": [rank, out], "rank",
"alpha"}}`` (the ``adapter_spec`` structure, numpy arrays), applied as
``W + A @ B * (alpha / rank)``.  ``save_adapter`` in either package writes
it as one npz plus a crc32 manifest; `load_adapter_state` reads and
verifies it.  ``LoRALinear``, ``attach_lora`` and adapter training are
not ported.
"""
from __future__ import annotations

import os

import numpy as np

from ..framework.checkpoint_manager import read_manifest, verify_checkpoint

ADAPTER_FILE = "adapter.npz"

# Projection attribute names an adapter may target: GPT (qkv_proj/out_proj/
# fc_in/fc_out) and Llama (q/k/v/o_proj, gate/up/down_proj).
DEFAULT_TARGETS = (
    "qkv_proj", "out_proj", "fc_in", "fc_out",
    "q_proj", "k_proj", "v_proj", "o_proj",
    "gate_proj", "up_proj", "down_proj",
)


def load_adapter_state(dirpath):
    """Read and crc-verify an adapter artifact.  Returns ``{layer_name:
    {"A", "B", "rank", "alpha"}}``."""
    man = read_manifest(dirpath)
    if man is None:
        raise FileNotFoundError(
            f"no adapter manifest under {dirpath!r} (expected "
            f"{ADAPTER_FILE} + manifest.json written by save_adapter)")
    if not verify_checkpoint(dirpath):
        raise ValueError(
            f"adapter artifact at {dirpath!r} failed crc32 verification")
    layers_meta = (man.get("meta") or {}).get("layers") or {}
    spec = {}
    with np.load(os.path.join(dirpath, ADAPTER_FILE)) as z:
        for name, lm in layers_meta.items():
            spec[name] = {"A": np.asarray(z[name + ".lora_A"]),
                          "B": np.asarray(z[name + ".lora_B"]),
                          "rank": int(lm["rank"]),
                          "alpha": float(lm["alpha"])}
    if not spec:
        raise ValueError(f"adapter manifest at {dirpath!r} lists no layers")
    return spec
