"""LoRA: low-rank adaptation of the ``Linear`` projections (port of
paddle_tpu/nn/lora.py): training and the adapter artifacts.

``W' = W + A @ B * (alpha / rank)`` with the base weight frozen and only
the rank-r factors trained.  `LoRALinear` adopts the wrapped
`nn.Linear`'s ``weight`` and ``bias`` parameters (the same tensors under
the same state-dict names), so the optimizer, amp, the compiled train
step and the checkpoints see an ordinary model.  Its forward is JAX's:
the effective weight ``W + torch.matmul(A, B) * scaling`` (a plain
product the JAX package computes outside any Pallas kernel too) and one
``F.linear`` over it.  Autograd keeps that weight, one more copy of each
wrapped projection, and the backward forms the full ``x^T dy`` weight
gradient before reducing it to dA and dB, as JAX's does.  `merge` writes
the same expression into the weight in place, so the merged and unmerged
forwards are equal bit for bit; `unmerge` copies back a stash of the
weight taken before (a float subtraction would not round-trip).

An adapter is ``{layer_name: {"A": [in, rank], "B": [rank, out], "rank",
"alpha"}}`` (`adapter_spec`, numpy arrays).  `save_adapter` writes the
factors as one npz plus a crc32 manifest (the `CheckpointManager`
protocol; the format the JAX package writes and reads), a bf16 factor
as its exact fp32 value; `load_adapter_state` reads and verifies it (the
serving `AdapterPool` takes the same structure), `load_adapter` copies
it into a wrapped model.
"""
from __future__ import annotations

import os

import numpy as np
import torch
from torch import nn

from . import functional as F
from .layers import Linear

ADAPTER_FILE = "adapter.npz"

# Projection attribute names wrapped by default: GPT (qkv_proj/out_proj/
# fc_in/fc_out) and Llama (q/k/v/o_proj, gate/up/down_proj).
DEFAULT_TARGETS = (
    "qkv_proj", "out_proj", "fc_in", "fc_out",
    "q_proj", "k_proj", "v_proj", "o_proj",
    "gate_proj", "up_proj", "down_proj",
)


def _default_generator(device):
    return torch.Generator(device=device).manual_seed(0)


class LoRALinear(nn.Module):
    """A `Linear` with a trainable low-rank residual ``A @ B * scaling``.

    ``LoRALinear(base, rank=8, alpha=None, name=None, *, generator=None)``
    adopts ``base``'s ``weight`` and ``bias``.  ``lora_A`` is drawn from N(0,
    0.02) with ``generator`` (a ``torch.Generator`` on the weight's
    device; None: one seeded 0), ``lora_B`` is zeros, so the adapter
    starts as the identity.  ``alpha`` defaults to ``rank``."""

    def __init__(self, base, rank=8, alpha=None, name=None, *,
                 generator=None):
        super().__init__()
        if not isinstance(base, Linear):
            raise TypeError(
                f"LoRALinear wraps nn.Linear, got {type(base).__name__}")
        rank = int(rank)
        if rank < 1:
            raise ValueError(f"LoRA rank must be >= 1, got {rank}")
        w = base.weight
        self.in_features = int(w.shape[0])
        self.out_features = int(w.shape[1])
        self.rank = rank
        self.alpha = float(alpha) if alpha is not None else float(rank)
        self.scaling = self.alpha / float(rank)
        self.weight = w
        self.bias = base.bias
        gen = generator if generator is not None else \
            _default_generator(w.device)
        self.lora_A = nn.Parameter(torch.empty(
            self.in_features, rank, device=w.device, dtype=w.dtype))
        self.lora_B = nn.Parameter(torch.zeros(
            rank, self.out_features, device=w.device, dtype=w.dtype))
        with torch.no_grad():
            self.lora_A.normal_(0.0, 0.02, generator=gen)
        self._merged = False
        self._weight_stash = None

    @property
    def merged(self):
        return self._merged

    def _effective_weight(self):
        return self.weight + torch.matmul(self.lora_A, self.lora_B) \
            * self.scaling

    def forward(self, x):
        if self._merged:
            return F.linear(x, self.weight, self.bias)
        return F.linear(x, self._effective_weight(), self.bias)

    @torch.no_grad()
    def merge(self):
        """Write ``A @ B * scaling`` into the weight, in place: the merged
        forward equals the unmerged one bit for bit (the same ops on the
        same tensors)."""
        if self._merged:
            return
        stash = self.weight.detach().clone()
        self.weight.copy_(self._effective_weight())
        self._weight_stash = stash
        self._merged = True

    @torch.no_grad()
    def unmerge(self):
        """Copy the weight stashed by `merge` back, in place."""
        if not self._merged:
            return
        self.weight.copy_(self._weight_stash)
        self._weight_stash = None
        self._merged = False

    def extra_repr(self):
        return (f"in_features={self.in_features}, "
                f"out_features={self.out_features}, rank={self.rank}, "
                f"alpha={self.alpha}, merged={self._merged}")


def attach_lora(model, rank=8, alpha=None, targets=None, *, generator=None):
    """Replace ``model``'s `Linear` attributes named in ``targets`` by
    `LoRALinear` wrappers, in place, drawing every ``lora_A`` from
    ``generator`` in module order (None: one seeded 0 on each weight's
    device).  Returns the qualified names of the wrapped projections;
    an attribute wrapped already is skipped."""
    targets = tuple(targets) if targets is not None else DEFAULT_TARGETS
    wrapped = []
    gens = {}
    for pname, parent in list(model.named_modules()):
        if isinstance(parent, LoRALinear):
            continue
        for attr, child in list(parent._modules.items()):
            if attr not in targets or not isinstance(child, Linear):
                continue
            gen = generator
            if gen is None:
                dev = child.weight.device
                gen = gens.setdefault(dev, _default_generator(dev))
            setattr(parent, attr, LoRALinear(child, rank=rank, alpha=alpha,
                                             generator=gen))
            wrapped.append(f"{pname}.{attr}" if pname else attr)
    if not wrapped:
        raise ValueError(
            f"attach_lora found no Linear sublayers matching targets "
            f"{targets}")
    return wrapped


def mark_only_lora_trainable(model):
    """``requires_grad=False`` on every parameter but the ``lora_A`` /
    ``lora_B`` factors; returns how many factors train."""
    n_lora = 0
    for name, p in model.named_parameters():
        train = name.rsplit(".", 1)[-1] in ("lora_A", "lora_B")
        p.requires_grad_(train)
        n_lora += int(train)
    if not n_lora:
        raise ValueError(
            "mark_only_lora_trainable: model has no LoRA parameters "
            "(call attach_lora first)")
    return n_lora


def lora_layers(model):
    """Qualified name -> `LoRALinear` of every wrapped projection."""
    return {name: m for name, m in model.named_modules()
            if isinstance(m, LoRALinear)}


def _host(t):
    t = t.detach()
    if t.dtype in (torch.bfloat16, torch.float16):
        t = t.float()                 # exact; numpy has no bfloat16
    return t.cpu().numpy().copy()


def adapter_spec(model):
    """The adapter in memory: ``{layer_name: {"A", "B", "rank", "alpha"}}``
    (numpy), the structure `load_adapter_state` returns and the serving
    ``AdapterPool`` takes."""
    layers = lora_layers(model)
    if not layers:
        raise ValueError("adapter_spec: model has no LoRA layers")
    spec = {}
    for name, lyr in layers.items():
        if lyr.merged:
            raise ValueError(
                f"adapter_spec: layer {name} is merged — unmerge() first")
        spec[name] = {"A": _host(lyr.lora_A), "B": _host(lyr.lora_B),
                      "rank": lyr.rank, "alpha": lyr.alpha}
    return spec


def save_adapter(model, dirpath, meta=None):
    """Write only the adapter's factors: one npz and a crc32 manifest
    (``verify_checkpoint(dirpath)`` checks it).  Returns the npz's path."""
    # framework imports the optimizers, which import nn: not at import time
    from ..framework.checkpoint_manager import write_manifest
    spec = adapter_spec(model)
    os.makedirs(dirpath, exist_ok=True)
    arrays, layers_meta = {}, {}
    for name, st in spec.items():
        arrays[name + ".lora_A"] = st["A"]
        arrays[name + ".lora_B"] = st["B"]
        layers_meta[name] = {
            "rank": st["rank"], "alpha": st["alpha"],
            "in_features": int(st["A"].shape[0]),
            "out_features": int(st["B"].shape[1]),
        }
    path = os.path.join(dirpath, ADAPTER_FILE)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    full_meta = {"format": "lora_adapter", "layers": layers_meta}
    if meta:
        full_meta.update(meta)
    write_manifest(dirpath, meta=full_meta)
    return path


def load_adapter_state(dirpath):
    """Read and crc-verify an adapter artifact.  Returns ``{layer_name:
    {"A", "B", "rank", "alpha"}}``."""
    from ..framework.checkpoint_manager import (read_manifest,
                                                verify_checkpoint)
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


def load_adapter(model, dirpath):
    """Copy an artifact's factors into a model wrapped by `attach_lora`
    (in place, in the factors' dtype).  Ranks must match the wrappers;
    ``alpha`` and the scaling are taken from the artifact.  Returns the
    layer names loaded."""
    spec = load_adapter_state(dirpath)
    layers = lora_layers(model)
    missing = sorted(set(spec) - set(layers))
    if missing:
        raise ValueError(
            f"load_adapter: model has no LoRA layers named {missing} "
            f"(attached: {sorted(layers)})")
    with torch.no_grad():
        for name, st in spec.items():
            lyr = layers[name]
            if st["rank"] != lyr.rank:
                raise ValueError(
                    f"load_adapter: layer {name} rank mismatch — artifact "
                    f"has rank {st['rank']}, model wrapper has rank "
                    f"{lyr.rank}")
            lyr.lora_A.copy_(torch.from_numpy(st["A"]))
            lyr.lora_B.copy_(torch.from_numpy(st["B"]))
            lyr.alpha = st["alpha"]
            lyr.scaling = st["alpha"] / float(st["rank"])
    return sorted(spec)
