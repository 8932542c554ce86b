"""Functional ops of the serving and training paths (port of
paddle_tpu/nn/functional.py: ``rms_norm``, ``layer_norm``, ``silu``,
``gelu``, ``dropout``, ``linear``, ``cross_entropy``,
``scaled_dot_product_attention``; and the public ``flash_attention`` of
paddle_tpu/pallas/flash_attention.py).

``linear``, ``rms_norm``, ``layer_norm``, ``cross_entropy`` and the two
attention entries apply `amp.auto_cast`'s lists under the JAX op names
(`amp.amp_op`), as the JAX package's dispatch hook applies them."""
from __future__ import annotations

import torch

from .. import amp
from ..kernels import flash_attention as _fa
from ..kernels import graph_state
from ..kernels import rms_norm as _rms
from ..ops.flops import counted


@counted("rms_norm")
@amp.amp_op("rms_norm")
def rms_norm(x, weight=None, epsilon=1e-6, name=None):
    """x / rms(x) * weight: the RMS-norm kernels on the card, their plain
    versions on the CPU.  When autograd needs a gradient the call goes
    through `RMSNormFunction` (forward kernel, then the backward kernel);
    otherwise (serving, ``torch.no_grad()``) only the forward runs.
    Without ``weight`` no kernel backs it, as in the JAX package: the
    statistics in fp32 for a 16-bit ``x``, rounded once to x's dtype."""
    if weight is None:
        xf = x.float() if x.dtype in (torch.bfloat16, torch.float16) else x
        ms = xf.square().mean(dim=-1, keepdim=True)
        return (xf * torch.rsqrt(ms + epsilon)).to(x.dtype)
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad):
        return _rms.RMSNormFunction.apply(x, weight, epsilon)
    return _rms.rms_norm(x, weight, epsilon)


@counted("layer_norm")
@amp.amp_op("layer_norm")
def layer_norm(x, normalized_shape=None, weight=None, bias=None,
               epsilon=1e-5, name=None):
    """The JAX package's rounding order, not ``F.layer_norm``'s: the
    statistics and the normalised value in fp32 for a 16-bit ``x``, that
    value rounded to x's dtype, then ``* weight + bias`` in x's dtype (the
    two differ in bf16).  No Pallas kernel backs it on the TPU either."""
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    n_axes = len(normalized_shape) if normalized_shape else 1
    axes = tuple(range(x.dim() - n_axes, x.dim()))
    xf = x.float() if x.dtype in (torch.bfloat16, torch.float16) else x
    mean = xf.mean(dim=axes, keepdim=True)
    var = (xf - mean).square().mean(dim=axes, keepdim=True)
    out = ((xf - mean) * torch.rsqrt(var + epsilon)).to(x.dtype)
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out


@counted("embedding")
def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Rows of ``weight`` at integer ids ``x``; with ``padding_idx`` the
    rows of ids equal to it are multiplied by 0 (so is their gradient), as the
    JAX package masks them.  Floating ids raise ``ValueError`` before
    anything is launched, as the JAX package's ``jnp.take`` refuses them
    (a ``bad_batch`` fault scales token ids into floats; cast to int64
    they would index past the table, which fails a device assert that
    poisons the CUDA context)."""
    if x.is_floating_point() or x.is_complex():
        raise ValueError("indices must have an integer type")
    out = torch.nn.functional.embedding(x.long(), weight)
    if padding_idx is not None:
        out = out * (x != padding_idx)[..., None].to(out.dtype)
    return out


@counted("silu")
def silu(x, name=None):
    return torch.nn.functional.silu(x)


@counted("gelu")
def gelu(x, approximate=False, name=None):
    """GELU; ``approximate=True`` is the tanh form (GPT-2's), as
    ``jax.nn.gelu(approximate=True)``."""
    return torch.nn.functional.gelu(
        x, approximate="tanh" if approximate else "none")


_generators = {}


def default_generator(device):
    """This package's own generator for ``device`` (seed 0), used by
    `dropout` when the caller passes none; never torch's global RNG."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev not in _generators:
        _generators[dev] = torch.Generator(device=dev).manual_seed(0)
    return _generators[dev]


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None, *, generator=None):
    """``upscale_in_train`` dropout: each element kept with probability
    ``1 - p`` (a uniform draw from ``generator``, a ``torch.Generator`` on
    x's device) and divided by ``1 - p``; the identity when not training
    or ``p == 0``.  Capturable: a captured train step registers the
    generator with its graph (`kernels.graph_state.note_generator`), so a
    replay draws the mask an eager step would draw."""
    if not training or p == 0.0:
        return x
    if mode != "upscale_in_train" or axis is not None:
        raise NotImplementedError(
            f"dropout: mode={mode!r}, axis={axis!r}: only upscale_in_train "
            "over every element is ported (ROADMAP A9)")
    return _dropout(x, p, default_generator(x.device) if generator is None
                    else generator)


@counted("dropout")
def _dropout(x, p, gen):
    def draw():
        graph_state.note_generator(gen)
        return torch.rand(x.shape, device=x.device, generator=gen) < 1.0 - p
    # a recomputed region takes its first run's mask back (no draw)
    keep = graph_state.logged_draw(draw)
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype,
                                                        device=x.device))


@counted("linear")
@amp.amp_op("linear")
def linear(x, weight, bias=None, name=None):
    """y = x @ W + b with W in Paddle's ``[in, out]`` layout."""
    y = torch.matmul(x, weight)
    if bias is not None:
        y = y + bias
    return y


class _SoftmaxXent(torch.autograd.Function):
    """Per-row softmax cross-entropy with hard labels (port of the JAX
    package's ``_softmax_xent_fused``): log-softmax in fp32; the backward
    keeps only the logits in their own dtype and the fp32 log-sum-exp, and
    recomputes the softmax, instead of saving fp32 copies of the logits."""

    @staticmethod
    def forward(ctx, logits, label, ignore_index):
        x32 = logits.float()
        lse = torch.logsumexp(x32, dim=-1, keepdim=True)
        lbl = label.clamp(0, logits.shape[-1] - 1).long()
        picked = x32.gather(-1, lbl[..., None])[..., 0]
        mask = label != ignore_index
        loss = torch.where(mask, lse[..., 0] - picked,
                           torch.zeros((), device=logits.device))
        ctx.save_for_backward(logits, label, lse)
        ctx.ignore_index = ignore_index
        return loss

    @staticmethod
    def backward(ctx, g):
        logits, label, lse = ctx.saved_tensors
        mask = label != ctx.ignore_index
        gm = torch.where(mask, g, torch.zeros((), device=g.device)).float()
        d = torch.exp(logits.float() - lse)
        lbl = label.clamp(0, logits.shape[-1] - 1).long()
        d.scatter_add_(-1, lbl[..., None],
                       -torch.ones_like(lbl, dtype=d.dtype)[..., None])
        d.mul_(gm[..., None])
        return d.to(logits.dtype), None, None


def _reduce(loss, reduction):
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


@counted("cross_entropy")
@amp.amp_op("cross_entropy")
def cross_entropy(input, label, weight=None, ignore_index=-100,  # noqa: A002
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    """paddle_tpu's ``cross_entropy``: log-softmax in fp32 whatever the
    logits' dtype.  Hard labels on the last axis without weight or
    smoothing (the LM head) take the fused softmax cross-entropy, the
    mean over the labels that are not ``ignore_index``; ``weight``,
    ``soft_label``, another ``axis``, ``use_softmax=False`` and
    ``label_smoothing`` take plain torch ops in the JAX package's
    order."""
    if (use_softmax and not soft_label and label_smoothing == 0.0
            and weight is None and axis in (-1, input.dim() - 1)):
        lbl = label
        if lbl.dim() == input.dim():
            lbl = lbl.squeeze(axis)
        loss = _SoftmaxXent.apply(input, lbl, ignore_index)
        if reduction == "mean":
            count = (lbl != ignore_index).sum().to(loss.dtype)
            return loss.sum() / count.clamp_min(1.0)
        return _reduce(loss, reduction)
    x = input.float() if input.dtype in (torch.bfloat16, torch.float16) \
        else input
    if use_softmax:
        logp = torch.log_softmax(x, dim=axis)
    else:
        logp = torch.log(x.clamp_min(1e-30))
    if soft_label:
        lbl = label.to(logp.dtype)
        if label_smoothing > 0.0:
            n = logp.shape[axis]
            lbl = lbl * (1 - label_smoothing) + label_smoothing / n
        return _reduce(-(lbl * logp).sum(dim=axis), reduction)
    lbl = label
    if lbl.dim() == logp.dim():
        lbl = lbl.squeeze(axis)
    lbl_clipped = lbl.clamp(0, logp.shape[axis] - 1).long()
    picked = torch.take_along_dim(logp, lbl_clipped[..., None],
                                  dim=axis)[..., 0]
    if label_smoothing > 0.0:
        smooth = logp.mean(dim=axis)
        loss = -(1 - label_smoothing) * picked - label_smoothing * smooth
    else:
        loss = -picked
    mask = lbl != ignore_index
    zero = torch.zeros((), dtype=loss.dtype, device=loss.device)
    loss = torch.where(mask, loss, zero)
    if weight is not None:
        w = weight.to(loss.device)[lbl_clipped]
        loss = loss * w
        if reduction == "mean":
            denom = torch.where(mask, w, torch.zeros_like(w)).sum()
            return loss.sum() / denom.clamp_min(1e-12)
    if reduction == "mean":
        return loss.sum() / mask.sum().to(loss.dtype).clamp_min(1.0)
    return _reduce(loss, reduction)


def mse_loss(input, label, reduction="mean", name=None):  # noqa: A002
    """paddle_tpu's ``mse_loss``: the squared difference, reduced."""
    return _reduce(torch.square(input - label), reduction)


flash_attention = counted("flash_attention", ("causal", "head_major"))(
    amp.amp_op("flash_attention")(_fa.flash_attention))


@counted("flash_attention", ("is_causal",))
@amp.amp_op("flash_attention")
def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, name=None, *,
                                 generator=None):
    """``[B, S, H, D]`` attention through the flash kernels
    (`kernels.flash_attention.flash_attention`), as the JAX package routes
    it to its Pallas kernels: a boolean or additive ``attn_mask``,
    in-kernel dropout seeded from ``generator`` (a CPU generator)."""
    return _fa.flash_attention(query, key, value, attn_mask=attn_mask,
                               dropout=dropout_p, causal=is_causal,
                               training=training, generator=generator)
