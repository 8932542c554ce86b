"""Functional ops of the serving and training paths (port of
paddle_tpu/nn/functional.py: ``rms_norm``, ``silu``, ``linear``,
``cross_entropy``)."""
from __future__ import annotations

import torch

from ..kernels import rms_norm as _rms


def rms_norm(x, weight, epsilon=1e-6):
    """x / rms(x) * weight: the RMS-norm kernels on the card, their plain
    versions on the CPU.  When autograd needs a gradient the call goes
    through `RMSNormFunction` (forward kernel, then the backward kernel);
    otherwise (serving, ``torch.no_grad()``) only the forward runs."""
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad):
        return _rms.RMSNormFunction.apply(x, weight, epsilon)
    return _rms.rms_norm(x, weight, epsilon)


def silu(x):
    return torch.nn.functional.silu(x)


def linear(x, weight, bias=None):
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


def cross_entropy(input, label, ignore_index=-100):  # noqa: A002
    """Hard-label softmax cross-entropy over the last axis (the LM-head
    case of paddle_tpu's ``cross_entropy``, ``reduction="mean"``): fp32
    whatever the logits' dtype, averaged over the labels that are not
    ``ignore_index``."""
    loss = _SoftmaxXent.apply(input, label, ignore_index)
    count = (label != ignore_index).sum().to(loss.dtype)
    return loss.sum() / count.clamp_min(1.0)
