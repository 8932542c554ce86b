"""Analytic FLOPs of a forward pass, and so of a train step (port of
paddle_tpu/ops/flops.py: the same estimators, ``FlopsCounter`` with
``forward_flops``, ``train_step_flops`` = 3 × forward and ``by_op``).

The JAX package counts every op that passes its dispatch funnel
(``core/dispatch.apply_op``).  The port has no funnel, so it counts in
two places while a `FlopsCounter` is active:

- **its op entries**, each decorated with `counted` under the JAX op's
  name: ``linear``, ``flash_attention`` (the hand-written flash kernels
  behind it included; ``torch.utils.flop_counter`` does not see them),
  ``rms_norm``, ``layer_norm``, ``cross_entropy``, ``silu``, ``gelu``,
  ``dropout``, ``embedding``, ``fused_rope``.  An entry is counted once,
  with the shapes of its tensor arguments; the torch ops inside it are
  not counted again;
- **the tensor operations of model code** outside any entry (a residual
  add, the SwiGLU product, LoRA's ``A @ B``), through a
  ``TorchFunctionMode``: ``add``, ``multiply``, ``matmul``, ``bmm``,
  ``mean``, ``sum``, ``softmax``, ``tanh``, ``relu``, ``sigmoid``.

Each estimator counts forward multiply-add FLOPs (2 × MACs for the matrix
products), as the JAX table does.  One difference is deliberate: the
attention estimator reads ``[B, S, H, D]`` and the JAX models call the
flash op head-major (``[B, H, S, D]``), which JAX's counter reads as
``S = H``; the port passes ``head_major`` and counts the attention the
kernels compute, ``4·B·H·S²·D`` (half when causal).

    with FlopsCounter() as fc, torch.no_grad():
        model(ids)
    fc.train_step_flops
"""
from __future__ import annotations

import functools
import inspect
import math

import torch
from torch.overrides import TorchFunctionMode

#: the counter in effect (`FlopsCounter.__enter__`), or None
_ACTIVE = None


def _numel(shape):
    return int(math.prod(shape)) if len(shape) else 1


def _matmul_like(shapes, **kw):
    xs, ys = shapes[0], shapes[1]
    if len(xs) < 2 or len(ys) < 1:
        return 2 * _numel(xs)
    m, k = xs[-2], xs[-1]
    n = ys[-1] if len(ys) >= 2 else 1
    return 2 * _numel(xs[:-2]) * m * k * n


def _linear_flops(shapes, **kw):
    xs, ws = shapes[0], shapes[1]
    return 2 * _numel(xs[:-1]) * xs[-1] * ws[-1]


def _attention_flops(shapes, causal=True, head_major=False, **kw):
    """QK^T and PV: 4·B·H·S²·D, halved when causal."""
    causal = kw.get("is_causal", causal)
    qs = shapes[0]
    if len(qs) == 4:
        b, s, h, d = (qs[0], qs[2], qs[1], qs[3]) if head_major else qs
    else:
        b, s, h, d = 1, qs[0], qs[1], qs[2]
    full = 4 * b * h * s * s * d
    return full // 2 if causal else full


def _elementwise(k):
    def fn(shapes, **kw):
        return k * _numel(shapes[0])
    return fn


ESTIMATORS = {
    "matmul": _matmul_like,
    "bmm": _matmul_like,
    "linear": _linear_flops,
    "flash_attention": _attention_flops,
    "layer_norm": _elementwise(8),
    "rms_norm": _elementwise(8),
    "softmax": _elementwise(5),
    "cross_entropy": _elementwise(6),
    "embedding": _elementwise(0),
    "gelu": _elementwise(10),
    "silu": _elementwise(5),
    "relu": _elementwise(1),
    "tanh": _elementwise(5),
    "sigmoid": _elementwise(4),
    "add": _elementwise(1),
    "multiply": _elementwise(1),
    "mean": _elementwise(1),
    "sum": _elementwise(1),
    "dropout": _elementwise(2),
    "fused_rope": _elementwise(6),
}

_T = torch.Tensor
#: model-code tensor operations, by the JAX op name they are counted as
_TENSOR_OPS = {
    **dict.fromkeys((_T.__add__, _T.__radd__, _T.add, torch.add), "add"),
    **dict.fromkeys((_T.__mul__, _T.__rmul__, _T.mul, torch.mul,
                     torch.multiply), "multiply"),
    **dict.fromkeys((_T.__matmul__, _T.matmul, torch.matmul), "matmul"),
    **dict.fromkeys((_T.bmm, torch.bmm), "bmm"),
    **dict.fromkeys((_T.mean, torch.mean), "mean"),
    **dict.fromkeys((_T.sum, torch.sum), "sum"),
    **dict.fromkeys((_T.softmax, torch.softmax,
                     torch.nn.functional.softmax), "softmax"),
    **dict.fromkeys((_T.tanh, torch.tanh), "tanh"),
    **dict.fromkeys((_T.relu, torch.relu, torch.nn.functional.relu), "relu"),
    **dict.fromkeys((_T.sigmoid, torch.sigmoid), "sigmoid"),
}


def _shapes(args):
    return tuple(tuple(a.shape) if torch.is_tensor(a) else ()
                 for a in args)


class _ModelOps(TorchFunctionMode):
    def __init__(self, counter):
        super().__init__()
        self.counter = counter

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = _TENSOR_OPS.get(func)
        if name is not None and self.counter._depth == 0:
            self.counter.add(name, _shapes(args), {})
        return func(*args, **(kwargs or {}))


class FlopsCounter:
    """Forward FLOPs by op name while active (``with FlopsCounter() as
    fc:``): ``by_op``, ``forward_flops``, ``train_step_flops`` (3 ×
    forward: the backward ≈ 2 × forward, the PaLM/Chinchilla
    accounting), ``uncounted`` (names seen with no estimator)."""

    def __init__(self):
        self.by_op = {}
        self.uncounted = set()
        self._depth = 0
        self._mode = None
        self._prev = None

    def add(self, name, shapes, static):
        est = ESTIMATORS.get(name)
        if est is None:
            self.uncounted.add(name)
            return
        self.by_op[name] = self.by_op.get(name, 0) + int(est(shapes,
                                                             **static))

    @property
    def forward_flops(self):
        return sum(self.by_op.values())

    @property
    def train_step_flops(self):
        return 3 * self.forward_flops

    def __enter__(self):
        global _ACTIVE
        self._prev, _ACTIVE = _ACTIVE, self
        self._mode = _ModelOps(self)
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        global _ACTIVE
        self._mode.__exit__(*exc)
        _ACTIVE = self._prev
        return False


def counted(name, static=()):
    """Decorator of an op entry: while a `FlopsCounter` is active and no
    other entry is running, the call is counted once under ``name`` with
    the shapes of its positional tensor arguments and the arguments
    named in ``static`` (their defaults when not passed); the ops inside
    it are not counted.
    Without a counter it is a plain call."""
    def deco(fn):
        sig = inspect.signature(fn)

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            fc = _ACTIVE
            if fc is None or fc._depth:
                return fn(*args, **kwargs)
            bound = sig.bind(*args, **kwargs)
            bound.apply_defaults()
            fc.add(name, _shapes(args),
                   {k: bound.arguments[k] for k in static})
            fc._depth += 1
            try:
                return fn(*args, **kwargs)
            finally:
                fc._depth -= 1
        return wrapper
    return deco

