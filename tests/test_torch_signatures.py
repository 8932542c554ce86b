"""Calls written for the JAX package bind on the port as they bind there
(ROADMAP Queue C, the "same names" entries 1-7): JAX's
``name`` in its place in `nn.functional`, ``generator`` keyword-only,
`rms_norm` without a weight, `embedding`'s ``x``; the norms' and
`LoRALinear`'s positional parameters; `GradScaler.minimize`;
`recompute(use_reentrant=...)`; `init_parallel_env`'s JAX keywords;
`to_device_batch` without a device; and the serving pool's
``lora_delta(y, x, ...)``.  Each result is held against JAX's on the same
inputs (fp32, CPU)."""
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch import amp
from paddle_tpu_torch.distributed.fleet.mp_layers import \
    VocabParallelEmbedding
from paddle_tpu_torch.distributed.fleet.utils import recompute
from paddle_tpu_torch.nn import Embedding, LayerNorm, Linear, RMSNorm
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.lora import LoRALinear
from paddle_tpu_torch.optimizer import SGD

ROOT = Path(__file__).resolve().parent.parent


def _np(t):
    return np.asarray(t._data_ if hasattr(t, "_data_") else t._data)


def _x(shape=(2, 8), seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(got, want, tol=1e-6):
    np.testing.assert_allclose(got.detach().numpy(), _np(want), rtol=tol,
                               atol=tol)


# ---- 1. nn/functional.py ---------------------------------------------------

def test_rms_norm_without_weight_and_with_name():
    x = _x()
    _close(F.rms_norm(torch.from_numpy(x)), JF.rms_norm(paddle.to_tensor(x)))
    w = _x((8,), 1)
    _close(F.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6, "n"),
           JF.rms_norm(paddle.to_tensor(x), paddle.to_tensor(w), 1e-6, "n"))


@pytest.mark.parametrize("op", ["linear", "gelu", "silu", "layer_norm"])
def test_functional_takes_name_in_jax_place(op):
    x, w = _x(), _x((8, 4), 1)
    args = {"linear": ((w, None, "fc"),), "gelu": ((False, "g"),),
            "silu": (("s",),),
            "layer_norm": ((8, None, None, 1e-5, "ln"),)}[op][0]

    def conv(a, to):
        return to(a) if isinstance(a, np.ndarray) else a
    got = getattr(F, op)(torch.from_numpy(x),
                         *[conv(a, torch.from_numpy) for a in args])
    want = getattr(JF, op)(paddle.to_tensor(x),
                           *[conv(a, paddle.to_tensor) for a in args])
    _close(got, want, 1e-5)


def test_embedding_takes_x_by_name():
    ids = np.array([[1, 2, 3]], np.int64)
    w = _x((5, 4))
    _close(F.embedding(x=torch.from_numpy(ids), weight=torch.from_numpy(w)),
           JF.embedding(x=paddle.to_tensor(ids), weight=paddle.to_tensor(w)))
    emb = Embedding(5, 4, device="cpu")
    assert emb(x=torch.from_numpy(ids)).shape == (1, 3, 4)
    vpe = VocabParallelEmbedding(5, 4, device="cpu")
    assert vpe(x=torch.from_numpy(ids)).shape == (1, 3, 4)


def test_dropout_and_attention_bind_name_not_generator():
    x = torch.ones(64, 32)
    y = F.dropout(x, 0.5, None, True, "upscale_in_train", "d1")
    assert set(torch.unique(y).tolist()) <= {0.0, 2.0} and (y == 0).any()
    assert torch.equal(F.dropout(x, 0.5, None, False, "upscale_in_train",
                                 "d1"), x)
    q, k, v = (_x((1, 8, 2, 16), s) for s in range(3))
    got = F.scaled_dot_product_attention(
        *(torch.from_numpy(t) for t in (q, k, v)), None, 0.0, True, False,
        "attn")
    want = JF.scaled_dot_product_attention(
        *(paddle.to_tensor(t) for t in (q, k, v)), None, 0.0, True, False,
        "attn")
    _close(got, want, 2e-5)
    with pytest.raises(TypeError):
        F.dropout(x, 0.5, None, True, "upscale_in_train", "d1",
                  torch.Generator())


# ---- 2. layer signatures ---------------------------------------------------

def test_layer_norm_bias_attr_false_as_jax():
    paddle.seed(0)
    jl = jnn.LayerNorm(8, 1e-5, None, False, "ln")
    tl = LayerNorm(8, 1e-5, None, False, "ln", device="cpu")
    assert jl.bias is None and tl.bias is None
    assert [n for n, _ in tl.named_parameters()] == ["weight"]
    x = _x()
    _close(tl(torch.from_numpy(x)), jl(paddle.to_tensor(x)), 1e-5)
    no_w = LayerNorm(8, weight_attr=False, device="cpu")
    assert no_w.weight is None and no_w.bias is not None


def test_rms_norm_layer_positional_as_jax():
    jl = jnn.RMSNorm(8, 1e-6, None, "n")
    tl = RMSNorm(8, 1e-6, None, "n", device="cpu")
    x = _x()
    _close(tl(torch.from_numpy(x)), jl(paddle.to_tensor(x)), 1e-6)
    with pytest.raises(NotImplementedError, match="A9"):
        RMSNorm(8, 1e-6, object(), device="cpu")


def test_lora_linear_takes_name_fourth():
    lora = LoRALinear(Linear(4, 6, device="cpu"), 2, 4, "q")
    assert lora.rank == 2 and lora.scaling == 2.0
    g = torch.Generator().manual_seed(3)
    a = LoRALinear(Linear(4, 6, device="cpu"), 2, 4, "q", generator=g)
    assert a.lora_A.shape == (4, 2)


# ---- 3. GradScaler.minimize ------------------------------------------------

def test_grad_scaler_minimize_is_step_as_jax():
    from paddle_tpu.amp import GradScaler as JaxScaler
    init = np.array([1.0, -2.0, 3.0], np.float32)
    jw = paddle.Parameter(init.copy())
    jopt = paddle.optimizer.SGD(0.1, parameters=[jw])
    js = JaxScaler(init_loss_scaling=8.0)
    jl = js.scale((jw * jw).sum())
    jl.backward()
    js.minimize(jopt, jl)
    tw = torch.nn.Parameter(torch.from_numpy(init.copy()))
    topt = SGD(0.1, parameters=[tw])
    ts = amp.GradScaler(init_loss_scaling=8.0)
    tl = ts.scale((tw * tw).sum())
    tl.backward()
    ts.minimize(topt, tl)
    np.testing.assert_allclose(tw.detach().numpy(), _np(jw), rtol=1e-6)
    jscale = js.get_loss_scaling()
    assert ts.get_loss_scaling() == float(np.asarray(
        getattr(jscale, "_data", jscale)))


# ---- 4. recompute(use_reentrant=...) ---------------------------------------

@pytest.mark.parametrize("reentrant", [True, False])
def test_recompute_takes_use_reentrant(reentrant):
    lin = Linear(4, 4, device="cpu")
    x = torch.from_numpy(_x((3, 4))).requires_grad_()
    y = recompute(lin, x, use_reentrant=reentrant)
    y.sum().backward()
    g = x.grad.clone()
    x.grad = None
    lin(x).sum().backward()
    assert torch.equal(g, x.grad)


# ---- 5. init_parallel_env's JAX keywords -----------------------------------

def test_init_parallel_env_takes_jax_keywords():
    from paddle_tpu_torch.distributed import env
    with pytest.raises(ValueError, match="num_processes or world_size"):
        env.init_parallel_env(num_processes=1, world_size=1)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    code = ("from paddle_tpu_torch.distributed import env\n"
            f"e = env.init_parallel_env('127.0.0.1:{port}', 1, 0, "
            "backend='gloo', device='cpu')\n"
            "print(e.world_size, e.rank)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["1", "0"]


# ---- 6. serving/adapters.lora_delta(y, x, ...) -----------------------------

def test_serving_lora_delta_is_jax_contract():
    from paddle_tpu.serving import adapters as jad
    from paddle_tpu_torch.serving import adapters as tad
    rng = np.random.default_rng(4)
    y = rng.normal(size=(3, 2, 6)).astype(np.float32)
    x = rng.normal(size=(3, 2, 5)).astype(np.float32)
    a = rng.normal(size=(4, 5, 2)).astype(np.float32)
    b = rng.normal(size=(4, 2, 6)).astype(np.float32)
    s = rng.uniform(size=(4,)).astype(np.float32)
    idx = np.array([0, 3, 1], np.int32)
    want = jad.lora_delta(*(paddle.to_tensor(t) for t in (y, x, a, b, s)),
                          paddle.to_tensor(idx))
    got = tad.lora_delta(*(torch.from_numpy(t) for t in (y, x, a, b, s, idx)))
    _close(got, want, 1e-5)


# ---- 7. to_device_batch without a device ----------------------------------

def test_to_device_batch_defaults_to_the_card(monkeypatch):
    from paddle_tpu_torch.data.prefetch import to_device_batch
    batch = {"ids": np.arange(6).reshape(2, 3)}
    out = to_device_batch(batch, "cpu")
    assert out["ids"].device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        to_device_batch(batch)
