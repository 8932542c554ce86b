"""The port's layers in the JAX package's positional forms (ROADMAP
Queue C 2): ``Linear(in, out, weight_attr, bias_attr, name)``,
``Embedding(n, d, padding_idx, sparse, weight_attr, name)`` and
``Dropout(p, axis, mode, name)`` against paddle_tpu/nn/layers_common.py,
with the port's own parameters keyword-only.  ``padding_idx`` is held
against JAX's ``F.embedding`` in the forward and the gradient (exact), a
negative one included (JAX zeroes that row and masks nothing).  A layer
fills its parameters at construction, as JAX's do; a ``ParamAttr`` or a
dropout the port does not compute raises ``NotImplementedError`` naming
ROADMAP A9."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch.nn import Dropout, Embedding, Linear
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn import layers


def _np(t):
    return np.asarray(t._data_ if hasattr(t, "_data_") else t._data)


def _adopt(port_param, jax_param):
    with torch.no_grad():
        port_param.copy_(torch.from_numpy(_np(jax_param).copy()))


def test_linear_positional_forms_match_jax():
    """The third positional argument is ``weight_attr`` (None: a bias is
    made), the fourth ``bias_attr`` (False: none); the outputs equal JAX's
    on its weights."""
    paddle.seed(1)
    jl = jnn.Linear(4, 8, None)
    tl = Linear(4, 8, None, device="cpu")
    assert tl.bias is not None and jl.bias is not None
    assert tuple(tl.weight.shape) == tuple(jl.weight.shape) == (4, 8)
    _adopt(tl.weight, jl.weight)
    _adopt(tl.bias, jl.bias)
    x = np.random.default_rng(0).normal(size=(3, 4)).astype(np.float32)
    np.testing.assert_allclose(tl(torch.from_numpy(x)).detach().numpy(),
                               _np(jl(paddle.to_tensor(x))), rtol=1e-6,
                               atol=1e-6)
    jn = jnn.Linear(4, 8, None, False, "head")
    tn = Linear(4, 8, None, False, "head", device="cpu")
    assert jn.bias is None and tn.bias is None
    assert [n for n, _ in tn.named_parameters()] == ["weight"]


def test_linear_init_at_construction():
    """Xavier normal weights and a zero bias, drawn when the layer is made
    (the parent left both uninitialised until a model's init pass); a
    model's layers wait for its own generator (`deferred_init`)."""
    lin = Linear(256, 256, device="cpu")
    std = float(lin.weight.detach().std())
    assert abs(std - np.sqrt(2.0 / 512)) < 0.05 * np.sqrt(2.0 / 512)
    assert not lin.bias.any()
    with layers.deferred_init():
        lazy = Linear(2, 2, device="cpu")
    with torch.no_grad():
        lazy.reset_parameters(torch.Generator().manual_seed(0))
    assert torch.isfinite(lazy.weight).all()


@pytest.mark.parametrize("attr", ["weight_attr", "bias_attr"])
def test_param_attr_raises_naming_a9(attr):
    with pytest.raises(NotImplementedError, match="A9"):
        Linear(4, 8, device="cpu", **{attr: object()})
    with pytest.raises(NotImplementedError, match="A9"):
        Embedding(4, 8, weight_attr=object(), device="cpu")


@pytest.mark.parametrize("padding_idx", [0, 3, -1])
def test_embedding_padding_idx_matches_jax(padding_idx):
    """``Embedding(10, 4, padding_idx)``: that row is 0 at init in both
    packages and the others N(0, 1); then, on JAX's weights with the
    padding row set to ones (so masking shows), the lookups and the
    gradient equal JAX's exactly: the padding id's rows read 0 and send no
    gradient; a negative index zeroes its row and masks nothing."""
    paddle.seed(2)
    je = jnn.Embedding(10, 4, padding_idx)
    te = Embedding(10, 4, padding_idx, device="cpu")
    assert not _np(je.weight)[padding_idx].any()
    assert not te.weight[padding_idx].any()
    assert te.weight.abs().sum() > 0 and te.padding_idx == padding_idx
    w = _np(je.weight).copy()
    w[padding_idx] = 1.0
    je.weight.set_value(w)
    _adopt(te.weight, je.weight)
    ids = np.array([[0, 3, 9, 5], [3, 3, 0, 9]], np.int64)
    g = np.random.default_rng(3).normal(size=(2, 4, 4)).astype(np.float32)
    jout = je(paddle.to_tensor(ids))
    (jout * paddle.to_tensor(g)).sum().backward()
    tout = te(torch.from_numpy(ids))
    (tout * torch.from_numpy(g)).sum().backward()
    np.testing.assert_array_equal(tout.detach().numpy(), _np(jout))
    np.testing.assert_array_equal(te.weight.grad.numpy(),
                                  _np(je.weight.grad))
    masked = ids == padding_idx
    assert (masked.any()) == (padding_idx >= 0)
    assert not tout.detach().numpy()[masked].any()


def test_embedding_functional_padding_idx_matches_jax():
    w = np.random.default_rng(4).normal(size=(6, 3)).astype(np.float32)
    ids = np.array([1, 2, 1, 5], np.int64)
    np.testing.assert_array_equal(
        F.embedding(torch.from_numpy(ids), torch.from_numpy(w), 1).numpy(),
        _np(JF.embedding(paddle.to_tensor(ids), paddle.to_tensor(w),
                         padding_idx=1)))


def test_embedding_init_is_standard_normal():
    te = Embedding(1000, 16, 0, device="cpu")
    rows = te.weight[1:].detach()
    assert abs(float(rows.std()) - 1.0) < 0.05
    assert abs(float(rows.mean())) < 0.05


def test_dropout_positional_forms_match_jax():
    """``Dropout(p, axis, mode, name)``: JAX's positional form builds in
    both; eval is the identity; training keeps ~1 - p of the elements,
    scaled by 1 / (1 - p), in both packages.  The generator is
    keyword-only: the parent took ``Dropout(0.1, 1)``'s 1 as its
    generator, JAX takes it as ``axis``, which the port refuses (A9), as
    it refuses another mode."""
    jd = jnn.Dropout(0.25, None, "upscale_in_train", "drop")
    td = Dropout(0.25, None, "upscale_in_train", "drop",
                 generator=torch.Generator().manual_seed(0))
    x = np.ones((64, 64), np.float32)
    jd.eval()
    td.eval()
    np.testing.assert_array_equal(td(torch.from_numpy(x)).numpy(), x)
    np.testing.assert_array_equal(_np(jd(paddle.to_tensor(x))), x)
    jd.train()
    td.train()
    for out in (td(torch.from_numpy(x)).numpy(),
                _np(jd(paddle.to_tensor(x)))):
        kept = out != 0
        assert abs(kept.mean() - 0.75) < 0.03
        np.testing.assert_allclose(out[kept], 1.0 / 0.75, rtol=1e-6)
    assert jnn.Dropout(0.1, 1).axis == 1
    with pytest.raises(NotImplementedError, match="A9"):
        Dropout(0.1, 1)
    with pytest.raises(NotImplementedError, match="A9"):
        Dropout(0.1, None, "downscale_in_infer")
    with pytest.raises(TypeError):
        Dropout(0.1, None, "upscale_in_train", None,
                torch.Generator())            # generator: keyword only
