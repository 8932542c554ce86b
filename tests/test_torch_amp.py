"""The port's amp surface against the JAX package's: `auto_cast` with
custom white and black lists at O1 and O2 on each op entry that applies
them (the port's counterpart of the JAX dispatch hook ``_amp_cast``),
the names it cannot honour, ``amp_guard``, ``is_bfloat16_supported`` /
``is_float16_supported``, ``decorate(save_dtype=)``, and the global-norm
clip's ``group_name`` / ``auto_skip_clip``.

Tolerances: the output dtype is equal.  fp32 outputs within 1e-5
(sums in another order); bf16 outputs compared in fp32 within 2e-2
absolute and relative (one bf16 rounding of each output is 2^-8
relative, and the attention's p·V is rounded at another place in JAX's
CPU lane, ROADMAP Queue C's reference-side notes).
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.core.tensor import Tensor
from paddle_tpu_torch import amp
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm

OPS = ("linear", "rms_norm", "layer_norm", "cross_entropy",
       "flash_attention")


def _inputs(op, seed=0):
    rng = np.random.default_rng(seed)

    def n(*s):
        return rng.normal(size=s).astype(np.float32)
    if op == "linear":
        return [n(2, 8, 16), n(16, 12), n(12)]
    if op in ("rms_norm", "layer_norm"):
        return [n(4, 16), 1.0 + 0.1 * n(16)] + \
            ([0.1 * n(16)] if op == "layer_norm" else [])
    if op == "cross_entropy":
        return [n(6, 10), rng.integers(0, 10, (6,)).astype(np.int64)]
    return [n(1, 16, 2, 8) for _ in range(3)]


def _jax_call(op, arrs):
    jf = paddle.nn.functional
    t = [Tensor(jnp.asarray(a)) for a in arrs]
    if op == "linear":
        return jf.linear(*t)
    if op == "rms_norm":
        return jf.rms_norm(t[0], t[1], 1e-6)
    if op == "layer_norm":
        return jf.layer_norm(t[0], [16], t[1], t[2], 1e-5)
    if op == "cross_entropy":
        return jf.cross_entropy(t[0], t[1])
    return jf.scaled_dot_product_attention(*t, is_causal=True)


def _port_call(op, arrs):
    t = [torch.from_numpy(a.copy()) for a in arrs]
    if op == "linear":
        return F.linear(*t)
    if op == "rms_norm":
        return F.rms_norm(t[0], t[1], 1e-6)
    if op == "layer_norm":
        return F.layer_norm(t[0], [16], t[1], t[2], 1e-5)
    if op == "cross_entropy":
        return F.cross_entropy(t[0], t[1])
    return F.scaled_dot_product_attention(*t, is_causal=True)


LISTS = {"none": ({}, {}), "white": ({"custom_white_list": True}, {}),
         "black": ({}, {"custom_black_list": True})}


@pytest.mark.parametrize("level", ["O1", "O2"])
@pytest.mark.parametrize("lists", sorted(LISTS))
@pytest.mark.parametrize("op", OPS)
def test_routed_op_under_auto_cast_matches_jax(op, lists, level):
    """The op under ``auto_cast(level=..., custom_*_list=[op])`` on fp32
    inputs: the output dtype and values equal JAX's (white casts to bf16,
    black to fp32 and wins; O2 makes every op not black white)."""
    kw = {k: [op] for d in LISTS[lists] for k in d}
    arrs = _inputs(op)
    with paddle.amp.auto_cast(True, level=level, dtype="bfloat16", **kw):
        want = _jax_call(op, arrs)
    with amp.auto_cast(True, level=level, dtype="bfloat16", **kw):
        got = _port_call(op, arrs)
    want_dt = {jnp.float32: torch.float32,
               jnp.bfloat16: torch.bfloat16}[jnp.dtype(want._data.dtype).type]
    assert got.dtype == want_dt, (got.dtype, want._data.dtype)
    w = np.asarray(want._data.astype(jnp.float32))
    tol = dict(rtol=1e-5, atol=1e-5) if want_dt == torch.float32 else \
        dict(rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(got.detach().float().numpy(), w, **tol)


def test_hook_rule_matches_jax_lists():
    """`op_dtype` is JAX's ``_amp_cast`` rule over the same lists: every
    name of JAX's white and black lists, at both levels."""
    assert amp.amp_lists.WHITE_LIST == paddle.amp.amp_lists.WHITE_LIST
    assert amp.amp_lists.BLACK_LIST == paddle.amp.amp_lists.BLACK_LIST
    for level in ("O1", "O2"):
        with amp.auto_cast(level=level):
            for name in OPS:
                white = name in amp.amp_lists.WHITE_LIST or level == "O2"
                black = name in amp.amp_lists.BLACK_LIST
                want = torch.float32 if black else (
                    torch.bfloat16 if white else None)
                assert amp.op_dtype(name) == want, (level, name)


@pytest.mark.parametrize("kw,level", [
    (dict(custom_white_list=["matmul"]), "O1"),
    (dict(custom_white_list=["softmax"]), "O1"),
    (dict(custom_black_list=["matmul"]), "O1"),
    (dict(custom_white_list=["matmul"]), "O2"),
    (dict(custom_black_list=["exp", "linear"]), "O2"),
])
def test_unrouted_names_raise(kw, level):
    """A custom list entry naming an op the port has no entry for raises,
    naming the op and ROADMAP A9 (before, ``auto_cast(True, ["matmul"])``
    bound the list to ``level`` and cast nothing, silently)."""
    name = next(iter(kw.values()))[0]
    with pytest.raises(NotImplementedError, match=f"'{name}'.*A9"):
        with amp.auto_cast(True, level=level, **kw):
            pass


def test_o1_routed_op_follows_the_hook_alone():
    """Under O1 torch's own products run in bf16 (``torch.autocast``), but
    a routed op follows the hook alone: ``linear`` is on no list, so it
    stays fp32, as in JAX."""
    x, w = torch.randn(4, 8), torch.randn(8, 3)
    with amp.auto_cast(True):
        assert torch.matmul(x, w).dtype == torch.bfloat16
        assert F.linear(x, w).dtype == torch.float32
        assert amp.op_dtype("linear") is None


def test_auto_cast_state_nests_and_restores():
    """``enable=False`` keeps what an outer context set (as JAX's does);
    leaving a context restores the outer state; without amp an op entry
    is a plain call."""
    x, w = torch.randn(4, 8), torch.randn(8, 3)
    plain = F.linear(x, w)
    assert torch.equal(plain, torch.matmul(x, w))
    with amp.auto_cast(True, ["linear"], level="O1"):
        with amp.auto_cast(enable=False):
            assert F.linear(x, w).dtype == torch.bfloat16
        with amp.auto_cast(True, custom_black_list=["linear"], level="O2"):
            assert F.linear(x, w).dtype == torch.float32
        assert F.linear(x, w).dtype == torch.bfloat16
    assert torch.equal(F.linear(x, w), plain)


def test_amp_guard_support_queries_and_save_dtype():
    assert amp.amp_guard is amp.auto_cast
    assert amp.is_bfloat16_supported("cpu") is True
    assert amp.is_bfloat16_supported("cpu") == \
        paddle.amp.is_bfloat16_supported()
    # the JAX package answers for its platform: the CPU here
    assert amp.is_float16_supported("cpu") is False
    assert amp.is_float16_supported("cpu") == \
        paddle.amp.is_float16_supported()
    m = torch.nn.Linear(4, 4)
    opt = torch.optim.SGD(m.parameters(), lr=0.1)
    out = amp.decorate(m, opt, level="O2", dtype="bfloat16",
                       save_dtype="float32")
    assert out[0] is m and m.weight.dtype == torch.bfloat16


def test_global_norm_clip_keywords_match_jax():
    """``group_name`` and ``auto_skip_clip`` construct and are stored (they
    raised before); the clip gives JAX's gradients above and below the
    norm (the norm's sums in another order: 1e-6 relative)."""
    c = ClipGradByGlobalNorm(1.0, group_name="mp_group", auto_skip_clip=True)
    assert (c.clip_norm, c.group_name, c.auto_skip_clip) == \
        (1.0, "mp_group", True)
    assert ClipGradByGlobalNorm(2.0).group_name == "default_group"
    rng = np.random.default_rng(12)
    arrays = [rng.normal(size=s).astype(np.float32)
              for s in ((8, 4), (16,), (3, 5, 2))]
    for norm in (1.0, 100.0):
        jc = paddle.nn.ClipGradByGlobalNorm(norm, group_name="mp_group",
                                            auto_skip_clip=True)
        tc = ClipGradByGlobalNorm(norm, "mp_group", True)
        j_out = jc([(None, Tensor(jnp.asarray(a))) for a in arrays])
        t_out = tc([(None, torch.from_numpy(a)) for a in arrays])
        for (_, jg), (_, tg) in zip(j_out, t_out):
            np.testing.assert_allclose(tg.numpy(), np.asarray(jg._data),
                                       rtol=1e-6, atol=1e-7)
