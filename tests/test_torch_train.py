"""The port's training path against the JAX package's eager training loop:
the tiny Llama with the same weights, ``model(ids, labels=...)``,
``loss.backward()``, ``AdamW.step()`` with weight decay and global-norm
clipping, ``clear_grad()``; the optimizer's update against the JAX
package's jnp lane; resuming from a converted JAX optimizer state; and
``amp.decorate`` / ``GradScaler``."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_config as jax_llama_config
from paddle_tpu_torch import amp, convert
from paddle_tpu_torch.models import LlamaForCausalLM, llama_config
from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
from paddle_tpu_torch.optimizer import AdamW

SEQ = 128
LR = 1e-3
# Both sides run fp32 on the CPU; the sums of the forward and backward run
# in other orders (XLA against torch), so losses agree to ~1e-6 relative.
# Parameters: AdamW moves an element by ~lr whatever its gradient's size,
# so an element whose gradient sits near the fp32 noise floor can step a
# little differently on the two sides.  So: all but 1 in 10^4 elements of
# every tensor within 2e-5 absolute, and every element within 2e-5 + 1e-2
# relative.
LOSS_RTOL = 1e-5
PARAM_ATOL = 2e-5
PARAM_RTOL = 1e-2


def _np(t):
    return np.asarray(t._data_)


def _batch(seed=0, b=2):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 512, (b, SEQ)).astype(np.int32)
    labels = np.roll(ids, -1, axis=1).astype(np.int64)
    labels[:, -1] = -100                   # an ignored position
    return ids, labels


def _jax_pair(seed=5):
    paddle.seed(seed)
    jm = JaxLlama(jax_llama_config("tiny", max_seq_len=SEQ))
    jopt = paddle.optimizer.AdamW(
        learning_rate=LR, parameters=jm.parameters(), weight_decay=0.01,
        grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0))
    return jm, jopt


def _port_from(jm):
    tm = LlamaForCausalLM(llama_config("tiny", max_seq_len=SEQ),
                          device="cpu")
    convert.load_paddle_tpu_state(
        tm, {k: v.numpy() for k, v in jm.state_dict().items()})
    assert [n for n, _ in tm.named_parameters()] == \
        [n for n, _ in jm.named_parameters()]
    topt = AdamW(learning_rate=LR, parameters=tm.parameters(),
                 weight_decay=0.01, grad_clip=ClipGradByGlobalNorm(1.0))
    return tm, topt


def _jax_steps(jm, jopt, ids, labels, n):
    losses = []
    for _ in range(n):
        _, loss = jm(Tensor(ids), labels=Tensor(labels))
        loss.backward()
        jopt.step()
        jopt.clear_grad()
        losses.append(float(loss.numpy()))
    return losses


def _port_steps(tm, topt, ids, labels, n):
    losses = []
    for _ in range(n):
        _, loss = tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
        loss.backward()
        topt.step()
        topt.clear_grad()
        losses.append(float(loss.detach()))
    return losses


def _assert_params_close(tm, jm):
    jstate = {k: _np(v) for k, v in jm.state_dict().items()}
    for name, p in tm.state_dict().items():
        got, want = p.numpy(), jstate[name]
        off = np.abs(got - want) > PARAM_ATOL
        assert off.mean() <= 1e-4, (name, int(off.sum()))
        np.testing.assert_allclose(got, want, rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, err_msg=name)


def test_tiny_llama_trains_like_jax():
    """Three AdamW steps (weight decay 0.01, global-norm clip 1.0) from the
    same weights on the same batch: losses and every final parameter."""
    ids, labels = _batch()
    jm, jopt = _jax_pair()
    tm, topt = _port_from(jm)
    j_losses = _jax_steps(jm, jopt, ids, labels, 3)
    t_losses = _port_steps(tm, topt, ids, labels, 3)
    np.testing.assert_allclose(t_losses, j_losses, rtol=LOSS_RTOL)
    assert t_losses[-1] < t_losses[0]
    _assert_params_close(tm, jm)


def test_labels_return_logits_and_loss():
    jm, _ = _jax_pair(seed=6)
    tm, _ = _port_from(jm)
    ids, labels = _batch(seed=1, b=1)
    out = tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    assert isinstance(out, tuple) and len(out) == 2
    logits, loss = out
    assert logits.shape == (1, SEQ, 512) and loss.dim() == 0
    j_logits, j_loss = jm(Tensor(ids), labels=Tensor(labels))
    np.testing.assert_allclose(logits.detach().numpy(), _np(j_logits),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(loss.detach()), float(j_loss.numpy()),
                               rtol=LOSS_RTOL)
    # without labels: logits alone, as before
    assert torch.equal(tm(torch.from_numpy(ids)).detach(), logits.detach())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_jax_lane(dtype):
    """One update of one parameter against ``AdamW._fused_update`` (the
    jnp lane) on random arrays, with the moments and, for bf16, the fp32
    master weight: the same fp32 ops in the same order, so the results
    agree to an fp32 ulp or two (XLA may fuse a multiply-add)."""
    rng = np.random.default_rng(3)
    w = rng.normal(size=(64, 48)).astype(np.float32)
    g = rng.normal(size=(64, 48)).astype(np.float32) * 1e-2
    m1 = rng.normal(size=(64, 48)).astype(np.float32) * 1e-3
    m2 = np.abs(rng.normal(size=(64, 48))).astype(np.float32) * 1e-5
    step = 3.0
    jp = paddle.create_parameter([64, 48], dtype=dtype)
    jopt = paddle.optimizer.AdamW(learning_rate=3e-4, parameters=[jp],
                                  weight_decay=0.1)
    master = w if dtype == "bfloat16" else None
    p_in = jnp.asarray(w).astype(dtype)
    new_p, st = jopt._fused_update(
        jnp.float32(3e-4), jnp.float32(step), [p_in],
        [jnp.asarray(g).astype(dtype)],
        {"moment1": [jnp.asarray(m1)], "moment2": [jnp.asarray(m2)],
         "master": [None if master is None else jnp.asarray(master)]},
        (1.0,), (True,))

    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    tp = torch.nn.Parameter(torch.from_numpy(np.array(p_in.astype(
        jnp.float32))).to(tdt))
    topt = AdamW(learning_rate=3e-4, parameters=[tp], weight_decay=0.1)
    topt._ensure_state()
    state = {"moment1": torch.from_numpy(m1.copy()),
             "moment2": torch.from_numpy(m2.copy()),
             "master": None if master is None else
             torch.from_numpy(master.copy())}
    topt._step_tensor.fill_(step)
    scal = topt._scalars(torch.full((), 3e-4), topt._step_tensor, 1.0)
    with torch.no_grad():
        topt._update(tp, torch.from_numpy(g).to(tdt), state, scal, True)
    tol = dict(rtol=2e-7, atol=1e-9)
    np.testing.assert_allclose(state["moment1"].numpy(),
                               np.asarray(st["moment1"][0]), **tol)
    np.testing.assert_allclose(state["moment2"].numpy(),
                               np.asarray(st["moment2"][0]), **tol)
    np.testing.assert_allclose(tp.detach().float().numpy(),
                               np.asarray(new_p[0].astype(jnp.float32)),
                               rtol=1e-6, atol=1e-8)
    if master is not None:
        np.testing.assert_allclose(state["master"].numpy(),
                                   np.asarray(st["master"][0]),
                                   rtol=1e-6, atol=1e-8)


def test_resume_from_converted_jax_optimizer_state():
    """Two JAX steps, then the JAX weights and optimizer state converted
    into the port, then one more step on each side."""
    ids, labels = _batch(seed=2)
    jm, jopt = _jax_pair(seed=7)
    _jax_steps(jm, jopt, ids, labels, 2)
    tm, topt = _port_from(jm)
    np_state = {k: (v.numpy() if hasattr(v, "numpy") else v)
                for k, v in jopt.state_dict().items()}
    convert.load_paddle_tpu_optimizer_state(topt, np_state)
    assert topt._step_count == 2 and float(topt._step_tensor) == 2.0
    np.testing.assert_array_equal(topt.state_dict()["moment1.0"].numpy(),
                                  np_state["moment1.0"])
    j_loss = _jax_steps(jm, jopt, ids, labels, 1)
    t_loss = _port_steps(tm, topt, ids, labels, 1)
    np.testing.assert_allclose(t_loss, j_loss, rtol=LOSS_RTOL)
    _assert_params_close(tm, jm)
    with pytest.raises(KeyError, match="velocity.0"):
        convert.load_paddle_tpu_optimizer_state(
            topt, {"velocity.0": np.zeros(3, np.float32)})


def test_decorate_o2_keeps_fp32_masters():
    """O2: parameters become bf16, the optimizer's masters and moments are
    fp32, and the masters carry the update below bf16 resolution."""
    tm = LlamaForCausalLM(llama_config("tiny", max_seq_len=SEQ),
                          device="cpu")
    opt = AdamW(learning_rate=1e-3, parameters=tm.parameters(),
                weight_decay=0.0)
    tm, opt = amp.decorate(tm, opt, level="O2", dtype="bfloat16")
    assert all(p.dtype == torch.bfloat16 for p in tm.parameters())
    ids, labels = _batch(seed=4, b=1)
    losses = _port_steps(tm, opt, ids, labels, 3)
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    sd = opt.state_dict()
    n = len(list(tm.parameters()))
    for i in range(n):
        assert sd[f"master.{i}"].dtype == torch.float32
        assert sd[f"moment1.{i}"].dtype == torch.float32
    p0 = next(tm.parameters())
    torch.testing.assert_close(sd["master.0"].to(torch.bfloat16), p0.detach())


def test_grad_scaler():
    """bf16 at scale 1: a pass-through.  fp16-style dynamic scaling: a
    non-finite gradient skips the update and halves the scale."""
    p = torch.nn.Parameter(torch.ones(4))
    opt = AdamW(learning_rate=0.1, parameters=[p], weight_decay=0.0)
    s1 = amp.GradScaler(init_loss_scaling=1.0)
    loss = (p * 2).sum()
    assert s1.scale(loss) is loss
    s1.scale(loss).backward()
    s1.step(opt)
    assert float(p.detach()[0]) < 1.0
    opt.clear_grad()
    s2 = amp.GradScaler(init_loss_scaling=1024.0, incr_every_n_steps=1)
    before = p.detach().clone()
    s2.scale((p * float("inf")).sum()).backward()
    s2.step(opt)
    assert torch.equal(p.detach(), before) and s2.get_loss_scaling() == 512.0
    opt.clear_grad()
    s2.scale((p * 2).sum()).backward()
    s2.step(opt)
    assert not torch.equal(p.detach(), before)
    assert s2.get_loss_scaling() == 1024.0


def test_global_norm_clip_matches_jax():
    """The clipped gradients against paddle_tpu's ClipGradByGlobalNorm on
    the same arrays, above and below the clip norm (fp32 sums of squares
    in another order: 1e-6 relative)."""
    rng = np.random.default_rng(11)
    arrays = [rng.normal(size=s).astype(np.float32)
              for s in ((8, 4), (16,), (3, 5, 2))]
    for clip in (1.0, 100.0):
        j_out = paddle.nn.ClipGradByGlobalNorm(clip)(
            [(None, Tensor(a)) for a in arrays])
        t_out = ClipGradByGlobalNorm(clip)(
            [(None, torch.from_numpy(a)) for a in arrays])
        for (_, jg), (_, tg) in zip(j_out, t_out):
            np.testing.assert_allclose(tg.numpy(), _np(jg), rtol=1e-6,
                                       atol=1e-7)
    # below the norm the gradients pass unchanged
    assert all(torch.equal(tg, torch.from_numpy(a))
               for (_, tg), a in zip(t_out, arrays))


def test_auto_cast_levels():
    """O1 casts the matrix products to bf16 (torch.autocast); O2 leaves
    the types to the parameters, which `decorate` has cast."""
    x, w = torch.randn(4, 8), torch.randn(8, 3)
    with amp.auto_cast(level="O1", dtype="bfloat16"):
        assert torch.matmul(x, w).dtype == torch.bfloat16
    with amp.auto_cast(level="O2", dtype="bfloat16"):
        assert torch.matmul(x, w).dtype == torch.float32
    with amp.auto_cast(enable=False):
        assert torch.matmul(x, w).dtype == torch.float32
