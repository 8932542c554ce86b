"""The port's compiled train step (paddle_tpu_torch/framework/train_step.py)
against the JAX package's (paddle_tpu/framework/train_step.py) on the CPU,
where the port runs its graph's body with the kernels' plain versions.

- The tiny Llama and the tiny GPT (fp32, the same weights through
  ``convert``) trained by both ``CompiledTrainStep``s: with a global-norm
  clip and a StepDecay schedule, with two-batch accumulation, under a
  GradScaler with a batch whose loss overflows (skipped on both sides,
  the scale halved, ``sync_scaler`` equal), and resumed from the JAX
  step's optimizer, schedule and scaler state.  Tolerances are
  test_torch_train.py's: fp32 sums in other orders (XLA against torch),
  losses to 1e-5 relative; parameters all but 1 in 10^4 of the model's
  elements within 2e-5, and every element within 2e-5 + 1e-2 relative
  (Llama) or 2 lr a step (GPT, test_torch_gpt.py's bound).
- The port's two lanes against each other, bit for bit: the compiled
  body equals the eager step (attention and residual dropout included).
- The eligibility fallbacks (flag off, a layer hook, a gradient hook, a
  forward that reads ``.item()``): each warns once, latches
  ``fallback_reason`` and stays byte-identical to the eager loop.
- The GradScaler's surface and device update, and the new clips, against
  the JAX package's."""
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.amp import GradScaler as JaxScaler
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.framework.train_step import CompiledTrainStep as JaxStep
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_config as jax_llama_config
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.gpt import gpt_config as jax_gpt_config
from paddle_tpu.optimizer import lr as jax_lr
from paddle_tpu_torch import amp, convert
from paddle_tpu_torch.framework import CompiledTrainStep
from paddle_tpu_torch.models import (GPTForCausalLM, LlamaForCausalLM,
                                     gpt_config, llama_config)
from paddle_tpu_torch.nn import Linear
from paddle_tpu_torch.nn import clip as port_clip
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.optimizer import lr as port_lr
from paddle_tpu_torch.utils import flags as port_flags
from paddle_tpu_torch.utils import monitor

SEQ = 64
LR = 1e-3
LOSS_RTOL = 1e-5
PARAM_ATOL = 2e-5
PARAM_RTOL = 1e-2
GPT_TINY = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=4,
                max_seq_len=SEQ)


@pytest.fixture(autouse=True)
def _restore_flags():
    saved = port_flags.get_flags("FLAGS_compiled_train_step")
    jsaved = paddle.get_flags("FLAGS_compiled_train_step")
    yield
    port_flags.set_flags(saved)
    paddle.set_flags(jsaved)


def _batches(n, seed=0, b=2, marked=None):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        ids = rng.integers(0, 512, (b, SEQ)).astype(np.int32)
        labels = np.roll(ids, -1, axis=1).astype(np.int64)
        labels[:, -1] = -100
        if i == marked:
            labels[0, 0] = -100        # the forward multiplies the loss by 3e38
        out.append((ids, labels))
    return out


def _jax_model(kind, seed):
    paddle.seed(seed)
    if kind == "llama":
        return JaxLlama(jax_llama_config("tiny", max_seq_len=SEQ))
    return JaxGPT(jax_gpt_config("gpt2-124m", **GPT_TINY))


def _port_model(kind, jm):
    tm = LlamaForCausalLM(llama_config("tiny", max_seq_len=SEQ),
                          device="cpu") if kind == "llama" else \
        GPTForCausalLM(gpt_config("gpt2-124m", **GPT_TINY), device="cpu")
    convert.load_paddle_tpu_state(
        tm, {k: v.numpy() for k, v in jm.state_dict().items()})
    return tm


def _jax_forward(jm, marked):
    def fwd(x, y):
        loss = jm(x, labels=y)[1]
        if marked:
            loss = loss * ((y[0, 0] == -100).astype("float32") * 3e38 + 1.0)
        return loss
    return fwd


def _port_forward(tm, marked):
    def fwd(x, y):
        loss = tm(x, labels=y)[1]
        if marked:
            loss = loss * ((y[0, 0] == -100).float() * 3e38 + 1.0)
        return loss
    return fwd


def _assert_params_close(tm, jm, steps=None):
    """All but 1 in 10^4 of the model's elements within PARAM_ATOL; every
    element within PARAM_ATOL + PARAM_RTOL relative (test_torch_train.py's
    Llama bound) or, given ``steps``, within 2 lr a step
    (test_torch_gpt.py's GPT bound: AdamW moves an element whose gradient
    sits at the fp32 noise floor by ~lr either way)."""
    jstate = {k: np.asarray(v._data_) for k, v in jm.state_dict().items()}
    off = total = 0
    for name, p in tm.state_dict().items():
        got, want = p.numpy(), jstate[name]
        off += int((np.abs(got - want) > PARAM_ATOL).sum())
        total += got.size
        if steps is None:
            np.testing.assert_allclose(got, want, rtol=PARAM_RTOL,
                                       atol=PARAM_ATOL, err_msg=name)
        else:
            assert np.abs(got - want).max() <= 2 * LR * steps, name
    assert off <= 1e-4 * total, (off, total)


def _finite_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    fin = np.isfinite(want)
    assert (np.isfinite(got) == fin).all(), (got, want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=LOSS_RTOL)


CASES = {
    # kind, clip, schedule, accumulate, scaler, marked batch
    "llama-clip-schedule": ("llama", True, True, 1, False, None),
    "llama-accumulate": ("llama", True, False, 2, False, None),
    "gpt-scaler-overflow": ("gpt", False, False, 1, True, 3),
    "gpt-schedule-accumulate": ("gpt", True, True, 2, False, None),
}


def _lanes(case, steps=6, seed=5):
    """Both packages' compiled steps over the same batches → (JAX losses,
    port losses, JAX step, port step, JAX model, port model, JAX scaler,
    port scaler)."""
    kind, clip, sched, accum, scaler, marked = CASES[case]
    jm = _jax_model(kind, seed)
    tm = _port_model(kind, jm)
    js = jax_lr.StepDecay(LR, step_size=2, gamma=0.5) if sched else LR
    ts = port_lr.StepDecay(LR, step_size=2, gamma=0.5) if sched else LR
    jopt = paddle.optimizer.AdamW(
        learning_rate=js, parameters=jm.parameters(), weight_decay=0.01,
        grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0) if clip else None)
    topt = AdamW(learning_rate=ts, parameters=tm.parameters(),
                 weight_decay=0.01,
                 grad_clip=port_clip.ClipGradByGlobalNorm(1.0)
                 if clip else None)
    jsc = JaxScaler(init_loss_scaling=1024.0, incr_every_n_steps=2) \
        if scaler else None
    tsc = amp.GradScaler(init_loss_scaling=1024.0, incr_every_n_steps=2) \
        if scaler else None
    jcs = JaxStep(_jax_forward(jm, marked is not None), jopt, scaler=jsc,
                  accumulate_grad_batches=accum)
    tcs = CompiledTrainStep(_port_forward(tm, marked is not None), topt,
                            scaler=tsc, accumulate_grad_batches=accum)
    j_losses, t_losses = [], []
    for i, (ids, labels) in enumerate(_batches(steps, marked=marked)):
        j_losses.append(float(jcs(Tensor(ids), Tensor(labels)).numpy()))
        t_losses.append(float(tcs(torch.from_numpy(ids),
                                  torch.from_numpy(labels))))
        if sched and (i + 1) % accum == 0:
            js.step()
            ts.step()
    jcs.sync_scaler()
    tcs.sync_scaler()
    return j_losses, t_losses, jcs, tcs, jm, tm, jsc, tsc


@pytest.mark.parametrize("case", sorted(CASES))
def test_compiled_step_matches_jax(case):
    fallbacks = monitor.get_monitor_value("jit.compiled_step_fallback")
    j_losses, t_losses, jcs, tcs, jm, tm, jsc, tsc = _lanes(case)
    assert jcs.compiled and tcs.compiled, (jcs.fallback_reason,
                                           tcs.fallback_reason)
    assert monitor.get_monitor_value("jit.compiled_step_fallback") == fallbacks
    _finite_close(t_losses, j_losses)
    _assert_params_close(tm, jm, len(t_losses) if case[:3] == "gpt" else None)
    assert float(tcs._opt._step_tensor) == \
        float(np.asarray(jcs._opt._step_tensor._data_))
    if jsc is not None:
        # the overflowing batch was skipped on both sides
        assert not np.isfinite(t_losses[3])
        assert float(tcs._opt._step_tensor) == len(t_losses) - 1
        assert tsc.state_dict() == jsc.state_dict()
        # 2x after steps 1 and 5, 0.5x at the overflow (step 3)
        assert tsc.get_loss_scaling() == 2048.0


def test_compiled_step_resumes_from_jax_state():
    """Two JAX compiled steps under a schedule and a scaler, then the
    weights, the optimizer state (step tensor, moments, the schedule) and
    the scaler's state adopted by the port: two more steps on each side
    agree (JAX tests/test_train_step.py's resume, across packages)."""
    batches = _batches(4, seed=3)
    jm = _jax_model("llama", 7)
    js = jax_lr.ExponentialDecay(LR, gamma=0.8)
    jopt = paddle.optimizer.AdamW(
        learning_rate=js, parameters=jm.parameters(), weight_decay=0.01,
        grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0))
    jsc = JaxScaler(init_loss_scaling=512.0, incr_every_n_steps=1)
    jcs = JaxStep(_jax_forward(jm, False), jopt, scaler=jsc)
    for ids, labels in batches[:2]:
        jcs(Tensor(ids), Tensor(labels))
        js.step()
    jcs.sync_scaler()
    tm = _port_model("llama", jm)
    ts = port_lr.ExponentialDecay(LR, gamma=0.8)
    topt = AdamW(learning_rate=ts, parameters=tm.parameters(),
                 weight_decay=0.01,
                 grad_clip=port_clip.ClipGradByGlobalNorm(1.0))
    np_state = {k: (v.numpy() if hasattr(v, "numpy") else v)
                for k, v in jopt.state_dict().items()}
    convert.load_paddle_tpu_optimizer_state(topt, np_state)
    tsc = convert.load_paddle_tpu_scaler_state(
        amp.GradScaler(init_loss_scaling=1.0, incr_every_n_steps=1),
        jsc.state_dict())
    assert float(topt._step_tensor) == 2.0 and ts.last_epoch == 2
    assert tsc.state_dict() == jsc.state_dict()
    assert topt.get_lr() == jopt.get_lr()
    tcs = CompiledTrainStep(_port_forward(tm, False), topt, scaler=tsc)
    j_losses, t_losses = [], []
    for ids, labels in batches[2:]:
        j_losses.append(float(jcs(Tensor(ids), Tensor(labels)).numpy()))
        js.step()
        t_losses.append(float(tcs(torch.from_numpy(ids),
                                  torch.from_numpy(labels))))
        ts.step()
    jcs.sync_scaler()
    tcs.sync_scaler()
    np.testing.assert_allclose(t_losses, j_losses, rtol=LOSS_RTOL)
    _assert_params_close(tm, jm)
    assert tsc.state_dict() == jsc.state_dict()
    assert float(topt._step_tensor) == 4.0


# ------------------------------------------------ the port's two lanes


def _port_lane(compiled, kind, dropout, accum=1, scaler=False, steps=5):
    if kind == "gpt":
        tm = GPTForCausalLM(gpt_config("gpt2-124m", **GPT_TINY,
                                       attn_dropout=dropout,
                                       dropout=dropout), device="cpu",
                            seed=2)
    else:
        tm = LlamaForCausalLM(llama_config("tiny", max_seq_len=SEQ),
                              device="cpu", seed=2)
    opt = AdamW(learning_rate=port_lr.CosineAnnealingDecay(LR, 8),
                parameters=tm.parameters(),
                grad_clip=port_clip.ClipGradByGlobalNorm(1.0))
    sc = amp.GradScaler(init_loss_scaling=2.0 ** 10,
                        incr_every_n_steps=2) if scaler else None
    opt._ensure_state()
    cs = CompiledTrainStep(_port_forward(tm, scaler), opt, scaler=sc,
                           network=tm, accumulate_grad_batches=accum)
    losses, counters = [], []
    for i, (ids, labels) in enumerate(_batches(
            steps, seed=4, marked=2 if scaler else None)):
        x, y = torch.from_numpy(ids), torch.from_numpy(labels)
        update = (i + 1) % accum == 0
        loss = cs(x, y, update) if compiled else \
            cs._default_eager_step(x, y, update)
        losses.append(float(loss))
        if update:
            opt._learning_rate.step()
        counters.append(float(opt._step_tensor))
    cs.sync_scaler()
    return (losses, counters, [p.detach().clone() for p in tm.parameters()],
            {k: [None if v is None else v.clone() for v in vals]
             for k, vals in opt._state.items()},
            sc.state_dict() if sc else None, cs)


@pytest.mark.parametrize("kind,dropout,accum,scaler", [
    ("gpt", 0.1, 1, False), ("gpt", 0.1, 2, True), ("llama", 0.0, 2, True)])
def test_compiled_body_equals_eager_step_bitwise(kind, dropout, accum,
                                                 scaler):
    """On the CPU the compiled lane runs the graph's body: its losses,
    step counters, parameters, moments and scaler state equal the eager
    step's bit for bit, dropout draws and a skipped step included."""
    eager = _port_lane(False, kind, dropout, accum, scaler)
    fallbacks = monitor.get_monitor_value("jit.compiled_step_fallback")
    comp = _port_lane(True, kind, dropout, accum, scaler)
    assert comp[5].compiled and monitor.get_monitor_value("jit.compiled_step_fallback") == fallbacks
    assert comp[0] == eager[0] and comp[1] == eager[1]
    for a, b in zip(comp[2], eager[2]):
        assert torch.equal(a, b)
    for name in eager[3]:
        for a, b in zip(comp[3][name], eager[3][name]):
            assert (a is None and b is None) or torch.equal(a, b)
    assert comp[4] == eager[4]


# ------------------------------------------------------------ fallbacks


def _mlp():
    torch.manual_seed(0)
    net = torch.nn.Sequential(Linear(8, 16, device="cpu"),
                              torch.nn.ReLU(), Linear(16, 4, device="cpu"))
    with torch.no_grad():
        for m in net:
            if isinstance(m, Linear):
                m.reset_parameters(torch.Generator().manual_seed(1))
    opt = AdamW(learning_rate=0.01, parameters=net.parameters())
    return net, opt


def _mlp_batches(n=5):
    rng = np.random.default_rng(0)
    return [(torch.from_numpy(rng.standard_normal((4, 8)).astype("float32")),
             torch.from_numpy(rng.standard_normal((4, 4)).astype("float32")))
            for _ in range(n)]


def _eager_mlp(install=None, host_read=False):
    net, opt = _mlp()
    if install:
        install(net)
    losses = []
    for x, y in _mlp_batches():
        out = net(x)
        if host_read:
            assert float(out.sum()) < 1e9
        loss = ((out - y) ** 2).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    return losses, [p.detach().clone() for p in net.parameters()]


@pytest.mark.parametrize("why", ["flag", "layer hook", "gradient hook",
                                 "host read"])
def test_ineligible_step_warns_once_and_stays_eager(why):
    """Each fallback warns once, latches ``fallback_reason``, counts its
    eager steps and leaves losses and weights byte-identical to the
    eager loop (JAX tests/test_train_step.py's fallback tests)."""
    seen = []
    install = None
    if why == "layer hook":
        def install(net):
            net[0].register_forward_hook(lambda m, i, o: seen.append(1))
    elif why == "gradient hook":
        def install(net):
            net[2].weight.register_hook(lambda g: g)
    want_losses, want_params = _eager_mlp(install, why == "host read")
    if why == "flag":
        port_flags.set_flags({"FLAGS_compiled_train_step": False})
    net, opt = _mlp()
    if install:
        install(net)

    def forward(x, y):
        out = net(x)
        if why == "host read":
            assert float(out.sum()) < 1e9      # a host read of a live value
        return ((out - y) ** 2).mean()
    cs = CompiledTrainStep(forward, opt, network=net)
    fallbacks = monitor.get_monitor_value("jit.compiled_step_fallback")
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        losses = [float(cs(x, y)) for x, y in _mlp_batches()]
    disabled = [r for r in rec
                if "compiled train step disabled" in str(r.message)]
    assert len(disabled) == 1
    key = {"flag": "FLAGS_compiled_train_step", "layer hook": "hook",
           "gradient hook": "hook", "host read": "host read"}[why]
    assert key in (cs.fallback_reason or "")
    assert not cs.compiled
    assert monitor.get_monitor_value("jit.compiled_step_fallback") - fallbacks == (4 if why == "host read" else 5)
    assert losses == want_losses
    for a, b in zip(net.parameters(), want_params):
        assert torch.equal(a.detach(), b)
    if why == "layer hook":
        assert seen


def test_unported_options_raise():
    """The mesh lanes run dp and mp (tests/test_torch_hybrid.py): a pp
    or sep axis above 1 still raises (JAX's wording); a sharding axis
    takes JAX's eager lane with a `MeshFallbackWarning` naming it
    (tests/test_torch_zero.py).  The sentinel with a mesh is ported
    (tests/test_torch_sentinel_ranks.py): in a world of one it resolves
    the mesh as the step without it does, up to the dp group this world
    cannot hold."""
    from paddle_tpu_torch.distributed import ProcessMesh
    from paddle_tpu_torch.framework.train_step import MeshFallbackWarning
    net, opt = _mlp()
    for axis in ("pp", "sharding", "sep"):
        mesh = ProcessMesh(np.arange(2).reshape(1, 2), ["dp", axis])
        if axis == "sharding":
            with pytest.warns(MeshFallbackWarning,
                              match=f"mesh axis '{axis}'"):
                CompiledTrainStep(lambda x, y: x, opt, mesh=mesh)
            continue
        with pytest.raises(NotImplementedError, match=f"mesh axis '{axis}'"):
            CompiledTrainStep(lambda x, y: x, opt, mesh=mesh)
    mesh = ProcessMesh(np.arange(2).reshape(2, 1), ["dp", "mp"])
    for sentinel in (False, True):
        with pytest.raises(ValueError, match="outside the world of 1"):
            CompiledTrainStep(lambda x, y: x, opt, mesh=mesh,
                              sentinel=sentinel)
    # sentinel=True is ported: each full call leaves its own health vector
    cs = CompiledTrainStep(lambda x, y: ((net(x) - y) ** 2).mean(), opt,
                           sentinel=True)
    rng = np.random.default_rng(0)
    healths = []
    for _ in range(3):
        x = torch.from_numpy(rng.standard_normal((4, 8)).astype(np.float32))
        y = torch.from_numpy(rng.standard_normal((4, 4)).astype(np.float32))
        cs(x, y)
        healths.append(cs.last_health)
    assert healths[0] is None            # call 1 is the eager step
    assert [h.shape for h in healths[1:]] == [(2,), (2,)]
    assert healths[1][1] == 0.0 and healths[1][0] == -1.0


# ------------------------------------------------- GradScaler and clips


def test_grad_scaler_surface_matches_jax():
    """``always_check_found_inf``, ``found_inf_streak``, the deferred
    found-inf flag, ``state_dict`` / ``load_state_dict``, ``is_enable``,
    ``is_use_dynamic_loss_scaling``: the JAX package's behaviour."""
    results = {}
    for pkg in ("jax", "port"):
        if pkg == "jax":
            w = paddle.Parameter(np.ones((4,), np.float32))
            opt = paddle.optimizer.AdamW(0.05, parameters=[w])
            mk = JaxScaler

            def back(sc, scale_inf):
                loss = sc.scale((w * w).sum())
                loss.backward()
                if scale_inf:
                    w.grad._data = w.grad._data * np.float32("inf")

            def flag(sc):
                return float(np.asarray(sc._found_inf_tensor()._data_)[0])
        else:
            w = torch.nn.Parameter(torch.ones(4))
            opt = AdamW(0.05, parameters=[w])
            mk = amp.GradScaler

            def back(sc, scale_inf):
                loss = sc.scale((w * w).sum())
                loss.backward()
                if scale_inf:
                    w.grad.mul_(float("inf"))

            def flag(sc):
                return float(sc._found_inf_tensor()[0])
        out = []
        sc = mk(init_loss_scaling=8.0)
        back(sc, True)
        sc.unscale_(opt, defer_found_inf=True)
        out += [sc._found_inf, flag(sc)]
        opt.clear_grad()
        sc = mk(init_loss_scaling=1.0, always_check_found_inf=True)
        for bad in (True, True, False):
            back(sc, bad)
            sc.step(opt)
            opt.clear_grad()
            out.append(sc.found_inf_streak)
        sc2 = mk(init_loss_scaling=4.0, use_dynamic_loss_scaling=False)
        sc2.load_state_dict({"scale": 64.0, "good_steps": 3,
                             "bad_steps": 1})
        out += [sc2.state_dict(), sc2.is_enable(),
                sc2.is_use_dynamic_loss_scaling(),
                mk(enable=False).is_enable()]
        results[pkg] = out
    assert results["port"] == results["jax"]


@pytest.mark.parametrize("state,found", [
    ((1024.0, 0.0, 0.0), False), ((1024.0, 1.0, 0.0), False),
    ((1024.0, 0.0, 0.0), True), ((1024.0, 1.0, 2.0), True),
    ((1.0, 3.0, 0.0), True), ((2.0, 0.0, 1.0), True)])
def test_scaler_update_matches_jax(state, found):
    """`amp.scaler_update` against the JAX step's ``_scaler_update`` on a
    scaler that grows every 2 good steps and shrinks after 2 bad ones
    (floor 2.0)."""
    import jax.numpy as jnp
    kw = dict(init_loss_scaling=state[0], incr_every_n_steps=2,
              decr_every_n_nan_or_inf=2, min_loss_scale=2.0)
    w = paddle.Parameter(np.ones((4,), np.float32))
    jcs = JaxStep(lambda x, y: x, paddle.optimizer.AdamW(
        0.05, parameters=[w]), scaler=JaxScaler(**kw))
    want = np.asarray(jcs._scaler_update(jnp.asarray(state, jnp.float32),
                                         jnp.asarray(found)))
    got = amp.scaler_update(amp.GradScaler(**kw),
                            torch.tensor(state, dtype=torch.float32),
                            torch.tensor(found))
    np.testing.assert_array_equal(got.numpy(), want)


def test_new_clips_match_jax():
    """ClipGradByValue, ClipGradByNorm (above and below the norm) and
    clip_grad_norm_ (2-norm and inf-norm) against the JAX package's on the
    same arrays (fp32 sums in another order: 1e-6 relative)."""
    from paddle_tpu.nn import clip as jclip
    rng = np.random.default_rng(8)
    arrays = [rng.normal(size=s).astype(np.float32) * 3
              for s in ((8, 4), (16,), (3, 5, 2))]
    for j_c, t_c in ((jclip.ClipGradByValue(1.5),
                      port_clip.ClipGradByValue(1.5)),
                     (jclip.ClipGradByValue(1.0, min=-0.5),
                      port_clip.ClipGradByValue(1.0, min=-0.5)),
                     (jclip.ClipGradByNorm(2.0),
                      port_clip.ClipGradByNorm(2.0)),
                     (jclip.ClipGradByNorm(100.0),
                      port_clip.ClipGradByNorm(100.0))):
        j_out = j_c([(None, Tensor(a)) for a in arrays])
        t_out = t_c([(None, torch.from_numpy(a)) for a in arrays])
        for (_, jg), (_, tg) in zip(j_out, t_out):
            np.testing.assert_allclose(tg.numpy(), np.asarray(jg._data_),
                                       rtol=1e-6, atol=1e-7)
    for norm_type in (2.0, float("inf")):
        jps = [paddle.Parameter(np.zeros_like(a)) for a in arrays]
        tps = [torch.nn.Parameter(torch.zeros(a.shape)) for a in arrays]
        for jp, tp, a in zip(jps, tps, arrays):
            jp.grad = Tensor(a.copy())
            tp.grad = torch.from_numpy(a.copy())
        jn = jclip.clip_grad_norm_(jps, 1.0, norm_type=norm_type)
        tn = port_clip.clip_grad_norm_(tps, 1.0, norm_type=norm_type)
        np.testing.assert_allclose(float(tn), float(jn.numpy()), rtol=1e-6)
        for jp, tp in zip(jps, tps):
            np.testing.assert_allclose(tp.grad.numpy(),
                                       np.asarray(jp.grad._data_),
                                       rtol=1e-6, atol=1e-7)
