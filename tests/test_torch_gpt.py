"""The port's GPT against the JAX package's: a tiny GPT (vocab 512, hidden
128, 2 layers, 4 heads, S 128) with the same weights, logits and loss,
then three AdamW steps of ``model(ids, labels=...)`` on both sides, with
the dropouts off and with attention dropout 0.1 inside the flash kernels
(the JAX side's Pallas kernels in interpret mode, both sides on one
seed); and its layers (``layer_norm``, ``gelu``, ``Dropout``) against the
JAX package's ops."""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.gpt import gpt_config as jax_gpt_config
from paddle_tpu.nn import functional as JF
from paddle_tpu.pallas import flash_attention as jfa
from paddle_tpu_torch import amp, convert
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.models import GPTForCausalLM, gpt_config
from paddle_tpu_torch.nn import Dropout, LayerNorm
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.serving import Engine, ServingConfig

SEQ = 128
LR = 1e-3
TINY = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=4,
            max_seq_len=SEQ)
# fp32 on the CPU on both sides, sums in other orders: losses to 1e-5
# relative.  Parameters: AdamW moves an element by ~lr whatever its
# gradient's size, so an element whose gradient sits at the fp32 noise
# floor may step differently on the two sides: all but 1 in 10^4
# elements of every tensor within 2e-5, and every element within 2 lr a
# step (the bound chip_smoke.py's train-parity holds the card to)
LOSS_RTOL = 1e-5
PARAM_ATOL = 2e-5


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")


def _np(t):
    return np.asarray(t._data_)


def _batch(seed=0, b=2):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 512, (b, SEQ)).astype(np.int32)
    labels = np.roll(ids, -1, axis=1).astype(np.int64)
    labels[:, -1] = -100
    return ids, labels


def _pair(seed, **overrides):
    paddle.seed(seed)
    jm = JaxGPT(jax_gpt_config("gpt2-124m", **TINY, **overrides))
    jopt = paddle.optimizer.AdamW(
        learning_rate=LR, parameters=jm.parameters(), weight_decay=0.01,
        grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0))
    tm = GPTForCausalLM(gpt_config("gpt2-124m", **TINY, **overrides),
                        device="cpu")
    convert.load_paddle_tpu_state(
        tm, {k: v.numpy() for k, v in jm.state_dict().items()})
    assert [n for n, _ in tm.named_parameters()] == \
        [n for n, _ in jm.named_parameters()]
    topt = AdamW(learning_rate=LR, parameters=tm.parameters(),
                 weight_decay=0.01, grad_clip=ClipGradByGlobalNorm(1.0))
    return jm, jopt, tm, topt


def _steps(jm, jopt, tm, topt, ids, labels, n):
    j_losses, t_losses = [], []
    for _ in range(n):
        _, loss = jm(Tensor(ids), labels=Tensor(labels))
        loss.backward()
        jopt.step()
        jopt.clear_grad()
        j_losses.append(float(loss.numpy()))
        _, loss = tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
        loss.backward()
        topt.step()
        topt.clear_grad()
        t_losses.append(float(loss.detach()))
    return j_losses, t_losses


def _assert_params_close(tm, jm, steps=3):
    jstate = {k: _np(v) for k, v in jm.state_dict().items()}
    assert set(jstate) == set(tm.state_dict())
    for name, p in tm.state_dict().items():
        diff = np.abs(p.numpy() - jstate[name])
        off = diff > PARAM_ATOL
        assert off.mean() <= 1e-4, (name, int(off.sum()))
        assert diff.max() <= 2 * LR * steps, (name, float(diff.max()))


def test_tiny_gpt_logits_and_loss_match_jax():
    """The same weights (the JAX state dict loaded by name, the head tied
    to ``wte``): logits to 1e-4, the loss to 1e-5 relative; the parameter
    counts and FLOPs a token as the JAX model counts them."""
    jm, _, tm, _ = _pair(seed=3)
    ids, labels = _batch(seed=1)
    j_logits, j_loss = jm(Tensor(ids), labels=Tensor(labels))
    logits, loss = tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    assert logits.shape == (2, SEQ, 512) and tm.lm_head is None
    np.testing.assert_allclose(logits.detach().numpy(), _np(j_logits),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(loss.detach()), float(j_loss.numpy()),
                               rtol=LOSS_RTOL)
    assert tm.num_params() == jm.num_params()
    assert tm.num_params(non_embedding=False) == \
        jm.num_params(non_embedding=False)
    assert tm.flops_per_token() == jm.flops_per_token()
    assert len(list(tm.parameters())) == 2 + 12 * 2 + 2


def test_tiny_gpt_trains_like_jax():
    """Three AdamW steps (weight decay 0.01, global-norm clip 1.0), the
    dropouts off: losses and every final parameter."""
    jm, jopt, tm, topt = _pair(seed=4)
    ids, labels = _batch(seed=2)
    j_losses, t_losses = _steps(jm, jopt, tm, topt, ids, labels, 3)
    np.testing.assert_allclose(t_losses, j_losses, rtol=LOSS_RTOL)
    assert t_losses[-1] < t_losses[0]
    _assert_params_close(tm, jm)


def test_tiny_gpt_attention_dropout_trains_like_jax(interpret, monkeypatch):
    """``attn_dropout`` 0.1 through the flash kernels on both sides (the
    JAX model's Pallas kernels in interpret mode): the JAX op's key fixed,
    the port given that key's ``jax.random.bits`` as its seed; three AdamW
    steps agree as without dropout, and differ from the run without it."""
    key = jax.random.PRNGKey(17)
    seed = int(np.asarray(jax.random.bits(key, (1, 1), jnp.uint32))[0, 0])
    monkeypatch.setattr(jfa._state, "next_rng_key", lambda: key)
    monkeypatch.setattr(fa, "draw_seed", lambda generator=None: seed)
    jm, jopt, tm, topt = _pair(seed=5, attn_dropout=0.1)
    ids, labels = _batch(seed=3)
    j_losses, t_losses = _steps(jm, jopt, tm, topt, ids, labels, 3)
    np.testing.assert_allclose(t_losses, j_losses, rtol=LOSS_RTOL)
    _assert_params_close(tm, jm)
    tm.eval()
    _, no_drop = tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    tm.train()
    _, drop = tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    assert float(no_drop) != float(drop)


def test_gpt_draws_its_own_seeds():
    """The model's flash seeds come from its CPU generator (seeded by the
    constructor): two models with one seed give equal dropout losses,
    whatever torch's global RNG does; another seed gives another loss."""
    cfg = gpt_config("gpt2-124m", **TINY, attn_dropout=0.1, dropout=0.1)
    ids, labels = (torch.from_numpy(a) for a in _batch(seed=4, b=1))
    losses = []
    for seed in (1, 1, 2):
        m = GPTForCausalLM(cfg, device="cpu", seed=seed)
        torch.manual_seed(len(losses))
        losses.append(float(m(ids, labels=labels)[1]))
    assert losses[0] == losses[1] != losses[2]
    assert m.flash_generator.device.type == "cpu"


def test_gpt_refuses_what_is_not_ported():
    """GPT serves with speculation and with the dense slot layout (ROADMAP
    A4, A6): greedy tokens equal `generate`'s in both.  What the engine
    still refuses is a KV capacity past GPT's learned positions: with
    speculation it is max_seq_len + speculation_k in whole pages, held
    against the target's table and the draft's
    (tests/test_torch_spec_serving.py holds both against the JAX engine)."""
    m = GPTForCausalLM(gpt_config("gpt2-124m", **TINY), device="cpu").eval()
    d = GPTForCausalLM(gpt_config("gpt2-124m", **dict(TINY, num_layers=1)),
                       device="cpu", seed=1).eval()
    prompt = np.arange(3, 12, dtype=np.int32)
    want = m.generate(torch.from_numpy(prompt[None].astype(np.int64)),
                      6)[0, prompt.size:].numpy()
    for kw in (dict(speculation_k=2, draft_model=d, max_seq_len=48),
               dict(kv_layout="slots")):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")   # the tick's static fallback
            with Engine(m, ServingConfig(num_slots=2, **kw)) as eng:
                out = eng.generate(prompt, max_new_tokens=6)
                st = eng.stats()
        np.testing.assert_array_equal(out.output_ids, want)
        assert (st["spec_windows"] > 0) == ("speculation_k" in kw)
    with pytest.raises(ValueError, match="learned positions"):
        Engine(m, ServingConfig(speculation_k=2, draft_model=d))


def test_gpt_o2_bf16_trains_on_cpu():
    """bf16 O2 through ``amp.decorate`` with dropout 0.1 everywhere: every
    parameter (biases, layer norms, the tied embedding) becomes bf16 with
    an fp32 master, and the loss falls."""
    m = GPTForCausalLM(gpt_config("gpt2-124m", **TINY, dropout=0.1,
                                  attn_dropout=0.1), device="cpu")
    opt = AdamW(learning_rate=1e-3, parameters=m.parameters(),
                weight_decay=0.01)
    m, opt = amp.decorate(m, opt, level="O2", dtype="bfloat16")
    assert all(p.dtype == torch.bfloat16 for p in m.parameters())
    ids, labels = (torch.from_numpy(a) for a in _batch(seed=5))
    losses = []
    for _ in range(4):
        _, loss = m(ids, labels=labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.detach()))
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    sd = opt.state_dict()
    assert all(sd[f"master.{i}"].dtype == torch.float32
               for i in range(len(list(m.parameters()))))


# ------------------------------------------------------------- layers
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_jax(dtype):
    """fp32: 1e-6.  bf16: the JAX rounding order (fp32 statistics, one
    rounding, then ``* w + b`` in bf16), to one bf16 ulp (2^-8 relative)
    of the JAX op; ``F.layer_norm``'s fp32 affine is further off."""
    rng = np.random.default_rng(7)
    x = (3 * rng.normal(size=(4, 9, 64)) + 1).astype(np.float32)
    w = (1 + 0.3 * rng.normal(size=64)).astype(np.float32)
    b = (0.5 * rng.normal(size=64)).astype(np.float32)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    want = np.asarray(JF.layer_norm(
        Tensor(jnp.asarray(x).astype(jd)), 64, Tensor(jnp.asarray(w)
                                                      .astype(jd)),
        Tensor(jnp.asarray(b).astype(jd)), 1e-5)._data_.astype(jnp.float32))
    tx, tw, tb = (torch.from_numpy(a).to(td) for a in (x, w, b))
    got = F.layer_norm(tx, 64, tw, tb, 1e-5)
    assert got.dtype == td
    tol = 1e-6 if dtype == "float32" else 2 ** -8
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                               atol=tol * 4)
    layer = LayerNorm(64, device="cpu", dtype=td)
    with torch.no_grad():
        layer.reset_parameters()
    assert torch.equal(layer.weight, torch.ones(64, dtype=td))
    assert torch.equal(layer.bias, torch.zeros(64, dtype=td))
    assert [n for n, _ in layer.named_parameters()] == ["weight", "bias"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("approximate", [True, False])
def test_gelu_matches_jax(dtype, approximate):
    """fp32 to 1e-6; bf16 to two bf16 ulps (JAX's bf16 arithmetic against
    torch's fp32 internals with one rounding)."""
    x = np.linspace(-6, 6, 4001).astype(np.float32)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    want = np.asarray(JF.gelu(Tensor(jnp.asarray(x).astype(jd)),
                              approximate=approximate)._data_
                      .astype(jnp.float32))
    got = F.gelu(torch.from_numpy(x).to(td), approximate=approximate)
    tol = 1e-6 if dtype == "float32" else 2 ** -7
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                               atol=tol)


def test_dropout_layer_keep_share_and_eval_identity():
    """Dropout(0.1): ~90% kept, the survivors scaled by 1 / 0.9, the same
    mask from equal generators; ``eval()`` is the identity; the JAX layer
    keeps the same share."""
    x = torch.ones(200, 500)
    d = Dropout(0.1, generator=torch.Generator().manual_seed(3))
    y = d(x)
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.9) < 0.005
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.9))
    d2 = Dropout(0.1, generator=torch.Generator().manual_seed(3))
    assert torch.equal(d2(x), y)
    d.eval()
    assert d(x) is x
    j = np.asarray(JF.dropout(Tensor(np.ones((200, 500), np.float32)), 0.1)
                   ._data_)
    assert abs(float((j != 0).mean()) - 0.9) < 0.005
    with pytest.raises(NotImplementedError, match="upscale_in_train"):
        F.dropout(x, 0.1, mode="downscale_in_infer")


def _init_stats_match(jax_model, port_model):
    """Each parameter's mean and standard deviation in the port's bare
    model against JAX's bare model.  Tolerance: the sampling error of the
    statistic, 6 sigma (std: sigma / sqrt(2 n); mean: sigma / sqrt(n));
    constant parameters (biases, norm weights) are equal exactly."""
    js = {k: np.asarray(v.numpy(), np.float64)
          for k, v in jax_model.state_dict().items()}
    ts = {k: v.detach().double().numpy()
          for k, v in port_model.state_dict().items()}
    assert set(js) == set(ts)
    for k, j in js.items():
        t = ts[k]
        assert j.shape == t.shape, k
        sigma, n = j.std(), j.size
        if sigma == 0:
            np.testing.assert_array_equal(t, j, err_msg=k)
            continue
        assert abs(t.std() - sigma) < 6 * sigma / np.sqrt(2 * n), k
        assert abs(t.mean() - j.mean()) < 6 * sigma / np.sqrt(n), k


def test_bare_gpt_model_draws_the_model_init():
    """A bare ``GPTModel(cfg)`` (hidden 256, 2 layers) draws JAX's model
    init: embeddings and projections N(0, 0.02), the output projections
    N(0, 0.02 / sqrt(2 L)), zero biases, layer norms at 1 and 0."""
    from paddle_tpu.models.gpt import GPTModel as JaxGPTModel
    from paddle_tpu_torch.models import GPTModel
    kw = dict(num_layers=2, hidden_size=256, num_heads=4, vocab_size=1024,
              max_seq_len=128)
    paddle.seed(0)
    _init_stats_match(JaxGPTModel(jax_gpt_config("gpt2-124m", **kw)),
                      GPTModel(gpt_config("gpt2-124m", **kw), device="cpu"))
