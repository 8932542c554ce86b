"""The port's expert-parallel MoE layer (`incubate/distributed/models/
moe/`) against the JAX package.

The inputs are drawn from numpy seeds; the random routing's uniforms come
from the same key on both sides (`framework.prng` is JAX's threefry bit
for bit, its stream put at JAX's seed and counter).  fp32 throughout: in
bf16 near ties route differently.

- The gates' dense ``(combine, dispatch, aux)`` against JAX's functions
  on the same logits and key, random routing and capacity drops
  included; the gate modules on JAX's weights (the Switch gate's jitter
  from the key stream); ``dispatch`` exactly, ``combine`` and ``aux``
  within rtol 1e-6 (softmax and sums in other orders).
- `MoELayer` with stacked and with list experts against JAX's layer: the
  output and the gradients within rtol 1e-5, atol 1e-6.
- The tiny MoE GPT with ``use_recompute`` in one process: the recomputed
  block takes its first run's routing key, so the loss (rtol 1e-5), the
  gradients (rtol 1e-5, atol 1e-6) and the key stream equal JAX's.
- dp 2 × mp 2 on 4 gloo ranks (`_torch_dist_worker.case_moe`): a rank's
  rows of the routing against JAX's routing over the global batch (the
  capacity places count the lower dp rank's tokens first), the layer's
  output and gradients, the tiny ``ParallelGPTForCausalLM(moe_every=2,
  num_experts=4)`` with a capacity that drops tokens through 3 AdamW
  steps + clip against JAX's at dp 2 × mp 2 (losses within 1e-5
  relative, parameters by tests/test_torch_hybrid.py's rule), the
  clip's global norm (each expert once) and the expert stacks' convert
  round trip.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.core import state as jstate
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.incubate.distributed.models.moe import MoELayer as JaxMoE
from paddle_tpu.incubate.distributed.models.moe import (
    GShardGate as JaxGShard, NaiveGate as JaxNaive,
    SwitchGate as JaxSwitch)
from paddle_tpu.incubate.distributed.models.moe.gate.gshard_gate import \
    _gshard_dispatch as jax_gshard
from paddle_tpu.incubate.distributed.models.moe.gate.switch_gate import \
    _switch_dispatch as jax_switch
from paddle_tpu.models import ParallelGPTForCausalLM as JaxPGPT
from paddle_tpu.models.gpt import gpt_config as jax_gpt_config

from paddle_tpu_torch import convert
from paddle_tpu_torch.framework import prng
from paddle_tpu_torch.incubate.distributed.models.moe import (
    ClipGradForMOEByGlobalNorm, ExpertFFN, GShardGate, MoELayer, NaiveGate,
    SwitchGate)
from paddle_tpu_torch.incubate.distributed.models.moe.gate.gshard_gate \
    import _gshard_dispatch
from paddle_tpu_torch.incubate.distributed.models.moe.gate.switch_gate \
    import _switch_dispatch
from paddle_tpu_torch.models import ParallelGPTForCausalLM, gpt_config
from paddle_tpu_torch.nn.layers import Linear

from _torch_dist_worker import run_ranks
from test_torch_context_parallel import _close, _jax_train, jax_axes

RTOL, ATOL = 1e-5, 1e-6
GATE_RTOL = 1e-6
LOSS_RTOL = 1e-5
SEQ = 32
GPT_CFG = dict(num_layers=2, hidden_size=64, num_heads=4, vocab_size=256,
               max_seq_len=SEQ)


def _rng_state():
    """JAX's key stream as the port's state: its seed (``PRNGKey(s)`` is
    ``[0, s]``) and counter."""
    return int(np.asarray(jstate.STATE.rng_key)[1]), \
        jstate.STATE.rng_counter


def _np(t):
    return np.asarray(t._data_) if isinstance(t, Tensor) else \
        t.detach().numpy()


def _state(layer):
    return {k: np.asarray(v._data_).copy()
            for k, v in layer.state_dict().items()}


# ---------------------------------------------------------------------------
# the gates' functions on the same logits and key
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rr", [True, False])
@pytest.mark.parametrize("capacity", [4, 16, 64])
def test_gshard_dispatch_matches_jax(rr, capacity):
    """Top-2 with random routing (the same key's uniforms) and capacity
    drops (4, 16 places of 64 tokens over 4 experts) against JAX's."""
    logits = np.random.default_rng(capacity).standard_normal(
        (64, 4)).astype(np.float32)
    jkey = jax.random.fold_in(jax.random.PRNGKey(3), capacity)
    want = jax_gshard(jnp.asarray(logits), capacity, key=jkey,
                      random_routing=rr)
    key = prng.fold_in(prng.PRNGKey(3), capacity)
    got = _gshard_dispatch(torch.tensor(logits), capacity, key=key,
                           random_routing=rr)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=GATE_RTOL, atol=1e-7)
    np.testing.assert_allclose(float(got[2]), float(want[2]),
                               rtol=GATE_RTOL)
    if capacity == 4:
        assert got[1].numpy().sum() < 2 * 64     # tokens were dropped


@pytest.mark.parametrize("capacity", [3, 40])
def test_switch_dispatch_matches_jax(capacity):
    logits = np.random.default_rng(capacity).standard_normal(
        (48, 4)).astype(np.float32)
    want = jax_switch(jnp.asarray(logits), capacity)
    got = _switch_dispatch(torch.tensor(logits), capacity)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=GATE_RTOL, atol=1e-7)
    np.testing.assert_allclose(float(got[2]), float(want[2]),
                               rtol=GATE_RTOL)


def _load_gate(port, jgate):
    port.load_state_dict({k: torch.tensor(v) for k, v in
                          _state(jgate).items()})


@pytest.mark.parametrize("kind", ["gshard", "switch"])
@pytest.mark.parametrize("train", [True, False])
def test_gate_modules_match_jax(kind, train):
    """The gates on JAX's weights: training draws the key stream's next
    key (GShard's random routing, Switch's jitter), as JAX's do."""
    paddle.seed(11)
    jcls, cls = ((JaxGShard, GShardGate) if kind == "gshard"
                 else (JaxSwitch, SwitchGate))
    jgate = jcls(16, 4, 1, capacity=(0.5, 1.0))
    gate = cls(16, 4, 1, capacity=(0.5, 1.0), device="cpu")
    _load_gate(gate, jgate)
    x = np.random.default_rng(2).standard_normal((40, 16)).astype(
        np.float32)
    prng.set_rng_state(_rng_state())
    want = jgate.dispatch_info(Tensor(x), train=train)
    got = gate.dispatch_info(torch.tensor(x), train=train)
    assert prng.get_rng_state() == _rng_state()   # the same draws
    np.testing.assert_array_equal(got[1].numpy(), _np(want[1]))
    np.testing.assert_allclose(got[0].detach().numpy(), _np(want[0]),
                               rtol=GATE_RTOL, atol=1e-6)
    np.testing.assert_allclose(float(got[2].detach()), float(_np(want[2])),
                               rtol=GATE_RTOL)
    assert gate.get_loss() is got[2] and gate.get_loss() is None


def test_naive_gate_topk_matches_jax():
    paddle.seed(0)
    jgate = JaxNaive(16, 4, 1, topk=2)
    gate = NaiveGate(16, 4, 1, topk=2, device="cpu")
    _load_gate(gate, jgate)
    x = np.random.default_rng(0).standard_normal((10, 16)).astype(
        np.float32)
    jv, ji, js = jgate(Tensor(x), return_all_scores=True)
    v, i, s = gate(torch.tensor(x), return_all_scores=True)
    np.testing.assert_allclose(s.detach().numpy(), _np(js), rtol=RTOL,
                               atol=ATOL)
    order = np.argsort(-_np(jv), axis=-1)
    np.testing.assert_array_equal(i.numpy(), np.take_along_axis(
        _np(ji), order, -1))
    np.testing.assert_allclose(v.detach().numpy(), np.take_along_axis(
        _np(jv), order, -1), rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# MoELayer in one process
# ---------------------------------------------------------------------------

def _layer_pair(experts, gate, seed=0):
    """JAX's MoELayer and the port's on its weights."""
    paddle.seed(seed)
    if experts == "list":
        jl = JaxMoE(d_model=8, experts=[jnn.Linear(8, 8) for _ in range(4)],
                    gate=dict(gate))
        pl = MoELayer(8, experts=[Linear(8, 8, device="cpu")
                                  for _ in range(4)], gate=dict(gate),
                      device="cpu")
    else:
        jl = JaxMoE(d_model=8, num_expert=4, d_hidden=16, gate=dict(gate))
        pl = MoELayer(8, num_expert=4, d_hidden=16, gate=dict(gate),
                      device="cpu")
    convert.load_paddle_tpu_state(pl, _state(jl))
    return jl, pl


@pytest.mark.parametrize("experts,gate,train", [
    ("stacked", {"type": "gshard", "top_k": 2}, True),
    ("stacked", {"type": "gshard", "top_k": 2, "capacity": (0.5, 0.5)},
     True),
    ("stacked", {"type": "switch", "top_k": 1}, False),
    ("list", {"type": "switch", "top_k": 1, "capacity": (0.5, 0.5)},
     False),
    ("list", {"type": "gshard", "top_k": 2}, True)])
def test_moe_layer_matches_jax(experts, gate, train):
    """The output and the gradients of ``sum(y * w)`` (x, every
    parameter) against JAX's layer."""
    jl, pl = _layer_pair(experts, gate)
    jl.train() if train else jl.eval()
    pl.train(train)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 16, 8)).astype(np.float32)
    w = rng.standard_normal((2, 16, 8)).astype(np.float32)
    prng.set_rng_state(_rng_state())
    jx = Tensor(x)
    jx.stop_gradient = False
    jy = jl(jx)
    (jy * Tensor(w)).sum().backward()
    tx = torch.tensor(x, requires_grad=True)
    y = pl(tx)
    (y * torch.tensor(w)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), _np(jy), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(tx.grad.numpy(), _np(jx.grad), rtol=RTOL,
                               atol=ATOL)
    jgrads = {k: _np(p.grad) for k, p in jl.named_parameters()}
    for k, p in pl.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), jgrads[k], rtol=RTOL,
                                   atol=ATOL, err_msg=k)


def test_switch_capacity_drops_tokens():
    """JAX's token-drop numerics on the port: with capacity below demand
    each expert holds at most ``cap`` tokens, dropped tokens give exactly
    zero (the layer counts them by expert), kept ones equal the
    ample-capacity run's."""
    n, e, d = 16, 2, 8
    x = torch.tensor(np.random.default_rng(0).standard_normal(
        (n, d)).astype(np.float32))
    ample = MoELayer(d, num_expert=e, d_hidden=16, device="cpu",
                     gate={"type": "switch", "top_k": 1,
                           "capacity": (8.0, 8.0)}).eval()
    tight = MoELayer(d, num_expert=e, d_hidden=16, device="cpu",
                     gate={"type": "switch", "top_k": 1,
                           "capacity": (0.25, 0.25)}).eval()
    tight.load_state_dict(ample.state_dict())
    with torch.no_grad():
        y_full, y_tight = ample(x), tight(x)
        _, d_full, _ = ample.gate.dispatch_info(x, train=False)
        _, d_t, _ = tight.gate.dispatch_info(x, train=False)
    assert (d_full.numpy().reshape(n, -1).sum(-1) == 1).all()
    assert (d_t.numpy().sum(axis=(0, 2)) <= 2).all()
    kept = d_t.numpy().reshape(n, -1).sum(-1) > 0
    assert kept.sum() < n
    # the layer's count of each expert's dropped tokens: demand - kept
    np.testing.assert_array_equal(
        tight.last_dropped.numpy(),
        d_full.numpy().sum(axis=(0, 2)) - d_t.numpy().sum(axis=(0, 2)))
    assert int(ample.last_dropped.sum()) == 0
    np.testing.assert_array_equal(y_tight.numpy()[~kept], 0.0)
    np.testing.assert_allclose(y_tight.numpy()[kept], y_full.numpy()[kept],
                               rtol=1e-6, atol=1e-7)


def test_moe_layer_refusals_match_jax():
    """NaiveGate: JAX's TypeError word for word; a gate neither dict nor
    BaseGate: its TypeError."""
    paddle.seed(0)
    jl = JaxMoE(d_model=8, num_expert=2, d_hidden=8,
                gate=JaxNaive(8, 2, 1, topk=1))
    with pytest.raises(TypeError) as want:
        jl(paddle.randn([4, 8]))
    pl = MoELayer(8, num_expert=2, d_hidden=8, device="cpu",
                  gate=NaiveGate(8, 2, 1, topk=1, device="cpu"))
    with pytest.raises(TypeError) as got:
        pl(torch.randn(4, 8))
    assert str(got.value) == str(want.value)
    with pytest.raises(TypeError, match="neither dict nor BaseGate"):
        MoELayer(8, gate="gshard", device="cpu")


def test_expert_ffn_and_clip_surface():
    """`ExpertFFN`'s stacks carry JAX's ``Shard(0)`` placement over mp;
    the clip is a global-norm clip keeping the reference's arguments as
    given."""
    f = ExpertFFN(4, 8, 16, device="cpu")
    assert tuple(f.w1.shape) == (4, 8, 16) and tuple(f.b2.shape) == (4, 1, 8)
    for p in f.parameters():
        assert p.mp_placement[0] == "mp" and p.mp_placement[1].dim == 0
    clip = ClipGradForMOEByGlobalNorm(1.0, moe_group="mp")
    assert clip.clip_norm == 1.0 and clip.moe_group == "mp"
    assert clip.is_expert_param_func is None
    fn = lambda p: True  # noqa: E731
    assert ClipGradForMOEByGlobalNorm(1.0, fn).is_expert_param_func is fn


def _jax_moe_gpt_grads(ids, labels):
    """JAX's tiny recomputed MoE GPT (one process, no mesh): its state,
    the key stream before and after, the loss and the gradients."""
    paddle.seed(11)
    jm = JaxPGPT(jax_gpt_config("gpt2-124m", use_recompute=True,
                                **GPT_CFG), moe_every=2, num_experts=4,
                 moe_capacity=(0.5, 1.0))
    state, before = _state(jm), _rng_state()
    _, loss = jm(Tensor(ids.astype(np.int32)), labels=Tensor(labels))
    loss.backward()
    return state, before, _rng_state(), float(_np(loss)), \
        {k: _np(p.grad) for k, p in jm.named_parameters()}


@pytest.mark.parametrize("recompute", [False, True])
def test_moe_gpt_under_recompute_matches_jax(recompute):
    """The block recomputed in the backward (``use_recompute``) routes as
    its first run did: the random routing's key is the first run's, so
    the loss, the gradients and the key stream equal JAX's (whose
    checkpoint reuses the traced key) and the run without recompute."""
    ids, labels = _batches(256, n=1)[0]
    state, before, after, loss, grads = _jax_moe_gpt_grads(ids, labels)
    model = ParallelGPTForCausalLM(
        gpt_config("gpt2-124m", use_recompute=recompute, **GPT_CFG),
        moe_every=2, num_experts=4, moe_capacity=(0.5, 1.0), device="cpu")
    convert.load_paddle_tpu_state(model, state)
    prng.set_rng_state(before)
    _, got = model(torch.tensor(ids), labels=torch.tensor(labels))
    got.backward()
    assert prng.get_rng_state() == after
    np.testing.assert_allclose(float(got.detach()), loss, rtol=LOSS_RTOL)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), grads[name], rtol=RTOL,
                                   atol=ATOL, err_msg=name)


# ---------------------------------------------------------------------------
# dp 2 x mp 2
# ---------------------------------------------------------------------------

_RANKS = {}


def _batches(vocab, n=3, b=4, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(0, vocab, (b, SEQ)).astype(np.int64)
        labels = np.roll(ids, -1, axis=1)
        labels[:, -1] = -100
        out.append((ids, labels))
    return out


def _ranks(tmp_path_factory):
    """JAX's references and the 4 ranks' results, run once."""
    if _RANKS:
        return _RANKS
    rng = np.random.default_rng(9)
    paddle.seed(11)
    jgate = JaxGShard(16, 4, 1, capacity=(0.5, 1.0))
    x = rng.standard_normal((64, 16)).astype(np.float32)
    gstate = _state(jgate)
    rng_state = _rng_state()
    gate_want = {}
    for train in (True, False):
        combine, dispatch, aux = jgate.dispatch_info(Tensor(x), train=train)
        gate_want[train] = (_np(combine), _np(dispatch), float(_np(aux)))
        jstate.STATE.rng_counter = rng_state[1]
    jl = JaxMoE(d_model=16, num_expert=4, d_hidden=32,
                gate={"type": "gshard", "top_k": 2, "capacity": (0.5, 1.0)})
    lstate = _state(jl)
    lx = rng.standard_normal((32, 16)).astype(np.float32)
    lw = rng.standard_normal((32, 16)).astype(np.float32)
    jstate.STATE.rng_counter = rng_state[1]
    jx = Tensor(lx)
    jx.stop_gradient = False
    jy = jl(jx)
    (jy * Tensor(lw)).sum().backward()
    layer_want = {"y": _np(jy), "dx": _np(jx.grad),
                  "grads": {k: _np(p.grad) for k, p in
                            jl.named_parameters()}}
    batches = _batches(256)
    with jax_axes(dp=2, mp=2):
        paddle.seed(11)
        jm = JaxPGPT(jax_gpt_config("gpt2-124m", **GPT_CFG), moe_every=2,
                     num_experts=4, moe_capacity=(0.5, 1.0))
        mstate = _state(jm)
        model_rng = _rng_state()
        # the first step's global norm, then the 3 steps from the start
        _, loss = jm(Tensor(batches[0][0].astype(np.int32)),
                     labels=Tensor(batches[0][1]))
        loss.backward()
        norm = float(np.sqrt(sum(float((_np(p.grad).astype(np.float64) ** 2)
                                       .sum()) for p in jm.parameters())))
        for p in jm.parameters():
            p.clear_grad()
        jstate.STATE.rng_counter = model_rng[1]
        model_want = _jax_train(jm, batches[:3])
        model_want_rng = _rng_state()
    outs = run_ranks(4, "moe", tmp_path_factory.mktemp("moe"), {
        "rng": rng_state,
        "gate": {"d": 16, "e": 4, "capacity": (0.5, 1.0), "x": x,
                 "w": gstate["gate.weight"], "b": gstate["gate.bias"]},
        "layer": {"d": 16, "e": 4, "h": 32, "capacity": (0.5, 1.0),
                  "state": lstate, "x": lx, "w": lw},
        "model": {"cfg": GPT_CFG, "capacity": (0.5, 1.0), "state": mstate,
                  "batches": batches, "rng": model_rng}}, timeout=400)
    _RANKS.update(gate=gate_want, layer=layer_want, model=model_want,
                  norm=norm, model_rng=model_want_rng, outs=outs,
                  lstate=lstate)
    return _RANKS


def _by_dp(outs):
    return {(o["dp_rank"], o["mp_rank"]): o for o in outs}


@pytest.mark.parametrize("train", [True, False])
def test_dp_mp_routing_matches_jax_global(train, tmp_path_factory):
    """A dp rank's rows of the dense routing equal JAX's routing of the
    global batch (capacity places after rank 0's tokens, the random
    routing's uniforms of the global draw); the aux loss is the global
    one; the mp ranks route alike."""
    r = _ranks(tmp_path_factory)
    combine, dispatch, aux = r["gate"][train]
    assert dispatch.sum() < 2 * 64          # the capacity drops tokens
    for (dp, mp), o in _by_dp(r["outs"]).items():
        g = o["gate"][train]
        rows = slice(32 * dp, 32 * dp + 32)
        np.testing.assert_array_equal(g["dispatch"], dispatch[rows])
        np.testing.assert_allclose(g["combine"], combine[rows],
                                   rtol=GATE_RTOL, atol=1e-6)
        np.testing.assert_allclose(g["aux"], aux, rtol=GATE_RTOL)


def test_dp_mp_layer_matches_jax(tmp_path_factory):
    """The layer's output and x's gradient rows, and each parameter's
    gradient (the dp ranks' summed; the experts' parts joined over mp)
    against JAX's on the global batch."""
    r = _ranks(tmp_path_factory)
    by = _by_dp(r["outs"])
    want = r["layer"]
    for (dp, mp), o in by.items():
        rows = slice(16 * dp, 16 * dp + 16)
        np.testing.assert_allclose(o["layer"]["y"], want["y"][rows],
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(o["layer"]["dx"], want["dx"][rows],
                                   rtol=RTOL, atol=ATOL)
    for name, g in want["grads"].items():
        parts = [by[(0, m)]["layer"]["grads"][name] +
                 by[(1, m)]["layer"]["grads"][name] for m in (0, 1)]
        got = np.concatenate(parts) if name.startswith("_stacked") \
            else parts[0]
        np.testing.assert_allclose(got, g, rtol=RTOL, atol=ATOL,
                                   err_msg=name)
        if not name.startswith("_stacked"):
            np.testing.assert_allclose(parts[1], g, rtol=RTOL, atol=ATOL)


def test_dp_mp_expert_shards_and_convert(tmp_path_factory):
    """Each mp rank holds 2 of the 4 experts (``[2, d, h]`` stacks, the
    gate whole); convert's shard and gather of the stacks round-trip bit
    for bit."""
    r = _ranks(tmp_path_factory)
    for o in r["outs"]:
        shapes = o["layer"]["local_shapes"]
        assert shapes["_stacked.w1"] == (2, 16, 32)
        assert shapes["_stacked.b2"] == (2, 1, 16)
        assert shapes["gate.gate.weight"] == (16, 4)
        assert all(o["convert"].values()) and \
            set(o["convert"]) == set(r["lstate"])
        assert o["model"]["expert_shape"] == (2, 64, 256)


def test_moe_gpt_losses_match_jax(tmp_path_factory):
    r = _ranks(tmp_path_factory)
    losses, _ = r["model"]
    for o in r["outs"]:
        np.testing.assert_allclose(o["model"]["losses"], losses,
                                   rtol=LOSS_RTOL)
        assert tuple(o["model"]["rng"]) == tuple(r["model_rng"])


def test_moe_gpt_parameters_match_jax(tmp_path_factory):
    """After 3 AdamW steps with the clip: the gathered parameters against
    JAX's, the dp replicas bit for bit."""
    r = _ranks(tmp_path_factory)
    _, state = r["model"]
    by = _by_dp(r["outs"])
    for name, want in state.items():
        _close(by[(0, 0)]["model"]["state"][name], want, name)
        for m in (0, 1):
            np.testing.assert_array_equal(by[(0, m)]["model"]["state"][name],
                                          by[(1, m)]["model"]["state"][name])


def test_moe_clip_counts_each_expert_once(tmp_path_factory):
    """The first step's global norm (`ClipGradForMOEByGlobalNorm` over the
    dp-synced gradients: the expert stacks' squares summed over mp, the
    copies once) equals JAX's norm of the global model's gradients."""
    r = _ranks(tmp_path_factory)
    for o in r["outs"]:
        np.testing.assert_allclose(o["model"]["norm"], r["norm"], rtol=1e-5)


def test_moe_refused_where_sharding_or_sep_split_the_batch(tmp_path):
    """At sharding 2 or sep 2 (dp 1) the gate would route over a part of
    the batch JAX routes whole: the layer refuses, labelled A8."""
    for out in run_ranks(2, "moe_split_refused", tmp_path):
        assert set(out) == {"sharding", "sep"}
        for axis, msg in out.items():
            assert f"at {axis} > 1" in msg and "ROADMAP A8" in msg
