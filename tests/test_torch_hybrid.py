"""The port's hybrid dp x mp training against the JAX package: the topology
(degrees and errors, in process), each tensor-parallel layer on 2 gloo
ranks against JAX's layer on the CPU mesh, the parallel Llama and GPT at
dp 2 x mp 2 (4 ranks: fleet.init -> distributed_model -> CompiledTrainStep
over the mesh, 3 AdamW steps with the clip) against JAX's parallel models
on the same global batch, `DataParallel` and hapi ``fit`` on 2 ranks
against one rank, the global-norm clip at dp 2 x mp 2 against the
one-rank norm and JAX's scale, the state conversion's round trip and TP
``generate`` against JAX's.  The ranks are processes
(`_torch_dist_worker`).

Tolerances (fp32 on both sides): a rank's sums run in other orders than
XLA's (the row-parallel products are summed over ranks), so losses agree
within 1e-5 relative; parameters after 3 AdamW steps as in
tests/test_torch_train.py: AdamW moves an element by ~lr whatever its
gradient's size, so all but 1 in 10^4 elements (at least one: the tiny
model's tensors hold a few thousand) within 2e-5 absolute and every
element within 2e-5 + 1e-2 relative.  Layers: 1e-5 relative (one
product summed in another order).
"""
import contextlib

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.distributed import mesh as jmesh
from paddle_tpu.distributed import topology as jtopo
from paddle_tpu.distributed.fleet import base as jbase
from paddle_tpu.models import ParallelGPTForCausalLM as JaxPGPT
from paddle_tpu.models import ParallelLlamaForCausalLM as JaxPLlama
from paddle_tpu.models.gpt import gpt_config as jax_gpt_config
from paddle_tpu.models.llama import llama_config as jax_llama_config
from paddle_tpu.nn.clip import ClipGradByGlobalNorm as JaxClip

from paddle_tpu_torch import convert
from paddle_tpu_torch.distributed import ProcessMesh, topology
from paddle_tpu_torch.distributed.fleet import mp_layers as M
from paddle_tpu_torch.framework import CompiledTrainStep
from paddle_tpu_torch.models import GPTForCausalLM, gpt_config
from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
from paddle_tpu_torch.nn.layers import Linear
from paddle_tpu_torch.optimizer import AdamW, SGD

from _torch_dist_worker import run_ranks

LOSS_RTOL = 1e-5
PARAM_ATOL = 2e-5
PARAM_RTOL = 1e-2
LAYER_RTOL = 1e-5
SEQ = 32
LLAMA_CFG = dict(max_seq_len=SEQ)
GPT_CFG = dict(num_layers=2, hidden_size=64, num_heads=4, vocab_size=256,
               max_seq_len=SEQ)


def _np(t):
    return np.asarray(t._data_)


@contextlib.contextmanager
def jax_hybrid(dp, mp):
    """JAX's hybrid topology over the first dp x mp CPU devices, the
    package's mesh and fleet state put back after."""
    saved = (jmesh._DEFAULT[0], jtopo.get_hybrid_communicate_group(),
             dict(jbase._fleet_state))
    hcg = jtopo.HybridCommunicateGroup(dp_degree=dp, mp_degree=mp,
                                       devices=jax.devices()[:dp * mp])
    jtopo.set_hybrid_communicate_group(hcg)
    jbase._fleet_state.update(initialized=True, strategy=None)
    try:
        yield hcg
    finally:
        jmesh._DEFAULT[0] = saved[0]
        jtopo.set_hybrid_communicate_group(saved[1])
        jbase._fleet_state.clear()
        jbase._fleet_state.update(saved[2])


def _close(got, want, what):
    """The parameter rule of the module docstring."""
    err = np.abs(got - want)
    off = int(np.sum(err > PARAM_ATOL))
    assert off <= max(1, err.size // 10000), (what, off, float(err.max()))
    np.testing.assert_allclose(got, want, rtol=PARAM_RTOL, atol=PARAM_ATOL,
                               err_msg=what)


# ---------------------------------------------------------------------------
# the topology
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(), dict(mp_degree=2), dict(mp_degree=4), dict(dp_degree=2,
                                                        mp_degree=4),
    dict(mp_degree=8), dict(dp_degree=-1, mp_degree=2, pp_degree=2)])
def test_hybrid_degrees_match_jax(kw):
    with jax_hybrid(1, 1):
        want = jtopo.HybridCommunicateGroup(
            devices=jax.devices()[:8], **kw).topology()
    assert topology.hybrid_degrees(8, **kw) == want


@pytest.mark.parametrize("kw", [
    dict(mp_degree=3), dict(dp_degree=2, mp_degree=2),
    dict(dp_degree=3, mp_degree=2), dict(mp_degree=16)])
def test_hybrid_degree_errors_match_jax(kw):
    with jax_hybrid(1, 1):
        with pytest.raises(ValueError) as want:
            jtopo.HybridCommunicateGroup(devices=jax.devices()[:8], **kw)
    with pytest.raises(ValueError) as got:
        topology.HybridCommunicateGroup(devices=list(range(8)), **kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("axis", ["pp", "sharding", "sep"])
def test_unported_axes_raise(axis):
    """Every axis is ported: sharding (tests/test_torch_zero.py), pp
    (tests/test_torch_pipeline.py) and sep
    (tests/test_torch_context_parallel.py).  The degree passes the check
    and the topology wants a world of that many ranks."""
    with pytest.raises(ValueError, match="the world has 1 ranks"):
        topology.HybridCommunicateGroup(devices=list(range(8)),
                                        **{f"{axis}_degree": 2})


def test_communicate_topology_matches_jax():
    names, dims = ("data", "pipe", "sharding", "sep", "model"), (2, 1, 1, 1, 4)
    a = jtopo.CommunicateTopology(names, dims)
    b = topology.CommunicateTopology(names, dims)
    assert a.world_size() == b.world_size() == 8
    for r in range(8):
        assert tuple(a.get_coord(r)) == tuple(b.get_coord(r))
    assert a.get_axis_list("model", 1) == b.get_axis_list("model", 1)
    assert a.get_fused_ranks(["data"]) == b.get_fused_ranks(["data"])
    assert a.get_rank(data=1, pipe=0, sharding=0, sep=0, model=3) == \
        b.get_rank(data=1, pipe=0, sharding=0, sep=0, model=3)


def test_compiled_step_refuses_other_axes_and_the_sentinel():
    """The mesh lanes run dp and mp: a pp or sep axis above 1 raises
    with JAX's wording; a sharding axis takes JAX's eager lane with the
    same words in a `MeshFallbackWarning` (tests/test_torch_zero.py).
    The sentinel with a mesh is ported (its health on 2 ranks:
    tests/test_torch_sentinel_ranks.py): in a world of one it gets as
    far as the step without it, the dp group this world cannot hold."""
    from paddle_tpu_torch.framework.train_step import MeshFallbackWarning
    opt = SGD(0.1, parameters=Linear(2, 2, device="cpu").parameters())
    for name in ("pp", "sharding", "sep"):
        mesh = ProcessMesh(np.arange(2).reshape(2, 1), [name, "dp"])
        words = f"mesh axis '{name}' cannot run inside one compiled program"
        if name == "sharding":
            with pytest.warns(MeshFallbackWarning, match=words):
                cs = CompiledTrainStep(lambda x, y: x, opt, mesh=mesh)
            assert not cs.compiled
            continue
        with pytest.raises(NotImplementedError, match=words):
            CompiledTrainStep(lambda x, y: x, opt, mesh=mesh)
    mesh = ProcessMesh(np.arange(2).reshape(2, 1), ["dp", "mp"])
    for sentinel in (False, True):
        with pytest.raises(ValueError, match="outside the world of 1"):
            CompiledTrainStep(lambda x, y: x, opt, mesh=mesh,
                              sentinel=sentinel)
    one = ProcessMesh(np.arange(1).reshape(1, 1), ["dp", "mp"])
    assert not CompiledTrainStep(lambda x, y: x, opt, mesh=one)._meshed


def test_compiled_step_refuses_a_data_parallel_network():
    """The mesh lanes average the gradients over dp in their own tail
    (`parallel.mesh_update`); a `DataParallel` network would sync them a
    second time after its backward, so the step takes the bare model."""
    from paddle_tpu_torch.distributed import DataParallel
    net = Linear(2, 2, device="cpu")
    opt = SGD(0.1, parameters=net.parameters())
    mesh = ProcessMesh(np.arange(2).reshape(2, 1), ["dp", "mp"])
    with pytest.raises(ValueError, match="bare model, not a DataParallel"):
        CompiledTrainStep(lambda x, y: x, opt, network=DataParallel(net),
                          mesh=mesh)


# ---------------------------------------------------------------------------
# the tensor-parallel layers, 2 ranks, against JAX's on the CPU mesh
# ---------------------------------------------------------------------------

_LAYERS = {}


@pytest.fixture
def layers(tmp_path_factory):
    """(inputs, each rank's results) of the mp_layers case."""
    if not _LAYERS:
        rng = np.random.default_rng(0)

        def f(*shape):
            return rng.standard_normal(shape).astype(np.float32)
        inp = dict(x=f(4, 6, 16), w1=f(16, 32), b1=f(32), w2=f(32, 16),
                   b2=f(16), gy=f(4, 6, 16), w3=f(16, 24), b3=f(24),
                   emb=f(20, 8), ids=rng.integers(0, 20, (3, 5)),
                   ge=f(3, 5, 8), logits=f(6, 20),
                   labels=np.array([1, 19, -100, 5, 10, 0]),
                   xs=f(2, 8, 16), gys=f(2, 8, 16))
        _LAYERS["inp"] = inp
        _LAYERS["outs"] = run_ranks(2, "mp_layers",
                                    tmp_path_factory.mktemp("mp"), inp)
    return _LAYERS["inp"], _LAYERS["outs"]


def _jax_mlp(inp, col_cls, row_cls, x, gy, gather):
    """JAX's column -> tanh -> row pair on a dp 1 x mp 2 mesh: (y, dx,
    dw1, db1, dw2, db2)."""
    with jax_hybrid(1, 2):
        kw = {} if col_cls is not jfleet.ColumnParallelLinear else \
            dict(gather_output=gather)
        col = col_cls(16, 32, **kw)
        kw = {} if row_cls is not jfleet.RowParallelLinear else \
            dict(input_is_parallel=not gather)
        row = row_cls(32, 16, **kw)
        for layer, w, b in ((col, "w1", "b1"), (row, "w2", "b2")):
            layer.weight.set_value(inp[w])
            layer.bias.set_value(inp[b])
        net = paddle.nn.Sequential(col, paddle.nn.Tanh(), row)
        jfleet.distributed_model(net)
        xt = paddle.to_tensor(x, stop_gradient=False)
        y = net(xt)
        (y * paddle.to_tensor(gy)).sum().backward()
        return [_np(y), _np(xt.grad), _np(col.weight.grad),
                _np(col.bias.grad), _np(row.weight.grad),
                _np(row.bias.grad)]


@pytest.mark.parametrize("tag", ["parallel", "gathered"])
def test_column_row_parallel_match_jax(layers, tag):
    """Column (gather_output either way) -> tanh -> row
    (input_is_parallel the other way): the output, the input's gradient
    and the gathered weight and bias gradients against JAX's layers."""
    inp, outs = layers
    want = _jax_mlp(inp, jfleet.ColumnParallelLinear,
                    jfleet.RowParallelLinear, inp["x"], inp["gy"],
                    tag == "gathered")
    for res in outs:
        got = [res[f"{tag}_{k}"] for k in ("y", "dx", "dw1", "db1", "dw2",
                                           "db2")]
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=LAYER_RTOL, atol=1e-5)


def test_sequence_parallel_linears_match_jax(layers):
    """The sequence split (scatter), the column and row sequence-parallel
    linears and the gather back: the output, the input's gradient (each
    rank its part) and the gradients against JAX's SP layers; the row
    layer's bias is marked sequence-parallel (its gradient summed over
    mp)."""
    inp, outs = layers
    want = _jax_mlp(inp, jfleet.ColumnSequenceParallelLinear,
                    jfleet.RowSequenceParallelLinear, inp["xs"], inp["gys"],
                    False)
    dx = np.concatenate([r["sp_dx_part"] for r in outs], axis=1)
    np.testing.assert_allclose(dx, want[1], rtol=LAYER_RTOL, atol=1e-5)
    for res in outs:
        np.testing.assert_allclose(res["sp_y"], want[0], rtol=LAYER_RTOL,
                                   atol=1e-5)
        np.testing.assert_allclose(res["sp_dw1"], want[2],
                                   rtol=LAYER_RTOL, atol=1e-5)
        np.testing.assert_allclose(res["sp_db2"], want[5],
                                   rtol=LAYER_RTOL, atol=1e-5)
        assert res["sp_marked"]


def test_vocab_parallel_embedding_matches_jax(layers):
    inp, outs = layers
    with jax_hybrid(1, 2):
        emb = jfleet.VocabParallelEmbedding(20, 8)
        emb.weight.set_value(inp["emb"])
        jfleet.distributed_model(emb)
        y = emb(paddle.to_tensor(inp["ids"]))
        (y * paddle.to_tensor(inp["ge"])).sum().backward()
        want, want_dw = _np(y), _np(emb.weight.grad)
    for res in outs:
        np.testing.assert_array_equal(res["emb_y"], want)
        np.testing.assert_allclose(res["emb_dw"], want_dw, rtol=LAYER_RTOL,
                                   atol=1e-6)


def test_parallel_cross_entropy_matches_jax(layers):
    """Per-token losses (0 at ignore_index) and the logits' gradient
    (softmax - one-hot, the local slices put together)."""
    inp, outs = layers
    with jax_hybrid(1, 2):
        logits = paddle.to_tensor(inp["logits"], stop_gradient=False)
        loss = jfleet.ParallelCrossEntropy()(logits,
                                             paddle.to_tensor(inp["labels"]))
        loss.sum().backward()
        want, want_g = _np(loss), _np(logits.grad)
    for res in outs:
        np.testing.assert_allclose(res["ce"], want, rtol=LAYER_RTOL,
                                   atol=1e-6)
        np.testing.assert_allclose(res["ce_grad"], want_g, rtol=LAYER_RTOL,
                                   atol=1e-6)


def test_fused_chunks_and_late_sharding(layers):
    """A column layer over 3 chunks (GPT's q, k, v) gathers back to the
    global product; a layer holding global values is split by
    ``shard_`` onto its rank (and a second ``shard_`` only checks)."""
    inp, outs = layers
    x = torch.tensor(inp["x"], requires_grad=True)
    y = x @ torch.tensor(inp["w3"]) + torch.tensor(inp["b3"])
    y.square().sum().backward()
    for r, res in enumerate(outs):
        np.testing.assert_allclose(res["chunks_y"], y.detach().numpy(),
                                   rtol=LAYER_RTOL, atol=1e-5)
        np.testing.assert_allclose(res["chunks_dx"], x.grad.numpy(),
                                   rtol=LAYER_RTOL, atol=1e-5)
        assert res["global_shape"] == (16, 32)
        shape, w, split = res["sharded"]
        assert shape == (16, 16) and split
        np.testing.assert_array_equal(w, inp["w1"][:, 16 * r:16 * r + 16])


def test_shard_of_and_unshard_round_trip():
    t = torch.arange(2 * 24, dtype=torch.float32).reshape(2, 24)
    for chunks in (1, 3):
        parts = [M.shard_of(t, 1, 4, r, chunks) for r in range(4)]
        assert torch.equal(M.unshard(parts, 1, chunks), t)
    # chunk-aware: rank 0 holds the first quarter of each third
    assert torch.equal(M.shard_of(t, 1, 4, 0, 3)[0],
                       torch.tensor([0., 1., 8., 9., 16., 17.]))


# ---------------------------------------------------------------------------
# the global-norm clip across dp x mp
# ---------------------------------------------------------------------------

CLIP = 0.05
_CLIP_SHAPES = {"col.weight": (8, 12), "col.bias": (12,),
                "row.weight": (12, 8), "row.bias": (8,),
                "emb.weight": (16, 8), "norm.weight": (8,), "sp.bias": (8,)}


@pytest.fixture(scope="module")
def clip_run(tmp_path_factory):
    """The gradients (global values; the replicated ones 3x larger, so
    that counting them twice, or not summing the shards over mp, moves
    the norm by far more than the tolerance) and the 4 ranks' norms."""
    rng = np.random.default_rng(7)
    grads = {k: (rng.standard_normal(s) * (3.0 if len(s) == 1 else 1.0))
             .astype(np.float32) for k, s in _CLIP_SHAPES.items()}
    half = (rng.standard_normal(8) * 2).astype(np.float32)
    inputs = {"grads": grads, "clip": CLIP,
              "sp_parts": [half, grads["sp.bias"] - half],
              "dp_noise": {k: rng.standard_normal(s).astype(np.float32)
                           for k, s in _CLIP_SHAPES.items()}}
    return grads, run_ranks(4, "clip_norm", tmp_path_factory.mktemp("clip"),
                            inputs)


@pytest.mark.parametrize("tag", ["plain", "sp"])
def test_clip_global_norm_dp_mp_matches_one_rank(clip_run, tag):
    """`ClipGradByGlobalNorm` at dp 2 x mp 2 (without and with a
    sequence-parallel parameter) against the one-rank norm of the global
    gradients (float64) and JAX's clip scale on them: the shards' squares
    summed over mp, the copies counted once, the dp and sequence-parallel
    syncs before.  1e-6 relative: fp32 sums of ~400 terms."""
    grads, outs = clip_run
    names = [k for k in grads if tag == "sp" or k != "sp.bias"]
    want = float(np.sqrt(sum(np.sum(grads[k].astype(np.float64) ** 2)
                             for k in names)))
    pg = [(None, paddle.to_tensor(grads[k])) for k in names]
    clipped = JaxClip(CLIP)(pg)
    j = int(np.argmax(np.abs(grads[names[0]])))
    jax_scale = float(_np(clipped[0][1]).reshape(-1)[j] /
                      grads[names[0]].reshape(-1)[j])
    for res in outs:
        assert res["split"] == ["col.bias", "col.weight", "emb.weight",
                                "row.weight"]
        norm, scale = res[tag]
        np.testing.assert_allclose(norm, want, rtol=1e-6)
        np.testing.assert_allclose(scale, CLIP / want, rtol=1e-6)
        np.testing.assert_allclose(scale, jax_scale, rtol=1e-6)


def test_clip_refuses_split_gradients_without_their_group():
    """A gradient marked ``mp_split`` names the group it is split over;
    without one the clip raises (it would not know which ranks to sum)."""
    p = torch.nn.Parameter(torch.ones(4))
    p.mp_split = True
    with pytest.raises(ValueError, match="one group they are split over"):
        ClipGradByGlobalNorm(1.0).scale([(p, torch.ones(4))])


# ---------------------------------------------------------------------------
# the parallel models at dp 2 x mp 2 against JAX's
# ---------------------------------------------------------------------------

def _batches(vocab, n=3, b=4, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(0, vocab, (b, SEQ)).astype(np.int64)
        labels = np.roll(ids, -1, axis=1)
        labels[:, -1] = -100          # one ignored position a row
        out.append((ids, labels))
    return out


def _jax_train(jm, batches):
    jfleet.distributed_model(jm)
    opt = paddle.optimizer.AdamW(
        learning_rate=1e-3, parameters=jm.parameters(), weight_decay=0.01,
        grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0))
    losses = []
    for ids, labels in batches:
        _, loss = jm(Tensor(ids.astype(np.int32)), labels=Tensor(labels))
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.numpy()))
    return losses, {k: np.asarray(v._data_) for k, v in
                    jm.state_dict().items()}


_HYBRID = {}


def _hybrid(which, tmp_path_factory):
    """(JAX losses and state, each rank's results) of the dp 2 x mp 2
    training of ``which``, run once."""
    if which not in _HYBRID:
        if which == "llama":
            vocab, case = 512, "hybrid_llama"
            mk = lambda: JaxPLlama(jax_llama_config("tiny", **LLAMA_CFG))
            extra = dict(cfg=LLAMA_CFG)
        else:
            vocab, case = 256, "hybrid_gpt"
            mk = lambda: JaxPGPT(jax_gpt_config("gpt2-124m", **GPT_CFG))
            extra = dict(cfg=GPT_CFG, dropout_cfg=dict(GPT_CFG,
                                                       attn_dropout=0.1))
        batches = _batches(vocab)
        with jax_hybrid(2, 2):
            paddle.seed(11)
            jm = mk()
            state = {k: np.asarray(v._data_).copy()
                     for k, v in jm.state_dict().items()}
            want = _jax_train(jm, batches)
        outs = run_ranks(4, case, tmp_path_factory.mktemp(which),
                         dict(extra, dp=2, mp=2, state=state,
                              batches=batches))
        _HYBRID[which] = (state, batches, want, outs)
    return _HYBRID[which]


@pytest.mark.parametrize("which", ["llama", "gpt"])
def test_parallel_model_losses_match_jax(which, tmp_path_factory):
    _, _, (losses, _), outs = _hybrid(which, tmp_path_factory)
    for res in outs:
        np.testing.assert_allclose(res["losses"], losses, rtol=LOSS_RTOL)
        assert res["compiled"]


@pytest.mark.parametrize("which", ["llama", "gpt"])
def test_parallel_model_parameters_match_jax(which, tmp_path_factory):
    """After 3 AdamW steps with the clip: the gathered parameters against
    JAX's (module rule), the dp replicas bit for bit, and the copies the
    mp ranks hold (norms, biases of row layers) bit for bit."""
    _, _, (_, state), outs = _hybrid(which, tmp_path_factory)
    for name, want in state.items():
        _close(outs[0]["state"][name], want, name)
    by = {(r["dp_rank"], r["mp_rank"]): r for r in outs}
    assert sorted(by) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for name in state:
        for m in (0, 1):
            np.testing.assert_array_equal(by[(0, m)]["state"][name],
                                          by[(1, m)]["state"][name])
        np.testing.assert_array_equal(by[(0, 0)]["state"][name],
                                      by[(0, 1)]["state"][name])


@pytest.mark.parametrize("which", ["llama", "gpt"])
def test_parallel_model_holds_shards(which, tmp_path_factory):
    """Each rank holds its shard: column weights [in, out / 2], row
    weights [in / 2, out], the vocabulary [V / 2, H]; the copies whole.
    A gloo process group is refused at capture, naming the backend."""
    state, _, _, outs = _hybrid(which, tmp_path_factory)
    for res in outs:
        shapes = res["local_shapes"]
        for name, arr in state.items():
            got = shapes[name]
            if "norm" in name or "ln_" in name or name.endswith(
                    ("o_proj.weight", "down_proj.weight", "out_proj.weight",
                     "fc_out.weight", "wte.weight", "wpe.weight",
                     "embed_tokens.weight")) or got != arr.shape:
                assert np.prod(got) * (1 if got == arr.shape else 2) == \
                    arr.size, name
        assert "gloo" in res["capture_refusal"]


def test_gpt_attention_dropout_masks_match_one_rank(tmp_path_factory):
    """GPT with attention dropout 0.1 at dp 2 x mp 2 draws the masks of
    the one-rank model on the global batch (the flash hash on global rows
    and heads): the losses and parameters equal the port's one-rank run
    within the module's rules."""
    state, batches, _, outs = _hybrid("gpt", tmp_path_factory)
    tm = GPTForCausalLM(gpt_config("gpt2-124m", **dict(
        GPT_CFG, attn_dropout=0.1)), device="cpu", seed=3)
    convert.load_paddle_tpu_state(tm, state)
    opt = AdamW(learning_rate=1e-3, parameters=tm.parameters(),
                weight_decay=0.01, grad_clip=ClipGradByGlobalNorm(1.0))
    losses = []
    for ids, labels in batches:
        _, loss = tm(torch.tensor(ids), labels=torch.tensor(labels))
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.detach()))
    for res in outs:
        np.testing.assert_allclose(res["dropout_losses"], losses,
                                   rtol=LOSS_RTOL)
    for name, t in tm.state_dict().items():
        _close(outs[0]["dropout_state"][name], t.detach().numpy(), name)


# ---------------------------------------------------------------------------
# data parallel, hapi, conversion, TP generate
# ---------------------------------------------------------------------------

def _mlp_params(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) * 0.3
            for s in ((8, 16), (16,), (16, 4), (4,))]


def _one_rank_mlp(params):
    net = torch.nn.Sequential(Linear(8, 16, device="cpu"), torch.nn.Tanh(),
                              Linear(16, 4, device="cpu"))
    with torch.no_grad():
        for p, v in zip(net.parameters(), params):
            p.copy_(torch.tensor(v))
    return net


def _dp_inputs():
    rng = np.random.default_rng(1)
    return dict(params=_mlp_params(),
                batches=[(rng.standard_normal((8, 8)).astype(np.float32),
                          rng.standard_normal((8, 4)).astype(np.float32))
                         for _ in range(3)])


def _fit_inputs(compiled):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((16, 8)).astype(np.float32)
    y = rng.standard_normal((16, 4)).astype(np.float32)
    return dict(params=_mlp_params(1), x=x, y=y, batch=4, compiled=compiled)


def _convert_inputs():
    paddle.seed(3)
    cfg = dict(GPT_CFG)
    jm = JaxPGPT(jax_gpt_config("gpt2-124m", **cfg))
    state = {k: np.asarray(v._data_).copy()
             for k, v in jm.state_dict().items()}
    rng = np.random.default_rng(4)
    opt_state = {"step_count": 3, "step_tensor": np.float32(3.0)}
    for i, v in enumerate(state.values()):
        opt_state[f"moment1.{i}"] = rng.standard_normal(v.shape).astype(
            np.float32)
        opt_state[f"moment2.{i}"] = np.abs(rng.standard_normal(
            v.shape)).astype(np.float32)
    return dict(cfg=cfg, state=state, opt_state=opt_state)


_TWO_RANKS = {}


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """(inputs, results) of the 2-rank cases that need no topology (the
    `DataParallel` MLP, hapi fit in both lanes), then the conversion's
    (mp 2), on one spawned group of ranks, run once."""
    if not _TWO_RANKS:
        inputs = {"data_parallel": _dp_inputs(),
                  "fit_True": _fit_inputs(True),
                  "fit_False": _fit_inputs(False),
                  "convert": _convert_inputs(),
                  "fleet_util": {"files": [f"f{i}" for i in range(5)]}}
        cases = [(k, "hapi_fit" if k.startswith("fit") else k, v)
                 for k, v in inputs.items()]
        outs = run_ranks(2, "many", tmp_path_factory.mktemp("two"),
                         {"cases": cases})
        _TWO_RANKS.update(inputs=inputs, results={
            k: [o[k] for o in outs] for k in inputs})
    return _TWO_RANKS


def test_data_parallel_matches_one_rank(two_ranks):
    """`DataParallel` on 2 ranks (each its half of the rows, the gradient
    average in several buckets after each backward) equals one rank on
    the global batch."""
    params = two_ranks["inputs"]["data_parallel"]["params"]
    batches = two_ranks["inputs"]["data_parallel"]["batches"]
    outs = two_ranks["results"]["data_parallel"]
    net = _one_rank_mlp(params)
    opt = AdamW(1e-2, parameters=net.parameters())
    for x, y in batches:
        ((net(torch.tensor(x)) - torch.tensor(y)) ** 2).mean().backward()
        opt.step()
        opt.clear_grad()
    for res in outs:
        for got, want in zip(res["params"], net.parameters()):
            _close(got, want.detach().numpy(), "mlp")
    for a, b in zip(outs[0]["params"], outs[1]["params"]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("compiled", [True, False])
def test_hapi_fit_two_ranks_matches_one_rank(two_ranks, compiled):
    """hapi ``fit`` on 2 ranks (a `DistributedBatchSampler` over the dp
    ranks: rank r reads rows r, r + 2, ...) through the compiled step or
    the eager lane equals the one-rank fit on the global batches (the two
    ranks' rows)."""
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.io import DataLoader, TensorDataset
    from paddle_tpu_torch.nn import MSELoss
    from paddle_tpu_torch.utils import flags
    inputs = two_ranks["inputs"][f"fit_{compiled}"]
    x, y, params = inputs["x"], inputs["y"], inputs["params"]
    outs = two_ranks["results"][f"fit_{compiled}"]
    # the global batch k: rank 0's rows then rank 1's
    order = np.concatenate([np.concatenate([np.arange(r, 16, 2)[4 * k:4 * k
                                                                 + 4]
                                            for r in (0, 1)])
                            for k in range(2)])
    net = _one_rank_mlp(params)
    flags.set_flags({"FLAGS_compiled_train_step": compiled})
    try:
        model = Model(net).prepare(AdamW(1e-2, parameters=net.parameters()),
                                   MSELoss())
        hist = model.fit(DataLoader(TensorDataset(
            [torch.tensor(x[order]), torch.tensor(y[order])]),
            batch_size=8, shuffle=False), epochs=2, verbose=0, log_freq=1)
    finally:
        flags.set_flags({"FLAGS_compiled_train_step": True})
    for res in outs:
        assert res["compiled"] == compiled
        for got, want in zip(res["params"], net.parameters()):
            _close(got, want.detach().numpy(), "fit")
        assert len(res["loss"]) == len(hist["loss"]) == 2
    for a, b in zip(outs[0]["params"], outs[1]["params"]):
        np.testing.assert_array_equal(a, b)


def test_convert_round_trip_bit_for_bit(two_ranks):
    """`shard_paddle_tpu_state` then `gather_paddle_tpu_state` gives the
    global state back bit for bit on every rank (``dst`` only on it), and
    the optimizer's moments the same way; each rank's part has its
    shard's shape."""
    state = two_ranks["inputs"]["convert"]["state"]
    opt_state = two_ranks["inputs"]["convert"]["opt_state"]
    outs = two_ranks["results"]["convert"]
    for r, res in enumerate(outs):
        assert res["only0"] == (r == 0)
        for k, v in state.items():
            np.testing.assert_array_equal(res["state"][k], v)
        for k, v in opt_state.items():
            if k.startswith("moment"):
                np.testing.assert_array_equal(res["opt"][k], v)
        qkv = "gpt.h.0.attn.qkv_proj.weight"
        assert res["local_shapes"][qkv] == (64, 96)
        assert res["local_shapes"]["gpt.wte.weight"] == (128, 64)


def test_tp_generate_matches_jax(tmp_path):
    """TP ``generate`` on 2 ranks (mp 2): the dense cache, the paged cache
    (the paged-decode path on the rank's heads) and the full forward give
    JAX's parallel ``generate`` tokens on both ranks, and the gathered
    logits JAX's; Llama with one kv head (kv heads gathered and repeated,
    as JAX replicates them) and GPT."""
    llama_cfg = dict(LLAMA_CFG, num_kv_heads=1)
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 256, (2, 7)).astype(np.int64)
    want = {}
    with jax_hybrid(1, 2):
        for name, mk in (
                ("llama", lambda: JaxPLlama(jax_llama_config("tiny",
                                                             **llama_cfg))),
                ("gpt", lambda: JaxPGPT(jax_gpt_config("gpt2-124m",
                                                       **GPT_CFG)))):
            paddle.seed(6)
            jm = mk()
            jm.eval()
            want[f"{name}_state"] = {k: np.asarray(v._data_).copy()
                                     for k, v in jm.state_dict().items()}
            jfleet.distributed_model(jm)
            want[name] = _np(jm.generate(Tensor(ids.astype(np.int32)),
                                         max_new_tokens=5))
            want[f"{name}_logits"] = _np(jm(Tensor(ids.astype(np.int32))))
    outs = run_ranks(2, "tp_generate", tmp_path, dict(
        llama_cfg=llama_cfg, gpt_cfg=GPT_CFG, ids=ids, new=5,
        llama_state=want["llama_state"], gpt_state=want["gpt_state"]))
    for res in outs:
        for name in ("llama", "gpt"):
            for lane in ("dense", "paged", "nocache"):
                np.testing.assert_array_equal(res[f"{name}_{lane}"],
                                              want[name])
            np.testing.assert_allclose(res[f"{name}_logits"],
                                       want[f"{name}_logits"], rtol=1e-4,
                                       atol=1e-5)
        assert res["llama_cache_heads"] == 2 and res["gpt_cache_heads"] == 2


def test_device_prefetch_takes_the_dp_rows():
    """With a mesh whose dp axis is above 1, `device_prefetch` puts this
    rank's dp rows of each array that divides by dp on the device (the
    JAX package places the batch sharded over dp) and leaves the others
    whole."""
    from paddle_tpu_torch import data
    from paddle_tpu_torch.distributed import mesh as pmesh
    from paddle_tpu_torch.data.prefetch import _dp_rows

    class Rows:
        def __len__(self):
            return 8

        def __getitem__(self, i):
            return np.full(3, i, np.int64), np.int64(i)
    pmesh.set_mesh(ProcessMesh(np.arange(2).reshape(2, 1), ["dp", "mp"]))
    try:
        pipe = data.pipeline(Rows()).shard(0, 1).batch(4) \
            .device_prefetch(1, device="cpu")
        batches = [b for b in pipe]
    finally:
        pmesh.set_mesh(None)
    assert [b[0][:, 0].tolist() for b in batches] == [[0, 1], [4, 5]]
    assert [b[1].tolist() for b in batches] == [[0, 1], [4, 5]]
    odd = _dp_rows((np.zeros((3, 2)), np.zeros(())), (1, 2))
    assert odd[0].shape == (3, 2) and odd[1].shape == ()


def test_placement_local_slice():
    """A rank's part of a global tensor under its placements: a dim
    split over one mesh axis, over two, and a replicated one."""
    from paddle_tpu_torch.distributed import Replicate, Shard, placement
    mesh = ProcessMesh(np.arange(4).reshape(2, 2), ["dp", "mp"])
    t = torch.arange(8 * 6).reshape(8, 6)
    assert torch.equal(placement.local_slice(t, mesh, [Replicate(), Shard(1)],
                                             rank=3), t[:, 3:])
    assert torch.equal(placement.local_slice(t, mesh, [Shard(0), Shard(0)],
                                             rank=2), t[4:6])
    assert torch.equal(placement.local_slice(t, mesh,
                                             [Replicate(), Replicate()],
                                             rank=1), t)
    assert placement.shardable_on((8, 6), mesh, "mp", dim=1)
    assert not placement.shardable_on((7, 6), mesh, "dp")
    assert mesh.lines("dp") == [[0, 2], [1, 3]]
    assert mesh.get_coord("mp", rank=3) == 1
    from paddle_tpu_torch.distributed import mesh as pmesh
    with mesh:
        assert pmesh.get_mesh() is mesh
        with pmesh.suspended():
            assert pmesh.get_mesh() is None
        assert pmesh.get_mesh() is mesh
    assert pmesh.get_mesh() is None
    assert pmesh.init_mesh([2], ["dp"], devices=[0, 1]).shape == [2]


# ---------------------------------------------------------------------------
# the rest of fleet's surface: Fleet, Role, UtilBase, the wrappers
# ---------------------------------------------------------------------------

def test_fleet_util_base_two_ranks(two_ranks, monkeypatch):
    """`fleet.Fleet` and its `UtilBase` on 2 ranks: all_reduce (sum,
    max, min) as numpy, all_gather of objects, the file shard of each
    rank equal to JAX's ``get_file_shard`` at that rank, print_on_rank,
    the worker's index and count, barriers."""
    from paddle_tpu.distributed import env as jenv
    files = two_ranks["inputs"]["fleet_util"]["files"]
    outs = two_ranks["results"]["fleet_util"]
    for r, res in enumerate(outs):
        np.testing.assert_array_equal(res["sum"], [3.0, 6.0])
        assert res["max"] == 4 and res["min"] == 3
        assert res["gather"] == [{"rank": 0}, {"rank": 1}]
        monkeypatch.setattr(jenv, "get_rank", lambda r=r: r)
        monkeypatch.setattr(jenv, "get_world_size", lambda: 2)
        assert res["shard"] == jfleet.UtilBase().get_file_shard(files)
        assert res["printed"] == ("hello\n" if r == 1 else "")
        assert (res["index"], res["num"], res["first"]) == (r, 2, r == 0)


def test_fleet_surface_matches_jax(capsys):
    """`Role`'s values, ``ELASTIC_TIMEOUT``, a world of one's `UtilBase`
    (all_reduce, all_gather, the file shard, print_on_rank) and `Fleet`'s
    worker queries against JAX's; `TensorParallel` and `SegmentParallel`
    wrap a model whose forward they keep."""
    from paddle_tpu.distributed.fleet import elastic as jelastic
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet import elastic
    for name in ("WORKER", "SERVER", "HETER_WORKER", "ALL", "COORDINATOR"):
        assert getattr(fleet.Role, name) == getattr(jfleet.Role, name)
    assert elastic.ELASTIC_TIMEOUT == jelastic.ELASTIC_TIMEOUT == 60
    port, jax_util = fleet.Fleet().util, jfleet.Fleet().util
    x = np.array([1.5, -2.0], dtype=np.float32)
    for mode in ("sum", "max", "min"):
        got, want = port.all_reduce(x, mode), jax_util.all_reduce(x, mode)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
    assert port.all_gather({"a": 1}) == jax_util.all_gather({"a": 1})
    files = ["a", "b", "c"]
    assert port.get_file_shard(files) == jax_util.get_file_shard(files)
    port.print_on_rank("p", 0)
    jax_util.print_on_rank("p", 0)
    assert capsys.readouterr().out == "p\np\n"
    f, jf = fleet.Fleet(), jfleet.Fleet()
    assert (f.worker_index(), f.worker_num(), f.is_first_worker()) == \
        (jf.worker_index(), jf.worker_num(), jf.is_first_worker())
    net = Linear(4, 3, device="cpu")
    xin = torch.randn(2, 4)
    for wrap in (fleet.TensorParallel, fleet.SegmentParallel):
        assert torch.equal(wrap(net)(xin), net(xin))
