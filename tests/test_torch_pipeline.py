"""The port's pipeline parallelism against the JAX package: the partition
(`segment_uniform`, `segment_by_layer`), `homogenize`, `Host1F1B._plan`
and the timetable in process; on gloo ranks (`_torch_dist_worker`)
`fleet.distributed_model(GPTForCausalLMPipe(cfg))` at pp 2, pp 2 × mp 2
and pp 2 × dp 2, the interleaved lane (pp 2 × mp 2, 2 virtual stages),
each 2 `train_batch` steps of AdamW(1e-3) with the global-norm clip 1.0,
then `eval_batch` and the global-view forward, against JAX's
`train_batch` on its CPU mesh (the SPMD schedule); JAX's heterogeneous
4-stage MLP (tests/test_pipeline.py) through the port's cross-rank 1F1B
at pp 4 against JAX's host 1F1B.

JAX draws the weights; the ranks load their stage's part
(`convert.shard_pipeline_state`) and the test gathers the trained model
back (`convert.gather_pipeline_state`).  Each rank holds only its
stage's parameters: its count equals the JAX model's parameters of that
stage (the tied embedding on the first and the last).

Tolerances (fp32 on both sides; tests/test_torch_hybrid.py's): losses
within 1e-5 relative (JAX's loss is the mean over the whole batch, the
port's the sum of the micro-batches' means / M: equal token counts);
parameters after 2 AdamW steps all but 1 in 10^4 elements within 2e-5
absolute and every element within 2e-5 + 1e-2 relative (AdamW moves an
element by ~lr whatever its gradient); the eval loss 1e-5 relative; the
logits within 1e-4 absolute; the SGD MLP's parameters within 1e-5 + 1e-4
relative (JAX's own test of the host 1F1B).
"""
import concurrent.futures
import contextlib
import warnings

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.distributed import mesh as jmesh
from paddle_tpu.distributed import topology as jtopo
from paddle_tpu.distributed.fleet import base as jbase
from paddle_tpu.distributed.fleet.meta_parallel import pp_layers as jpp
from paddle_tpu.distributed.fleet.meta_parallel import pipeline_spmd as jspmd
from paddle_tpu.distributed.fleet.meta_parallel.pipeline_parallel import \
    Host1F1B as JaxHost1F1B
from paddle_tpu.models import GPTForCausalLMPipe as JaxGPTPipe
from paddle_tpu.models.gpt import gpt_config as jax_gpt_config
from paddle_tpu.nn.clip import ClipGradByGlobalNorm as JaxClip

from paddle_tpu_torch.distributed.fleet import DistributedStrategy
from paddle_tpu_torch.distributed.fleet.meta_parallel import (
    PipelineParallel, pp_layers as tpp)
from paddle_tpu_torch.distributed.fleet.meta_parallel import \
    pipeline_spmd as tspmd
from paddle_tpu_torch.distributed.fleet.meta_parallel.pipeline_parallel \
    import Host1F1B, timetable
from paddle_tpu_torch.models import GPTForCausalLMPipe, gpt_config
from paddle_tpu_torch.nn.layers import Linear

from _torch_dist_worker import run_ranks

LOSS_RTOL = 1e-5
PARAM_ATOL = 2e-5
PARAM_RTOL = 1e-2
LOGIT_ATOL = 1e-4
SEQ, ROWS, ACCUM = 32, 4, 2
CFG = dict(num_layers=2, hidden_size=64, num_heads=4, vocab_size=256,
           max_seq_len=SEQ, use_flash_attention=False)
CFG4 = dict(CFG, num_layers=4)
#: key: (gpt overrides, pp, mp, dp, virtual stages)
RUNS2 = {"pp2": (CFG, 2, 1, 1, 1)}
RUNS4 = {"pp2mp2": (CFG, 2, 2, 1, 1), "pp2dp2": (CFG, 2, 1, 2, 1),
         "interleave": (CFG4, 2, 2, 1, 2)}


def _np(t):
    return np.asarray(t._data_)


def _close(got, want, what):
    err = np.abs(got - want)
    off = int(np.sum(err > PARAM_ATOL))
    assert off <= max(1, err.size // 10000), (what, off, float(err.max()))
    np.testing.assert_allclose(got, want, rtol=PARAM_RTOL, atol=PARAM_ATOL,
                               err_msg=what)


def _strategy(cls, accum, **pipeline):
    s = cls()
    s.pipeline = True
    s.pipeline_configs = {"accumulate_steps": accum, **pipeline}
    return s


@contextlib.contextmanager
def jax_pipe(pp, mp=1, dp=1, accum=ACCUM):
    """JAX's hybrid topology with a pp axis over the first pp × mp × dp
    CPU devices, the package's mesh and fleet state put back after."""
    saved = (jmesh._DEFAULT[0], jtopo.get_hybrid_communicate_group(),
             dict(jbase._fleet_state))
    hcg = jtopo.HybridCommunicateGroup(
        dp_degree=dp, mp_degree=mp, pp_degree=pp,
        devices=jax.devices()[:pp * mp * dp])
    jtopo.set_hybrid_communicate_group(hcg)
    jbase._fleet_state.update(initialized=True,
                              strategy=_strategy(jfleet.DistributedStrategy,
                                                 accum))
    try:
        yield hcg
    finally:
        jmesh._DEFAULT[0] = saved[0]
        jtopo.set_hybrid_communicate_group(saved[1])
        jbase._fleet_state.clear()
        jbase._fleet_state.update(saved[2])


def _batches(seed=0, n=2):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(0, CFG["vocab_size"], (ROWS, SEQ))
        out.append((ids, np.roll(ids, -1, axis=1)))
    return out


def _jax_gpt(key, cfg, pp, mp, dp, chunks):
    """JAX's model of a run, its initial state and its stage keys."""
    with jax_pipe(pp, mp, dp):
        paddle.seed(hash(key) % 1000)
        m = JaxGPTPipe(jax_gpt_config("gpt2-124m", **cfg),
                       num_virtual_pipeline_stages=chunks)
        state = {k: _np(v) for k, v in m.state_dict().items()}
    return m, state


def _jax_train(m, cfg, pp, mp, dp, batches):
    """JAX's train_batch on ``batches``; then the trained weights in a
    one-stage JAX model without a mesh (after the SPMD schedule JAX's
    own global-view forward mixes the stage sub-meshes' arrays with the
    full mesh's): its loss and logits of the first batch, what
    ``eval_batch`` and the forward compute."""
    with jax_pipe(pp, mp, dp):
        model = jfleet.distributed_model(m)
        opt = paddle.optimizer.AdamW(1e-3, parameters=model.parameters(),
                                     grad_clip=JaxClip(1.0))
        losses = [float(model.train_batch(
            (paddle.to_tensor(x.astype("int32")),
             paddle.to_tensor(y.astype("int32"))), opt)) for x, y in batches]
        state = {k: _np(v) for k, v in model.state_dict().items()}
    one = JaxGPTPipe(jax_gpt_config("gpt2-124m", **cfg), num_stages=1)
    one.set_state_dict({k: paddle.to_tensor(v) for k, v in state.items()})
    x, y = (paddle.to_tensor(a.astype("int32")) for a in batches[0])
    logits = one(x)
    return dict(losses=losses, state=state, logits=_np(logits),
                eval=float(one._default_loss(logits, y)),
                spmd=model._spmd is not None,
                param_shapes=[tuple(p.shape) for p in model.parameters()])


def _stage_keys(m, state, stage, num_stages):
    """The JAX model's state keys a stage holds (``run_function.0`` is
    the tied embedding: the first and the last stage)."""
    out = set()
    for k in state:
        i = int(k.split(".")[1])
        stages = {0, num_stages - 1} if i == 0 else \
            {m.get_stage_from_index(i)}
        if stage in stages:
            out.add(k)
    return out


# the heterogeneous MLP of tests/test_pipeline.py (JAX's host 1F1B lane)

def _jax_hetero(seed=11):
    def mse(out, y):
        return ((out - y) ** 2).mean()
    paddle.seed(seed)
    L = jpp.LayerDesc
    descs = [L(jnn.Linear, 8, 32), L(jnn.Tanh), L(jnn.Linear, 32, 16),
             L(jnn.Sigmoid), L(jnn.Linear, 16, 16), L(jnn.Linear, 16, 24),
             L(jnn.Tanh), L(jnn.Linear, 24, 8)]
    return jpp.PipelineLayer(descs, num_stages=4, loss_fn=mse)


def _mlp_batches(seed=5, n=2):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((8, 8)).astype(np.float32),
             rng.standard_normal((8, 8)).astype(np.float32))
            for _ in range(n)]


_STATE = {}


def _results(tmp_path_factory):
    """(JAX's results and models, the 2-rank and 4-rank outputs)."""
    if _STATE:
        return _STATE
    batches = _batches()
    runs = {**RUNS2, **RUNS4}
    models, states = {}, {}
    for key, (cfg, pp, mp, dp, chunks) in runs.items():
        models[key], states[key] = _jax_gpt(key, cfg, pp, mp, dp, chunks)
    with jax_pipe(4, accum=4):
        hetero = _jax_hetero()
        hetero_state = {k: _np(v) for k, v in hetero.state_dict().items()}
    mlp = _mlp_batches()
    gpt_in = dict(batches=batches, accum=ACCUM)
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        two = pool.submit(
            run_ranks, 2, "many", tmp_path_factory.mktemp("pp2"),
            {"cases": [("gpt", "pipe_gpt", dict(
                gpt_in, runs=RUNS2, states=states))]})
        four = pool.submit(
            run_ranks, 4, "many", tmp_path_factory.mktemp("pp4"),
            {"cases": [
                ("gpt", "pipe_gpt", dict(gpt_in, runs=RUNS4,
                                         states=states)),
                ("hetero", "pipe_hetero", dict(state=hetero_state,
                                               batches=mlp)),
                ("refusals", "pipe_refusals", {})]})
        want = {key: _jax_train(models[key], *runs[key][:4], batches)
                for key in runs}
        with jax_pipe(4, accum=4):
            with warnings.catch_warnings(record=True) as seen:
                warnings.simplefilter("always")
                jm = jfleet.distributed_model(hetero)
            opt = paddle.optimizer.SGD(0.1, parameters=hetero.parameters())
            hl = [float(jm.train_batch((paddle.to_tensor(x),
                                        paddle.to_tensor(y)), opt))
                  for x, y in mlp]
            want["hetero"] = dict(
                losses=hl, state={k: _np(v) for k, v in
                                  hetero.state_dict().items()},
                schedule=list(jm._host1f1b.last_schedule),
                plan=jm._host1f1b._plan(),
                warnings=[str(w.message) for w in seen])
        outs = {"pp2": two.result(), "pp4": four.result()}
    _STATE.update(want=want, models=models, states=states, outs=outs)
    return _STATE


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return _results(tmp_path_factory)


def _rank_results(res, key):
    outs = res["outs"]["pp2" if key in RUNS2 else "pp4"]
    return [o["gpt"][key] for o in outs]


@pytest.mark.parametrize("key", sorted({**RUNS2, **RUNS4}))
def test_gpt_pipe_train_batch_matches_jax(results, key):
    """Losses, the gathered state, eval_batch and the global-view logits
    on every rank against JAX's; JAX took its SPMD schedule."""
    want = results["want"][key]
    assert want["spmd"]
    for r, got in enumerate(_rank_results(results, key)):
        np.testing.assert_allclose(got["losses"], want["losses"],
                                   rtol=LOSS_RTOL, err_msg=f"{key} r{r}")
        assert sorted(got["state"]) == sorted(want["state"])
        for name, arr in want["state"].items():
            _close(got["state"][name], arr, f"{key} r{r} {name}")
        np.testing.assert_allclose(got["eval"], want["eval"],
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["logits"], want["logits"],
                                   atol=LOGIT_ATOL, rtol=0)
        assert got["kind"] == ("PipelineParallelWithInterleave"
                               if key == "interleave" else
                               "PipelineParallel")
        assert got["spmd"] and not got["warnings"]


@pytest.mark.parametrize("key", sorted({**RUNS2, **RUNS4}))
def test_each_rank_holds_only_its_stage(results, key):
    """A rank's state-dict keys are its stage's (JAX's names, the tied
    embedding on the first and the last stage) and its parameter count
    (mp parts counted whole) equals the JAX model's parameters of that
    stage: below the whole model's."""
    m, state = results["models"][key], results["states"][key]
    pp = {**RUNS2, **RUNS4}[key][1]
    total = sum(a.size for a in state.values())
    for got in _rank_results(results, key):
        keys = _stage_keys(m, state, got["stage"], pp)
        assert set(got["keys"]) == keys
        assert got["held"] == sum(state[k].size for k in keys) < total


def test_parameters_are_the_stage_not_stacked(results):
    """A deliberate divergence (ROADMAP Queue C): under JAX's SPMD
    schedule `PipelineParallel.parameters()` is the stacked ``[S, C,
    ...]`` body tensors and the edge parameters; the port's is the
    rank's own stage parameters (what its optimizer updates), so the
    packages are compared through ``state_dict``."""
    want = results["want"]["pp2"]["param_shapes"]
    assert any(s[:2] == (2, 1) for s in want)
    for got in _rank_results(results, "pp2"):
        assert got["opt_shapes"] == got["local_shapes"]
        assert not any(s[:2] == (2, 1) for s in got["opt_shapes"])
        assert sum(int(np.prod(s)) for s in got["opt_shapes"]) == \
            got["held"]


def test_schedule_is_1f1b_per_rank(results):
    """Each rank ran its stage's action list of JAX's `_plan` (M = 2)."""
    plan = JaxHost1F1B(_Stub(2), ACCUM, None)._plan()
    for key in ("pp2", "pp2mp2", "pp2dp2"):
        for got in _rank_results(results, key):
            s = got["stage"]
            assert [(op, m) for st, op, m in got["schedule"]] == plan[s]
            assert {st for st, _, _ in got["schedule"]} == {s}


def test_interleaved_lane_order(results):
    """The interleaved lane: a rank's forwards chunk by chunk, then its
    backwards in reverse (each micro-batch of a chunk once each way)."""
    for got in _rank_results(results, "interleave"):
        ops = [op for _, op, _ in got["schedule"]]
        assert ops == ["F"] * 4 + ["B"] * 4


def test_heterogeneous_stages_through_cross_rank_1f1b(results):
    """tests/test_pipeline.py's MLP at pp 4: JAX's fallback warning, the
    losses and weights of 2 SGD steps against JAX's host 1F1B, and each
    rank's order equal to JAX's plan row for its stage."""
    want = results["want"]["hetero"]
    outs = [o["hetero"] for o in results["outs"]["pp4"]]
    for r, got in enumerate(outs):
        np.testing.assert_allclose(got["losses"], want["losses"],
                                   rtol=LOSS_RTOL)
        for name, arr in want["state"].items():
            np.testing.assert_allclose(got["state"][name], arr, rtol=1e-4,
                                       atol=1e-5, err_msg=name)
        assert not got["spmd"]
        # JAX's words (the signatures inside come from a set: any order)
        assert [w.split(" (")[0] + w.split(");")[-1]
                for w in got["warnings"]] == \
            [w.split(" (")[0] + w.split(");")[-1] for w in want["warnings"]
             if "stackable" in w]
        assert [(op, m) for _, op, m in got["schedule"]] == \
            want["plan"][r]
        assert [(op, m) for s, op, m in want["schedule"] if s == r] == \
            want["plan"][r]


def test_refusals(results):
    """pp with a sharding degree (A8) and schedule="spmd" on stages JAX
    cannot stack raise."""
    for got in results["outs"]["pp4"]:
        assert "ROADMAP A8" in got["refusals"]["sharding"]
        assert got["refusals"]["spmd"] == "NotHomogeneous"


# ---------------------------------------------------------------------------
# in process: the partition, homogenize, the plan, the timetable
# ---------------------------------------------------------------------------

class _Stub:
    def __init__(self, s):
        self.s = s
        self._num_chunks = 1

    def get_num_stages(self):
        return self.s


@pytest.mark.parametrize("n", [1, 3, 7, 8, 10, 13])
def test_segment_uniform_matches_jax(n):
    for parts in (1, 2, 3, 4, 8):
        assert tpp.segment_uniform(n, parts) == jpp.segment_uniform(n, parts)


def _named(base, name):
    return type(name, (base,), {})


@pytest.mark.parametrize("pattern", ["EBBBBLH", "EBBBLH", "BBBBBB", "EH",
                                     "EBLBBLBH", "ELLLH"])
def test_segment_by_layer_matches_jax(pattern):
    """The same class names in both packages, each pattern over 1-4
    parts, the blocks' pattern and one that matches nothing."""
    names = {"E": "Embed", "B": "Block", "L": "Norm", "H": "Head"}
    jcls = {k: _named(jnn.Layer, v) for k, v in names.items()}
    tcls = {k: _named(torch.nn.Module, v) for k, v in names.items()}
    jd = [jpp.LayerDesc(jcls[c]) for c in pattern]
    td = [tpp.LayerDesc(tcls[c]) for c in pattern]
    for parts in (1, 2, 3, 4):
        for name in ("Block", "Missing"):
            assert tpp.segment_by_layer(td, parts, name) == \
                jpp.segment_by_layer(jd, parts, name), (parts, name)


@pytest.mark.parametrize("s", [1, 2, 3, 4, 6])
@pytest.mark.parametrize("m", [1, 2, 3, 4, 5, 8])
def test_plan_and_timetable(s, m):
    """`Host1F1B._plan` equals JAX's; the timetable runs every stage's
    list in order, each forward after its input's producer and each
    backward after its gradient's, and each action once."""
    plan = Host1F1B(_Stub(s), m, None)._plan()
    assert plan == JaxHost1F1B(_Stub(s), m, None)._plan()
    plans = [[(op, st, mi) for op, mi in row] for st, row in enumerate(plan)]
    seen, when = {st: [] for st in range(s)}, {}
    for t, tick in enumerate(timetable(plans, s)):
        for st, (op, v, mi) in tick.items():
            seen[st].append((op, mi))
            when[(op, v, mi)] = t
            if op == "F" and v > 0:
                assert when[("F", v - 1, mi)] < t
            if op == "B" and v < s - 1:
                assert when[("B", v + 1, mi)] < t
    assert [seen[st] for st in range(s)] == plan


def _homogenize_result(fn, parts):
    try:
        pre, body, post = fn(parts)
    except ValueError as e:
        return type(e).__name__
    return len(pre), [len(b) for b in body], len(post)


@pytest.mark.parametrize("case", ["gpt4_s2", "gpt4_s4", "gpt4_s2_c2",
                                  "gpt3_s2", "mlp_s2", "hetero_s4"])
def test_homogenize_matches_jax(case):
    """The same model in both packages (no pp axis: every part built in
    the one process): JAX's and the port's `homogenize` agree on each
    part structure, or both raise NotHomogeneous."""
    if case.startswith("gpt"):
        layers = int(case[3])
        s = int(case.split("_s")[1][0])
        c = 2 if case.endswith("c2") else 1
        cfg = dict(CFG, num_layers=layers)
        jm = JaxGPTPipe(jax_gpt_config("gpt2-124m", **cfg), num_stages=s,
                        num_virtual_pipeline_stages=c)
        tm = GPTForCausalLMPipe(gpt_config("gpt2-124m", **cfg),
                                num_stages=s, num_virtual_pipeline_stages=c,
                                device="cpu")
    elif case == "mlp_s2":
        jm = jpp.PipelineLayer([jpp.LayerDesc(jnn.Linear, 8, 8),
                                jpp.LayerDesc(jnn.Tanh)] * 2, num_stages=2)
        tm = tpp.PipelineLayer(
            [tpp.LayerDesc(Linear, 8, 8, device="cpu"),
             tpp.LayerDesc(torch.nn.Tanh)] * 2, num_stages=2)
    else:
        jm = _jax_hetero()
        tm = _port_hetero()
    want = _homogenize_result(jspmd.homogenize, jm._parts)
    assert _homogenize_result(tspmd.homogenize, tm._parts) == want


def _port_hetero():
    def lin(i, o):
        return tpp.LayerDesc(Linear, i, o, device="cpu")
    L = tpp.LayerDesc
    return tpp.PipelineLayer(
        [lin(8, 32), L(torch.nn.Tanh), lin(32, 16), L(torch.nn.Sigmoid),
         lin(16, 16), lin(16, 24), L(torch.nn.Tanh), lin(24, 8)],
        num_stages=4, loss_fn=lambda o, y: ((o - y) ** 2).mean())


def test_spmd_schedule_refuses_what_jax_refuses():
    """``schedule="spmd"`` on stages without one structure (or without a
    matching pp axis) raises `NotHomogeneous` in both packages; ``auto``
    falls back to the 1F1B with JAX's warning."""
    with pytest.raises(jspmd.NotHomogeneous):
        jspmd.SPMDPipeline(_jax_hetero(), 4)
    with pytest.raises(tspmd.NotHomogeneous):
        PipelineParallel(_port_hetero(),
                         strategy=_strategy(DistributedStrategy, 4,
                                            schedule="spmd"))
    with pytest.warns(UserWarning, match="host-scheduled 1F1B"):
        pp = PipelineParallel(_port_hetero(),
                              strategy=_strategy(DistributedStrategy, 4))
    assert pp._host1f1b is not None and pp._spmd is None


def test_one_process_pipeline_equals_the_whole_batch():
    """pp 1 with every stage in the process: `train_batch` over 2
    micro-batches equals one step on the whole batch by hand (the loss
    and each parameter), and remat gives the same step."""
    from paddle_tpu_torch.optimizer import SGD
    cfg = gpt_config("gpt2-124m", **CFG)
    (ids, labels), = _batches(n=1)
    ids, labels = torch.tensor(ids), torch.tensor(labels)
    ref = GPTForCausalLMPipe(cfg, device="cpu", seed=3)
    opt = SGD(0.1, parameters=ref.parameters())
    loss = ref._loss_fn(ref.run_part(0, ids), labels)
    loss.backward()
    opt.step()
    for remat in (False, True):
        m = GPTForCausalLMPipe(cfg, num_stages=2, device="cpu", seed=3)
        with pytest.warns(UserWarning):
            pp = PipelineParallel(m, strategy=_strategy(
                DistributedStrategy, 2, remat=remat))
        got = pp.train_batch((ids, labels), SGD(0.1,
                                                parameters=pp.parameters()))
        np.testing.assert_allclose(float(got), float(loss.detach()), rtol=1e-6)
        want = ref.state_dict()
        for k, v in m.state_dict().items():
            np.testing.assert_allclose(v.numpy(), want[k].numpy(),
                                       rtol=1e-5, atol=1e-7, err_msg=k)
