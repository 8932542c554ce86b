"""The port's ZeRO sharding (`distributed/fleet/sharding.py`) against the
JAX package: JAX's own recipe (benchmarks/run.py config 3: fleet.init
with a sharding degree, ``strategy.sharding`` at stage 3,
distributed_model, AdamW with the global-norm clip,
group_sharded_parallel, distributed_optimizer, the batch placed by
shard_tensor, eager steps) on the tiny parallel GPT at sharding 2 × mp 2
and the tiny parallel Llama at dp 2 × sharding 2, at each of the levels
``os``, ``os_g`` and ``p_g_os``, 4 gloo ranks (`_torch_dist_worker`)
against JAX's hybrid mesh over 4 CPU devices on the same global state and
batches; each parameter's placements against JAX's; a batch sharded over
both dp and sharding; JAX's test_sharding_stage1_optimizer_states and
test_sharding_stage3_params at sharding 4; save_group_sharded_model read
by JAX's ``paddle.load``; the compiled step's `MeshFallbackWarning`
against JAX's; and `utils.cpp_extension.load`'s build options.

Tolerances (fp32 on both sides), test_torch_hybrid.py's rule: losses
within 1e-5 relative (the row-parallel sums and the ZeRO averages run in
other orders than XLA's); parameters after 3 AdamW steps all but 1 in
10^4 elements within 2e-5 absolute, every element within 2e-5 + 1e-2
relative (AdamW moves an element by ~lr whatever its gradient's size).
"""
import contextlib
import warnings

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.distributed as jdist
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.distributed import mesh as jmesh
from paddle_tpu.distributed import topology as jtopo
from paddle_tpu.distributed.fleet import base as jbase
from paddle_tpu.framework import train_step as jts
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import ParallelGPTForCausalLM as JaxPGPT
from paddle_tpu.models import ParallelLlamaForCausalLM as JaxPLlama
from paddle_tpu.models.gpt import gpt_config as jax_gpt_config
from paddle_tpu.models.llama import llama_config as jax_llama_config

from paddle_tpu_torch.distributed import ProcessMesh
from paddle_tpu_torch.framework import CompiledTrainStep
from paddle_tpu_torch.framework.train_step import MeshFallbackWarning
from paddle_tpu_torch.kernels import adam as port_adam
from paddle_tpu_torch.nn.layers import Linear
from paddle_tpu_torch.optimizer import SGD
from paddle_tpu_torch.utils import cpp_extension

from _torch_dist_worker import run_ranks

LOSS_RTOL = 1e-5
PARAM_ATOL = 2e-5
PARAM_RTOL = 1e-2
SEQ = 32
GPT_CFG = dict(num_layers=2, hidden_size=64, num_heads=4, vocab_size=256,
               max_seq_len=SEQ)
LLAMA_CFG = dict(max_seq_len=SEQ)
LEVELS = ("os", "os_g", "p_g_os")


def _close(got, want, what):
    err = np.abs(got - want)
    off = int(np.sum(err > PARAM_ATOL))
    assert off <= max(1, err.size // 10000), (what, off, float(err.max()))
    np.testing.assert_allclose(got, want, rtol=PARAM_RTOL, atol=PARAM_ATOL,
                               err_msg=what)


@contextlib.contextmanager
def jax_hybrid(dp, sharding, mp, stage3=False):
    """JAX's hybrid topology over the first dp × sharding × mp CPU devices
    with a fleet strategy (``sharding`` on for stage 3), the package's
    mesh and fleet state put back after."""
    saved = (jmesh._DEFAULT[0], jtopo.get_hybrid_communicate_group(),
             dict(jbase._fleet_state))
    n = dp * sharding * mp
    hcg = jtopo.HybridCommunicateGroup(
        dp_degree=dp, mp_degree=mp, sharding_degree=sharding,
        devices=jax.devices()[:n])
    jtopo.set_hybrid_communicate_group(hcg)
    s = jfleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": dp, "mp_degree": mp,
                        "sharding_degree": sharding}
    if stage3:
        s.sharding = True
        s.sharding_configs = {"stage": 3}
    jbase._fleet_state.update(initialized=True, strategy=s)
    try:
        yield hcg
    finally:
        jmesh._DEFAULT[0] = saved[0]
        jtopo.set_hybrid_communicate_group(saved[1])
        jbase._fleet_state.clear()
        jbase._fleet_state.update(saved[2])


def _batches(vocab, n=4, b=4, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, (b, SEQ)).astype(np.int64),
             rng.integers(0, vocab, (b, SEQ)).astype(np.int64))
            for _ in range(n)]


def _jax_zero(jm, level, batches, batch_axes):
    """JAX's recipe on ``jm`` (built under the hybrid mesh): the losses,
    the state, each parameter's placements, and the model and
    optimizer."""
    jfleet.distributed_model(jm)
    opt = paddle.optimizer.AdamW(
        learning_rate=1e-3, parameters=jm.parameters(), weight_decay=0.01,
        grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0))
    jm, opt, _ = jfleet.group_sharded_parallel(jm, opt, level=level)
    opt = jfleet.distributed_optimizer(opt)
    mesh = jdist.get_mesh()
    place = [jdist.Shard(0) if n in batch_axes else jdist.Replicate()
             for n in mesh.dim_names]
    losses = []
    for ids, labels in batches:
        x = jdist.shard_tensor(Tensor(ids.astype(np.int32)), mesh, place,
                               stop_gradient=True)
        y = jdist.shard_tensor(Tensor(labels), mesh, place,
                               stop_gradient=True)
        _, loss = jm(x, labels=y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.numpy()))
    state = {k: np.asarray(v._data_) for k, v in jm.state_dict().items()}
    placements = {n: [repr(p) for p in p_.placements]
                  for n, p_ in jm.named_parameters()}
    return losses, state, placements, jm


_RUNS = {}

#: (model, dp, sharding, mp, batch axes): the configurations run
CONFIGS = {
    "gpt": ("gpt", 1, 2, 2, ("dp",)),
    "llama": ("llama", 2, 2, 1, ("dp",)),
    "llama-rows": ("llama", 2, 2, 1, ("dp", "sharding")),
    "gpt-recompute": ("gpt", 1, 2, 2, ("dp",)),
}
#: the configurations run at stage 3 only
STAGE3_ONLY = ("llama-rows", "gpt-recompute")


def _run(which, tmp_path_factory):
    """(JAX's results a level, the ranks' results a level) of
    ``which``'s configuration, run once: every level in one group of
    4 ranks."""
    if which in _RUNS:
        return _RUNS[which]
    model, dp, sh, mp, axes = CONFIGS[which]
    levels = ("p_g_os",) if which in STAGE3_ONLY else LEVELS
    if model == "gpt":
        vocab, cfg = 256, dict(GPT_CFG,
                               use_recompute=which == "gpt-recompute")
        mk = lambda: JaxPGPT(jax_gpt_config("gpt2-124m", **cfg))  # noqa: E731
    else:
        vocab, cfg = 512, LLAMA_CFG
        mk = lambda: JaxPLlama(jax_llama_config("tiny", **cfg))  # noqa: E731
    batches = _batches(vocab, b=8 if which == "llama-rows" else 4)
    train, extra = batches[:3], batches[3]
    want, state = {}, None
    save = str(tmp_path_factory.mktemp(f"save-{which}") / "zero")
    for level in levels:
        with jax_hybrid(dp, sh, mp, stage3=level == "p_g_os"):
            paddle.seed(11)
            jm = mk()
            if state is None:
                state = {k: np.asarray(v._data_).copy()
                         for k, v in jm.state_dict().items()}
            losses, jstate, placements, jm = _jax_zero(jm, level, train,
                                                       axes)
            ids, labels = extra
            _, nxt = jm(Tensor(ids.astype(np.int32)), labels=Tensor(labels))
            want[level] = dict(losses=losses, state=jstate,
                               placements=placements,
                               next=float(nxt.numpy()))
    cases = [(level, "zero", dict(
        level=level, dp=dp, sharding=sh, mp=mp, model=model, cfg=cfg,
        state=state, batches=train, batch_axes=axes,
        save=save if level == "p_g_os" else None)) for level in levels]
    outs = run_ranks(4, "many", tmp_path_factory.mktemp(which),
                     {"cases": cases})
    _RUNS[which] = (want, outs, extra, cfg, save)
    return _RUNS[which]


PAIRS = [("gpt", lv) for lv in LEVELS] + [("llama", lv) for lv in LEVELS] \
    + [(which, "p_g_os") for which in STAGE3_ONLY]


@pytest.mark.parametrize("which,level", PAIRS)
def test_zero_losses_match_jax(which, level, tmp_path_factory):
    want, outs, *_ = _run(which, tmp_path_factory)
    for res in outs:
        np.testing.assert_allclose(res[level]["losses"],
                                   want[level]["losses"], rtol=LOSS_RTOL)


@pytest.mark.parametrize("which,level", PAIRS)
def test_zero_parameters_match_jax(which, level, tmp_path_factory):
    """The gathered parameters after 3 AdamW steps against JAX's (the
    module rule); every rank gathers the same bits."""
    want, outs, *_ = _run(which, tmp_path_factory)
    for name, w in want[level]["state"].items():
        _close(outs[0][level]["state"][name], w, f"{level} {name}")
        for res in outs[1:]:
            np.testing.assert_array_equal(res[level]["state"][name],
                                          outs[0][level]["state"][name])


@pytest.mark.parametrize("which,level", PAIRS)
def test_zero_placements_match_jax(which, level, tmp_path_factory):
    """Each parameter's placements equal JAX's (the sharding axis only
    where dim 0 tiles and mp does not split dim 0: the row-parallel
    weights and the vocabulary stay whole over it); its local part is
    the shape they give, and the moments cover the rows."""
    want, outs, *_ = _run(which, tmp_path_factory)
    for res in outs:
        got = res[level]
        assert got["placements"] == want[level]["placements"]
        assert got["mesh"] == ["pp", "dp", "sharding", "sep", "mp"]
        sh = got["mesh"].index("sharding")
        _, dp, sharding, mp, _ = CONFIGS[which]
        sizes = [1, dp, sharding, 1, mp]
        for name, pl in got["placements"].items():
            local = list(want[level]["state"][name].shape)
            for n, p in zip(sizes, pl):
                if p.startswith("Shard"):
                    local[int(p[len("Shard(dim="):-1])] //= n
            if pl[sh].startswith("Shard"):
                assert level == "p_g_os", name
            assert got["local_shapes"][name] == tuple(local), name
    if level != "p_g_os":
        # stages 1 and 2: parameters whole over sharding, moments rows
        for res in outs:
            assert all(not p[sh].startswith("Shard")
                       for p in res[level]["placements"].values())
            assert any(m[0] * 2 == s[0] for m, s in zip(
                res[level]["moment_shapes"],
                res[level]["local_shapes"].values()))


def test_zero_collectives_by_stage(tmp_path_factory):
    """Stage 1 all-reduces the gradients and all-gathers the parameters;
    stage 2 reduce-scatters; stage 3 reduce-scatters in the backward and
    gathers parameters on use, again to rebuild the saved ones."""
    _, outs, *_ = _run("gpt", tmp_path_factory)
    c = {lv: outs[0][lv]["coll"] for lv in LEVELS}
    assert "reduce_scatter" not in c["os"] and c["os"]["all_gather"] > 0
    assert c["os_g"]["reduce_scatter"] > 0
    assert c["p_g_os"]["all_gather"] > c["os_g"]["all_gather"]
    assert outs[0]["p_g_os"]["regathers"] > 0
    assert outs[0]["os"]["regathers"] == outs[0]["os_g"]["regathers"] == 0


def test_zero_stage3_under_recompute(tmp_path_factory):
    """With ``use_recompute`` each block is run again in the backward,
    which gathers its parameters a third time instead of rebuilding the
    saved ones; each gradient is still reduce-scattered once a step."""
    _, plain, *_ = _run("gpt", tmp_path_factory)
    _, outs, *_ = _run("gpt-recompute", tmp_path_factory)
    a, b = plain[0]["p_g_os"], outs[0]["p_g_os"]
    assert b["coll"]["reduce_scatter"] == a["coll"]["reduce_scatter"]
    assert b["coll"]["all_gather"] > a["coll"]["all_gather"]
    assert b["regathers"] < a["regathers"]


def test_zero_batch_rows_over_sharding(tmp_path_factory):
    """A batch sharded over dp and sharding: each rank holds 2 of the 8
    rows, its loss the mean over them; the world mean is JAX's."""
    want, outs, *_ = _run("llama-rows", tmp_path_factory)
    assert {r["p_g_os"]["rows"] for r in outs} == {2}
    assert len({r["p_g_os"]["rank_loss"] for r in outs}) > 1


@pytest.mark.parametrize("which", ["gpt", "llama"])
def test_save_group_sharded_model_loads_into_jax(which, tmp_path_factory):
    """save_group_sharded_model after the stage-3 run: JAX's paddle.load
    reads the full state (the gathered arrays bit for bit); a one-device
    JAX model loaded from it gives JAX's stage-3 run's next loss."""
    want, outs, (ids, labels), cfg, save = _run(which, tmp_path_factory)
    loaded = paddle.load(outs[0]["p_g_os"]["saved"])
    got = {k: np.asarray(v._data_ if hasattr(v, "_data_") else v)
           for k, v in loaded.items()}
    assert sorted(got) == sorted(want["p_g_os"]["state"])
    for k, v in got.items():
        np.testing.assert_array_equal(v, outs[0]["p_g_os"]["state"][k])
    if which == "gpt":
        paddle.seed(0)
        jm = JaxGPT(jax_gpt_config("gpt2-124m", **cfg))
        jm.set_state_dict({k: Tensor(v) for k, v in got.items()})
        _, loss = jm(Tensor(ids.astype(np.int32)), labels=Tensor(labels))
        np.testing.assert_allclose(float(loss.numpy()),
                                   want["p_g_os"]["next"], rtol=1e-4)


def test_jax_stage_unit_cases_at_sharding_4(tmp_path_factory):
    """JAX's test_sharding_stage1_optimizer_states (level os_g: the
    weight's moment1 split over sharding) and test_sharding_stage3_params
    (p_g_os: the weight itself split, and changed by a step) at
    sharding 4, each against JAX on the same weights and input."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((16, 16)).astype(np.float32)
    b = rng.standard_normal(16).astype(np.float32)
    x = rng.standard_normal((4, 16)).astype(np.float32)
    want = {}
    for level in ("os_g", "p_g_os"):
        with jax_hybrid(1, 4, 1):
            model = paddle.nn.Linear(16, 16)
            model.weight.set_value(w)
            model.bias.set_value(b)
            if level == "os_g":
                jfleet.distributed_model(model)
            opt = paddle.optimizer.AdamW(0.01,
                                         parameters=model.parameters())
            model, opt, _ = jfleet.group_sharded_parallel(model, opt,
                                                          level=level)
            placements = [repr(p) for p in model.weight.placements]
            loss = model(Tensor(x)).mean()
            loss.backward()
            opt.step()
            opt.clear_grad()
            moment = opt._state["moment1"][0]
            want[level] = dict(
                placements=placements,
                moment_spec=str(moment._data_.sharding.spec),
                weight=np.asarray(model.weight._data_))
    outs = run_ranks(4, "zero_stage_units",
                     tmp_path_factory.mktemp("units"),
                     {"state": {"weight": w, "bias": b}, "x": x})
    for res in outs:
        s1, s3 = res["os_g"], res["p_g_os"]
        assert "sharding" in want["os_g"]["moment_spec"]
        assert s1["moment1"][0] == (4, 16)          # the weight's rows
        assert s1["zero_kinds"] == ["rows", "rows"]
        assert s3["placements"]["weight"] == want["p_g_os"]["placements"]
        assert s3["local"]["weight"] == (4, 16)
        assert s3["zero_kinds"] == ["param", "param"]
        assert not np.allclose(s3["state"]["weight"], w)
        for level in ("os_g", "p_g_os"):
            np.testing.assert_allclose(res[level]["state"]["weight"],
                                       want[level]["weight"], rtol=1e-5,
                                       atol=1e-6)


def test_compiled_step_takes_the_eager_lane_with_jax_warning():
    """A mesh with a sharding axis above 1: the compiled step warns one
    `MeshFallbackWarning` naming the axis and runs the eager step, as
    JAX's; a ZeRO optimizer without a mesh is refused with JAX's
    "ZeRO-sharded accumulators" reason."""
    from paddle_tpu_torch.distributed.fleet.sharding import ZeroState
    net = Linear(2, 2, device="cpu")
    opt = SGD(0.1, parameters=net.parameters())
    mesh = ProcessMesh(np.arange(2).reshape(1, 2), ["dp", "sharding"])
    with pytest.warns(MeshFallbackWarning,
                      match="mesh axis 'sharding' cannot run inside one "
                            "compiled program") as got:
        cs = CompiledTrainStep(lambda x, y: ((net(x) - y) ** 2).mean(),
                               opt, mesh=mesh)
    assert not cs.compiled and "sharding" in cs.fallback_reason
    x, y = torch.ones(3, 2), torch.zeros(3, 2)
    before = net.weight.detach().clone()
    cs(x, y)
    assert not torch.equal(before, net.weight.detach())
    # JAX: the same warning class name and message
    with jax_hybrid(1, 2, 1):
        jnet = paddle.nn.Linear(2, 2)
        jopt = paddle.optimizer.SGD(0.1, parameters=jnet.parameters())
        jcs = jts.CompiledTrainStep(
            lambda a, b: ((jnet(a) - b) ** 2).mean(), jopt,
            mesh=jdist.get_mesh())
        with warnings.catch_warnings(record=True) as jw:
            warnings.simplefilter("always")
            jcs(Tensor(np.ones((3, 2), np.float32)),
                Tensor(np.zeros((3, 2), np.float32)))
    jmsg = [str(w.message) for w in jw
            if w.category.__name__ == "MeshFallbackWarning"]
    assert jmsg and str(got[0].message) == jmsg[0]
    # a ZeRO plan on the optimizer: JAX's accumulator reason
    opt2 = SGD(0.1, parameters=net.parameters())
    opt2._zero = ZeroState(None, 1)
    with pytest.warns(UserWarning, match="ZeRO-sharded accumulators"):
        cs2 = CompiledTrainStep(lambda a, b: net(a).sum(), opt2)
    assert cs2.fallback_reason == "ZeRO-sharded accumulators (fleet.sharding)"


def test_adam_vector_path_rule():
    """The Adam kernel's vector path (csrc/adam.cu `launch`): w, m1, m2
    16-byte aligned, g and p aligned to four elements; a slice at an odd
    offset takes the scalar path, which the wrapper counts."""
    w = torch.zeros(64)
    g = torch.zeros(64, dtype=torch.bfloat16)
    assert port_adam.vector_path(w, g, w, w, g)
    assert not port_adam.vector_path(w[1:], g[1:], w[1:], w[1:])
    assert not port_adam.vector_path(w, g[2:], w, w)
    assert port_adam.vector_path(w[4:], g[4:], w[4:], w[4:], g[4:])


def test_cpp_extension_build_options(tmp_path, capsys):
    """load's JAX options: an extra define and an include path build a
    small host source into the given build directory; verbose prints
    the command; another flag builds another library."""
    inc = tmp_path / "inc"
    inc.mkdir()
    (inc / "answer.h").write_text("#define BASE 40\n")
    src = tmp_path / "answer.cpp"
    src.write_text('#include "answer.h"\n#include <Python.h>\n'
                   'extern "C" int answer() { return BASE + EXTRA; }\n')
    build = tmp_path / "build"
    lib = cpp_extension.load("answer", [str(src)],
                             extra_cflags=["-DEXTRA=2"],
                             extra_ldflags=["-lm"],
                             extra_include_paths=[str(inc)],
                             build_directory=str(build), verbose=True,
                             with_python=True)
    assert lib.answer() == 42
    assert "-DEXTRA=2" in capsys.readouterr().out
    built = list(build.glob("host-*/libanswer.so"))
    assert len(built) == 1
    lib3 = cpp_extension.load("answer", [str(src)],
                              extra_cflags=["-DEXTRA=3"],
                              extra_include_paths=[str(inc)],
                              build_directory=str(build), with_python=True)
    assert lib3.answer() == 43
    assert len(list(build.glob("host-*/libanswer.so"))) == 2
