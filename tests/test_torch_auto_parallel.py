"""The port's semi-auto parallel API (`distributed/api.py`,
`placement.commit_param` / `placements_to_spec`, `reshard.
partition_from_tensor`) against the JAX package: on 4 gloo ranks over a
dp 2 × mp 2 mesh (`_torch_dist_worker.case_auto_parallel`), each rank's
part of ``shard_tensor`` and of each ``reshard`` move equals
`placement.local_slice` of JAX's global array (bit for bit), and
``unshard_dtensor`` gives JAX's global array back; ``dtensor_from_fn``,
``shard_constraint``'s gradient, ``Partial``'s refusal (JAX's words),
``shard_layer``'s output and weight gradient (a weight ``Shard(1)`` over
mp: the layer computes JAX's global output) and ``partition_from_tensor``
against JAX's.  Products summed in another order: 1e-6 relative.
"""
import numpy as np
import pytest

import paddle_tpu as paddle
import paddle_tpu.distributed as jdist
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.distributed import mesh as jmesh
from paddle_tpu.distributed.reshard import MeshSpec as JaxMeshSpec
from paddle_tpu.distributed.reshard import \
    partition_from_tensor as jax_partition

from paddle_tpu_torch.distributed import ProcessMesh
from paddle_tpu_torch.distributed import api, placement

from _torch_dist_worker import run_ranks

PLACEMENTS = {
    "s0_r": ("S(0)", "R()"), "r_s1": ("R()", "S(1)"),
    "s0_s1": ("S(0)", "S(1)"), "s1_s0": ("S(1)", "S(0)"),
    "both_dim0": ("S(0)", "S(0)"), "r_r": ("R()", "R()"),
}
MOVES = {
    "shard_to_replicate": (("S(0)", "R()"), ("R()", "R()")),
    "replicate_to_shard": (("R()", "R()"), ("R()", "S(1)")),
    "all_to_all": (("S(0)", "R()"), ("S(1)", "R()")),
    "swap_axes": (("S(0)", "S(1)"), ("S(1)", "S(0)")),
    "both_to_one": (("S(0)", "S(0)"), ("R()", "S(1)")),
    "one_to_both": (("R()", "S(1)"), ("S(0)", "S(0)")),
}
S, R = placement.Shard, placement.Replicate
JS, JR = jdist.Shard, jdist.Replicate


def _port(pl):
    return [eval(p) for p in pl]


def _jax(pl):
    return [eval(p.replace("S(", "JS(").replace("R(", "JR(")) for p in pl]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    rng = np.random.default_rng(0)
    inputs = {"x": rng.standard_normal((8, 16)).astype(np.float32),
              "w": rng.standard_normal((8, 8)).astype(np.float32),
              "b": rng.standard_normal(8).astype(np.float32),
              "xin": rng.standard_normal((2, 8)).astype(np.float32),
              "placements": PLACEMENTS, "moves": MOVES}
    outs = run_ranks(4, "auto_parallel", tmp_path_factory.mktemp("auto"),
                     inputs)
    return inputs, outs


@pytest.fixture
def jax_mesh():
    saved = jmesh._DEFAULT[0]
    mesh = jdist.init_mesh([2, 2], ["dp", "mp"])
    jdist.set_mesh(mesh)
    yield mesh
    jmesh._DEFAULT[0] = saved


def _pmesh():
    return ProcessMesh(np.arange(4).reshape(2, 2), ["dp", "mp"])


@pytest.mark.parametrize("key", sorted(PLACEMENTS))
def test_shard_tensor_parts_are_local_slices_of_jax(key, ranks, jax_mesh):
    inputs, outs = ranks
    t = jdist.shard_tensor(Tensor(inputs["x"]), jax_mesh,
                           _jax(PLACEMENTS[key]))
    glob = np.asarray(t._data_)
    for r, res in enumerate(outs):
        part, pl = res["parts"][key]
        want = placement.local_slice(glob, _pmesh(), _port(PLACEMENTS[key]),
                                     rank=r)
        np.testing.assert_array_equal(part, want)
        assert pl == [repr(p) for p in t.placements]


@pytest.mark.parametrize("key", sorted(MOVES))
def test_reshard_moves_against_jax(key, ranks, jax_mesh):
    """Each move's part equals local_slice of JAX's resharded global
    array; unshard_dtensor gives it back whole on every rank."""
    inputs, outs = ranks
    src, dst = MOVES[key]
    t = jdist.shard_tensor(Tensor(inputs["x"]), jax_mesh, _jax(src))
    moved = jdist.reshard(t, jax_mesh, _jax(dst))
    glob = np.asarray(moved._data_)
    whole = jdist.unshard_dtensor(moved).numpy()
    for r, res in enumerate(outs):
        part, back = res["moves"][key]
        np.testing.assert_array_equal(
            part, placement.local_slice(glob, _pmesh(), _port(dst), rank=r))
        np.testing.assert_array_equal(back, whole)


def test_dtensor_from_fn_and_partial(ranks, jax_mesh):
    inputs, outs = ranks
    t = jdist.dtensor_from_fn(paddle.ones, jax_mesh, [JS(0), JR()], [4, 2])
    with pytest.raises(NotImplementedError) as jerr:
        jdist.shard_tensor(Tensor(inputs["x"]), jax_mesh,
                           [jdist.Partial(), JR()])
    for r, res in enumerate(outs):
        np.testing.assert_array_equal(
            res["from_fn"], placement.local_slice(
                np.asarray(t._data_), _pmesh(), [S(0), R()], rank=r))
        assert res["partial"] == str(jerr.value)


def test_shard_constraint_gradient(ranks, jax_mesh):
    """The move inside a forward carries its gradient: each rank's sum of
    its part's squares, backward through the slice (an all-gather),
    gives JAX's gradient of the constrained global sum."""
    inputs, outs = ranks
    w = Tensor(inputs["x"], stop_gradient=False)
    c = jdist.shard_constraint(w, jax_mesh, [JS(0), JS(1)])
    (c * c).sum().backward()
    for res in outs:
        np.testing.assert_allclose(res["constraint_grad"], w.grad.numpy(),
                                   rtol=1e-6)


def test_shard_layer_output_and_gradient(ranks, jax_mesh):
    """A Linear whose weight is Shard(1) over mp: each rank keeps its
    columns and gathers them on use, so the layer's output is JAX's
    global one; the weight's gradient is the rank's part of JAX's."""
    inputs, outs = ranks
    lin = paddle.nn.Linear(8, 8)
    lin.weight.set_value(inputs["w"])
    lin.bias.set_value(inputs["b"])

    def shard_fn(name, layer, mesh):
        if isinstance(layer, paddle.nn.Linear):
            layer.weight.placements = [JR(), JS(1)]
    jdist.shard_layer(lin, jax_mesh, shard_fn)
    y = lin(Tensor(inputs["xin"]))
    y.sum().backward()
    gw = lin.weight.grad.numpy()
    for r, res in enumerate(outs):
        got = res["layer"]
        np.testing.assert_allclose(got["out"], y.numpy(), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_array_equal(
            got["weight_part"], placement.local_slice(
                inputs["w"], _pmesh(), [R(), S(1)], rank=r))
        np.testing.assert_allclose(
            got["weight_grad"], placement.local_slice(
                gw, _pmesh(), [R(), S(1)], rank=r), rtol=1e-6, atol=1e-6)
        assert got["placements"] == [repr(p) for p in lin.weight.placements]


def test_partition_from_tensor_and_spec(ranks, jax_mesh):
    inputs, outs = ranks
    spec = JaxMeshSpec(["dp", "mp"], [2, 2])
    x = Tensor(inputs["x"])
    want = [jax_partition(jdist.shard_tensor(x, jax_mesh, [JS(0), JS(1)]),
                          spec),
            jax_partition(jdist.shard_tensor(x, jax_mesh, [JR(), JS(0)]),
                          spec),
            jax_partition(x, spec)]
    jspec = tuple(jdist.placements_to_spec(jax_mesh, [JS(0), JS(1)], 2))
    for res in outs:
        assert [tuple(p) for p in res["partition"]] == want
        assert tuple(res["spec"]) == jspec
    back = placement.spec_to_placements(_pmesh(), jspec, 2)
    assert back == [S(0), S(1)]


def test_commit_param_keeps_identity_and_refuses_a_gather():
    """commit_param: the rank keeps its part in a new contiguous tensor,
    the parameter object stays; a part it holds is not gathered back."""
    import torch
    mesh = ProcessMesh(np.arange(1).reshape(1, 1), ["dp", "mp"])
    p = torch.nn.Parameter(torch.arange(8.0).reshape(4, 2))
    q = placement.commit_param(p, mesh, [S(0), R()])
    assert q is p and p.is_dist_param and p.placements == [S(0), R()]
    assert p.process_mesh == mesh and p.shape == (4, 2)
    two = ProcessMesh(np.arange(2).reshape(2, 1), ["dp", "mp"])
    p.placements, p.process_mesh = [S(0), R()], two
    with pytest.raises(ValueError, match="not gathered here"):
        placement.commit_param(p, two, [R(), R()])
    assert api.shard_constraint(torch.ones(2), None) is not None
