"""The port's in-graph collectives (`paddle_tpu_torch.distributed.
functional`) against the JAX package's under ``shard_map``, at 2 and 4
ranks: each op's value and its gradient.

JAX runs each op inside ``jax.shard_map`` over a mesh of N CPU devices
with the axis ``"dp"``, ``in_specs`` and ``out_specs`` over that axis (a
rank's output is its own), and takes ``jax.vjp`` with a cotangent drawn
from a seed.  The port's ranks (gloo processes, `_torch_dist_worker`,
dp = N) run the op on their blocks of the same input and backpropagate
``sum(y * w)`` with their blocks of the cotangent: the global loss is
the sum of the ranks' losses, which is the function JAX differentiates.
psum's transpose is then the psum of the cotangents (not the identity
a replicated output would give).  Max and min have no differentiation
rule in JAX; the port's backward raises JAX's message.

Tolerance: values and gradients equal to JAX's within 1e-6 relative and
absolute (fp32 sums of up to 4 terms in another order).
"""
import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

from paddle_tpu.distributed import functional as JFn

from _torch_dist_worker import run_ranks

RTOL = ATOL = 1e-6


def _ops(n):
    """``name: (fn, kwargs, local input shape)`` of the cases at n
    ranks."""
    return {
        "sum": ("all_reduce", dict(op="sum"), (2, 3)),
        "avg": ("all_reduce", dict(op="avg"), (2, 3)),
        "mean": ("all_reduce", dict(op="mean"), (2, 3)),
        "max": ("all_reduce", dict(op="max"), (2, 3)),
        "min": ("all_reduce", dict(op="min"), (2, 3)),
        "gather0": ("all_gather", dict(axis=0), (2, 3)),
        "gather1": ("all_gather", dict(axis=1), (2, 3)),
        "gather_stack": ("all_gather", dict(axis=1, tiled=False), (2, 3)),
        "scatter0": ("reduce_scatter", dict(axis=0), (2 * n, 3)),
        "scatter1": ("reduce_scatter", dict(axis=1), (2, 3 * n)),
        "scatter_stack": ("reduce_scatter", dict(axis=0, tiled=False),
                          (n, 3)),
        "a2a": ("all_to_all", dict(split_axis=0, concat_axis=1),
                (2 * n, 3)),
        "a2a_t": ("all_to_all", dict(split_axis=1, concat_axis=0),
                  (2, 3 * n)),
        "a2a_stack": ("all_to_all", dict(split_axis=0, concat_axis=0,
                                         tiled=False), (n, 3)),
        "a2a_stack_t": ("all_to_all", dict(split_axis=0, concat_axis=1,
                                           tiled=False), (n, 3)),
        "shift_right": ("shift_right", dict(size=n), (2, 3)),
        "shift_left": ("shift_left", dict(size=n), (2, 3)),
        "partial": ("ppermute", dict(perm=[(0, n - 1)]), (2, 3)),
        "bcast": ("broadcast_from", dict(src=1), (2, 3)),
    }


def _jax_op(n, fn, kw):
    """JAX's op under shard_map over n devices."""
    mesh = Mesh(np.array(jax.devices()[:n]), ("dp",))
    return jax.shard_map(lambda a: getattr(JFn, fn)(a, "dp", **kw),
                         mesh=mesh, in_specs=P("dp"), out_specs=P("dp"))


#: JAX's vjp rejects its own cotangent there (an untiled all-to-all whose
#: split and concat axes differ): the value is held against JAX's, the
#: gradient by its adjoint identity
NO_JAX_GRAD = ("a2a_stack_t",)


def _jax_case(f, x, w):
    """(y, dx or the differentiation error) of ``f`` at ``x``, ``w``."""
    if w is None:
        return np.asarray(f(x)), None
    try:
        y, vjp = jax.vjp(f, jnp.asarray(x))
    except NotImplementedError as e:
        return np.asarray(f(x)), str(e).splitlines()[0]
    return np.asarray(y), np.asarray(vjp(jnp.asarray(w))[0])


_RUNS = {}


@pytest.fixture(scope="module", params=[2, 4])
def run(request, tmp_path_factory):
    """(the cases, JAX's results, each rank's) at n ranks."""
    n = request.param
    if n not in _RUNS:
        rng = np.random.default_rng(n)
        ops, want, inputs, cases = _ops(n), {}, {}, {}
        for name, (fn, kw, shape) in ops.items():
            x = rng.standard_normal((n * shape[0],) + shape[1:]).astype(
                np.float32)
            f = _jax_op(n, fn, kw)
            w = rng.standard_normal(jax.eval_shape(f, x).shape).astype(
                np.float32)
            cases[name] = (f, x, w)
            inputs[name] = (fn, kw, np.split(x, n), np.split(w, n))
        # the ranks run while JAX compiles
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            ranks = pool.submit(run_ranks, n, "functional",
                                tmp_path_factory.mktemp("fn"),
                                {"ops": inputs})
            for name, (f, x, w) in cases.items():
                want[name] = _jax_case(f, x, None if name in NO_JAX_GRAD
                                       else w)
            outs = ranks.result()
        _RUNS[n] = (ops, want, outs, inputs)
    return n, _RUNS[n]


@pytest.mark.parametrize("name", sorted(_ops(2)))
def test_op_value_and_gradient_match_shard_map(run, name):
    """Each rank's value and input gradient equal its blocks of JAX's."""
    n, (ops, want, outs, _) = run
    y, g = want[name]
    if g is None:
        # the op is linear: sum_r <y_r, w_r> = sum_r <x_r, g_r>
        inp = _RUNS[n][3][name]
        lhs = sum(float(np.vdot(o[name]["y"], w))
                  for o, w in zip(outs, inp[3]))
        rhs = sum(float(np.vdot(x, o[name]["g"]))
                  for o, x in zip(outs, inp[2]))
        np.testing.assert_allclose(lhs, rhs, rtol=1e-5)
    for r, res in enumerate(outs):
        got = res[name]
        np.testing.assert_allclose(got["y"], np.split(y, n)[r], rtol=RTOL,
                                   atol=ATOL, err_msg=f"{name} r{r}")
        if g is None:
            continue
        if isinstance(g, str):
            assert got["error"] == g, (name, got.get("error"), g)
        else:
            np.testing.assert_allclose(got["g"], np.split(g, n)[r],
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f"{name} grad r{r}")


def test_axis_index_size_and_axis_names(run):
    """``axis_index`` / ``axis_size`` equal JAX's under shard_map; the
    pp and mp axes resolve to their groups (the ring shift over each
    equals the one over dp)."""
    n, (_, want, outs, _) = run
    mesh = Mesh(np.array(jax.devices()[:n]), ("dp",))
    idx = jax.shard_map(lambda a: a * 0 + JFn.axis_index("dp"), mesh=mesh,
                        in_specs=P("dp"), out_specs=P("dp"))(
                            jnp.zeros((n,), jnp.int32))
    size = jax.shard_map(lambda a: a * 0 + JFn.axis_size("dp"), mesh=mesh,
                         in_specs=P("dp"), out_specs=P("dp"))(
                             jnp.zeros((n,), jnp.int32))
    for r, res in enumerate(outs):
        assert res["index"] == int(idx[r]) == r
        assert res["size"] == int(size[r]) == n
        for axis in ("pp", "mp"):
            np.testing.assert_array_equal(res[f"shift_{axis}"],
                                          res["shift_right"]["y"])
            assert res[f"index_{axis}"] == r


def test_unknown_axis_and_bad_permutation_raise():
    """No topology: an axis name raises; a bad permutation raises; a group
    of one gives JAX's values at axis size 1."""
    import torch
    from paddle_tpu_torch.distributed import collective
    from paddle_tpu_torch.distributed import functional as Fn
    with pytest.raises(RuntimeError, match="fleet.init"):
        Fn.all_reduce(torch.ones(2), "dp")
    one = collective.Group([0])
    with pytest.raises(ValueError, match="not a permutation"):
        Fn.ppermute(torch.ones(2), one, [(0, 0), (0, 0)])
    x = torch.arange(3.0)
    assert torch.equal(Fn.all_reduce(x, one), x)
    assert torch.equal(Fn.ppermute(x, one, []), torch.zeros(3))
    assert Fn.all_gather(x, one, tiled=False).shape == (1, 3)
    assert Fn.axis_size(one) == 1 and Fn.axis_index(one) == 0
