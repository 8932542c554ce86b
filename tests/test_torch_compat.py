"""`distributed/compat.py` against the JAX package's (paddle_tpu/
distributed/compat.py): the same public names, exported from
``paddle_tpu_torch.distributed`` as JAX exports them; at world one each
call's result equals JAX's on the same inputs; on 2 gloo ranks each
collective gives what JAX's semantics give (the rank order of
`all_gather_object`, ``src``'s list after `broadcast_object_list`, rank
i's item of `scatter_object_list`, the all-to-all's transposed parts,
``dst``'s list of `gather`), on the world and on an explicit gloo group.
"""
import inspect

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed import compat as jc
from paddle_tpu_torch import distributed as tdist
from paddle_tpu_torch.distributed import compat as tc

from _torch_dist_worker import run_ranks


def _public(mod):
    return {n for n, v in vars(mod).items() if not n.startswith("_")
            and (inspect.isfunction(v) or inspect.isclass(v))
            and getattr(v, "__module__", None) == mod.__name__}


def test_compat_names_and_exports_equal_jax():
    import paddle_tpu.distributed as jdist
    assert _public(tc) == _public(jc)
    exported = {n for n in dir(jdist)
                if getattr(getattr(jdist, n), "__module__", None)
                == jc.__name__}
    assert exported and exported <= set(tdist.__all__)
    for name in exported:
        assert getattr(tdist, name) is getattr(tc, name)


def test_compat_world_one_equals_jax():
    assert tc.ParallelMode.__dict__.keys() - {"__doc__"} == \
        jc.ParallelMode.__dict__.keys() - {"__doc__"}
    for name in ("DATA_PARALLEL", "TENSOR_PARALLEL", "PIPELINE_PARALLEL",
                 "SHARDING_PARALLEL", "SEGMENT_PARALLEL"):
        assert getattr(tc.ParallelMode, name) == \
            getattr(jc.ParallelMode, name)
    for cls, args in (("ProbabilityEntry", (0.5,)),
                      ("CountFilterEntry", (3,)),
                      ("ShowClickEntry", ("show", "click"))):
        assert getattr(tc, cls)(*args)._to_attr() == \
            getattr(jc, cls)(*args)._to_attr()
    with pytest.raises(ValueError):
        tc.ProbabilityEntry(0.0)
    assert repr(tc.DistAttr(None, ["x", None])) == \
        repr(jc.DistAttr(None, ["x", None]))
    assert tc.is_available() is jc.is_available() is True
    obj = {"a": [1, 2]}
    assert tc.all_gather_object([], obj) == jc.all_gather_object([], obj)
    assert tc.broadcast_object_list([obj], src=0) == \
        jc.broadcast_object_list([obj], src=0)
    assert tc.scatter_object_list([], ["x", "y"]) == \
        jc.scatter_object_list([], ["x", "y"])
    x = np.arange(6, dtype=np.float32)
    got = tc.alltoall_single(torch.empty(6), torch.from_numpy(x))
    want = jc.alltoall_single(paddle.to_tensor(np.zeros(6, np.float32)),
                              paddle.to_tensor(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want._data_))
    gl = tc.gather(torch.from_numpy(x))
    assert len(gl) == len(jc.gather(paddle.to_tensor(x))) == 1
    t = torch.ones(2)
    assert tc.wait(t) is t
    with pytest.raises(NotImplementedError, match="A8"):
        tc.alltoall_single(torch.empty(6), torch.from_numpy(x), [2, 4])
    with pytest.raises(ValueError, match="linear"):
        tc.split(torch.ones(2, 4), (4, 4), "conv")


def test_compat_two_gloo_ranks(tmp_path):
    outs = run_ranks(2, "compat", tmp_path)
    objs = [{"rank": r, "data": [r] * (r + 1)} for r in range(2)]
    for r, out in enumerate(outs):
        assert out["all_gather_object"] == objs
        assert out["broadcast_object_list"] == ["from-1", {"n": 1}]
        assert out["scatter_object_list"] == [["a", {"b": 2}][r]]
        # rank r receives rank j's item r
        assert out["alltoall"] == [[j * 10.0 + r] for j in range(2)]
        assert out["alltoall_single"] == \
            [2.0 * r + 100 * j + i for j in range(2) for i in range(2)]
        assert out["gather"] == ([[0.0], [1.0]] if r == 0 else [])
        assert out["backend"] == out["group_backend"] == "GLOO"
        assert out["descriptor"] == [7, 8, 9, 10]
        assert out["after_destroy"] == 2.0
