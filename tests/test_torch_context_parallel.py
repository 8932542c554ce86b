"""The port's context parallelism (`distributed/context_parallel.py`, the
sep axis of the topology, the parallel models' sep lanes) against the
JAX package.

The ranks are gloo processes (`_torch_dist_worker`); JAX runs on its
8-device CPU mesh.  The inputs are drawn from numpy seeds.

- The ops: ring attention and Ulysses at sep 2 and 4, causal and not,
  each rank on its chunk of the sequence, against JAX's ops on the
  global arrays: the outputs and the gradients of ``sum(out * w)``
  (fp32; the port's sums run in other orders: rtol 1e-5, atol 1e-6).
- The fallback at sep 1 (no topology): the port's flash attention, and
  JAX's fallback.
- The models: `ParallelGPTForCausalLM` and `ParallelLlamaForCausalLM` at
  sep 2 × mp 2 (ring and the gathered lane; GPT also with
  ``sequence_parallel``) and GPT at dp 2 × sep 2 against JAX's
  model at the same degrees: losses after 2 AdamW steps with the clip
  within 1e-5 relative, parameters by tests/test_torch_hybrid.py's rule.
  JAX's reference is its sep model without ring (GSPMD's attention over
  the sequence): its ring model computes the same function and runs for
  minutes on the CPU mesh (its ``shard_map`` traced anew each call), so
  one tiny ring run holds JAX's ring against its gathered lane.  Each
  chunk of the batches holds the same count of labelled tokens, where a
  rank's mean over its chunk equals JAX's global mean (the port's rule).
"""
import contextlib

import jax
import numpy as np
import pytest

import paddle_tpu as paddle
import paddle_tpu.distributed as jdist
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.distributed import mesh as jmesh
from paddle_tpu.distributed import topology as jtopo
from paddle_tpu.distributed.fleet import base as jbase
from paddle_tpu.models import ParallelGPTForCausalLM as JaxPGPT
from paddle_tpu.models import ParallelLlamaForCausalLM as JaxPLlama
from paddle_tpu.models.gpt import gpt_config as jax_gpt_config
from paddle_tpu.models.llama import llama_config as jax_llama_config

import torch

from paddle_tpu_torch.distributed import context_parallel as CP
from paddle_tpu_torch.distributed import topology
from paddle_tpu_torch.nn.functional import flash_attention

from _torch_dist_worker import run_ranks

OP_RTOL, OP_ATOL = 1e-5, 1e-6
LOSS_RTOL = 1e-5
PARAM_ATOL = 2e-5
PARAM_RTOL = 1e-2
SEQ = 32
GPT_CFG = dict(num_layers=2, hidden_size=64, num_heads=4, vocab_size=256,
               max_seq_len=SEQ)
LLAMA_CFG = dict(max_seq_len=SEQ)


@contextlib.contextmanager
def jax_axes(**degrees):
    """JAX's hybrid topology at ``degrees`` over the first CPU devices,
    the package's mesh and fleet state put back after."""
    saved = (jmesh._DEFAULT[0], jtopo.get_hybrid_communicate_group(),
             dict(jbase._fleet_state))
    n = int(np.prod([v for v in degrees.values()]))
    hcg = jtopo.HybridCommunicateGroup(devices=jax.devices()[:n],
                                       **{f"{k}_degree": v
                                          for k, v in degrees.items()})
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
    """tests/test_torch_hybrid.py's parameter rule: all but 1 in 10^4
    elements within PARAM_ATOL, every one within PARAM_RTOL."""
    err = np.abs(got - want)
    off = int(np.sum(err > PARAM_ATOL))
    assert off <= max(1, err.size // 10000), (what, off, float(err.max()))
    np.testing.assert_allclose(got, want, rtol=PARAM_RTOL, atol=PARAM_ATOL,
                               err_msg=what)


# ---------------------------------------------------------------------------
# the ops
# ---------------------------------------------------------------------------

def _op_inputs(seed, b=2, s=32, h=4, d=8):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, h, d)).astype(np.float32)
            for _ in range(4)]


def _jax_op(fn, causal, q, k, v, w, sep):
    """JAX's op on the global arrays at sep: the output and the
    gradients of sum(out * w)."""
    with jax_axes(sep=sep):
        ts = [Tensor(a) for a in (q, k, v)]
        for t in ts:
            t.stop_gradient = False
        y = getattr(jdist, fn)(*ts, causal=causal)
        (y * Tensor(w)).sum().backward()
        return {"y": y.numpy(), "dq": ts[0].grad.numpy(),
                "dk": ts[1].grad.numpy(), "dv": ts[2].grad.numpy()}


_OPS = {}


def _ops(sep, tmp_path_factory):
    """Each op case at sep, JAX's and the ranks' (run once a degree)."""
    if sep not in _OPS:
        cases = {f"{fn}-{causal}": (fn, causal,
                                    *_op_inputs(7 + i + 10 * sep))
                 for i, (fn, causal) in enumerate(
                     (f, c) for f in ("ring_flash_attention",
                                      "ulysses_attention")
                     for c in (True, False))}
        outs = run_ranks(sep, "cp_ops", tmp_path_factory.mktemp(f"cp{sep}"),
                         {"ops": cases})
        want = {key: _jax_op(*case, sep) for key, case in cases.items()}
        _OPS[sep] = (cases, want, outs)
    return _OPS[sep]


@pytest.mark.parametrize("sep", [2, 4])
@pytest.mark.parametrize("fn", ["ring_flash_attention", "ulysses_attention"])
@pytest.mark.parametrize("causal", [True, False])
def test_ops_match_jax(sep, fn, causal, tmp_path_factory):
    """Each rank's chunk of the output and of dq, dk, dv equals JAX's
    global result's chunk."""
    _, want, outs = _ops(sep, tmp_path_factory)
    key = f"{fn}-{causal}"
    for name in ("y", "dq", "dk", "dv"):
        got = np.concatenate([o[key][name] for o in
                              sorted(outs, key=lambda o: o["sep_rank"])],
                             axis=1)
        np.testing.assert_allclose(got, want[key][name], rtol=OP_RTOL,
                                   atol=OP_ATOL, err_msg=f"{key} {name}")


@pytest.mark.parametrize("sep", [2, 4])
def test_ulysses_refuses_indivisible_heads(sep, tmp_path_factory):
    """JAX's ValueError, word for word."""
    _, _, outs = _ops(sep, tmp_path_factory)
    with jax_axes(sep=sep):
        q = paddle.randn([2, 4 * sep, 3, 8])
        with pytest.raises(ValueError) as want:
            jdist.ulysses_attention(q, q, q)
    for o in outs:
        assert o["ulysses_error"] == str(want.value)


@pytest.mark.parametrize("sep", [2, 4])
def test_split_sequence_and_groups(sep, tmp_path_factory):
    """`split_sequence` keeps the rank's contiguous chunk (its backward
    gathers the chunks' gradients), and the sep groups hold the ranks of
    JAX's mesh along sep."""
    _, _, outs = _ops(sep, tmp_path_factory)
    seq = np.arange(2 * 4 * sep, dtype=np.float32).reshape(2, 4 * sep)
    grad = np.concatenate([np.full((2, 4), r + 1.0) for r in range(sep)],
                          axis=1)
    for o in outs:
        r = o["sep_rank"]
        np.testing.assert_array_equal(o["split"], seq[:, 4 * r:4 * r + 4])
        np.testing.assert_array_equal(o["split_grad"], grad)
    with jax_axes(sep=sep) as hcg:
        ids = np.asarray(hcg.mesh.mesh).astype(int)
        want = np.moveaxis(ids, 3, -1).reshape(-1, sep).tolist()
    assert sorted(o["sep_ranks"] for o in outs) == \
        sorted(want * (sep // len(want)))
    assert [o["sep_rank"] for o in outs] == list(range(sep))


@pytest.mark.parametrize("degrees", [dict(sep=2, mp=2), dict(dp=2, sep=2),
                                     dict(sep=2, mp=4)])
def test_sep_groups_match_jax_mesh(degrees):
    """The port's sep lines (and the dp × sep data group's) are JAX's
    mesh along those axes, in the same axis order."""
    n = int(np.prod(list(degrees.values())))
    with jax_axes(**degrees) as hcg:
        ids = np.asarray(hcg.mesh.mesh).astype(int)
        names = list(jtopo.HYBRID_AXES)
    from paddle_tpu_torch.distributed import ProcessMesh
    mesh = ProcessMesh(np.arange(n).reshape(ids.shape), names)
    sep = names.index("sep")
    assert mesh.lines("sep") == np.moveaxis(ids, sep, -1).reshape(
        -1, ids.shape[sep]).tolist()
    dp = names.index("dp")
    want = np.moveaxis(ids, [dp, sep], [-2, -1]).reshape(
        -1, ids.shape[dp] * ids.shape[sep]).tolist()
    assert mesh.lines(("dp", "sep")) == want


def test_sep_one_falls_back_to_flash():
    """Without a topology (sep 1) ring and Ulysses are the port's flash
    attention, bit for bit, and JAX's fallback within OP_RTOL."""
    q, k, v, _ = _op_inputs(3, s=16)
    assert topology.get_hybrid_communicate_group() is None
    tq, tk, tv = (torch.tensor(a) for a in (q, k, v))
    want = flash_attention(tq, tk, tv, causal=True)
    for fn in (CP.ring_flash_attention, CP.ulysses_attention):
        assert torch.equal(fn(tq, tk, tv, causal=True), want)
    jq, jk, jv = (Tensor(a) for a in (q, k, v))
    np.testing.assert_allclose(
        want.numpy(), jdist.ring_flash_attention(jq, jk, jv,
                                                 causal=True).numpy(),
        rtol=OP_RTOL, atol=OP_ATOL)


# ---------------------------------------------------------------------------
# the parallel models at sep 2
# ---------------------------------------------------------------------------

def _batches(vocab, sep, n=2, b=4, seed=0):
    """Global batches with one ignored label in each sep chunk of a row
    (equal labelled counts in every chunk)."""
    rng = np.random.default_rng(seed)
    out = []
    c = SEQ // sep
    for _ in range(n):
        ids = rng.integers(0, vocab, (b, SEQ)).astype(np.int64)
        labels = np.roll(ids, -1, axis=1)
        labels[:, c - 1::c] = -100
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


#: key: (model, degrees, ring, sequence_parallel)
RUNS = {
    "gpt-sep2-ring": ("gpt", dict(sep_degree=2, mp_degree=2), True, False),
    "gpt-sep2": ("gpt", dict(sep_degree=2, mp_degree=2), False, False),
    "llama-sep2-ring": ("llama", dict(sep_degree=2, mp_degree=2), True,
                        False),
    "llama-sep2": ("llama", dict(sep_degree=2, mp_degree=2), False, False),
    "gpt-dp2-sep2-ring": ("gpt", dict(dp_degree=2, sep_degree=2), True,
                          False),
    "gpt-sep2-sp-ring": ("gpt", dict(sep_degree=2, mp_degree=2), True,
                         True),
}
_MODELS = {}


def _jax_model(which, sp=False):
    if which == "gpt":
        return JaxPGPT(jax_gpt_config("gpt2-124m", **GPT_CFG),
                       sequence_parallel=sp)
    return JaxPLlama(jax_llama_config("tiny", **LLAMA_CFG),
                     sequence_parallel=sp)


def _models(tmp_path_factory):
    """JAX's losses and state for each run (its sep model without ring,
    on the run's degrees) and the four ranks' results, run once."""
    if not _MODELS:
        batches = _batches(256, 2)
        states, want = {}, {}
        for key, (which, degrees, _, sp) in RUNS.items():
            ref = (which, tuple(sorted(degrees.items())), sp)
            with jax_axes(**{k[:-7]: v for k, v in degrees.items()}):
                paddle.seed(11)
                jm = _jax_model(which, sp)
                states[key] = {k: np.asarray(v._data_).copy()
                               for k, v in jm.state_dict().items()}
                if ref not in want:
                    want[ref] = _jax_train(jm, batches)
            want[key] = want[ref]
        runs = {key: (which, GPT_CFG if which == "gpt" else LLAMA_CFG,
                      degrees, ring, sp)
                for key, (which, degrees, ring, sp) in RUNS.items()}
        outs = run_ranks(4, "sep_train", tmp_path_factory.mktemp("sep"),
                         {"runs": runs, "states": states,
                          "batches": batches}, timeout=400)
        _MODELS.update(want=want, outs=outs, states=states)
    return _MODELS


@pytest.mark.parametrize("key", sorted(RUNS))
def test_sep_model_losses_match_jax(key, tmp_path_factory):
    m = _models(tmp_path_factory)
    losses, _ = m["want"][key]
    for o in m["outs"]:
        np.testing.assert_allclose(o[key]["losses"], losses, rtol=LOSS_RTOL)
        assert o[key]["kind"] == "SegmentParallel"


@pytest.mark.parametrize("key", sorted(RUNS))
def test_sep_model_parameters_match_jax(key, tmp_path_factory):
    """After 2 AdamW steps with the clip: the gathered parameters against
    JAX's, and the sep ranks' copies bit for bit."""
    m = _models(tmp_path_factory)
    _, state = m["want"][key]
    outs = [o[key] for o in m["outs"]]
    for name, want in state.items():
        _close(outs[0]["state"][name], want, f"{key} {name}")
        for o in outs[1:]:
            np.testing.assert_array_equal(o["state"][name],
                                          outs[0]["state"][name])


def test_sep_model_logits_are_the_rank_chunk(tmp_path_factory):
    """With labels a rank's logits are its chunk and vocabulary slice:
    ``[B / dp, S / sep, V / mp]``."""
    m = _models(tmp_path_factory)
    for o in m["outs"]:
        assert o["gpt-sep2"]["logits_shape"] == (4, SEQ // 2, 256 // 2)
        assert o["gpt-dp2-sep2-ring"]["logits_shape"] == (2, SEQ // 2, 256)


def test_jax_ring_model_matches_its_gathered_lane():
    """JAX's own ring model (one layer, sep 2, one step) against its
    sep model without ring: the reference the port's ring lane is held
    to computes the same function."""
    batches = _batches(256, 2, n=1, b=2)
    cfg = dict(GPT_CFG, num_layers=1)
    res = []
    for ring in (True, False):
        with jax_axes(sep=2):
            paddle.seed(5)
            jm = JaxPGPT(jax_gpt_config("gpt2-124m", **cfg),
                         use_ring_attention=ring)
            res.append(_jax_train(jm, batches))
    np.testing.assert_allclose(res[0][0], res[1][0], rtol=LOSS_RTOL)
    for name, want in res[1][1].items():
        _close(res[0][1][name], want, name)


def test_sep_with_pp_refused(tmp_path):
    """sep > 1 with pp > 1 raises NotImplementedError naming ROADMAP A8
    (JAX's ``_inside_manual_region`` lane has no counterpart)."""
    outs = run_ranks(4, "sep_refusals", tmp_path, {"cfg": GPT_CFG})
    for o in outs:
        assert "ROADMAP A8" in o["built_after"]
        assert o["distributed_model"] == o["built_after"]
