"""Multi-LoRA serving in the port against the JAX package: the gathered
delta's plain version against both JAX lanes, adapter artifacts written by
the JAX package, greedy outputs of mixed-adapter batches identical to the
JAX engine's on the tiny Llama, and the pool's own contract (LRU
eviction, prefix-tree scopes, unknown ids, config errors, telemetry,
pass-through outside an engine)."""
import os
import threading

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.framework import checkpoint_manager as jcm
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_config as jax_llama_config
from paddle_tpu.serving import Engine as JaxEngine
from paddle_tpu.serving import ServingConfig as JaxServingConfig
from paddle_tpu.serving import adapters as jad
from paddle_tpu.utils import flags as jflags
from paddle_tpu_torch import convert, kernels
from paddle_tpu_torch.framework import checkpoint_manager as cm
from paddle_tpu_torch.kernels import lora as kl
from paddle_tpu_torch.models import LlamaForCausalLM, llama_config
from paddle_tpu_torch.nn.lora import load_adapter_state
from paddle_tpu_torch.observability.registry import REGISTRY
from paddle_tpu_torch.serving import (AdapterConfigError, AdapterPool,
                                      Engine, PrefixTree, ServingConfig,
                                      UnknownAdapterError)

ATTN = ("q_proj", "k_proj", "v_proj", "o_proj")
MLP = ("gate_proj", "up_proj", "down_proj")


def _routed_by_adapter():
    """The per-adapter series of the registry's
    ``serving.adapter.requests_routed_adapter{adapter=...}`` family (read
    before the next engine's start resets it)."""
    fam = REGISTRY.get("serving.adapter.requests_routed_adapter")
    return {lv[0]: int(leaf.value) for lv, leaf in fam._samples() if lv}


def _prompts(lens, seed=0, vocab=512):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (n,)).astype("int32") for n in lens]


def make_spec(model, seed, rank, targets, alpha=None, std=0.1):
    """An adapter_spec dict over ``model``'s target projections, factors
    N(0, std) from a numpy seed (nonzero B, unlike a fresh LoRALinear)."""
    rng = np.random.default_rng(seed)
    spec = {}
    for name, mod in model.named_modules():
        if name.rsplit(".", 1)[-1] in targets:
            din, dout = mod.weight.shape
            spec[name] = {
                "A": rng.normal(0, std, (din, rank)).astype(np.float32),
                "B": rng.normal(0, std, (rank, dout)).astype(np.float32),
                "rank": rank, "alpha": float(alpha or rank)}
    return spec


@pytest.fixture(scope="module")
def pair():
    paddle.seed(4)
    jm = JaxLlama(jax_llama_config("tiny", max_seq_len=64))
    jm.eval()
    tm = LlamaForCausalLM(llama_config("tiny", max_seq_len=64),
                          device="cpu")
    convert.load_paddle_tpu_state(
        tm, {k: v.numpy() for k, v in jm.state_dict().items()})
    return jm, tm


@pytest.fixture(scope="module")
def model(pair):
    return pair[1]


@pytest.fixture(scope="module")
def specs(model):
    """Three adapters as the chip run has them: rank 8 on every
    projection; rank 4 on q/v; rank 8, alpha 16, on the MLP."""
    return {"a": make_spec(model, 7, 8, ATTN + MLP),
            "b": make_spec(model, 8, 4, ("q_proj", "v_proj")),
            "c": make_spec(model, 9, 8, MLP, alpha=16.0)}


# ---------------------------------------------------------------- kernel
@pytest.mark.parametrize("seq,din,dout,rank", [(1, 32, 48, 8),
                                               (3, 40, 24, 4)])
def test_lora_delta_ref_matches_jax_lanes(monkeypatch, seq, din, dout,
                                          rank):
    """The plain version against the JAX op's XLA lane (the default) and
    its Pallas kernel in interpret mode (FLAGS_pallas_lora), 1e-5; idx
    with a repeat and the identity slot 0."""
    rng = np.random.default_rng(seq)
    ns, P = 4, 3
    x = rng.standard_normal((ns, seq, din)).astype(np.float32)
    a = rng.standard_normal((P, din, rank)).astype(np.float32)
    b = rng.standard_normal((P, rank, dout)).astype(np.float32)
    s = np.array([0.0, 1.0, 0.5], np.float32)
    a[0], b[0] = 0.0, 0.0
    idx = np.array([0, 1, 2, 1], np.int32)
    y = Tensor(np.zeros((ns, seq, dout), np.float32))
    args = [Tensor(t) for t in (x, a, b, s, idx)]
    monkeypatch.setitem(jflags._FLAGS, "FLAGS_pallas_lora", False)
    xla = jad.lora_delta(y, *args).numpy()
    monkeypatch.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setitem(jflags._FLAGS, "FLAGS_pallas_lora", True)
    assert jad._use_pallas()
    pallas = jad.lora_delta(y, *args).numpy()
    got = kl.lora_delta_ref(*(torch.from_numpy(t) for t in
                              (x, a, b, s, idx)))
    assert got.shape == (ns, seq, dout) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), xla, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), pallas, rtol=1e-5, atol=1e-5)
    assert not got[0].any()                     # slot 0: exact zeros


def test_lora_delta_cpu_route_rounds_once():
    """CPU tensors take the plain version (no launch); in bf16 the delta
    is the fp32 formula rounded once."""
    kernels.reset_launch_counts()
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 5, 16, generator=g).to(torch.bfloat16)
    a = torch.randn(3, 16, 4, generator=g).to(torch.bfloat16)
    b = torch.randn(3, 4, 8, generator=g).to(torch.bfloat16)
    s = torch.tensor([0.0, 2.0, 0.5]).to(torch.bfloat16)
    idx = torch.tensor([2, 1], dtype=torch.int32)
    got = kl.lora_delta(x, a, b, s, idx)
    i = idx.long()
    want = ((x.float() @ a[i].float()) @ b[i].float()
            * s[i].float()[:, None, None]).to(torch.bfloat16)
    assert torch.equal(got, want)
    assert kernels.launch_counts()["lora_delta"] == 0


# ---------------------------------------------------------------- artifacts
def test_load_adapter_state_reads_jax_artifact(tmp_path):
    """A save_adapter artifact of the JAX package reads back equal, and
    a flipped byte fails the crc check; the port's manifest passes the
    JAX package's verify."""
    paddle.seed(1)
    jm = JaxLlama(jax_llama_config("tiny", num_layers=1, max_seq_len=32))
    jnn.attach_lora(jm, rank=4, alpha=8, targets=("q_proj", "down_proj"))
    rng = np.random.default_rng(2)
    for lyr in jnn.lora_layers(jm).values():
        lyr.lora_B.set_value(rng.standard_normal(
            lyr.lora_B.shape).astype(np.float32))
    art = str(tmp_path / "art")
    jnn.save_adapter(jm, art)
    want = jnn.load_adapter_state(art)
    got = load_adapter_state(art)
    assert sorted(got) == sorted(want) == [
        "llama.layers.0.mlp.down_proj", "llama.layers.0.self_attn.q_proj"]
    for name, st in want.items():
        assert got[name]["rank"] == 4 and got[name]["alpha"] == 8.0
        np.testing.assert_array_equal(got[name]["A"], st["A"])
        np.testing.assert_array_equal(got[name]["B"], st["B"])
    npz = os.path.join(art, "adapter.npz")
    raw = bytearray(open(npz, "rb").read())
    raw[len(raw) // 2] ^= 0xFF
    open(npz, "wb").write(bytes(raw))
    assert not cm.verify_checkpoint(art)
    with pytest.raises(ValueError, match="crc32"):
        load_adapter_state(art)
    with pytest.raises(FileNotFoundError, match="manifest"):
        load_adapter_state(str(tmp_path / "missing"))
    mine = tmp_path / "mine"
    mine.mkdir()
    (mine / "payload.bin").write_bytes(b"abc")
    cm.write_manifest(str(mine), meta={"k": 1})
    assert jcm.verify_checkpoint(str(mine))
    assert cm.read_manifest(str(mine))["meta"] == {"k": 1}


# ---------------------------------------------------------------- engine
def _jax_engine_outputs(jm, cfg, jobs):
    prev = paddle.get_flags("FLAGS_compiled_tick")["FLAGS_compiled_tick"]
    paddle.set_flags({"FLAGS_compiled_tick": False})
    try:
        with JaxEngine(jm, cfg) as eng:
            futs = [eng.submit(p, max_new_tokens=n, adapter_id=aid)
                    for p, n, aid in jobs]
            return [f.result(timeout=300).output_ids for f in futs]
    finally:
        paddle.set_flags({"FLAGS_compiled_tick": prev})


@pytest.mark.parametrize("cache_dtype", ["float32", "int8"])
def test_mixed_adapter_batch_matches_jax_engine(pair, specs, cache_dtype):
    """A base request and three adapters, two of them sharing a 32-token
    prefix under one adapter, through 2 slots and a 2-adapter pool
    (hot-loads and an eviction mid-run), 5 greedy tokens: output_ids
    equal the JAX engine's (host lane) on the same weights and specs."""
    jm, tm = pair
    prompts = _prompts([6, 40, 9, 37, 5], seed=3)
    prompts[3][:32] = prompts[1][:32]
    jobs = list(zip(prompts, [5] * 5, [None, "a", "b", "a", "c"]))
    kw = dict(num_slots=2, max_adapters=2, adapter_rank_pool=8,
              adapters=specs, cache_dtype=cache_dtype)
    want = _jax_engine_outputs(jm, JaxServingConfig(**kw), jobs)
    with Engine(tm, ServingConfig(**kw)) as eng:
        futs = [eng.submit(p, max_new_tokens=n, adapter_id=aid)
                for p, n, aid in jobs]
        got = [f.result(timeout=120).output_ids for f in futs]
        st = eng.stats()
    for i, (w, g) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(g, w, err_msg=str(i))
    assert st["adapters_loaded"] >= 3 and st["adapter_evictions"] >= 1
    assert st["prefix_cache_hits"] >= 1


def test_multi_adapter_bit_equal_vs_single_adapter_engines(model, specs):
    """Heterogeneous adapters decoding in one batched step: each output
    equals a dedicated single-adapter engine's, and a base request riding
    the same batch equals the base engine's."""
    prompts = _prompts([6, 9, 5], seed=3)
    ids = ["a", "b", "c"]
    refs = {}
    for aid, p in zip(ids, prompts):
        with Engine(model, ServingConfig(
                num_slots=2, max_adapters=1, adapter_rank_pool=8,
                adapters={aid: specs[aid]})) as eng:
            refs[aid] = eng.generate(p, max_new_tokens=5,
                                     adapter_id=aid).output_ids
    with Engine(model, ServingConfig(num_slots=2)) as eng:
        base = eng.generate(prompts[0], max_new_tokens=5).output_ids
    with Engine(model, ServingConfig(
            num_slots=4, max_adapters=3, adapter_rank_pool=8,
            adapters=specs)) as eng:
        futs = [eng.submit(p, max_new_tokens=5, adapter_id=aid)
                for aid, p in zip(ids, prompts)]
        futs.append(eng.submit(prompts[0], max_new_tokens=5))
        outs = [f.result(timeout=120).output_ids for f in futs]
        st = eng.stats()
        by_adapter = _routed_by_adapter()
    for aid, o in zip(ids, outs):
        np.testing.assert_array_equal(o, refs[aid], err_msg=aid)
    np.testing.assert_array_equal(outs[3], base)
    assert not np.array_equal(outs[0], base)    # the adapter does act
    assert st["requests_routed_adapter"] == 3
    assert by_adapter == {"a": 1, "b": 1, "c": 1}


def test_lru_evict_reload_zero_drops(model, specs):
    """Three adapters through a one-slot pool: hot-loads and LRU
    evictions mid-run, every future completes, and a second round
    reloads each adapter to the same outputs."""
    prompts = _prompts([5, 7, 6], seed=4)
    with Engine(model, ServingConfig(
            num_slots=2, max_queue=16, max_adapters=1, adapter_rank_pool=8,
            adapters=specs)) as eng:
        rounds = []
        for _ in range(2):
            futs = [eng.submit(p, max_new_tokens=4, adapter_id=aid)
                    for aid, p in zip("abc", prompts)]
            rounds.append([f.result(timeout=120).output_ids for f in futs])
        st = eng.stats()
        assert eng.loaded_adapters() == ["c"]
    for a, b in zip(*rounds):
        np.testing.assert_array_equal(a, b)
    assert st["requests_completed"] == 6
    assert st["adapters_loaded"] >= 6 and st["adapter_evictions"] >= 5


def test_prefix_tree_adapter_isolation(model, specs):
    """The same prompt under two adapters never shares pages: a second
    request under "a" hits, one under "b" does not, and both equal their
    no-cache outputs."""
    prompt = _prompts([20], seed=6)[0]
    refs = {}
    for aid in ("a", "b"):
        with Engine(model, ServingConfig(
                num_slots=2, max_adapters=1, adapter_rank_pool=8,
                page_size=4, enable_prefix_cache=False,
                adapters={aid: specs[aid]})) as eng:
            refs[aid] = eng.generate(prompt, max_new_tokens=4,
                                     adapter_id=aid).output_ids
    with Engine(model, ServingConfig(
            num_slots=2, max_adapters=2, adapter_rank_pool=8, page_size=4,
            adapters=specs)) as eng:
        eng.generate(prompt, max_new_tokens=4, adapter_id="a")
        assert eng.stats().get("prefix_cache_hits", 0) == 0
        o_a = eng.generate(prompt, max_new_tokens=4, adapter_id="a")
        assert eng.stats()["prefix_cache_hits"] == 1
        o_b = eng.generate(prompt, max_new_tokens=4, adapter_id="b")
        assert eng.stats()["prefix_cache_hits"] == 1
    np.testing.assert_array_equal(o_a.output_ids, refs["a"])
    np.testing.assert_array_equal(o_b.output_ids, refs["b"])


def test_prefix_tree_scope_api():
    class _FakeCache:
        def make_shared(self, slot, i):
            return 100 + i

    tree = PrefixTree(page_size=4)
    prompt = np.arange(9).astype(np.int32)
    held = []
    assert tree.insert(prompt, _FakeCache(), 0, held, scope="a") == 2
    nodes_a, pages_a = tree.match(prompt, scope="a")
    _, pages_b = tree.match(prompt, scope="b")
    _, pages_0 = tree.match(prompt)
    assert pages_a == [100, 101] and not pages_b and not pages_0
    assert tree.cached_pages() == 2
    tree.release(nodes_a)
    tree.release(held)
    freed = []
    assert tree.evict(5, freed.append) == 2 and sorted(freed) == [100, 101]


def test_unknown_adapter_fails_future_not_engine(model, specs):
    p = _prompts([5], seed=8)[0]
    with Engine(model, ServingConfig(num_slots=2, max_adapters=1,
                                     adapter_rank_pool=8,
                                     adapters={"a": specs["a"]})) as eng:
        fut = eng.submit(p, max_new_tokens=3, adapter_id="nope")
        with pytest.raises(UnknownAdapterError, match="'a'"):
            fut.result(timeout=30)
        assert eng.generate(p, max_new_tokens=3).output_ids.size == 3
        assert eng.generate(p, max_new_tokens=3,
                            adapter_id="a").output_ids.size == 3
    with Engine(model, ServingConfig(num_slots=1)) as eng:
        with pytest.raises(UnknownAdapterError, match="max_adapters"):
            eng.submit(p, adapter_id="a").result(timeout=30)
        with pytest.raises(AdapterConfigError, match="no adapter pool"):
            eng.register_adapter("a", specs["a"])


def test_adapter_config_errors(model, specs):
    with pytest.raises(AdapterConfigError, match="rank"):
        Engine(model, ServingConfig(num_slots=2, max_adapters=1,
                                    adapter_rank_pool=4,
                                    adapters={"a": specs["a"]}))
    bad = {k: dict(v) for k, v in specs["b"].items()}
    name = next(iter(bad))
    bad[name] = dict(bad[name], A=np.zeros((3, 4), np.float32))
    with pytest.raises(AdapterConfigError, match=name):
        Engine(model, ServingConfig(num_slots=2, max_adapters=1,
                                    adapter_rank_pool=8,
                                    adapters={"b": bad}))
    with pytest.raises(AdapterConfigError, match="does not have"):
        Engine(model, ServingConfig(
            num_slots=2, max_adapters=1,
            adapters={"b": {"not.a.layer": specs["b"][name]}}))
    with pytest.raises(AdapterConfigError, match="non-empty"):
        Engine(model, ServingConfig(num_slots=2, max_adapters=1,
                                    adapters={"b": {}}))
    with pytest.raises(AdapterConfigError, match="no Linear"):
        AdapterPool(model, 1, 8, 2, targets=("nothing",))
    with pytest.raises(ValueError, match="max_adapters"):
        ServingConfig(max_adapters=-1).validate()
    with pytest.raises(ValueError, match="adapter_rank_pool"):
        ServingConfig(max_adapters=1, adapter_rank_pool=0).validate()
    with pytest.raises(ValueError, match="adapters"):
        ServingConfig(adapters={"a": specs["a"]}).validate()


def test_adapter_telemetry_keys(model, specs):
    """The snapshot carries the adapter keys at 0 without a pool, and
    counts hot-loads, evictions, load time and routed requests with one."""
    with Engine(model, ServingConfig(num_slots=1)) as eng:
        st = eng.stats()
    assert st["adapters_loaded"] == st["adapter_evictions"] == 0
    assert st["requests_routed_adapter"] == 0
    assert st["adapter_load_ms_avg"] is None
    with Engine(model, ServingConfig(num_slots=1, max_adapters=1,
                                     adapter_rank_pool=8,
                                     adapters=specs)) as eng:
        p = _prompts([5], seed=9)[0]
        for aid in ("a", "b", "a"):
            eng.generate(p, max_new_tokens=2, adapter_id=aid)
        st = eng.stats()
        by_adapter = _routed_by_adapter()
    assert st["adapters_loaded"] == 3 and st["adapter_evictions"] == 2
    assert st["adapter_load_ms_avg"] >= 0
    assert st["requests_routed_adapter"] == 3
    assert by_adapter == {"a": 2, "b": 1}


def test_pool_is_a_pass_through_outside_its_scope(model, specs):
    """Building a pool changes no output outside `activate`, on this
    thread or another one while a scope is active here; hot-loads write
    the stacks in place and leave slot 0 zero; the state-dict names stay
    the Linear's."""
    ids = torch.tensor(_prompts([7], seed=10)[0][None, :])
    names = set(model.state_dict())
    with torch.no_grad():
        before = model(ids)
        pool = AdapterPool(model, 2, 8, 1)
        pool.register("a", specs["a"])
        stk = pool._stacks["llama.layers.1.mlp.down_proj"]
        ptrs = (stk.A.data_ptr(), stk.B.data_ptr(), pool.idx.data_ptr())
        slot = pool.acquire("a")
        pool.set_row(0, slot)
        assert (stk.A.data_ptr(), stk.B.data_ptr(),
                pool.idx.data_ptr()) == ptrs
        assert not stk.A[0].any() and not stk.scale[0]
        assert float(stk.scale[slot]) == 1.0
        assert torch.equal(model(ids), before)
        seen = {}
        with pool.activate():
            adapted = model(ids)
            t = threading.Thread(target=lambda: seen.update(out=model(ids)))
            t.start()
            t.join()
        assert torch.equal(seen["out"], before)
        assert not torch.equal(adapted, before)
        assert torch.equal(model(ids), before)
    assert set(model.state_dict()) == names
