"""Prefill/decode disaggregation in the port against the JAX package
(tests/test_disagg.py, run on the port): the migration wire format
(the port's frames equal JAX's byte for byte, fp32 and int8, and each
package's `unpack` reads the other's payload), page adoption (attention
over adopted pages bit-equal to the sender's), the engine's handoff
(greedy and seeded tokens equal to JAX's thread-mode fleet on the same
weights and to the port's single engine), `submit_resume` validation,
the local-decode fallback, the role-aware router, drain-time migration,
a role flip, and deadlines across the migration path.  Thread-mode
replicas (several `ReplicaServer`s in one process) on the tiny Llama;
the process-mode fleet is in test_torch_fleet.py."""
import pickle
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_config as jax_llama_config
from paddle_tpu.serving import PagedKVCache as JaxPagedKVCache
from paddle_tpu.serving import PageMigrationError as JaxPageMigrationError
from paddle_tpu.serving import migration as jax_migration
from paddle_tpu_torch import convert
from paddle_tpu_torch.distributed.store import TCPStore
from paddle_tpu_torch.incubate.nn import functional as IF
from paddle_tpu_torch.models import LlamaForCausalLM, llama_config
from paddle_tpu_torch.serving import (DeadlineExceededError, Engine,
                                      PagedKVCache, PageMigrationError,
                                      ReplicaConfig, ReplicaServer,
                                      RouterConfig, SamplingParams,
                                      ServingConfig, ServingRouter,
                                      migration, serving_stats)
from paddle_tpu_torch.utils.flags import set_flags

VOCAB = 512


def _prompts(lens, seed=0, vocab=VOCAB):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (n,)).astype("int32") for n in lens]


@pytest.fixture(scope="module")
def pair():
    paddle.seed(5)
    jm = JaxLlama(jax_llama_config("tiny", max_seq_len=64))
    jm.eval()
    tm = LlamaForCausalLM(llama_config("tiny", max_seq_len=64),
                          device="cpu")
    convert.load_paddle_tpu_state(
        tm, {k: v.numpy() for k, v in jm.state_dict().items()})
    return jm, tm.eval()


@pytest.fixture(scope="module")
def model(pair):
    return pair[1]


_REFS = {}


def _ref(model, prompt, max_new, sampling=None):
    """The port's single-engine tokens (cached per prompt and knobs)."""
    key = (prompt.tobytes(), max_new, sampling)
    if key not in _REFS:
        with Engine(model, ServingConfig(num_slots=2)) as eng:
            _REFS[key] = eng.generate(prompt, max_new_tokens=max_new,
                                      sampling=sampling).output_ids
    return _REFS[key]


# ------------------------------------------------------------------
# the wire format and adoption
# ------------------------------------------------------------------

def _pool_contents(rng, shape, dtype):
    if dtype == "int8":
        return rng.integers(-127, 127, shape).astype(np.int8)
    return rng.normal(size=shape).astype(np.float32)


def _filled_pair(dtype, layers=2, offset=37, seed=0):
    """A JAX and a port cache of one geometry holding the same seeded
    pool contents (and scales), with one slot of ``offset`` tokens."""
    import jax.numpy as jnp
    from paddle_tpu.core.tensor import Tensor
    caches = (JaxPagedKVCache(layers, 2, 64, 2, 4, page_size=16,
                              dtype=dtype),
              PagedKVCache(layers, 2, 64, 2, 4, page_size=16, dtype=dtype,
                           device="cpu"))
    slots = []
    for c in caches:
        s = c.allocate(4)
        c.ensure_capacity(s, 47)                # 3 pages assigned
        c.set_offset(s, offset)
        slots.append(s)
    rng = np.random.default_rng(seed)
    names = ["k_pool", "v_pool"] + (["k_scale", "v_scale"]
                                    if dtype == "int8" else [])
    for li in range(layers):
        for name in names:
            shape = tuple(caches[1].layers[li][name].shape)
            arr = rng.random(shape).astype(np.float32) \
                if name.endswith("scale") else \
                _pool_contents(rng, shape, dtype)
            caches[0].layers[li][name] = Tensor(jnp.asarray(arr))
            caches[1].layers[li][name].copy_(torch.from_numpy(arr))
    assert slots[0] == slots[1]
    np.testing.assert_array_equal(caches[0].table, caches[1].table)
    return caches[0], caches[1], slots[1]


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_wire_frames_equal_jax_byte_for_byte(dtype):
    """The same pool contents exported by both packages: equal headers,
    frames equal byte for byte; each `unpack` reads the other's payload;
    a bad version or frame count raises `PageMigrationError` in both."""
    jc, tc, slot = _filled_pair(dtype)
    jh, jb = jax_migration.export_slot(jc, slot)
    th, tb = migration.export_slot(tc, slot)
    assert th == jh and th["num_pages"] == 3 and th["offset"] == 37
    assert len(tb) == len(jb) == (4 if dtype == "int8" else 2)
    for a, b in zip(tb, jb):
        assert a.tobytes() == b.tobytes()
    with pytest.raises(TypeError, match="raw-bytes fast path"):
        pickle.dumps(tb[0])
    from_jax = migration.unpack(jh, *jb)
    from_port = jax_migration.unpack(th, *tb)
    for name in ("k_pages", "v_pages", "k_scales", "v_scales"):
        if from_port[name] is None:
            assert from_jax[name] is None
            continue
        np.testing.assert_array_equal(from_jax[name].numpy(),
                                      from_port[name])
    assert from_jax["offset"] == from_port["offset"] == 37
    for unpack, err in ((migration.unpack, PageMigrationError),
                        (jax_migration.unpack, JaxPageMigrationError)):
        with pytest.raises(err, match="wire version"):
            unpack(dict(th, version=99), *tb)
        with pytest.raises(err, match="frames"):
            unpack(th, *tb[:1])


def test_bf16_frames_carry_raw_bytes():
    """A bfloat16 pool's frames are its raw bytes under JAX's dtype name
    (numpy has no bfloat16): the round trip is bit for bit."""
    c = PagedKVCache(2, 1, 32, 2, 4, page_size=8, dtype="bfloat16",
                     device="cpu")
    s = c.allocate(4)
    c.ensure_capacity(s, 20)
    c.set_offset(s, 19)
    for lay in c.layers:
        lay["k_pool"].copy_(torch.randn(lay["k_pool"].shape))
        lay["v_pool"].copy_(torch.randn(lay["v_pool"].shape))
    header, blobs = migration.export_slot(c, s)
    assert header["store_dtype"] == "bfloat16"
    pages = migration.unpack(header, *blobs)
    jpages = jax_migration.unpack(header, *blobs)
    assert str(jpages["k_pages"].dtype) == "bfloat16"
    assert pages["k_pages"].view(torch.int16).numpy().tobytes() == \
        jpages["k_pages"].tobytes()
    d = PagedKVCache(2, 1, 32, 2, 4, page_size=8, dtype="bfloat16",
                     device="cpu")
    s2 = d.adopt_pages(0, 19, jpages["k_pages"], jpages["v_pages"])
    for la, lb in zip(c.layers, d.layers):
        for j in range(3):
            assert torch.equal(lb["k_pool"][int(d.table[s2, j])],
                               la["k_pool"][int(c.table[s, j])])


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_page_payload_roundtrip_bitwise(dtype):
    """export → frames → unpack → adopt lands every page (and scale) bit
    for bit in the receiving pool, slot-private, with the growth
    reservation intact."""
    _, a, slot = _filled_pair(dtype)
    header, blobs = migration.export_slot(a, slot)
    pages = migration.unpack(header, *blobs)
    b = PagedKVCache(2, 2, 64, 2, 4, page_size=16, num_pages=8, dtype=dtype,
                     device="cpu")
    s2 = b.adopt_pages(1, pages["offset"], pages["k_pages"],
                       pages["v_pages"], pages["k_scales"],
                       pages["v_scales"])
    assert s2 is not None and int(b.offsets[s2]) == 37
    names = ["k_pool", "v_pool"] + (["k_scale", "v_scale"]
                                    if dtype == "int8" else [])
    for li in range(2):
        for name in names:
            for j in range(3):
                assert torch.equal(
                    b.layers[li][name][int(b.table[s2, j])],
                    a.layers[li][name][int(a.table[slot, j])])
    assert b._shared[s2] == 0 and len(b._private[s2]) == 3
    assert b._reserved[s2] == 1


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_adopted_pages_attention_bit_equal(dtype):
    """The paged attention op over the adopted pool (from the port's
    payload and from JAX's) reads bit-identically to the sender's pool;
    the adoption writes into the pool tensors in place."""
    jc, a, slot = _filled_pair(dtype, layers=1, offset=41, seed=1)
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.normal(size=(2, 1, 4, 4)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(2, 1, 2, 4)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(2, 1, 2, 4)).astype(np.float32))
    payloads = [migration.unpack(*_split(migration.export_slot(a, slot))),
                jax_migration.unpack(*_split(
                    jax_migration.export_slot(jc, slot)))]
    outs = []
    caches = [(a, slot)]
    for pages in payloads:
        b = PagedKVCache(1, 2, 64, 2, 4, page_size=16, num_pages=9,
                         dtype=dtype, device="cpu")
        pools = [t.data_ptr() for t in b.layers[0].values()
                 if isinstance(t, torch.Tensor)]
        s2 = b.adopt_pages(0, pages["offset"], pages["k_pages"],
                           pages["v_pages"], pages["k_scales"],
                           pages["v_scales"])
        assert pools == [t.data_ptr() for t in b.layers[0].values()
                         if isinstance(t, torch.Tensor)]
        caches.append((b, s2))
    for cache, s in caches:
        lay = cache.layer_caches()[0]
        kw = {}
        if dtype == "int8":
            kw = {"k_scale": lay["k_scale"].clone(),
                  "v_scale": lay["v_scale"].clone()}
        res = IF.paged_masked_multihead_attention(
            q, k, v, lay["k_pool"].clone(), lay["v_pool"].clone(),
            lay["page_table"], lay["offset"], cache.page_size, **kw)
        out = res[0] if isinstance(res, tuple) else res
        outs.append(out[s])
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])


def _split(header_blobs):
    header, blobs = header_blobs
    return (header, *blobs)


def test_adopt_pages_backpressure_and_validation():
    _, a, slot = _filled_pair("float32", offset=40, seed=2)
    header, blobs = migration.export_slot(a, slot)
    pages = migration.unpack(header, *blobs)

    def cache(layers=2, slots=2, page=16, pages_=None, dtype="float32"):
        return PagedKVCache(layers, slots, 64, 2, 4, page_size=page,
                            num_pages=pages_, dtype=dtype, device="cpu")
    assert cache(slots=1, pages_=2).adopt_pages(
        0, pages["offset"], pages["k_pages"], pages["v_pages"]) is None
    with pytest.raises(PageMigrationError, match="pool"):
        cache(layers=3).adopt_pages(0, pages["offset"], pages["k_pages"],
                                    pages["v_pages"])
    with pytest.raises(PageMigrationError, match="pool"):
        cache(page=8).adopt_pages(0, pages["offset"], pages["k_pages"],
                                  pages["v_pages"])
    with pytest.raises(PageMigrationError, match="dtype"):
        cache(dtype="bfloat16").adopt_pages(
            0, pages["offset"], pages["k_pages"], pages["v_pages"])
    with pytest.raises(PageMigrationError, match="scales"):
        cache().adopt_pages(0, pages["offset"], pages["k_pages"],
                            pages["v_pages"],
                            np.ones((2, 3, 16), np.float32),
                            np.ones((2, 3, 16), np.float32))
    with pytest.raises(PageMigrationError, match="offset"):
        cache().adopt_pages(0, 49, pages["k_pages"], pages["v_pages"])


def test_prefix_tree_pages_migrate_as_copies():
    """Tree-owned (shared) pages export by value: the receiver owns
    private copies, and the sender's tree keeps its page."""
    _, a, slot = _filled_pair("float32", layers=1, offset=41, seed=3)
    shared_page = a.make_shared(slot, 0)
    free_before = a.free_page_count
    header, blobs = migration.export_slot(a, slot)
    pages = migration.unpack(header, *blobs)
    b = PagedKVCache(1, 2, 64, 2, 4, page_size=16, num_pages=9,
                     device="cpu")
    s2 = b.adopt_pages(0, pages["offset"], pages["k_pages"],
                       pages["v_pages"])
    assert b._shared[s2] == 0 and len(b._private[s2]) == 3
    assert torch.equal(b.layers[0]["k_pool"][int(b.table[s2, 0])],
                       a.layers[0]["k_pool"][shared_page])
    a.release(slot)
    assert a.free_page_count == free_before + 2
    a.reclaim(shared_page)
    assert a.free_page_count == free_before + 3


# ------------------------------------------------------------------
# engine-level handoff, resume, fallback
# ------------------------------------------------------------------

def _local_migrator(target_engine, name="peer"):
    """A single-phase in-process migrator: unpack and resume on the
    target engine, return the completed payload."""
    def migrate(req, header, blobs, target):
        pages = migration.unpack(header, *blobs)
        fut = target_engine.submit_resume(
            req.prompt, list(req.tokens), pages,
            max_new_tokens=req.max_new_tokens, sampling=req.sampling,
            eos_token_id=req.eos_token_id, ttft_ms=req.ttft_ms)
        out = fut.result(timeout=120)
        return {"request_id": req.id, "replica": name,
                "output_ids": out.output_ids,
                "finish_reason": out.finish_reason}
    return migrate


SAMPLINGS = [None, SamplingParams(temperature=0.8, top_k=20, seed=123),
             SamplingParams(temperature=0.7, top_p=0.9,
                            repetition_penalty=1.1, seed=7)]


@pytest.mark.parametrize("tick", [True, False])
def test_engine_handoff_bit_equal_greedy_and_seeded(model, tick):
    """A handed-off request's stream (the first token from the prefill
    engine, the rest decoded from adopted pages) equals a single-engine
    run, greedy, seeded and seeded with a penalty; with the tick on, the
    decode engine's every decode step is a tick (the resumed slot's
    state rebuilt from its tokens, penalty mask and key position)."""
    p = _prompts([9], seed=4)[0]
    refs = [_ref(model, p, 8, sp) for sp in SAMPLINGS]
    set_flags({"FLAGS_compiled_tick": tick})
    try:
        eng_p = Engine(model, ServingConfig(num_slots=2,
                                            role="prefill")).start()
        eng_d = Engine(model, ServingConfig(num_slots=2,
                                            role="decode")).start()
        try:
            eng_p.migrator = _local_migrator(eng_d)
            for sp, want in zip(SAMPLINGS, refs):
                out = eng_p.submit(p, max_new_tokens=8, sampling=sp,
                                   handoff={"name": "peer"}) \
                    .result(timeout=180)
                assert out.decoded_by == "peer"
                np.testing.assert_array_equal(out.output_ids, want)
            snap = serving_stats()
            assert snap["migrations"] >= 3
            assert snap["migration_pages_sent"] >= 3
            assert snap["migration_resumed_requests"] >= 3
            assert snap["migration_fallbacks"] == 0
            assert (snap["tick_compiled_hits"] == snap["decode_steps"]
                    > 0) == tick
            assert eng_p.cache.pages_in_use == 0
            assert eng_d.cache.pages_in_use == 0
        finally:
            eng_p.shutdown()
            eng_d.shutdown()
    finally:
        set_flags({"FLAGS_compiled_tick": True})


def test_engine_handoff_fallback_decodes_locally(model):
    """A dead migration target costs latency, never the request: the
    engine decodes it locally, bit-equal, and leaks no page."""
    p = _prompts([7], seed=5)[0]
    want = _ref(model, p, 6)
    eng = Engine(model, ServingConfig(num_slots=2, role="prefill")).start()
    try:
        def dead(req, header, blobs, target):
            raise ConnectionError("target died mid-transfer")
        eng.migrator = dead
        out = eng.submit(p, max_new_tokens=6,
                         handoff={"name": "x"}).result(timeout=180)
        np.testing.assert_array_equal(out.output_ids, want)
        assert out.decoded_by is None
        assert serving_stats()["migration_fallbacks"] == 1
        assert eng.cache.pages_in_use == 0
    finally:
        eng.shutdown()


def _resume_errors(eng, payload_cls):
    """(type name, message) of each invalid `submit_resume` call."""
    pages = {"offset": 5,
             "k_pages": payload_cls(np.zeros((2, 1, 16, 2, 16), np.float32)),
             "v_pages": payload_cls(np.zeros((2, 1, 16, 2, 16), np.float32)),
             "k_scales": None, "v_scales": None}
    p = _prompts([5], seed=6)[0]
    out = []
    for args, kw in (((p, [], pages), {"max_new_tokens": 4}),
                     ((p, [1, 2, 3, 4], pages), {"max_new_tokens": 4}),
                     ((p, [1], dict(pages, offset=9)),
                      {"max_new_tokens": 4}),
                     ((p, [1] * 60, pages), {"max_new_tokens": 100}),
                     ((p, [1], pages), {"max_new_tokens": 400})):
        with pytest.raises(Exception) as ei:
            eng.submit_resume(*args, **kw)
        out.append((type(ei.value).__name__, str(ei.value)))
    return out


def test_submit_resume_validation_matches_jax(pair):
    from paddle_tpu.serving import Engine as JaxEngine
    from paddle_tpu.serving import ServingConfig as JaxServingConfig
    jm, tm = pair
    with JaxEngine(jm, JaxServingConfig(num_slots=2,
                                        kv_pool_pages=3)) as eng:
        want = _resume_errors(eng, np.asarray)
    with Engine(tm, ServingConfig(num_slots=2, kv_pool_pages=3)) as eng:
        got = _resume_errors(eng, torch.from_numpy)
    assert got == want
    assert [t for t, _ in got] == ["ValueError", "ValueError",
                                   "PageMigrationError", "ValueError",
                                   "PageMigrationError"]


# ------------------------------------------------------------------
# thread-mode fleets: the role-aware router and migration over rpc
# ------------------------------------------------------------------

_FAST = dict(heartbeat_interval_s=0.15, heartbeat_ttl_s=1.2)


class _RoleFleet:
    """A thread-mode disaggregated fleet of one package: named (role,
    ServingConfig) replicas and a role-aware router on one TCP store."""

    def __init__(self, model, specs, disaggregation=True, pkg=None):
        if pkg is None:
            store_cls, rep_cls, rcfg_cls, router_cls, router_cfg = (
                TCPStore, ReplicaServer, ReplicaConfig, ServingRouter,
                RouterConfig)
        else:
            store_cls, rep_cls, rcfg_cls, router_cls, router_cfg = pkg
        self.master = store_cls(is_master=True)
        self.reps = {}
        for name, scfg in specs.items():
            self.reps[name] = rep_cls(
                name, model, store_cls("127.0.0.1", self.master.port),
                scfg, rcfg_cls(**_FAST).validate())
        self.router = router_cls(
            store_cls("127.0.0.1", self.master.port),
            router_cfg(heartbeat_ttl_s=1.2, poll_interval_s=0.1,
                       disaggregation=disaggregation)).start()
        deadline = time.monotonic() + 30
        while len(self.router.ring.members) < len(specs):
            assert time.monotonic() < deadline, \
                f"ring never filled: {self.router.replicas()}"
            time.sleep(0.05)

    def close(self):
        self.router.close()
        for rep in self.reps.values():
            rep.close()
        self.master.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _jax_fleet_pkg():
    from paddle_tpu.distributed.store import TCPStore as JStore
    from paddle_tpu.serving import (ReplicaConfig as JRC,
                                    ReplicaServer as JRS,
                                    RouterConfig as JRoC,
                                    ServingRouter as JRouter)
    return JStore, JRS, JRC, JRouter, JRoC


def test_fleet_handoff_matches_jax_fleet(pair):
    """The same requests (greedy, seeded, seeded with a penalty) through
    a prefill → decode fleet of each package on the same weights: equal
    tokens, every request decoded by the decode replica, both pools
    empty afterwards."""
    from paddle_tpu.serving import ServingConfig as JaxServingConfig
    from paddle_tpu.utils.flags import set_flags as jax_set_flags
    jm, tm = pair
    prompts = _prompts([5, 9, 6], seed=7)
    samplings = [None, SamplingParams(temperature=0.8, top_k=20, seed=123),
                 SamplingParams(temperature=0.7, top_p=0.9,
                                repetition_penalty=1.1, seed=7)]

    def run(model, cfg_cls, pkg, sp_cls):
        specs = {"rep-p": cfg_cls(num_slots=2, role="prefill"),
                 "rep-d": cfg_cls(num_slots=4, role="decode")}
        with _RoleFleet(model, specs, pkg=pkg) as f:
            futs = [f.router.submit(
                p, max_new_tokens=6, session_id=i,
                sampling=None if sp is None else sp_cls(
                    temperature=sp.temperature, top_k=sp.top_k,
                    top_p=sp.top_p,
                    repetition_penalty=sp.repetition_penalty,
                    seed=sp.seed))
                for i, (p, sp) in enumerate(zip(prompts, samplings))]
            outs = [fut.result(timeout=300) for fut in futs]
            left = [r.engine.cache.pages_in_use for r in f.reps.values()]
        return outs, left

    from paddle_tpu.serving import SamplingParams as JaxSamplingParams
    jax_set_flags({"FLAGS_compiled_tick": False})
    try:
        want, jleft = run(jm, JaxServingConfig, _jax_fleet_pkg(),
                          JaxSamplingParams)
    finally:
        jax_set_flags({"FLAGS_compiled_tick": True})
    got, tleft = run(tm, ServingConfig, None, SamplingParams)
    for w, g, p, sp in zip(want, got, prompts, samplings):
        np.testing.assert_array_equal(g.output_ids, w.output_ids)
        np.testing.assert_array_equal(g.output_ids, _ref(tm, p, 6, sp))
        assert g.decoded_by == w.decoded_by == "rep-d"
    assert jleft == tleft == [0, 0]


def test_fleet_disagg_routes_prefill_and_migrates(model):
    """Requests land on the prefill replica, their pages migrate, and the
    decode replica finishes them; counters and per-role telemetry
    advance; both engines return every page."""
    specs = {"rep-p": ServingConfig(num_slots=2, role="prefill"),
             "rep-d": ServingConfig(num_slots=4, role="decode")}
    prompts = _prompts([5, 9, 6], seed=8)
    refs = [_ref(model, p, 5) for p in prompts]
    with _RoleFleet(model, specs) as f:
        base = serving_stats()
        futs = [f.router.submit(p, max_new_tokens=5, session_id=i)
                for i, p in enumerate(prompts)]
        outs = [fut.result(timeout=300) for fut in futs]
        for want, o in zip(refs, outs):
            np.testing.assert_array_equal(o.output_ids, want)
            assert o.decoded_by == "rep-d"
        snap = serving_stats()
        assert snap["migrations"] - base["migrations"] >= 3
        assert snap["migration_resumed_requests"] >= 3
        assert snap["migration_fallbacks"] == base["migration_fallbacks"]
        assert f.reps["rep-p"].engine.cache.pages_in_use == 0
        assert f.reps["rep-d"].engine.cache.pages_in_use == 0
        from paddle_tpu_torch.observability import render_prometheus
        assert 'serving_router_requests_routed_role{role="prefill"}' \
            in render_prometheus()


def test_fleet_disagg_no_decode_replica_degrades_to_local(model):
    specs = {"rep-p": ServingConfig(num_slots=2, role="prefill")}
    p = _prompts([6], seed=9)[0]
    want = _ref(model, p, 4)
    with _RoleFleet(model, specs) as f:
        out = f.router.submit(p, max_new_tokens=4,
                              session_id="solo").result(timeout=300)
        np.testing.assert_array_equal(out.output_ids, want)
        assert out.decoded_by == "rep-p"


def test_fleet_disagg_off_ignores_roles(model):
    specs = {"rep-p": ServingConfig(num_slots=2, role="prefill"),
             "rep-d": ServingConfig(num_slots=2, role="decode")}
    prompts = _prompts([5, 7, 6, 8], seed=10)
    refs = [_ref(model, p, 4) for p in prompts]
    with _RoleFleet(model, specs, disaggregation=False) as f:
        base = serving_stats()
        futs = [f.router.submit(p, max_new_tokens=4, session_id=i)
                for i, p in enumerate(prompts)]
        for want, fut in zip(refs, futs):
            o = fut.result(timeout=300)
            np.testing.assert_array_equal(o.output_ids, want)
            assert o.decoded_by in ("rep-p", "rep-d")
        assert serving_stats()["migrations"] == base["migrations"]


def test_drain_migrates_active_requests_to_survivor(model):
    """Draining a role-specialized replica streams its mid-decode slots
    to the survivor, which resumes them: streams bit-equal, and no
    prompt prefilled again (the survivor ran no prefill chunk)."""
    specs = {"rep-a": ServingConfig(num_slots=2, role="prefill"),
             "rep-b": ServingConfig(num_slots=4, role="decode")}
    prompts = _prompts([6, 8], seed=11)
    refs = [_ref(model, p, 40) for p in prompts]
    with _RoleFleet(model, specs, disaggregation=False) as f:
        base = serving_stats()
        key = next(f"s{i}" for i in range(1000)
                   if f.router.ring.lookup(f"s{i}") == "rep-a")
        futs = [f.router.submit(p, max_new_tokens=40, session_id=key)
                for p in prompts]
        eng = f.reps["rep-a"].engine
        deadline = time.monotonic() + 60
        while len(eng._active) < 2:
            assert time.monotonic() < deadline, "never started decoding"
            time.sleep(0.005)
        chunks = serving_stats()["prefill_chunks"]
        drainer = threading.Thread(target=f.reps["rep-a"].drain,
                                   kwargs={"deadline_s": 60.0})
        drainer.start()
        outs = [fut.result(timeout=300) for fut in futs]
        drainer.join(120)
        assert not drainer.is_alive()
        for want, o in zip(refs, outs):
            np.testing.assert_array_equal(o.output_ids, want)
        snap = serving_stats()
        migrated = [o for o in outs if o.decoded_by == "rep-b"]
        assert migrated, "drain never migrated a request"
        assert snap["migration_resumed_requests"] \
            - base["migration_resumed_requests"] >= len(migrated)
        assert snap["prefill_chunks"] == chunks
        assert f.reps["rep-b"].engine.cache.pages_in_use == 0


def test_role_flip_rejoins_with_bumped_generation(model):
    specs = {"rep-f": ServingConfig(num_slots=2, role="prefill"),
             "rep-g": ServingConfig(num_slots=2, role="decode")}
    p = _prompts([5], seed=12)[0]
    want = _ref(model, p, 4)
    with _RoleFleet(model, specs) as f:
        rep = f.reps["rep-f"]
        gen0 = rep.gen
        rep.drain(deadline_s=30.0)
        deadline = time.monotonic() + 15
        while "rep-f" in f.router.ring.members:
            assert time.monotonic() < deadline
            time.sleep(0.05)
        flipped = ReplicaServer(
            "rep-f", model, TCPStore("127.0.0.1", f.master.port),
            ServingConfig(num_slots=2, role="decode"),
            ReplicaConfig(**_FAST))
        f.reps["rep-f"] = flipped
        assert flipped.gen > gen0
        deadline = time.monotonic() + 30
        while "rep-f" not in f.router.ring.members:
            assert time.monotonic() < deadline, f.router.replicas()
            time.sleep(0.05)
        with f.router._lock:
            assert f.router._replicas["rep-f"].role == "decode"
        out = f.router.submit(p, max_new_tokens=4,
                              session_id="postflip").result(timeout=300)
        np.testing.assert_array_equal(out.output_ids, want)


def test_config_validation():
    from paddle_tpu.serving import ServingConfig as JaxServingConfig
    for role in ("mixed", "prefill", "decode"):
        assert ServingConfig(role=role).validate().role == role
    for cls in (ServingConfig, JaxServingConfig):
        with pytest.raises(ValueError, match="role"):
            cls(role="bogus").validate()
    assert RouterConfig().disaggregation is False
    assert ReplicaConfig().migrate_on_drain is True
    assert ServingConfig().role == "mixed"


def test_deadline_propagates_through_migration(model):
    """A client deadline bounds the whole migrated request: a generous
    one rides through the handoff, one that expires while the slowed
    decode replica holds the request surfaces `DeadlineExceededError`,
    and both replicas return every page."""
    specs = {"rep-p": ServingConfig(num_slots=2, role="prefill"),
             "rep-d": ServingConfig(num_slots=4, role="decode")}
    p = _prompts([6], seed=20)[0]
    want = _ref(model, p, 5)
    with _RoleFleet(model, specs) as f:
        out = f.router.submit(p, max_new_tokens=5, deadline_s=60.0,
                              session_id="ok").result(timeout=300)
        np.testing.assert_array_equal(out.output_ids, want)
        assert out.decoded_by == "rep-d"
        set_flags({"FLAGS_fault_inject":
                   "engine_slow:to=rep-d,delay_s=0.4,count=200"})
        try:
            with pytest.raises(DeadlineExceededError):
                f.router.submit(p, max_new_tokens=24, deadline_s=1.5,
                                session_id="late").result(timeout=120)
        finally:
            set_flags({"FLAGS_fault_inject": ""})
        deadline = time.monotonic() + 60
        for name in ("rep-p", "rep-d"):
            eng = f.reps[name].engine
            while eng.cache.pages_in_use or eng._active:
                assert time.monotonic() < deadline, \
                    f"{name} leaked pages after deadline evict"
                time.sleep(0.05)
        assert serving_stats()["requests_evicted_deadline"] >= 1


def test_mid_transfer_deadline_leaves_no_pages_on_either_side(model):
    specs = {"rep-p": ServingConfig(num_slots=2, role="prefill"),
             "rep-d": ServingConfig(num_slots=4, role="decode")}
    p = _prompts([7], seed=21)[0]
    want = _ref(model, p, 4)
    with _RoleFleet(model, specs) as f:
        set_flags({"FLAGS_fault_inject":
                   "rpc_slow:to=rep-d,delay_s=2.0,count=8"})
        try:
            with pytest.raises(DeadlineExceededError):
                f.router.submit(p, max_new_tokens=16, deadline_s=1.2,
                                session_id="midxfer").result(timeout=120)
        finally:
            set_flags({"FLAGS_fault_inject": ""})
        deadline = time.monotonic() + 60
        for name in ("rep-p", "rep-d"):
            eng = f.reps[name].engine
            while eng.cache.pages_in_use or eng._active:
                assert time.monotonic() < deadline, \
                    f"{name} leaked pages after mid-transfer deadline"
                time.sleep(0.05)
        out = f.router.submit(p, max_new_tokens=4,
                              session_id="after").result(timeout=300)
        np.testing.assert_array_equal(out.output_ids, want)
