"""A serving replica split over two mp ranks (`serving.tp_replica`)
behind the fleet's router, on gloo in fp32, against the JAX package:
the tiny Llama (2 layers, hidden 64, 4 heads, 2 kv heads) with JAX's
weights through `convert`.

- a tp 1 prefill replica hands its requests to a tp 2 decode replica
  (tp 1 → tp 2 migration: each rank keeps its kv heads of the global
  pages); greedy and seeded requests equal JAX's `Engine` token for token
  (JAX's tensor-parallel replica is that engine under a mesh);
- a drain of the tp 2 replica migrates its slots onto a tp 1 decode
  replica (the ranks' heads gathered into global pages) and loses
  nothing; a SIGKILLed follower takes its replica out of the ring, and
  the router completes every request elsewhere;
- in one process, a leader engine's descriptors replayed by a follower
  leave the same pools bit for bit, and a follower fed a wrong token
  raises `DesyncError`;
- `ReplicaConfig(tensor_parallel_degree=2)` validates; 0 still gives
  JAX's error; what the followers cannot mirror raises naming A8.

Every wait has its own time limit."""
import functools
import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_config as jax_llama_config
from paddle_tpu.serving import Engine as JaxEngine
from paddle_tpu.serving import SamplingParams as JaxSamplingParams
from paddle_tpu.serving import ServingConfig as JaxServingConfig
from paddle_tpu.serving.fleet import ReplicaConfig as JaxReplicaConfig
from paddle_tpu_torch.distributed import DesyncError, rpc
from paddle_tpu_torch.serving import (Engine, ReplicaConfig, RouterConfig,
                                      SamplingParams, ServingConfig,
                                      ServingFleet)
from paddle_tpu_torch.serving import tp_replica

from _torch_dist_worker import replica_probe, tp_llama

CFG = dict(num_layers=2, hidden_size=64, num_heads=4, num_kv_heads=2,
           intermediate_size=192, vocab_size=256, max_seq_len=256)
#: leases and rank beats: long enough that a loaded machine's late beat
#: is not a death
TTL = 6.0
RC1 = ReplicaConfig(heartbeat_interval_s=0.3, heartbeat_ttl_s=TTL)
RC2 = ReplicaConfig(heartbeat_interval_s=0.3, heartbeat_ttl_s=TTL,
                    tensor_parallel_degree=2, device="cpu")


def _prompts(lens, seed=11):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, CFG["vocab_size"], (n,)).astype(np.int32)
            for n in lens]


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """JAX's tiny Llama and its state saved for the replicas' factory."""
    paddle.seed(21)
    jm = JaxLlama(jax_llama_config("tiny", **CFG))
    jm.eval()
    path = tmp_path_factory.mktemp("tp") / "state.npz"
    np.savez(path, **{k: np.asarray(v.numpy())
                      for k, v in jm.state_dict().items()})
    return jm, str(path)


def _fleet(path, configs, roles):
    return ServingFleet(
        functools.partial(tp_llama, CFG, path), len(roles),
        ServingConfig(num_slots=2, max_seq_len=CFG["max_seq_len"]), RC1,
        RouterConfig(heartbeat_ttl_s=TTL, poll_interval_s=0.05,
                     disaggregation=True, rpc_timeout_s=120.0,
                     request_timeout_s=120.0),
        roles=roles, replica_configs=configs)


def _probe(name):
    return rpc.rpc_sync(name, replica_probe, args=(name,), timeout=30)


def _wait(what, cond, timeout=60.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.02)


def _jax_tokens(jm, subs):
    eng = JaxEngine(jm, JaxServingConfig(
        num_slots=2, max_seq_len=CFG["max_seq_len"])).start()
    try:
        futs = [eng.submit(p, max_new_tokens=n, sampling=None if s is None
                           else JaxSamplingParams(**s)) for p, n, s in subs]
        return [np.asarray(f.result(timeout=300).output_ids) for f in futs]
    finally:
        eng.shutdown()


def test_tp_config_validates_as_jax():
    assert ReplicaConfig(tensor_parallel_degree=2).validate().device is None
    for cls in (ReplicaConfig, JaxReplicaConfig):
        with pytest.raises(ValueError, match="tensor_parallel_degree"):
            cls(tensor_parallel_degree=0).validate()


def test_tp2_decode_replica_tokens_equal_jax(weights):
    """tp 1 prefill → tp 2 decode: greedy and seeded requests equal the
    JAX engine's tokens exactly; the decode replica ran its compiled tick
    on both ranks (its mirror sent a descriptor a call)."""
    jm, path = weights
    prompts = _prompts([5, 9, 17, 30])
    subs = [(prompts[0], 8, None), (prompts[1], 8, dict(
        temperature=0.8, top_k=20, seed=3)), (prompts[2], 8, None),
        (prompts[3], 8, dict(temperature=1.0, top_p=0.9,
                             repetition_penalty=1.3, seed=5))]
    want = _jax_tokens(jm, subs)
    fleet = _fleet(path, [RC1, RC2], ["prefill", "decode"])
    try:
        fleet.start(warmup_timeout_s=120)
        states = fleet.replica_states(detail=True)
        assert states["replica-0"]["tp"] == 1
        assert states["replica-1"]["tp"] == 2
        futs = [fleet.submit(p, max_new_tokens=n, sampling=None if s is None
                             else SamplingParams(**s)) for p, n, s in subs]
        outs = [f.result(timeout=120) for f in futs]
        dec = _probe("replica-1")
        # the follower ran every descriptor (its beat carries its count)
        _wait("the follower's beat after the traffic", lambda: (
            _probe("replica-1")["follower"] or {}).get("calls")
            == dec["descriptors"], timeout=30)
    finally:
        fleet.shutdown()
    for o, w in zip(outs, want):
        np.testing.assert_array_equal(o.output_ids, w)
        assert o.decoded_by == "replica-1"
    assert dec["kv_heads"] == 1          # 2 kv heads over mp 2
    assert dec["stats"]["tick_compiled_hits"] > 0
    assert dec["stats"]["migration_resumed_requests"] == len(subs)
    assert dec["descriptors"] >= dec["stats"]["decode_steps"]


def test_tp2_drain_onto_tp1_then_follower_sigkill(weights):
    """(1) The tp 2 decode replica drains mid-decode: its slots migrate
    to a tp 1 decode replica (global pages gathered from both ranks) and
    finish there with the single engine's tokens, nothing resubmitted.
    (2) A new tp 2 replica loses its follower to SIGKILL mid-decode: the
    leader leaves the ring and exits, and the router completes every
    request elsewhere with the same tokens."""
    _, path = weights
    ref_model = tp_llama(CFG, path)
    prompts = _prompts([6, 8, 11, 7], seed=4)
    new = 64
    with Engine(ref_model, ServingConfig(
            num_slots=2, max_seq_len=CFG["max_seq_len"])) as eng:
        want = [eng.generate(p, max_new_tokens=new).output_ids
                for p in prompts]
    fleet = _fleet(path, [RC1, RC2, RC1], ["prefill", "decode", "decode"])
    try:
        fleet.start(warmup_timeout_s=120)
        names = ("replica-1", "replica-2")
        base = fleet.stats()["router_resubmissions"]
        futs = [fleet.submit(p, max_new_tokens=new) for p in prompts[:2]]
        # the router hands each request to the least loaded decode
        # replica (replica-1 on a tie): wait until both are adopted
        _wait("both requests adopted", lambda: sum(
            _probe(n)["stats"]["migration_resumed_requests"]
            for n in names) == 2)
        in_flight = _probe("replica-1")["active"]
        resumed = _probe("replica-2")["stats"]["migration_resumed_requests"]
        ranks = fleet._ranks["replica-1"]
        fleet.drain_replica("replica-1")
        outs = [f.result(timeout=120) for f in futs]
        for p in ranks:
            p.join(60)
        assert [p.exitcode for p in ranks] == [0, 0]
        moved = _probe("replica-2")["stats"][
            "migration_resumed_requests"] - resumed
        assert 0 < moved == in_flight
        assert fleet.stats()["router_resubmissions"] == base
        for o, w in zip(outs, want[:2]):
            np.testing.assert_array_equal(o.output_ids, w)
        # (2) a fresh tp 2 replica, the only decode replica once replica-2
        # drained; its follower is killed mid-decode
        fleet.add_replica(role="decode", replica_config=RC2)   # replica-3
        fleet.drain_replica("replica-2")
        fleet._procs["replica-2"].join(60)
        fleet.wait_ready(2, timeout=120)
        _wait("replica-3 alone in the ring", lambda: sorted(
            fleet.router.ring.members) == ["replica-0", "replica-3"])
        futs = [fleet.submit(p, max_new_tokens=new) for p in prompts[2:]]
        _wait("a request decoding on replica-3",
              lambda: _probe("replica-3")["active"] >= 1)
        t0 = time.monotonic()
        fleet.kill_replica("replica-3", rank=1)
        outs = [f.result(timeout=120) for f in futs]
        leader = fleet._procs["replica-3"]
        leader.join(30)
        assert leader.exitcode == 101
        assert "replica-3" not in fleet.replica_states()
        assert time.monotonic() - t0 < 60
        for o, w in zip(outs, want[2:]):
            np.testing.assert_array_equal(o.output_ids, w)
    finally:
        fleet.shutdown()


class _ListMirror(tp_replica.StepMirror):
    """A leader mirror whose channel is a list (one process)."""

    def __init__(self, ctx):
        super().__init__(ctx)
        self.sent = []

    def _send(self, kind, **payload):
        self.sent.append(dict(payload, kind=kind, seq=self.seq,
                              check=self._check))
        self._check = None
        self.seq += 1


def _one_rank_ctx():
    from paddle_tpu_torch.distributed import collective
    return tp_replica.TPContext(0, 1, collective.Group([0]), "local")


def test_follower_replays_descriptors_and_catches_desync(weights):
    """At mp 1 a leader engine's descriptors (prefill, the tick's modes,
    an uncompiled step, a migration's export and adoption) replayed by a
    follower with its own copy of the model leave its pools equal to the
    leader's bit for bit; a descriptor whose check carries another token
    raises `DesyncError`."""
    _, path = weights
    scfg = ServingConfig(num_slots=2, max_seq_len=CFG["max_seq_len"])
    mirror = _ListMirror(_one_rank_ctx())
    leader = Engine(tp_llama(CFG, path), scfg)
    mirror.attach(leader)
    follower = tp_replica.StepFollower(_one_rank_ctx(), tp_llama(CFG, path),
                                       scfg)
    prompts = _prompts([5, 21, 9])
    leader.start()
    try:
        outs = [leader.submit(p, max_new_tokens=6, sampling=s) for p, s in
                zip(prompts, (None, SamplingParams(
                    temperature=0.9, top_k=8, seed=2), SamplingParams(
                    repetition_penalty=1.2)))]
        [f.result(timeout=60) for f in outs]
    finally:
        leader.shutdown()
    kinds = {d["kind"] for d in mirror.sent}
    assert {"prefill", "tick"} <= kinds
    for desc in mirror.sent:
        follower.step(desc)
    for mine, theirs in zip(follower.engine.cache.layers,
                            leader.cache.layers):
        for name in ("k_pool", "v_pool"):
            assert torch.equal(mine[name], theirs[name])
    # the last call's check, one token off
    seq, tokens, fin = mirror._check
    slot = next(iter(tokens))
    wrong = dict(tokens)
    wrong[slot] = (tokens[slot] + 1) % CFG["vocab_size"]
    bad = dict(kind="stop", seq=seq + 1, check=(seq, wrong, fin))
    with pytest.raises(DesyncError, match="diverged"):
        follower.step(bad)


def test_tp_refuses_what_it_cannot_mirror():
    model = tp_llama(CFG)
    for kw in (dict(kv_layout="slots"), dict(cache_dtype="int8"),
               dict(speculation_k=2, draft_model=tp_llama(CFG, seed=1))):
        eng = Engine(model, ServingConfig(num_slots=2, **kw))
        with pytest.raises(NotImplementedError, match="A8"):
            tp_replica.StepMirror(_one_rank_ctx()).attach(eng)
