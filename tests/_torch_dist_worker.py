"""Ranks for the port's multi-process CPU tests: each rank is a spawned
process that joins a gloo process group through a file rendezvous (no
fixed port: the suite runs in several workers at once), runs one case
and pickles what it saw into the case's directory.  Imports torch, numpy
and paddle_tpu_torch only (the parent test holds the results against the
JAX package).

    from _torch_dist_worker import run_ranks
    outs = run_ranks(4, "hybrid_llama", tmp_path, inputs)   # [rank0, ...]
    outs = run_ranks(2, "many", tmp_path, {"cases": [(key, case, inputs),
                                                     ...]})
"""
from __future__ import annotations

import os
import pickle
import sys
import time
import traceback

import numpy as np
import torch

# the repository root, for the spawned ranks that import the port
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)


def run_ranks(world, case, tmp_path, inputs=None, timeout=240):
    """Run ``case`` on ``world`` gloo ranks; returns each rank's result
    (a rank's exception is raised here with its traceback)."""
    import torch.multiprocessing as mp
    d = str(tmp_path / f"{case}-{world}")
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs or {}, f)
    ctx = mp.start_processes(_main, args=(world, d, case), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{case} on {world} ranks: {timeout} s")
    outs = []
    for r in range(world):
        with open(os.path.join(d, f"out-{r}.pkl"), "rb") as f:
            res = pickle.load(f)
        if isinstance(res, dict) and "__error__" in res:
            raise RuntimeError(f"rank {r} of {case}:\n{res['__error__']}")
        outs.append(res)
    return outs


def _main(rank, world, d, case):
    torch.set_num_threads(1)
    from paddle_tpu_torch.distributed import env
    env.init_parallel_env(backend="gloo", init_method="file://" +
                          os.path.join(d, "rdzv"), world_size=world,
                          rank=rank)
    with open(os.path.join(d, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    try:
        res = CASES[case](rank, world, inputs)
    except BaseException:  # noqa: BLE001 — relayed to the parent
        res = {"__error__": traceback.format_exc()}
    with open(os.path.join(d, f"out-{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
    import torch.distributed as dist
    if "__error__" not in res:
        dist.barrier()
    dist.destroy_process_group()


def _np(t):
    return t.detach().float().numpy() if t.dtype == torch.bfloat16 \
        else t.detach().numpy()


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def case_collectives(rank, world, inputs):
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.observability import registry
    out = {}
    base = torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10 * rank
    for op in ("sum", "max", "min", "prod", "avg"):
        t = base.clone()
        C.all_reduce(t, op=op)
        out[f"all_reduce_{op}"] = t.numpy()
    t = torch.arange(4, dtype=torch.int64) + rank
    C.all_reduce(t, op=C.ReduceOp.AVG)
    out["avg_int"] = (t.dtype, t.numpy())
    parts = C.all_gather(None, base.clone())
    out["all_gather"] = [p.numpy() for p in parts]
    lst = []
    C.all_gather(lst, base.clone(), axis=0)
    out["all_gather_list"] = len(lst)
    out["all_gather_concat"] = C.all_gather_concat(base, axis=1).numpy()
    t = base.clone()
    C.broadcast(t, src=world - 1)
    out["broadcast"] = t.numpy()
    t = base.clone()
    C.reduce(t, dst=0, op=C.ReduceOp.SUM)
    out["reduce"] = t.numpy()
    t = torch.zeros(3)
    src_list = [torch.full((3,), 100.0 + i) for i in range(world)]
    C.scatter(t, src_list if rank == 0 else None, src=0)
    out["scatter"] = t.numpy()
    t = torch.zeros(3)
    C.reduce_scatter(t, [torch.full((3,), float(rank * world + i))
                         for i in range(world)])
    out["reduce_scatter"] = t.numpy()
    out["reduce_scatter_concat"] = C.reduce_scatter_concat(
        torch.arange(world * 2, dtype=torch.float32) + rank).numpy()
    outs = []
    C.all_to_all(outs, [torch.full((2,), float(10 * rank + j))
                        for j in range(world)])
    out["all_to_all"] = [o.numpy() for o in outs]
    # p2p: a ring through send/recv pairs in batch_isend_irecv
    buf = torch.full((3,), float(rank))
    got = torch.zeros(3)
    C.batch_isend_irecv([C.P2POp(C.isend, buf, (rank + 1) % world),
                         C.P2POp(C.irecv, got, (rank - 1) % world)])
    out["ring"] = got.numpy()
    if rank in (0, 1):
        t = torch.full((2,), 7.0) if rank == 0 else torch.zeros(2)
        if rank == 0:
            C.send(t, dst=1)
        else:
            C.recv(t, src=0)
        out["send_recv"] = t.numpy()
    # a subgroup of the even ranks (every rank calls new_group)
    evens = C.new_group([r for r in range(world) if r % 2 == 0])
    out["group_rank"] = evens.rank
    if rank % 2 == 0:
        t = torch.full((2,), float(rank))
        C.all_reduce(t, group=evens)
        out["even_sum"] = t.numpy()
    else:
        try:
            C.all_reduce(torch.ones(1), group=evens)
            out["outsider"] = "no error"
        except ValueError as e:
            out["outsider"] = str(e)
    C.barrier()
    calls = registry.REGISTRY.get("dist.collective_calls")
    out["calls"] = {op: calls.labels(op=op).value for op in (
        "all_reduce", "all_gather", "broadcast", "reduce", "scatter",
        "reduce_scatter", "all_to_all", "send", "recv", "barrier")}
    out["bytes"] = registry.REGISTRY.get("dist.collective_bytes").labels(
        op="broadcast").value
    return out


def case_guarded_collectives(rank, world, inputs):
    """`case_collectives` three times: the guardian off, armed (a trap
    over ``inputs["guard_dir"]``, a timeout, the desync check on every
    call) and on the host lane (``FLAGS_collective_backend=host``, the
    gather through the same store); then what the watchdog saw."""
    from paddle_tpu_torch.distributed import host_collectives, watchdog
    from paddle_tpu_torch.distributed.store import FileKVStore
    from paddle_tpu_torch.utils.flags import set_flags
    out = {}
    watchdog.reset()
    out["off"] = case_collectives(rank, world, inputs)
    out["off_token"] = watchdog.begin("all_reduce", _Probe())
    store = FileKVStore(inputs["guard_dir"])
    wd = watchdog.configure(store=store, job="j", rank=rank)
    set_flags({"FLAGS_collective_timeout_s": 30.0,
               "FLAGS_desync_check_every": 1})
    try:
        out["armed"] = case_collectives(rank, world, inputs)
        out["armed_seq"] = dict(wd._seq)
        out["armed_in_flight"] = wd.in_flight()
        out["armed_recent"] = len(wd.recent())
        host_collectives.reset()
        import os
        os.environ["PADDLE_GUARDIAN_DIR"] = inputs["guard_dir"]
        set_flags({"FLAGS_collective_backend": "host"})
        out["host"] = case_collectives(rank, world, inputs)
        out["host_keys"] = len(store.list_prefix("default/hc/"))
    finally:
        set_flags({"FLAGS_collective_timeout_s": 0.0,
                   "FLAGS_desync_check_every": 16,
                   "FLAGS_collective_backend": "auto"})
        watchdog.reset()
    return out


class _Probe:
    id, ranks, nranks = 0, [0, 1], 2


# ---------------------------------------------------------------------------
# the tensor-parallel layers (mp = world)
# ---------------------------------------------------------------------------

def case_mp_layers(rank, world, inputs):
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet import mp_layers as M
    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": 1, "mp_degree": world}
    fleet.init(is_collective=True, strategy=s, backend="gloo")
    out = {}
    x = torch.tensor(inputs["x"], requires_grad=True)
    w1, b1 = inputs["w1"], inputs["b1"]
    w2, b2 = inputs["w2"], inputs["b2"]

    def load(layer, w, b):
        layer._fill("weight", torch.tensor(w))
        if b is not None:
            layer._fill("bias", torch.tensor(b))

    for gather in (False, True):
        col = fleet.ColumnParallelLinear(w1.shape[0], w1.shape[1],
                                         gather_output=gather, device="cpu")
        row = fleet.RowParallelLinear(w2.shape[0], w2.shape[1],
                                      input_is_parallel=not gather,
                                      device="cpu")
        with torch.no_grad():
            load(col, w1, b1)
            load(row, w2, b2)
        xi = x.detach().clone().requires_grad_(True)
        y = row(torch.tanh(col(xi)))
        (y * torch.tensor(inputs["gy"])).sum().backward()
        tag = "gathered" if gather else "parallel"
        out[f"{tag}_y"] = y.detach().numpy()
        out[f"{tag}_dx"] = xi.grad.numpy()
        out[f"{tag}_dw1"] = M.unshard(
            list(M.C.all_gather(None, col.weight.grad)), 1).numpy()
        out[f"{tag}_dw2"] = M.unshard(list(
            M.C.all_gather(None, row.weight.grad)), 0).numpy()
        out[f"{tag}_db1"] = M.unshard(list(
            M.C.all_gather(None, col.bias.grad)), 0).numpy()
        out[f"{tag}_db2"] = row.bias.grad.numpy()
    # the fused q/k/v column over 3 chunks, gathered
    qkv = fleet.ColumnParallelLinear(w1.shape[0], 3 * 8, chunks=3,
                                     gather_output=True, device="cpu")
    with torch.no_grad():
        qkv._fill("weight", torch.tensor(inputs["w3"]))
        qkv._fill("bias", torch.tensor(inputs["b3"]))
    xi = x.detach().clone().requires_grad_(True)
    y = qkv(xi)
    y.square().sum().backward()
    out["chunks_y"] = y.detach().numpy()
    out["chunks_dx"] = xi.grad.numpy()
    # vocab-parallel embedding and cross entropy
    emb = fleet.VocabParallelEmbedding(*inputs["emb"].shape, device="cpu")
    with torch.no_grad():
        emb._fill("weight", torch.tensor(inputs["emb"]))
    ids = torch.tensor(inputs["ids"])
    e = emb(ids)
    (e * torch.tensor(inputs["ge"])).sum().backward()
    out["emb_y"] = e.detach().numpy()
    out["emb_dw"] = M.unshard(list(M.C.all_gather(None, emb.weight.grad)),
                              0).numpy()
    logits = torch.tensor(inputs["logits"])
    local = M.shard_of(logits, 1, world, rank).requires_grad_(True)
    ce = fleet.ParallelCrossEntropy(ignore_index=-100)
    loss = ce(local, torch.tensor(inputs["labels"]))
    loss.sum().backward()
    out["ce"] = loss.detach().numpy()
    out["ce_grad"] = M.unshard(list(M.C.all_gather(None, local.grad)),
                               1).numpy()
    # sequence parallel: x split on the sequence, column SP -> row SP
    xs = torch.tensor(inputs["xs"])
    colsp = fleet.ColumnSequenceParallelLinear(w1.shape[0], w1.shape[1],
                                               device="cpu")
    rowsp = fleet.RowSequenceParallelLinear(w2.shape[0], w2.shape[1],
                                            device="cpu")
    with torch.no_grad():
        load(colsp, w1, b1)
        load(rowsp, w2, b2)
    part = M.scatter(xs.clone().requires_grad_(True))
    part.retain_grad()
    ysp = rowsp(torch.tanh(colsp(part)))
    full = M.all_gather_seq(ysp)
    (full * torch.tensor(inputs["gys"])).sum().backward()
    out["sp_y"] = full.detach().numpy()
    out["sp_dx_part"] = part.grad.numpy()
    out["sp_dw1"] = M.unshard(list(M.C.all_gather(
        None, colsp.weight.grad)), 1).numpy()
    db2 = rowsp.bias.grad.clone()
    M.C.all_reduce(db2)                  # sequence-parallel: summed over mp
    out["sp_db2"] = db2.numpy()
    out["sp_marked"] = bool(getattr(rowsp.bias, "is_sequence_parallel",
                                    False))
    # a layer built over a group of one holds the global values: shard_
    # splits it onto this rank of the topology's mp group
    glob = fleet.ColumnParallelLinear(w1.shape[0], w1.shape[1],
                                      mp_group=M.C.Group([rank]),
                                      device="cpu")
    with torch.no_grad():
        load(glob, w1, b1)
    out["global_shape"] = tuple(glob.weight.shape)
    glob.shard_(None)
    out["sharded"] = (tuple(glob.weight.shape), glob.weight.detach().numpy(),
                      bool(glob.weight.mp_split))
    glob.shard_(None)                    # already split: a check
    return out


# ---------------------------------------------------------------------------
# hybrid dp x mp training
# ---------------------------------------------------------------------------

def _hybrid_init(dp, mp):
    from paddle_tpu_torch.distributed import fleet
    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": dp, "mp_degree": mp}
    return fleet.init(is_collective=True, strategy=s, backend="gloo")


def _train(model, hcg, state, batches, clip=1.0):
    """3 AdamW steps (clip, weight decay) of ``model`` loaded with global
    ``state`` through `CompiledTrainStep` over the hybrid mesh (the global
    batch in, each rank its dp rows); the global losses (the dp ranks'
    mean: equal token counts) and the step."""
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.framework import CompiledTrainStep
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    model = fleet.distributed_model(model)
    convert.load_paddle_tpu_state(
        model, convert.shard_paddle_tpu_state(state, model))
    opt = fleet.distributed_optimizer(AdamW(
        learning_rate=1e-3, parameters=model.parameters(), weight_decay=0.01,
        grad_clip=ClipGradByGlobalNorm(clip)))
    step = CompiledTrainStep(lambda x, y: model(x, labels=y)[1], opt,
                             network=model, mesh=hcg.mesh)
    losses = []
    for ids, labels in batches:
        loss = step(torch.tensor(ids), torch.tensor(labels))
        lt = loss.detach().clone().reshape(1)
        C.all_reduce(lt, op=C.ReduceOp.AVG,
                     group=hcg.get_data_parallel_group())
        losses.append(float(lt[0]))
    return losses, step


def _train_hybrid(model_cls, cfg_fn, rank, world, inputs):
    from paddle_tpu_torch import convert
    hcg = _hybrid_init(inputs["dp"], inputs["mp"])
    model = model_cls(cfg_fn(inputs["cfg"]), device="cpu")
    losses, step = _train(model, hcg, inputs["state"], inputs["batches"],
                          inputs.get("clip", 1.0))
    out = {"losses": losses, "state": convert.gather_paddle_tpu_state(model),
           "compiled": step.compiled,
           "dp_rank": hcg.get_data_parallel_rank(),
           "mp_rank": hcg.get_model_parallel_rank(),
           "local_shapes": {k: tuple(v.shape)
                            for k, v in model.state_dict().items()}}
    try:
        step._check_capturable()
    except NotImplementedError as e:
        out["capture_refusal"] = str(e)
    if "dropout_cfg" in inputs:
        # attention dropout: the dp x mp run's masks are the one rank's
        model = model_cls(cfg_fn(inputs["dropout_cfg"]), device="cpu",
                          seed=3)
        out["dropout_losses"], _ = _train(model, hcg, inputs["state"],
                                          inputs["batches"])
        out["dropout_state"] = convert.gather_paddle_tpu_state(model)
    return out


def case_hybrid_llama(rank, world, inputs):
    from paddle_tpu_torch.models import ParallelLlamaForCausalLM, llama_config
    return _train_hybrid(ParallelLlamaForCausalLM,
                         lambda cfg: llama_config("tiny", **cfg),
                         rank, world, inputs)


def case_hybrid_gpt(rank, world, inputs):
    from paddle_tpu_torch.models import ParallelGPTForCausalLM, gpt_config
    return _train_hybrid(ParallelGPTForCausalLM,
                         lambda cfg: gpt_config("gpt2-124m", **cfg),
                         rank, world, inputs)


def case_tp_generate(rank, world, inputs):
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.models import (ParallelGPTForCausalLM,
                                         ParallelLlamaForCausalLM,
                                         gpt_config, llama_config)
    _hybrid_init(1, world)
    out = {}
    for name, cls, cfg in (
            ("llama", ParallelLlamaForCausalLM,
             llama_config("tiny", **inputs["llama_cfg"])),
            ("gpt", ParallelGPTForCausalLM,
             gpt_config("gpt2-124m", **inputs["gpt_cfg"]))):
        model = fleet.distributed_model(cls(cfg, device="cpu")).eval()
        convert.load_paddle_tpu_state(model, convert.shard_paddle_tpu_state(
            inputs[f"{name}_state"], model))
        ids = torch.tensor(inputs["ids"])
        out[f"{name}_dense"] = model.generate(ids, inputs["new"]).numpy()
        out[f"{name}_paged"] = model.generate(ids, inputs["new"],
                                              page_size=4).numpy()
        out[f"{name}_nocache"] = model.generate(ids, inputs["new"],
                                                use_cache=False).numpy()
        out[f"{name}_cache_heads"] = model.cache_kv_heads
        with torch.no_grad():
            out[f"{name}_logits"] = model(ids).numpy()
    return out


def case_convert(rank, world, inputs):
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.models import ParallelGPTForCausalLM, gpt_config
    from paddle_tpu_torch.optimizer import AdamW
    _hybrid_init(1, world)
    model = fleet.distributed_model(ParallelGPTForCausalLM(
        gpt_config("gpt2-124m", **inputs["cfg"]), device="cpu"))
    local = convert.shard_paddle_tpu_state(inputs["state"], model)
    convert.load_paddle_tpu_state(model, local)
    back = convert.gather_paddle_tpu_state(model)
    only0 = convert.gather_paddle_tpu_state(model, dst=0)
    opt = AdamW(1e-3, parameters=model.parameters())
    convert.load_paddle_tpu_optimizer_state(
        opt, convert.shard_paddle_tpu_optimizer_state(
            inputs["opt_state"], model, opt))
    opt_back = convert.gather_paddle_tpu_optimizer_state(model, opt)
    return {"state": back, "only0": only0 is not None, "opt": opt_back,
            "local_shapes": {k: v.shape for k, v in local.items()}}


# ---------------------------------------------------------------------------
# data parallel: DataParallel and hapi fit
# ---------------------------------------------------------------------------

def _mlp(seed):
    from paddle_tpu_torch.nn.layers import Linear
    torch.manual_seed(seed)
    net = torch.nn.Sequential(Linear(8, 16, device="cpu"), torch.nn.Tanh(),
                              Linear(16, 4, device="cpu"))
    return net


def case_data_parallel(rank, world, inputs):
    from paddle_tpu_torch.distributed import DataParallel
    from paddle_tpu_torch.optimizer import AdamW
    net = _mlp(0)
    with torch.no_grad():
        for p, v in zip(net.parameters(), inputs["params"]):
            p.copy_(torch.tensor(v))
    dp = DataParallel(net, comm_buffer_size=0.0001)   # several buckets
    opt = AdamW(1e-2, parameters=net.parameters())
    for x, y in inputs["batches"]:
        n = x.shape[0] // world
        xs = torch.tensor(x[rank * n:(rank + 1) * n])
        ys = torch.tensor(y[rank * n:(rank + 1) * n])
        loss = ((dp(xs) - ys) ** 2).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
    return {"params": [_np(p) for p in net.parameters()]}


class _Rows:
    def __init__(self, x, y):
        self.x, self.y = x, y

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        return self.x[i], self.y[i]


def case_hapi_fit(rank, world, inputs):
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.nn import MSELoss
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.utils import flags
    flags.set_flags({"FLAGS_compiled_train_step": inputs["compiled"]})
    net = _mlp(0)
    with torch.no_grad():
        for p, v in zip(net.parameters(), inputs["params"]):
            p.copy_(torch.tensor(v))
    model = Model(net).prepare(AdamW(1e-2, parameters=net.parameters()),
                               MSELoss())
    hist = model.fit(_Rows(inputs["x"], inputs["y"]),
                     batch_size=inputs["batch"], epochs=2, shuffle=False,
                     verbose=0, log_freq=1)
    cs = model._compiled_step
    return {"params": [_np(p) for p in net.parameters()],
            "loss": hist["loss"],
            "compiled": bool(cs and cs.compiled)}


def case_sentinel_fit(rank, world, inputs):
    """hapi ``fit`` on the dp ranks through the compiled mesh step, first
    without the sentinel, then under it with the guardian's trap over
    ``inputs["guard_dir"]`` (the health exchange every check)."""
    from paddle_tpu_torch.distributed import watchdog
    from paddle_tpu_torch.distributed.store import FileKVStore
    from paddle_tpu_torch.framework.sentinel import read_health
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.nn import MSELoss
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.utils import flags
    out = {}
    for lane in ("off", "on"):
        flags.set_flags({"FLAGS_sentinel": lane == "on",
                         "FLAGS_sentinel_check_every": 2})
        if lane == "on":
            trap = watchdog.configure(store=FileKVStore(inputs["guard_dir"]),
                                      job="j", rank=rank).trap
        net = _mlp(0)
        with torch.no_grad():
            for p, v in zip(net.parameters(), inputs["params"]):
                p.copy_(torch.tensor(v))
        model = Model(net).prepare(AdamW(1e-2, parameters=net.parameters()),
                                   MSELoss())
        held = {}
        orig = Model._install_sentinel

        def grab(self, cb, held=held, orig=orig):
            held["s"] = orig(self, cb)
            return held["s"]

        Model._install_sentinel = grab
        try:
            hist = model.fit(_Rows(inputs["x"], inputs["y"]),
                             batch_size=inputs["batch"], epochs=2,
                             shuffle=False, verbose=0, log_freq=1)
        finally:
            Model._install_sentinel = orig
        cs = model._compiled_step
        out[lane] = {"params": [_np(p) for p in net.parameters()],
                     "loss": hist["loss"], "meshed": cs._meshed,
                     "sentinel": cs._sentinel, "compiled": cs.compiled}
        if lane == "on":
            out["report"] = held["s"].report()
            out["health"] = read_health(trap)
    flags.set_flags({"FLAGS_sentinel": False,
                     "FLAGS_sentinel_check_every": 8})
    watchdog.reset()
    return out


def case_clip_norm(rank, world, inputs):
    """The global-norm clip at dp 2 x mp 2 on known gradients: each dp
    rank holds the global gradient plus or minus a part that the dp mean
    cancels, an mp rank its shard of a split one, a copy of a replicated
    one, and its part of a sequence-parallel one's mp sum; after
    `allreduce_gradients`, `global_norm` and the clip's scale with and
    without the sequence-parallel parameter."""
    from paddle_tpu_torch.distributed import fleet, parallel
    from paddle_tpu_torch.distributed.fleet import mp_layers as M
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm, global_norm
    hcg = _hybrid_init(2, 2)
    dp_r, mp_r = hcg.get_data_parallel_rank(), hcg.get_model_parallel_rank()
    g = inputs["grads"]
    col = fleet.ColumnParallelLinear(*g["col.weight"].shape, device="cpu")
    row = fleet.RowParallelLinear(*g["row.weight"].shape, device="cpu")
    emb = fleet.VocabParallelEmbedding(*g["emb.weight"].shape, device="cpu")
    rowsp = fleet.RowSequenceParallelLinear(*g["row.weight"].shape,
                                            device="cpu")
    norm = torch.nn.Parameter(torch.ones(g["norm.weight"].shape))
    params = {"col.weight": col.weight, "col.bias": col.bias,
              "row.weight": row.weight, "row.bias": row.bias,
              "emb.weight": emb.weight, "norm.weight": norm,
              "sp.bias": rowsp.bias}
    split = {"col.weight": 1, "col.bias": 0, "row.weight": 0,
             "emb.weight": 0}
    sign = 1.0 if dp_r == 0 else -1.0
    for name, p in params.items():
        full = torch.tensor(g[name] if name != "sp.bias"
                            else inputs["sp_parts"][mp_r])
        full = full + sign * torch.tensor(inputs["dp_noise"][name])
        p.grad = M.shard_of(full, split[name], 2, mp_r) \
            if name in split else full
    out = {"split": sorted(n for n, p in params.items()
                           if getattr(p, "mp_split", False))}
    for tag, names in (("plain", [n for n in params if n != "sp.bias"]),
                       ("sp", list(params))):
        ps = [params[n] for n in names]
        saved = [p.grad.clone() for p in ps]
        parallel.allreduce_gradients(ps, hcg.get_data_parallel_group(),
                                     hcg.get_model_parallel_group())
        pg = [(p, p.grad) for p in ps]
        out[tag] = (float(global_norm(pg)),
                    float(ClipGradByGlobalNorm(inputs["clip"]).scale(pg)))
        for p, s in zip(ps, saved):
            p.grad = s
    return out


def case_sharded_fit(rank, world, inputs):
    """hapi ``fit`` of a tiny (parallel) GPT at ``inputs["dp"]`` ×
    ``inputs["mp"]`` with a ModelCheckpoint each epoch into
    ``inputs["save_dir"]`` (a sharded checkpoint: a shard file a rank);
    returns the rank's state and optimizer state and the global ones put
    together over mp (`convert.gather_paddle_tpu_state` and its optimizer
    twin), all numpy."""
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.models import ParallelGPTForCausalLM, gpt_config
    from paddle_tpu_torch.nn import CrossEntropyLoss
    from paddle_tpu_torch.optimizer import AdamW
    if inputs["mp"] > 1:
        _hybrid_init(inputs["dp"], inputs["mp"])
    net = fleet.distributed_model(ParallelGPTForCausalLM(
        gpt_config("gpt2-124m", **inputs["cfg"]), device="cpu", seed=0)) \
        if inputs["mp"] > 1 else ParallelGPTForCausalLM(
            gpt_config("gpt2-124m", **inputs["cfg"]), device="cpu", seed=0)
    opt = AdamW(1e-3, parameters=net.parameters())
    model = Model(net).prepare(opt, CrossEntropyLoss())
    model.fit(_Rows(inputs["x"], inputs["y"]), batch_size=inputs["batch"],
              epochs=inputs["epochs"], shuffle=False, verbose=0,
              save_dir=inputs["save_dir"])
    np_opt = {k: (_np(v) if torch.is_tensor(v) else v)
              for k, v in opt.state_dict().items()}
    return {"state": {k: _np(v) for k, v in net.state_dict().items()},
            "opt": np_opt,
            "global": convert.gather_paddle_tpu_state(net),
            "global_opt": convert.gather_paddle_tpu_optimizer_state(net,
                                                                    opt)}


# ---------------------------------------------------------------------------
# ZeRO sharding and the semi-auto parallel API
# ---------------------------------------------------------------------------

def _place_str(placements):
    return [repr(p) for p in placements]


def case_zero(rank, world, inputs):
    """The JAX recipe (benchmarks/run.py config 3) at ``inputs["dp"]`` ×
    ``inputs["sharding"]`` × ``inputs["mp"]`` on the tiny parallel
    ``inputs["model"]``: fleet.init (``strategy.sharding`` at level
    p_g_os), distributed_model, the global state loaded (each rank its
    parts), AdamW + clip, group_sharded_parallel(level),
    distributed_optimizer, the batches placed by shard_tensor (Shard(0)
    on ``inputs["batch_axes"]``), eager steps.  Returns the world-mean
    losses, the gathered state and optimizer state, each parameter's
    placements and local shape, the optimizer state's local shapes, the
    collectives a step and the ZeRO-3 regathers."""
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.distributed import api, collective as C, fleet
    from paddle_tpu_torch.models import (ParallelGPTForCausalLM,
                                         ParallelLlamaForCausalLM,
                                         gpt_config, llama_config)
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    level = inputs["level"]
    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": inputs["dp"], "mp_degree": inputs["mp"],
                        "sharding_degree": inputs["sharding"]}
    if level == "p_g_os":
        s.sharding = True
        s.sharding_configs = {"stage": 3}
    fleet.init(is_collective=True, strategy=s, backend="gloo")
    if inputs["model"] == "gpt":
        cfg = gpt_config("gpt2-124m", **inputs["cfg"])
        net = ParallelGPTForCausalLM(cfg, device="cpu")
    else:
        cfg = llama_config("tiny", **inputs["cfg"])
        net = ParallelLlamaForCausalLM(cfg, device="cpu")
    model = fleet.distributed_model(net)
    convert.load_paddle_tpu_state(
        model, convert.shard_paddle_tpu_state(inputs["state"], model))
    opt = AdamW(learning_rate=1e-3, parameters=model.parameters(),
                weight_decay=0.01, grad_clip=ClipGradByGlobalNorm(1.0))
    model, opt, _ = fleet.group_sharded_parallel(model, opt, level=level)
    opt = fleet.distributed_optimizer(opt)
    mesh = dist.get_mesh()
    place = [dist.Shard(0) if n in inputs["batch_axes"] else dist.Replicate()
             for n in mesh.dim_names]
    losses, coll = [], None
    regathers = api.stats["regathers"]
    for ids, labels in inputs["batches"]:
        before = C.counts()
        x = dist.shard_tensor(torch.tensor(ids), mesh, place,
                              stop_gradient=True)
        y = dist.shard_tensor(torch.tensor(labels), mesh, place,
                              stop_gradient=True)
        _, loss = model(x, labels=y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        if coll is None:
            coll = {k: v[0] - before.get(k, (0, 0))[0]
                    for k, v in C.counts().items()}
        lt = loss.detach().clone().reshape(1)
        C.all_reduce(lt, op=C.ReduceOp.AVG)
        losses.append(float(lt[0]))
    out = {"losses": losses, "rank_loss": float(loss.detach()),
           "rows": int(x.shape[0]),
           "state": convert.gather_paddle_tpu_state(model),
           "opt": {k: v for k, v in convert.gather_paddle_tpu_optimizer_state(
               model, opt).items() if k.startswith(("moment", "master"))},
           "placements": {n: _place_str(p.placements)
                          for n, p in model.named_parameters()},
           "local_shapes": {n: tuple(p.shape)
                            for n, p in model.named_parameters()},
           "moment_shapes": [tuple(t.shape)
                             for t in opt._state["moment1"]],
           "coll": coll, "regathers": api.stats["regathers"] - regathers,
           "mesh": list(mesh.dim_names)}
    if inputs.get("save"):
        path = fleet.save_group_sharded_model(model, inputs["save"], opt)
        out["saved"] = path
    return out


def case_zero_stage_units(rank, world, inputs):
    """JAX's test_sharding_stage1_optimizer_states and
    test_sharding_stage3_params at sharding ``world``: nn.Linear(16, 16),
    AdamW(0.01), one step on the global x; the moments' and weight's
    placements, parts and the gathered weight after the step."""
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.nn.layers import Linear
    from paddle_tpu_torch.optimizer import AdamW
    out = {}
    for level in ("os_g", "p_g_os"):
        s = fleet.DistributedStrategy()
        s.hybrid_configs = {"sharding_degree": world}
        fleet.init(is_collective=True, strategy=s, backend="gloo")
        model = Linear(16, 16, device="cpu")
        convert.load_paddle_tpu_state(model, inputs["state"])
        if level == "os_g":
            fleet.distributed_model(model)
        opt = AdamW(0.01, parameters=model.parameters())
        model, opt, _ = fleet.group_sharded_parallel(model, opt, level=level)
        res = {"placements": {n: _place_str(p.placements)
                              for n, p in model.named_parameters()},
               "local": {n: tuple(p.shape)
                         for n, p in model.named_parameters()}}
        loss = model(torch.tensor(inputs["x"])).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
        res["moment1"] = [tuple(t.shape) for t in opt._state["moment1"]]
        res["zero_kinds"] = [opt._zero.kind(p)[0]
                             for p in opt._parameter_list]
        res["state"] = convert.gather_paddle_tpu_state(model)
        out[level] = res
    return out


def case_auto_parallel(rank, world, inputs):
    """The semi-auto API on a dp 2 x mp 2 mesh: shard_tensor's parts
    under several placements, reshard moves (Shard -> Replicate ->
    Shard(j), Shard(i) -> Shard(j), both axes on one dim),
    unshard_dtensor, dtensor_from_fn, shard_constraint's gradient,
    Partial's refusal, shard_layer's output and gradient, and
    partition_from_tensor."""
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed.reshard import (MeshSpec,
                                                      partition_from_tensor)
    from paddle_tpu_torch.nn.layers import Linear
    mesh = dist.init_mesh([2, 2], ["dp", "mp"])
    dist.set_mesh(mesh)
    x = torch.tensor(inputs["x"])
    S, R = dist.Shard, dist.Replicate
    out = {"parts": {}, "moves": {}}
    for key, pl in inputs["placements"].items():
        t = dist.shard_tensor(x, mesh, [eval(p) for p in pl])
        out["parts"][key] = (t.numpy(), _place_str(t.placements))
    for key, (a, b) in inputs["moves"].items():
        t = dist.shard_tensor(x, mesh, [eval(p) for p in a])
        r = dist.reshard(t, mesh, [eval(p) for p in b])
        back = dist.unshard_dtensor(r)
        out["moves"][key] = (r.numpy(), back.numpy())
    t = dist.dtensor_from_fn(torch.ones, mesh, [S(0), R()], 4, 2)
    out["from_fn"] = t.numpy()
    try:
        dist.shard_tensor(x, mesh, [dist.Partial(), R()])
    except NotImplementedError as e:
        out["partial"] = str(e)
    # the gradient through a move inside a forward
    w = torch.tensor(inputs["x"], requires_grad=True)
    part = dist.shard_constraint(w, mesh, [S(0), S(1)])
    (part * part).sum().backward()
    out["constraint_grad"] = w.grad.numpy()
    # shard_layer: weight Shard(1) over mp computes the global output
    lin = Linear(8, 8, device="cpu")
    with torch.no_grad():
        lin.weight.copy_(torch.tensor(inputs["w"]))
        lin.bias.copy_(torch.tensor(inputs["b"]))

    def shard_fn(name, layer, m):
        if isinstance(layer, Linear):
            layer.weight.placements = [R(), S(1)]
    dist.shard_layer(lin, mesh, shard_fn)
    xin = torch.tensor(inputs["xin"])
    y = lin(xin)
    y.sum().backward()
    out["layer"] = {"out": y.detach().numpy(),
                    "weight_part": lin._parameters["weight"].detach().numpy(),
                    "weight_grad": lin._parameters["weight"].grad.numpy(),
                    "placements": _place_str(
                        lin._parameters["weight"].placements)}
    spec = MeshSpec(["dp", "mp"], [2, 2])
    out["partition"] = [
        partition_from_tensor(dist.shard_tensor(x, mesh, [S(0), S(1)]), spec),
        partition_from_tensor(dist.shard_tensor(x, mesh, [R(), S(0)]), spec),
        partition_from_tensor(x, spec)]
    out["spec"] = dist.placements_to_spec(mesh, [S(0), S(1)], 2)
    return out


def case_compat(rank, world, inputs):
    """`distributed.compat`'s collectives on the world and on an explicit
    gloo group (the serving replica's descriptor channel)."""
    import torch.distributed as dist
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed import compat
    out = {}
    objs = []
    compat.all_gather_object(objs, {"rank": rank, "data": [rank] * (rank + 1)})
    out["all_gather_object"] = objs
    lst = [f"from-{rank}", {"n": rank}] if rank == 1 else [None, None]
    compat.broadcast_object_list(lst, src=1)
    out["broadcast_object_list"] = lst
    got = []
    compat.scatter_object_list(got, ["a", {"b": 2}] if rank == 0 else None,
                               src=0)
    out["scatter_object_list"] = got
    ins = [torch.tensor([rank * 10.0 + j]) for j in range(world)]
    out["alltoall"] = [t.tolist() for t in compat.alltoall([], ins)]
    single = torch.empty(2 * world)
    compat.alltoall_single(single, torch.arange(2.0 * world) + 100 * rank)
    out["alltoall_single"] = single.tolist()
    gl = []
    compat.gather(torch.tensor([float(rank)]), gl, dst=0)
    out["gather"] = [t.tolist() for t in gl]
    out["backend"] = compat.get_backend()
    pg = dist.new_group(list(range(world)), backend="gloo")
    grp = C.Group(list(range(world)), process_group=pg)
    desc = [{"kind": "decode", "tokens": np.arange(4) + 7}] if rank == 0 \
        else [None]
    compat.broadcast_object_list(desc, src=0, group=grp)
    out["descriptor"] = desc[0]["tokens"].tolist()
    out["group_backend"] = compat.get_backend(grp)
    compat.destroy_process_group()
    t = torch.ones(1)
    C.all_reduce(t)
    out["after_destroy"] = float(t)
    compat.wait(t)
    return out


# ---------------------------------------------------------------------------
# distributed.functional and the pipeline
# ---------------------------------------------------------------------------

def _axis_init(**degrees):
    from paddle_tpu_torch.distributed import fleet
    s = fleet.DistributedStrategy()
    s.hybrid_configs = dict(degrees)
    return fleet.init(is_collective=True, strategy=s, backend="gloo")


def case_functional(rank, world, inputs):
    """Each ``inputs["ops"]`` entry ``name: (fn, kwargs, x blocks,
    cotangent blocks)`` on this rank's blocks over the dp axis (dp =
    world): its value and, with a cotangent, the gradient of
    ``sum(y * w)``; max and min record the backward's error.  Then the
    ring shift over the pp and the mp axis (each the world)."""
    from paddle_tpu_torch.distributed import functional as Fn
    _axis_init(dp_degree=world)
    out = {"index": Fn.axis_index("dp"), "size": Fn.axis_size("dp")}
    for name, (fn, kw, xs, ws) in inputs["ops"].items():
        x = torch.tensor(xs[rank], requires_grad=True)
        y = getattr(Fn, fn)(x, "dp", **kw)
        res = {"y": y.detach().numpy()}
        if ws is not None:
            try:
                (y * torch.tensor(ws[rank])).sum().backward()
                res["g"] = x.grad.numpy()
            except NotImplementedError as e:
                res["error"] = str(e)
        out[name] = res
    x = torch.tensor(inputs["ops"]["shift_right"][2][rank])
    for axis, kw in (("pp", dict(pp_degree=world)),
                     ("mp", dict(mp_degree=world))):
        _axis_init(**kw)
        out[f"shift_{axis}"] = Fn.shift_right(x, axis, world).numpy()
        out[f"index_{axis}"] = Fn.axis_index(axis)
    return out


def _pipe_strategy(pp, mp=1, dp=1, accum=2, **pipeline):
    from paddle_tpu_torch.distributed import fleet
    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": dp, "mp_degree": mp, "pp_degree": pp}
    s.pipeline = True
    s.pipeline_configs = {"accumulate_steps": accum, **pipeline}
    return s


def _pipe_run(model, strategy, state, batches, make_opt, evaluate=True):
    """``model`` (built after fleet.init) loaded with the global
    ``state`` (its stage's part), wrapped by distributed_model and
    trained on ``batches``: losses, the gathered state, the eval loss and
    the global-view logits of the first batch, the parameters held."""
    import warnings
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.distributed import fleet
    held = sum(p.numel() * (p.mp_group.nranks if getattr(p, "mp_split",
                                                          False) else 1)
               for p in model.parameters())
    keys = sorted(model.state_dict())
    convert.load_paddle_tpu_state(
        model, convert.shard_pipeline_state(state, model))
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        pm = fleet.distributed_model(model)
    opt = make_opt(pm.parameters())
    losses = [float(pm.train_batch(tuple(torch.tensor(a) for a in b), opt))
              for b in batches]
    out = {"losses": losses, "state": convert.gather_pipeline_state(pm),
           "held": held, "keys": keys, "kind": type(pm).__name__,
           "opt_shapes": [tuple(p.shape) for p in pm.parameters()],
           "local_shapes": [tuple(p.shape) for p in model.parameters()],
           "schedule": list(pm._runner.last_schedule),
           "warnings": [str(w.message) for w in seen],
           "spmd": pm._spmd is not None}
    if evaluate:
        ids, labels = (torch.tensor(a) for a in batches[0])
        out["eval"] = float(pm.eval_batch((ids, labels)))
        with torch.no_grad():
            out["logits"] = pm(ids).numpy()
    return out


def case_pipe_gpt(rank, world, inputs):
    """``GPTForCausalLMPipe`` of each ``inputs["runs"]`` entry
    ``key: (gpt overrides, pp, mp, dp, chunks)`` on the JAX state
    ``inputs["states"][key]``: `_pipe_run` with AdamW(1e-3) and the
    global-norm clip 1.0."""
    from paddle_tpu_torch.models import GPTForCausalLMPipe, gpt_config
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    out = {}
    for key, (cfg, pp, mp, dp, chunks) in inputs["runs"].items():
        strategy = _pipe_strategy(pp, mp, dp, accum=inputs["accum"])
        from paddle_tpu_torch.distributed import fleet
        hcg = fleet.init(is_collective=True, strategy=strategy,
                         backend="gloo")
        model = GPTForCausalLMPipe(gpt_config("gpt2-124m", **cfg),
                                   num_virtual_pipeline_stages=chunks,
                                   device="cpu")
        res = _pipe_run(model, strategy, inputs["states"][key],
                        inputs["batches"],
                        lambda ps: AdamW(1e-3, parameters=ps,
                                         grad_clip=ClipGradByGlobalNorm(1.0)))
        res["stage"] = hcg.get_pipe_parallel_rank()
        res["mp_rank"] = hcg.get_model_parallel_rank()
        out[key] = res
    return out


def case_pipe_hetero(rank, world, inputs):
    """tests/test_pipeline.py's heterogeneous 4-stage MLP at pp 4
    (``inputs["state"]``: JAX's weights), SGD(0.1), mse, 4
    micro-batches: the cross-rank 1F1B."""
    from paddle_tpu_torch.distributed.fleet import LayerDesc, PipelineLayer
    from paddle_tpu_torch.nn.layers import Linear
    from paddle_tpu_torch.optimizer import SGD
    from paddle_tpu_torch.distributed import fleet
    strategy = _pipe_strategy(world, accum=4)
    fleet.init(is_collective=True, strategy=strategy, backend="gloo")

    def lin(i, o):
        return LayerDesc(Linear, i, o, device="cpu")
    descs = [lin(8, 32), LayerDesc(torch.nn.Tanh), lin(32, 16),
             LayerDesc(torch.nn.Sigmoid), lin(16, 16), lin(16, 24),
             LayerDesc(torch.nn.Tanh), lin(24, 8)]
    model = PipelineLayer(descs, num_stages=world,
                          loss_fn=lambda o, y: ((o - y) ** 2).mean())
    return _pipe_run(model, strategy, inputs["state"], inputs["batches"],
                     lambda ps: SGD(0.1, parameters=ps), evaluate=False)


def case_pipe_refusals(rank, world, inputs):
    """pp 2 × sharding 2 (not ported: A8) and ``schedule="spmd"`` on the
    heterogeneous MLP at pp 4: the errors."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet import (LayerDesc,
                                                    PipelineLayer,
                                                    PipelineParallel)
    from paddle_tpu_torch.nn.layers import Linear
    out = {}
    s = _pipe_strategy(2)
    s.hybrid_configs["sharding_degree"] = 2
    fleet.init(is_collective=True, strategy=s, backend="gloo")
    model = PipelineLayer([LayerDesc(Linear, 4, 4, device="cpu")] * 2)
    try:
        PipelineParallel(model, strategy=s)
    except NotImplementedError as e:
        out["sharding"] = str(e)
    s = _pipe_strategy(world, accum=4, schedule="spmd")
    fleet.init(is_collective=True, strategy=s, backend="gloo")
    descs = [LayerDesc(Linear, 8, 8, device="cpu"),
             LayerDesc(torch.nn.Tanh), LayerDesc(Linear, 8, 8, device="cpu"),
             LayerDesc(Linear, 8, 4, device="cpu"),
             LayerDesc(torch.nn.Sigmoid)]
    try:
        PipelineParallel(PipelineLayer(descs), strategy=s)
    except ValueError as e:
        out["spmd"] = type(e).__name__
    return out


def case_fleet_util(rank, world, inputs):
    """`fleet.UtilBase` and `fleet.Fleet` on the world's ranks."""
    import io
    from contextlib import redirect_stdout
    from paddle_tpu_torch.distributed import fleet
    f = fleet.Fleet()
    f.init(is_collective=True, backend="gloo")
    util = f.util
    out = {"sum": util.all_reduce(np.array([1.0, 2.0]) * (rank + 1)),
           "max": util.all_reduce(rank + 3, mode="max"),
           "min": util.all_reduce(np.float32(rank + 3), mode="min"),
           "gather": util.all_gather({"rank": rank}),
           "shard": util.get_file_shard(inputs["files"]),
           "index": f.worker_index(), "num": f.worker_num(),
           "first": f.is_first_worker()}
    util.barrier()
    f.barrier_worker()
    buf = io.StringIO()
    with redirect_stdout(buf):
        util.print_on_rank("hello", 1)
    out["printed"] = buf.getvalue()
    return out


# ---------------------------------------------------------------------------
# context parallelism (sep)
# ---------------------------------------------------------------------------

def _chunk_of(arr, n, r, dim=1):
    c = arr.shape[dim] // n
    return np.take(arr, np.arange(r * c, (r + 1) * c), axis=dim)


def case_cp_ops(rank, world, inputs):
    """`context_parallel`'s ops at sep = world: each ``inputs["ops"]``
    entry ``key: (fn, causal, q, k, v, w)`` (global ``[B, S, H, D]``
    arrays) on this rank's chunk: the output chunk and the chunks of the
    gradients of ``sum(out * w)``; then Ulysses' error on 3 heads,
    `split_sequence` and the groups."""
    from paddle_tpu_torch.distributed import context_parallel as CP
    hcg = _axis_init(sep_degree=world)
    r = hcg.get_sep_parallel_rank()
    out = {"sep_rank": r, "sep_ranks": hcg.get_sep_parallel_group().ranks}
    for key, (fn, causal, *arrs) in inputs["ops"].items():
        q, k, v, w = (torch.tensor(_chunk_of(a, world, r)) for a in arrs)
        for t in (q, k, v):
            t.requires_grad_(True)
        y = getattr(CP, fn)(q, k, v, causal=causal)
        (y * w).sum().backward()
        out[key] = {"y": y.detach().numpy(), "dq": q.grad.numpy(),
                    "dk": k.grad.numpy(), "dv": v.grad.numpy()}
    x = torch.zeros(2, 4 * world, 3, 8)
    try:
        CP.ulysses_attention(x, x, x)
    except ValueError as e:
        out["ulysses_error"] = str(e)
    seq = torch.arange(2 * 4 * world, dtype=torch.float32).reshape(
        2, 4 * world).requires_grad_(True)
    part = CP.split_sequence(seq)
    (part * (r + 1)).sum().backward()
    out["split"] = part.detach().numpy()
    out["split_grad"] = seq.grad.numpy()
    return out


def case_sep_train(rank, world, inputs):
    """Each ``inputs["runs"]`` entry ``key: (which, cfg overrides, degrees,
    ring, sequence_parallel)`` (``which`` "gpt" or "llama"): fleet.init at
    ``degrees``, the
    parallel model through ``fleet.distributed_model`` (`SegmentParallel`
    at sep > 1) on JAX's state ``inputs["states"][key]``, AdamW(1e-3, wd
    0.01) + the global-norm clip 1.0, eager steps over the global batches
    (each dp rank its rows; the model cuts the rank's sequence chunk):
    the global losses (the ranks' chunk losses averaged over dp × sep),
    the gathered state, the wrapper's kind."""
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet.meta_parallel.segment_parallel \
        import sep_data_group
    from paddle_tpu_torch.models import (ParallelGPTForCausalLM,
                                         ParallelLlamaForCausalLM,
                                         gpt_config, llama_config)
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    out = {}
    for key, (which, cfg, degrees, ring, sp) in inputs["runs"].items():
        hcg = _axis_init(**degrees)
        if which == "gpt":
            model = ParallelGPTForCausalLM(gpt_config("gpt2-124m", **cfg),
                                           sequence_parallel=sp,
                                           use_ring_attention=ring,
                                           device="cpu")
        else:
            model = ParallelLlamaForCausalLM(llama_config("tiny", **cfg),
                                             sequence_parallel=sp,
                                             use_ring_attention=ring,
                                             device="cpu")
        model = fleet.distributed_model(model)
        convert.load_paddle_tpu_state(model, convert.shard_paddle_tpu_state(
            inputs["states"][key], model))
        opt = AdamW(learning_rate=1e-3, parameters=model.parameters(),
                    weight_decay=0.01, grad_clip=ClipGradByGlobalNorm(1.0))
        dp, dpr = (hcg.get_data_parallel_world_size(),
                   hcg.get_data_parallel_rank())
        group = sep_data_group(hcg)
        losses = []
        for ids, labels in inputs["batches"]:
            per = ids.shape[0] // dp
            rows = slice(dpr * per, (dpr + 1) * per)
            logits, loss = model(torch.tensor(ids[rows]),
                                 labels=torch.tensor(labels[rows]))
            loss.backward()
            opt.step()
            opt.clear_grad()
            lt = loss.detach().clone().reshape(1)
            C.all_reduce(lt, op=C.ReduceOp.AVG, group=group)
            losses.append(float(lt[0]))
        out[key] = {"losses": losses,
                    "state": convert.gather_paddle_tpu_state(model),
                    "kind": type(model).__name__,
                    "logits_shape": tuple(logits.shape),
                    "sep_rank": hcg.get_sep_parallel_rank(),
                    "mp_rank": hcg.get_model_parallel_rank()}
    return out


def case_sep_refusals(rank, world, inputs):
    """sep 2 × pp 2: the parallel model's refusal, built under the
    topology and built before it (``fleet.distributed_model``)."""
    from paddle_tpu_torch.distributed import fleet, topology
    from paddle_tpu_torch.models import ParallelGPTForCausalLM, gpt_config
    cfg = gpt_config("gpt2-124m", **inputs["cfg"])
    out = {}
    _axis_init(sep_degree=2, pp_degree=2)
    try:
        ParallelGPTForCausalLM(cfg, device="cpu")
    except NotImplementedError as e:
        out["built_after"] = str(e)
    hcg = topology.get_hybrid_communicate_group()
    topology.set_hybrid_communicate_group(None)
    model = ParallelGPTForCausalLM(cfg, device="cpu")
    topology.set_hybrid_communicate_group(hcg)
    try:
        fleet.distributed_model(model)
    except NotImplementedError as e:
        out["distributed_model"] = str(e)
    return out


# ---------------------------------------------------------------------------
# the expert-parallel MoE layer
# ---------------------------------------------------------------------------

def case_moe(rank, world, inputs):
    """dp 2 × mp 2 on 4 ranks, each dp rank its rows of the global tokens
    (the key stream at ``inputs["rng"]`` before each part):

    - ``gate``: `GShardGate` on JAX's gate weights, training (random
      routing) and eval: this rank's rows of the dense combine and
      dispatch, the aux loss;
    - ``layer``: `MoELayer` (stacked experts) on JAX's state, training:
      the output rows, the gradients of ``sum(y * w)`` (x's rows; each
      parameter's local gradient, summed over dp by the parent);
    - ``model``: the tiny ``ParallelGPTForCausalLM(moe_every=2)`` through
      `CompiledTrainStep` over the mesh (3 AdamW steps + the clip): the
      global losses, the gathered state, the first step's global norm
      (`ClipGradForMOEByGlobalNorm`), the local expert shapes;
    - ``convert``: the expert stacks' shard and gather round trip."""
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.framework import CompiledTrainStep, prng
    from paddle_tpu_torch.incubate.distributed.models.moe import (
        ClipGradForMOEByGlobalNorm, GShardGate, MoELayer)
    from paddle_tpu_torch.models import ParallelGPTForCausalLM, gpt_config
    from paddle_tpu_torch.nn.clip import global_norm
    from paddle_tpu_torch.optimizer import AdamW
    hcg = _hybrid_init(2, 2)
    dpr = hcg.get_data_parallel_rank()
    out = {"dp_rank": dpr, "mp_rank": hcg.get_model_parallel_rank()}

    def rows(a):
        per = a.shape[0] // 2
        return torch.tensor(a[dpr * per:(dpr + 1) * per])

    g = inputs["gate"]
    gate = GShardGate(g["d"], g["e"], 1, capacity=g["capacity"],
                      device="cpu")
    gate.load_state_dict({"gate.weight": torch.tensor(g["w"]),
                          "gate.bias": torch.tensor(g["b"])})
    res = {}
    for train in (True, False):
        prng.set_rng_state(inputs["rng"])
        combine, dispatch, aux = gate.dispatch_info(rows(g["x"]), train)
        res[train] = {"combine": combine.detach().numpy(),
                      "dispatch": dispatch.numpy(), "aux": float(aux)}
    out["gate"] = res

    lay = inputs["layer"]
    layer = MoELayer(lay["d"], num_expert=lay["e"], d_hidden=lay["h"],
                     gate={"type": "gshard", "top_k": 2,
                           "capacity": lay["capacity"]}, device="cpu")
    layer = fleet.distributed_model(layer)
    convert.load_paddle_tpu_state(layer, convert.shard_paddle_tpu_state(
        lay["state"], layer))
    prng.set_rng_state(inputs["rng"])
    x = rows(lay["x"]).requires_grad_(True)
    y = layer(x)
    (y * rows(lay["w"])).sum().backward()
    out["layer"] = {"y": y.detach().numpy(), "dx": x.grad.numpy(),
                    "grads": {k: p.grad.numpy()
                              for k, p in layer.named_parameters()},
                    "local_shapes": {k: tuple(v.shape) for k, v in
                                     layer.state_dict().items()}}
    back = convert.gather_paddle_tpu_state(layer)
    out["convert"] = {k: np.array_equal(back[k], v)
                      for k, v in lay["state"].items()}

    m = inputs["model"]
    model = fleet.distributed_model(ParallelGPTForCausalLM(
        gpt_config("gpt2-124m", **m["cfg"]), moe_every=2, num_experts=4,
        moe_capacity=m["capacity"], device="cpu"))
    convert.load_paddle_tpu_state(model, convert.shard_paddle_tpu_state(
        m["state"], model))
    clip = ClipGradForMOEByGlobalNorm(1.0)
    opt = AdamW(learning_rate=1e-3, parameters=model.parameters(),
                weight_decay=0.01, grad_clip=clip)
    prng.set_rng_state(m["rng"])
    ids, labels = (torch.tensor(a) for a in m["batches"][0])
    per = ids.shape[0] // 2
    sl = slice(dpr * per, (dpr + 1) * per)
    _, loss = model(ids[sl], labels=labels[sl])
    loss.backward()
    from paddle_tpu_torch.distributed import parallel
    parallel.allreduce_gradients(list(model.parameters()),
                                 hcg.get_data_parallel_group())
    norm = global_norm([(p, p.grad) for p in model.parameters()])
    opt.clear_grad()
    prng.set_rng_state(m["rng"])
    step = CompiledTrainStep(lambda a, b: model(a, labels=b)[1], opt,
                             network=model, mesh=hcg.mesh)
    losses = []
    for a, b in m["batches"]:
        lt = step(torch.tensor(a), torch.tensor(b)).detach().clone()
        lt = lt.reshape(1)
        C.all_reduce(lt, op=C.ReduceOp.AVG,
                     group=hcg.get_data_parallel_group())
        losses.append(float(lt[0]))
    out["model"] = {"losses": losses, "norm": float(norm),
                    "state": convert.gather_paddle_tpu_state(model),
                    "rng": prng.get_rng_state(),
                    "expert_shape": tuple(
                        model.gpt.h[1].mlp._stacked.w1.shape)}
    return out


def case_moe_split_refused(rank, world, inputs):
    """The MoE layer on 2 ranks at sharding 2 and then at sep 2 (dp 1):
    each forward's `NotImplementedError` message."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.incubate.distributed.models.moe import MoELayer
    out = {}
    for axis in ("sharding", "sep"):
        s = fleet.DistributedStrategy()
        s.hybrid_configs = {f"{axis}_degree": 2}
        fleet.init(is_collective=True, strategy=s, backend="gloo")
        layer = MoELayer(8, num_expert=2, d_hidden=8, device="cpu")
        try:
            layer(torch.randn(4, 8))
        except NotImplementedError as e:
            out[axis] = str(e)
    return out


def case_many(rank, world, inputs):
    """Several cases on the same ranks, one after the other (one spawned
    group for a test module's cases): ``inputs["cases"]`` is a list of
    ``(key, case, its inputs)``; returns ``{key: result}``."""
    return {key: CASES[case](rank, world, case_inputs)
            for key, case, case_inputs in inputs["cases"]}


CASES = {
    "many": case_many,
    "compat": case_compat,
    "collectives": case_collectives,
    "mp_layers": case_mp_layers,
    "hybrid_llama": case_hybrid_llama,
    "hybrid_gpt": case_hybrid_gpt,
    "tp_generate": case_tp_generate,
    "convert": case_convert,
    "data_parallel": case_data_parallel,
    "hapi_fit": case_hapi_fit,
    "clip_norm": case_clip_norm,
    "guarded_collectives": case_guarded_collectives,
    "sentinel_fit": case_sentinel_fit,
    "sharded_fit": case_sharded_fit,
    "zero": case_zero,
    "zero_stage_units": case_zero_stage_units,
    "auto_parallel": case_auto_parallel,
    "functional": case_functional,
    "pipe_gpt": case_pipe_gpt,
    "pipe_hetero": case_pipe_hetero,
    "pipe_refusals": case_pipe_refusals,
    "fleet_util": case_fleet_util,
    "cp_ops": case_cp_ops,
    "sep_train": case_sep_train,
    "sep_refusals": case_sep_refusals,
    "moe": case_moe,
    "moe_split_refused": case_moe_split_refused,
}


# ---------------------------------------------------------------------------
# a serving fleet's model factory (spawned replica processes import it)
# ---------------------------------------------------------------------------

def tp_llama(cfg_kwargs, state_path=None, seed=0):
    """The tiny Llama as `ParallelLlamaForCausalLM` on the CPU: this rank's
    part of the JAX state at ``state_path`` (an ``.npz`` of the global
    arrays by state-dict name), or of the seed's draw; at mp 1 the whole
    model."""
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.models import ParallelLlamaForCausalLM, llama_config
    model = ParallelLlamaForCausalLM(llama_config("tiny", **cfg_kwargs),
                                     device="cpu", seed=seed)
    if state_path is not None:
        with np.load(state_path) as f:
            state = {k: f[k] for k in f.files}
        convert.load_paddle_tpu_state(
            model, convert.shard_paddle_tpu_state(state, model))
    return model.eval()


def replica_probe(name):
    """An rpc target run inside replica ``name``'s process: its engine's
    serving stats, active slots, tick hits and the descriptors its mirror
    sent (None for a replica of one rank)."""
    from paddle_tpu_torch.serving import fleet as sfleet
    from paddle_tpu_torch.serving import tp_replica
    rep = sfleet._REPLICAS[name]
    eng = rep.engine
    follower = None if eng.mirror is None else tp_replica.peer_stats(
        rep.store, eng.mirror.ctx.key, 1)
    return {"stats": dict(eng.stats()), "active": len(eng._active),
            "pending": len(eng._pending),
            "descriptors": None if eng.mirror is None else eng.mirror.seq,
            "follower": None if follower is None else follower["stats"],
            "kv_heads": eng._kv_heads}
