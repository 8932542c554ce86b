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


def case_many(rank, world, inputs):
    """Several cases on the same ranks, one after the other (one spawned
    group for a test module's cases): ``inputs["cases"]`` is a list of
    ``(key, case, its inputs)``; returns ``{key: result}``."""
    return {key: CASES[case](rank, world, case_inputs)
            for key, case, case_inputs in inputs["cases"]}


CASES = {
    "many": case_many,
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
}
