"""The rest of ``paddle.distributed``'s public surface (port of
paddle_tpu/distributed/compat.py): object collectives, the single-tensor
all-to-all, gather, async send/recv tasks, the parallel-mode enum, the PS
entry configs, the model-parallel `split` helper, backend introspection
and the gloo shims.

An object travels as JAX's does: pickled into a uint8 tensor, its length
sent first.  Every call goes through the port's collectives
(`distributed.collective`), so each one is counted and guarded like any
other.  A group whose torch backend is gloo moves its bytes in CPU
tensors; any other (NCCL) in tensors on the rank's card.  The tensor
parallel serving replica (`serving.tp_replica`) sends its step
descriptor with `broadcast_object_list` over a gloo group, so host
metadata never queues behind the card's NCCL work.
"""
from __future__ import annotations

import pickle

import numpy as np
import torch
import torch.distributed as dist

from . import collective as C
from . import env as _env


class ParallelMode:
    """reference: distributed/fleet/base/topology.py:33."""
    DATA_PARALLEL = 0
    TENSOR_PARALLEL = 1
    PIPELINE_PARALLEL = 2
    SHARDING_PARALLEL = 3
    SEGMENT_PARALLEL = 4


class DistAttr:
    """Tensor distributed attribute: a mesh and per-dim sharding specs
    (reference: distributed/auto_parallel/api.py DistAttr)."""

    def __init__(self, mesh=None, sharding_specs=None):
        self.process_mesh = mesh
        self.sharding_specs = list(sharding_specs or [])

    def __repr__(self):
        return (f"DistAttr(mesh={self.process_mesh}, "
                f"sharding_specs={self.sharding_specs})")


class EntryAttr:
    """reference: distributed/entry_attr.py — sparse-table admission
    policies read by the parameter server's sparse tables."""

    def _to_attr(self):
        raise NotImplementedError


class ProbabilityEntry(EntryAttr):
    def __init__(self, probability):
        if not 0 < probability <= 1:
            raise ValueError("probability must be in (0, 1]")
        self._name = "probability_entry"
        self._probability = probability

    def _to_attr(self):
        return f"{self._name}:{self._probability}"


class CountFilterEntry(EntryAttr):
    def __init__(self, count_filter):
        if count_filter < 0:
            raise ValueError("count_filter must be non-negative")
        self._name = "count_filter_entry"
        self._count_filter = count_filter

    def _to_attr(self):
        return f"{self._name}:{self._count_filter}"


class ShowClickEntry(EntryAttr):
    def __init__(self, show_name, click_name):
        self._name = "show_click_entry"
        self._show_name = show_name
        self._click_name = click_name

    def _to_attr(self):
        return f"{self._name}:{self._show_name}:{self._click_name}"


# ------------------------------------------------------------------
# backend / lifecycle introspection
# ------------------------------------------------------------------

def is_available():
    """Whether torch was built with ``torch.distributed``."""
    return dist.is_available()


def get_backend(group=None):
    """The group's communication backend, upper case as the reference
    returns it (``"NCCL"``, ``"GLOO"``); without a process group the one
    `init_parallel_env` would pick (``"NCCL"`` with a card)."""
    if not (dist.is_available() and dist.is_initialized()):
        return "NCCL" if torch.cuda.is_available() else "GLOO"
    pg = getattr(group, "process_group", None)
    return str(dist.get_backend(pg)).upper()


def destroy_process_group(group=None):
    """Drop the port's cached groups, as JAX's drops its cached sub-groups;
    the world group persists for the process's lifetime like the
    reference's default group.  Torch's own ``destroy_process_group`` is
    not called: on one card it hangs NCCL ranks that share it (as its
    ``barrier`` does, which `collective.barrier` avoids), and the port's
    ranks end with a barrier and the process's exit."""
    if group is None:
        C._default.update(group=None, world=None)


def wait(tensor, group=None, use_calc_stream=True):
    """Block until ``tensor``'s producing work completes: the current
    stream is synchronised on the card (NCCL returns at the enqueue)."""
    if torch.is_tensor(tensor) and tensor.is_cuda:
        torch.cuda.current_stream(tensor.device).synchronize()
    return tensor


class _CompletedTask:
    """Async handle of `isend` / `irecv`: the op ran when the call
    returned, ``wait`` waits for the tensor on the card."""

    def __init__(self, tensor=None):
        self._tensor = tensor

    def wait(self):
        if self._tensor is not None:
            wait(self._tensor)

    def is_completed(self):
        return True


def isend(tensor, dst=0, group=None):
    C.send(tensor, dst=dst, group=group, sync_op=False)
    return _CompletedTask(tensor)


def irecv(tensor, src=0, group=None):
    C.recv(tensor, src=src, group=group, sync_op=False)
    return _CompletedTask(tensor)


# ------------------------------------------------------------------
# tensor-list and object collectives
# ------------------------------------------------------------------

def alltoall(out_tensor_list, in_tensor_list, group=None, sync_op=True):
    """reference: communication/all_to_all.py alltoall."""
    return C.all_to_all(out_tensor_list, in_tensor_list, group=group,
                        sync_op=sync_op)


def alltoall_single(out_tensor, in_tensor, in_split_sizes=None,
                    out_split_sizes=None, group=None, sync_op=True):
    """Single-tensor all-to-all: dim 0 of ``in_tensor`` splits evenly
    across the group's ranks and ``out_tensor`` receives each rank's part
    in group order (reference: communication/all_to_all.py).  Uneven
    split sizes raise `NotImplementedError` (ROADMAP A8): JAX's takes
    them and splits evenly all the same."""
    n = C._resolve(group).nranks
    for sizes in (in_split_sizes, out_split_sizes):
        if sizes and len(set(sizes)) > 1:
            raise NotImplementedError(
                f"alltoall_single: uneven split sizes {list(sizes)} are "
                "not ported (ROADMAP A8)")
    if n <= 1:
        out_tensor.copy_(in_tensor)
        return out_tensor
    parts = [p.contiguous() for p in torch.chunk(in_tensor, n, dim=0)]
    outs = C.all_to_all([], parts, group=group, sync_op=sync_op)
    out_tensor.copy_(torch.cat(outs, dim=0))
    return out_tensor


def gather(tensor, gather_list=None, dst=0, group=None, sync_op=True):
    """Every rank contributes ``tensor``; rank ``dst`` receives the list
    in group order (an all-gather, as JAX's; reference:
    communication/gather.py)."""
    if gather_list is None:
        gather_list = []
    if C._resolve(group).nranks <= 1:
        gather_list.append(tensor)
        return gather_list
    parts = C.all_gather(None, tensor, group=group, sync_op=sync_op)
    if _env.get_rank() == dst:
        gather_list[:] = parts
    return gather_list


def _obj_device(group):
    """Where a group's object bytes travel: the CPU for gloo, else the
    rank's card."""
    pg = getattr(C._resolve(group), "process_group", None)
    if dist.is_available() and dist.is_initialized() and \
            str(dist.get_backend(pg)) == "gloo":
        return torch.device("cpu")
    return _env.current_device()


def _obj_to_tensor(obj, device):
    buf = np.frombuffer(pickle.dumps(obj), np.uint8)
    return torch.from_numpy(buf.copy()).to(device), len(buf)


def _tensor_to_obj(t, length):
    return pickle.loads(t[:length].cpu().numpy().tobytes())


def all_gather_object(object_list, obj, group=None):
    """Every rank's ``obj`` into ``object_list`` in group order: the
    pickles' lengths are gathered, each padded to the longest, gathered
    and unpickled (reference: communication/all_gather.py)."""
    if C._resolve(group).nranks <= 1:
        object_list.append(obj)
        return object_list
    dev = _obj_device(group)
    t, n = _obj_to_tensor(obj, dev)
    lens = C.all_gather(None, torch.tensor([n], dtype=torch.int64,
                                           device=dev), group=group)
    lens = [int(x) for x in torch.stack(lens).reshape(-1).tolist()]
    pad = torch.zeros(max(lens), dtype=torch.uint8, device=dev)
    pad[:n] = t
    outs = C.all_gather(None, pad, group=group)
    object_list[:] = [_tensor_to_obj(o, ln) for o, ln in zip(outs, lens)]
    return object_list


def broadcast_object_list(object_list, src=0, group=None):
    """``object_list`` of global rank ``src`` to every rank of the group,
    in place: its pickle's length, then its bytes (reference:
    communication/broadcast.py)."""
    if C._resolve(group).nranks <= 1:
        return object_list
    dev = _obj_device(group)
    me = _env.get_rank() == src
    payload = pickle.dumps(list(object_list)) if me else b""
    n = torch.tensor([len(payload)], dtype=torch.int64, device=dev)
    C.broadcast(n, src=src, group=group)
    buf = torch.from_numpy(np.frombuffer(payload, np.uint8).copy()) \
        .to(dev) if me else torch.empty(int(n.item()), dtype=torch.uint8,
                                        device=dev)
    C.broadcast(buf, src=src, group=group)
    if not me:
        object_list[:] = pickle.loads(buf.cpu().numpy().tobytes())
    return object_list


def scatter_object_list(out_object_list, in_object_list=None, src=0,
                        group=None):
    """Rank i of the group receives ``in_object_list[i]`` of ``src``
    (reference: communication/scatter.py)."""
    grp = C._resolve(group)
    if grp.nranks <= 1:
        out_object_list[:] = [in_object_list[0]] \
            if in_object_list else [None]
        return out_object_list
    objs = list(in_object_list) if _env.get_rank() == src and \
        in_object_list else [None] * grp.nranks
    broadcast_object_list(objs, src=src, group=group)
    out_object_list[:] = [objs[grp.rank]]
    return out_object_list


def split(x, size, operation, axis=0, num_partitions=1, gather_out=True,
          weight_attr=None, bias_attr=None, name=None):
    """Model-parallel weight split (reference:
    distributed/fleet/layers/mpu/mp_ops.py:698 split): builds the
    column- or row-parallel linear or the vocab-parallel embedding over
    the mp group on ``x``'s device and applies it."""
    from .fleet.mp_layers import (ColumnParallelLinear, RowParallelLinear,
                                  VocabParallelEmbedding)
    dev = x.device
    if operation == "embedding":
        layer = VocabParallelEmbedding(size[0], size[1],
                                       weight_attr=weight_attr, device=dev)
        return layer(x)
    if operation != "linear":
        raise ValueError("operation must be 'linear' or 'embedding'")
    if axis == 0:
        layer = RowParallelLinear(size[0], size[1],
                                  weight_attr=weight_attr,
                                  has_bias=bias_attr is not False,
                                  input_is_parallel=not gather_out,
                                  device=dev, dtype=x.dtype)
    else:
        layer = ColumnParallelLinear(size[0], size[1],
                                     weight_attr=weight_attr,
                                     has_bias=bias_attr is not False,
                                     gather_output=gather_out, device=dev,
                                     dtype=x.dtype)
    return layer(x)


# gloo shims: the reference's CPU rendezvous over gloo; here a gloo
# process group through `init_parallel_env`
def gloo_init_parallel_env(rank_id, rank_num, server_endpoint):
    """Join a gloo world of ``rank_num`` ranks as ``rank_id`` through the
    ``host:port`` rendezvous ``server_endpoint``."""
    from .env import init_parallel_env
    return init_parallel_env(server_endpoint, rank_num, rank_id,
                             backend="gloo", device="cpu")


def gloo_barrier():
    C.barrier()


def gloo_release():
    pass
