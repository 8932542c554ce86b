"""Compiled train step: a whole training step as one CUDA graph replay
(port of paddle_tpu/framework/train_step.py ``CompiledTrainStep``).

The JAX package lowers the step (forward, tape backward, loss scaling,
found-inf, clip, the optimizer's fused update) to one donated-buffer XLA
program.  Here the program is a ``torch.cuda.CUDAGraph`` captured by
`framework.capture.CapturedStep` over persistent tensors the body updates
in place: the parameters, their gradients, the optimizer's moments,
masters and step counter, the loss scaler's ``[scale, good, bad]`` vector,
the learning rate and the staged batch.

- **Call 1** is the real first step, run eagerly on the capture stream
  (JAX's call 1 runs its eager step too), with the forward watched for
  host reads (`framework.capture.host_read_probe`, the counterpart of
  JAX's discovery ``TraceEscape``) and the device generators it draws
  from recorded.  There is no snapshot of parameters or moments: the
  first step is a step.  The gradients it leaves (zeroed in place) are
  the ones the graph accumulates into.
- **Later calls** stage the batch into persistent tensors (one pair a
  ``(update, shape, dtype)`` signature; a copy in stream order), write
  the learning rate into the optimizer's device scalar, refill the flash
  dropout seeds (`kernels.graph_state.device_seed`) and replay the
  signature's graph, captured at its first call.  The loss comes back as
  a clone of the graph's output, so the next replay does not overwrite a
  loss the caller still holds.  ``update=False`` (a gradient-accumulation
  micro-step) has its own graph: forward and backward, the gradients
  accumulating in place.
- **The body** mirrors JAX's ``_traced_body`` and ``_update_tail`` op for
  op: the loss times the device scale and ``1 / accumulate_grad_batches``,
  backward, unscale, found-inf (armed at a scale other than 1 or with
  ``always_check_found_inf``), the clip (`Optimizer._clip`: a global-norm
  clip only computes its device scale, which the update applies), the
  optimizer's update with the found-inf flag as its skip flag, the step
  counter kept on a skipped step, the scaler vector's update
  (`amp.scaler_update`), the gradients zeroed in place.  Every op is the
  eager step's, so on the card the two lanes agree bit for bit.
- **Sentinel mode** (``sentinel=True``, JAX's ``_update_tail`` under its
  ``_sentinel``): found-inf is armed for runs without a scaler too and
  feeds the update's skip flag, and each full call gives a health vector
  ``[grad_norm_sq, skipped]`` (fp32, on the device) in ``last_health``,
  a clone of the graph's output, so a window of calls holds a record
  each.  The squared norm of the unscaled gradients (one
  ``torch._foreach_norm`` pass, summed in fp32) is taken only on the
  sentinel's cadence calls, ``calls % FLAGS_sentinel_check_every == 1``;
  the other calls carry -1.0.  A graph cannot branch on a device value,
  so a cadence call replays a second graph of its signature (the key
  gains the flag; both share the staged batch, the pool and every
  persistent tensor).  The health pass writes nothing the update reads:
  the trajectory is bit for bit the one without the sentinel.

- **The mesh lanes** (``mesh=ProcessMesh(...)`` with a dp or mp axis
  above 1; JAX's ``_resolve_mesh``): ``step(x, y)`` takes the global
  batch and each rank takes its dp rows (``local_batch=True``: the
  caller feeds the rank's rows, as `hapi.Model` does).  The tail
  all-reduces the gradients over dp and averages them, in buckets of
  25 MB (`distributed.parallel.allreduce_gradients`;
  sequence-parallel gradients summed over mp first), right after the
  unscale; the scaler's found-inf becomes one fp32 scalar all-reduced
  over the world (JAX hapi's ``_sync_grads``); the global-norm clip sums
  the squares of the mp-split gradients over mp and counts the copies
  once (`nn.clip.ClipGradByGlobalNorm.scale`).  The eager lane runs the
  same ops in the same order (`distributed.parallel.mesh_update`), so
  the lanes agree bit for bit.  A `DataParallel` network raises: the
  step syncs itself.  Capture
  takes the NCCL collectives into the graph (the communicators exist
  after call 1); a process group that cannot be captured (gloo) raises
  `NotImplementedError` at the capture.  An axis other than dp and mp
  above 1 raises with JAX's wording.  With ``sentinel=True`` the health
  vector is taken after the dp all-reduce, from the world's gradients
  (JAX's compiled step under its mesh): it carries the step's health
  across ranks and no further; the per-rank blame reads the eager lane's
  local gradients (`framework.sentinel`).

The step runs eagerly, warns once and latches ``fallback_reason`` when
``FLAGS_compiled_train_step`` is off, the network has forward hooks, a
parameter has gradient hooks, the optimizer has no device update, or the
forward reads the host.  A capture or replay error raises: nothing falls
back to the eager body after it.  On CPU parameters there is no graph:
each call after the first runs the body with the kernels' plain versions.

Telemetry, as JAX's counters (`utils.monitor`): ``jit.compiled_step_hit``
counts the compiled calls, ``jit.compiled_step_fallback`` the calls the
eager lane took because the step is not (or no longer) eligible, and
``jit.compiled_step_compile`` each graph made for a new signature.  JAX's
``ragged_fallback`` (a batch that does not divide dp) and ``alias_fallback``
(buffer donation, which torch has no counterpart of: the graph updates
its tensors in place) have no event here, so no counter is made for
them: a batch whose rows do not split over dp raises.
"""
from __future__ import annotations

import contextlib
import warnings
import weakref

import torch

from .. import amp
from ..distributed import parallel as _parallel
from ..optimizer.optimizer import Optimizer
from ..utils import monitor as _monitor
from ..utils.flags import flag as _flag
from . import capture

def _signature(t):
    if t is None:
        return None
    return tuple(t.shape), t.dtype


def _has_grad_hooks(p):
    return bool(getattr(p, "_backward_hooks", None)) or \
        bool(getattr(p, "_post_accumulate_grad_hooks", None))


class CompiledTrainStep:
    """``CompiledTrainStep(forward_fn, optimizer, *, scaler=None,
    network=None, accumulate_grad_batches=1, mesh=None, eager_step=None,
    sentinel=False)``.

    ``mesh`` (a `distributed.ProcessMesh` with dp and mp axes) and
    ``local_batch`` make the mesh lanes.
    ``forward_fn(x, y) -> loss`` is the only user code in the graph;
    everything after the loss is the framework's step tail.
    ``eager_step(x, y, update) -> loss`` is the eager lane, run at call 1
    and on every fallback (default: `_default_eager_step`, the JAX
    package's standalone semantics).  A custom ``eager_step`` whose
    forward is not ``forward_fn`` is not watched for host reads: a host
    read in the graph's forward then makes the capture raise."""

    def __init__(self, forward_fn, optimizer, *, scaler=None, network=None,
                 accumulate_grad_batches=1, mesh=None, eager_step=None,
                 sentinel=False, local_batch=False):
        self._forward = forward_fn
        self._opt = optimizer
        self._scaler = scaler
        self._network = network
        self._accum = max(int(accumulate_grad_batches or 1), 1)
        self._eager_step = eager_step  # None: `_default_eager_step`
        self._device = optimizer._device() if optimizer is not None \
            else torch.device("cpu")
        self._sentinel = bool(sentinel)
        self._health_every = max(
            int(_flag("FLAGS_sentinel_check_every", 8) or 1), 1)
        #: the last full call's device ``[grad_norm_sq, skipped]`` (sentinel)
        self.last_health = None
        self._micro = 0               # position within the accum window
        self._calls = 0
        self._fallback_reason = None
        self._warned = False
        self._probe = None            # host-read probe of call 1's forward
        self._built = False
        self._params = []             # parameters receiving gradients
        self._recorded = None         # call 1's generators and seeds
        self._steps = {}              # signature -> CapturedStep
        self._inputs = {}             # signature -> staged (x, y)
        self._outputs = {}            # signature -> the body's last loss
        self._health = {}             # signature -> its health vector
        self._svec = None             # device [scale, good, bad] fp32
        self._pool = self._stream = None
        self._local_batch = bool(local_batch)
        self._meshed = False
        self._dp, self._dp_rank = 1, 0
        self._dp_group = self._mp_group = None
        if mesh is not None:
            self._resolve_mesh(mesh)
        self.check_static_eligibility()

    def _resolve_mesh(self, mesh):
        """The dp and mp groups of ``mesh`` (JAX ``_resolve_mesh``): any
        other axis above 1 raises; a mesh of ones is no mesh."""
        names = mesh.dim_names
        for name in names:
            if name not in ("dp", "mp") and mesh.get_dim_size(name) != 1:
                raise NotImplementedError(
                    f"mesh axis '{name}' cannot run inside one compiled "
                    "program (pipeline schedules, ZeRO resharding and "
                    "context parallel keep their own lanes)")
        dp = mesh.get_dim_size("dp") if "dp" in names else 1
        mp = mesh.get_dim_size("mp") if "mp" in names else 1
        if dp <= 1 and mp <= 1:
            return
        _parallel.refuse_data_parallel(self._network,
                                       "CompiledTrainStep(mesh=...)")
        self._meshed = True
        if dp > 1:
            self._dp = dp
            self._dp_group = mesh.get_group("dp")
            self._dp_rank = mesh.get_coord("dp")
        if mp > 1:
            self._mp_group = mesh.get_group("mp")

    # ------------------------------------------------------------------
    # public surface
    # ------------------------------------------------------------------

    @property
    def compiled(self):
        return self._built and self._fallback_reason is None

    @property
    def fallback_reason(self):
        return self._fallback_reason

    def __call__(self, x, y=None, update=None):
        if update is None:
            update = (self._micro + 1) >= self._accum
        if self._meshed:
            x, y = self._rows(x), self._rows(y)
        return self._call(x, y, update)

    def _rows(self, t):
        """This dp rank's rows of a global batch (the batch as it is with
        ``local_batch`` or without a dp axis)."""
        if t is None or self._dp <= 1 or self._local_batch:
            return t
        n = t.shape[0]
        if n % self._dp:
            raise ValueError(f"CompiledTrainStep: a batch of {n} rows does "
                             f"not split over the {self._dp} dp ranks")
        per = n // self._dp
        return t[self._dp_rank * per:(self._dp_rank + 1) * per]

    def _call(self, x, y, update):
        self._calls += 1
        if self._fallback_reason is not None or not self._eligible_now():
            _monitor.incr("jit.compiled_step_fallback")
            loss = self._run_eager(x, y, update)
        elif not self._built:
            loss = self._warm_up(x, y, update)
        else:
            loss = self._run_compiled(x, y, update)
            _monitor.incr("jit.compiled_step_hit")
        self._micro = 0 if update else self._micro + 1
        return loss

    step = __call__

    def sync_scaler(self):
        """Write the device-held loss-scaling state (scale, good and bad
        counters) back into the Python ``GradScaler``: one host read."""
        if self._scaler is None or self._svec is None:
            return
        scale, good, bad = self._svec.tolist()
        self._scaler._scale = float(scale)
        self._scaler._good_steps = int(good)
        self._scaler._bad_steps = int(bad)

    def load_scaler(self):
        """Write the Python ``GradScaler``'s state into the device vector
        the graphs read, in place (after a rollback restored the scaler;
        a new tensor would leave the graphs reading the old one)."""
        if self._scaler is None or self._svec is None:
            return
        sc = self._scaler
        self._svec.copy_(torch.tensor(
            [sc._scale, float(sc._good_steps), float(sc._bad_steps)],
            dtype=torch.float32))

    def graph_stats(self):
        """{signature label: (captures, replays, launches per replay)}; a
        signature is captured once, at its first compiled call on the
        card."""
        out = {}
        for (update, xs, ys, cadence), st in self._steps.items():
            label = ("full" if update else "micro") + \
                ("+health" if cadence else "") + \
                f" x{list(xs[0])} {str(xs[1]).replace('torch.', '')}"
            out[label] = (int(st.graph is not None), st.replays,
                          dict(st.launches))
        return out

    # ------------------------------------------------------------------
    # eligibility and fallback
    # ------------------------------------------------------------------

    def _set_fallback(self, reason):
        self.sync_scaler()
        self._svec = None
        self._fallback_reason = reason
        if not self._warned:
            self._warned = True
            warnings.warn(f"compiled train step disabled ({reason}); "
                          "running the eager step for this model",
                          UserWarning, stacklevel=3)

    def check_static_eligibility(self):
        """One-time structural checks; returns None when eligible, else
        the (latched) fallback reason."""
        opt = self._opt
        if opt is None:
            self._fallback_reason = "no optimizer"
        elif type(opt).step is not Optimizer.step:
            self._set_fallback(f"{type(opt).__name__}.step is overridden "
                               "(closure-style optimizers run eagerly)")
        elif type(opt)._update is Optimizer._update:
            self._set_fallback(f"{type(opt).__name__} has no fused update")
        return self._fallback_reason

    def _eligible_now(self):
        """Per-call checks of state that may change mid-run."""
        if not _flag("FLAGS_compiled_train_step", True):
            self._set_fallback("FLAGS_compiled_train_step is off")
            return False
        if self._network is not None:
            for layer in self._network.modules():
                if layer._forward_hooks or layer._forward_pre_hooks:
                    self._set_fallback("layer forward hooks installed")
                    return False
        for p in self._opt._parameter_list:
            if _has_grad_hooks(p):
                self._set_fallback("tensor gradient hooks installed")
                return False
        return True

    # ------------------------------------------------------------------
    # eager lane
    # ------------------------------------------------------------------

    def _run_eager(self, x, y, update):
        # a fallback after compiled steps must not read a stale host
        # scaler: pull the device-held state down first
        if self._svec is not None:
            self.sync_scaler()
            self._svec = None
        self.last_health = None       # no stale record for this step
        return (self._eager_step or self._default_eager_step)(x, y, update)

    def _call_forward(self, x, y):
        if self._probe is None:
            return self._forward(x, y)
        with capture.host_read_probe(self._device) as probe:
            loss = self._forward(x, y)
        self._probe = self._probe or probe.found or ""
        return loss

    def _default_eager_step(self, x, y, update):
        """Standalone eager semantics (scaler- and clip-aware)."""
        loss = self._call_forward(x, y)
        bwd = loss
        if self._scaler is not None:
            bwd = self._scaler.scale(bwd)
        if self._accum > 1:
            bwd = bwd * (1.0 / self._accum)
        bwd.backward()
        if update:
            if self._meshed:
                _parallel.mesh_update(self._opt, self._scaler,
                                      self._dp_group, self._mp_group,
                                      self._device)
            elif self._scaler is not None:
                self._scaler.step(self._opt)   # unscale, found-inf, update
            else:
                self._opt.step()
            self._opt.clear_grad()
        return loss

    # ------------------------------------------------------------------
    # call 1: the real first step, eagerly on the capture stream
    # ------------------------------------------------------------------

    def _warm_up(self, x, y, update):
        cuda = self._device.type == "cuda"
        ctx = contextlib.nullcontext()
        if cuda:
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(self._device)
            self._stream.wait_stream(torch.cuda.current_stream(self._device))
            ctx = torch.cuda.stream(self._stream)
        self._probe = ""              # armed: `_call_forward` fills it
        try:
            with ctx, capture.recording() as rec:
                loss = self._run_eager(x, y, update)
        finally:
            found, self._probe = self._probe, None
        if torch.is_tensor(loss):
            # no autograd graph of the side stream's step outlives it
            loss = loss.detach()
        if cuda:
            current = torch.cuda.current_stream(self._device)
            current.wait_stream(self._stream)
            if torch.is_tensor(loss):
                loss.record_stream(current)
        if found:
            self._set_fallback(found)
            return loss
        opt = self._opt
        # the gradients call 1 left (zeroed in place by clear_grad) are
        # the ones the graphs accumulate into
        self._params = [p for p in opt._parameter_list
                        if p.requires_grad and p.grad is not None]
        if not self._params:
            self._set_fallback("no trainable parameters received gradients")
            return loss
        opt._ensure_state()
        self._recorded = rec
        self._built = True
        if cuda:
            # the eager step's cached blocks and the graphs' pool must not
            # both sit at peak
            torch.cuda.empty_cache()
        return loss

    # ------------------------------------------------------------------
    # later calls: stage, replay
    # ------------------------------------------------------------------

    def _stage(self, key, x, y):
        """Copy the batch into the signature's persistent tensors (in
        stream order)."""
        staged = self._inputs.get(key)
        if staged is None:
            staged = self._inputs[key] = tuple(
                None if t is None else torch.empty(
                    t.shape, dtype=t.dtype, device=self._device)
                for t in (x, y))
        for dst, src in zip(staged, (x, y)):
            if dst is not None:
                dst.copy_(src)

    def _run_compiled(self, x, y, update):
        cadence = bool(self._sentinel and update
                       and self._calls % self._health_every == 1)
        key = (bool(update), _signature(x), _signature(y), cadence)
        self._stage(key[1:3], x, y)
        if self._scaler is not None and self._scaler._enable and \
                self._svec is None:
            sc = self._scaler
            self._svec = torch.tensor(
                [sc._scale, float(sc._good_steps), float(sc._bad_steps)],
                dtype=torch.float32).to(self._device)
        if update:
            self._opt._write_lr()
        step = self._steps.get(key)
        if step is None and self._meshed and self._device.type == "cuda":
            self._check_capturable()
        if step is None:
            # the graph's body holds the step weakly: no reference cycle
            # keeps a dropped step, its model and its graph pool alive
            ref = weakref.ref(self)
            step = self._steps[key] = capture.CapturedStep(
                lambda: ref()._body(key), (), self._device, pool=self._pool,
                stream=self._stream, warmup=False, recorded=self._recorded)
            _monitor.incr("jit.compiled_step_compile")
        step()
        if update:
            self._opt._step_count += 1
            if self._sentinel:
                self.last_health = self._health[key].clone()
        return self._outputs[key].clone()

    def _check_capturable(self):
        """Every process group of the tail must be capturable (NCCL)."""
        import torch.distributed as dist
        for group in (self._dp_group, self._mp_group, None):
            if group is not None and group.nranks <= 1:
                continue
            backend = dist.get_backend(
                None if group is None else group.process_group)
            if backend != "nccl":
                raise NotImplementedError(
                    f"CompiledTrainStep(mesh=...) on the card over a "
                    f"{backend} process group: {backend} collectives "
                    "cannot be captured in a CUDA graph (use nccl)")

    def _body(self, key):
        """The graph's body: forward, backward and, for an update, the
        step tail; reads and writes persistent tensors only."""
        update = key[0]
        xs, ys = self._inputs[key[1:3]]
        svec = self._svec
        with torch.enable_grad():
            loss = self._forward(xs, ys)
            bwd = loss
            if svec is not None:      # the scale is device state
                bwd = bwd * svec[0].to(loss.dtype)
            if self._accum > 1:
                bwd = bwd * (1.0 / self._accum)
            bwd.backward()
        self._outputs[key] = loss.detach()
        if update:
            with torch.no_grad():
                self._health[key] = self._update_tail(svec, key[3])

    def _update_tail(self, svec, cadence=False):
        """Unscale, found-inf, clip, the update with its skip flag, the
        step counter, the scaler vector, zeroed gradients: JAX's
        ``_update_tail`` with the eager step's ops.  Returns the sentinel's
        health vector (None without the sentinel)."""
        opt = self._opt
        grads = [p.grad for p in self._params]
        found = None
        if svec is not None:
            inv = 1.0 / svec[0]
            for g in grads:
                if g.dtype == torch.float32:
                    g.mul_(inv)
                else:                 # fp32 product, one rounding
                    g.copy_(g.float() * inv)
            found = amp.found_inf(grads)
            if not self._scaler._always_check:
                found = found & (svec[0] != 1.0)
        if self._meshed:
            _parallel.allreduce_gradients(self._params, self._dp_group,
                                          self._mp_group)
            if found is not None:
                found = _parallel.all_ranks_found_inf(found, self._device)
        health = None
        if self._sentinel:
            if found is None:         # no scaler: the sentinel arms it
                found = amp.found_inf(grads)
            if cadence:
                norms = torch._foreach_norm(grads, 2.0, dtype=torch.float32)
                gnorm_sq = torch.stack(norms).square().sum()
            else:
                gnorm_sq = torch.full((), -1.0, device=self._device)
            health = torch.stack([gnorm_sq, found.float()])
        params_grads, gscale = opt._clip([(p, p.grad) for p in self._params])
        step = opt._step_tensor
        new_step = step + 1.0
        opt._apply_update(params_grads, opt._lr_tensor, new_step, skip=found,
                          gscale=gscale)
        step.copy_(new_step if found is None
                   else torch.where(found, step, new_step))
        if svec is not None:
            svec.copy_(amp.scaler_update(self._scaler, svec, found))
        torch._foreach_zero_(grads)
        return health
