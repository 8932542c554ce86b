#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printed as it ends; any failure exits non-zero before the
last line:

1. device   the card's name and power limit (nvidia-smi); no card → exit 1
2. build    every CUDA kernel built with nvcc for sm_90a from csrc/; the
            registers and spills (ptxas -v) of the RMS-norm kernels, the
            paged-decode kernels, every flash forward and backward kernel
            and the LoRA delta: any spill fails, and so does a flash
            source whose build lists no wgmma kernel
3. kernels  each kernel against its plain PyTorch version on the card at
            the serving and training paths' shapes, with its time, the
            plain version's, one PyTorch library call's where there is
            one and its bound; controls: deliberately wrong results that
            the checks must reject; the flash kernels' feature variants
            (dropout 0.1, an additive bias, a key-padding mask with a
            fully masked row, segment ids) at GPT-2's training shape;
            the flash kernels' dropout hash on global rows and heads
            (offsets 0 = none bit for bit, a dp x mp split's parts = the
            global call's slices, one part against the plain versions);
            the dropout seed read from device memory (a 0-dim int64
            tensor) equal to the host int's bits, seed + 1 rejected;
            Adam with its [lr, bc1, bc2, gscale] made on the card from a
            device step counter, bit for bit, the skip flag set writing
            nothing, the fourth step's scalars rejected; adam_clip: the
            global-norm clip's scale (gscale < 1) applied as the kernel
            loads a bf16 gradient, bit for bit with the plain version and
            with the clip applied first, the unclipped update and the
            scale without the rounding to bf16 rejected;
            paged decode's split plan for each case, a 32-row batch and
            offsets on the split's edges; RMS norm's launch plan for each
            case, its staged and generic paths, dw bit-identical over two
            calls, the backward's two launches timed apart, and the
            Timer's floor (one in-place add on a 4-element tensor)
4. serve    Llama-2 7B at full width (32 layers, bf16, random weights
            from a seed) behind the paged Engine: 8 requests, every decode
            step a compiled tick (one CUDA graph replay; no fallback), the
            serving kernels' launch counts (a replay adds its graph's
            launches) checked against the steps taken; then torch.profiler
            over a short serving run (device busy share, device time by
            kernel) and over one 900-token request (paged decode's device
            time a decode step)
5. serve-lora-int8  the same model behind an int8-KV Engine with a
            4-slot LoRA adapter pool (rank pool 16) and three adapters:
            the same 8 requests, six of them under adapters; launch counts
            of the int8 decode and LoRA delta kernels checked against the
            steps taken, a prefix hit inside an adapter's scope; the same
            traffic without the pool (the pool's decode-step cost); int8
            and fp8 pages in use at equal load against a bf16 pool; every
            run decodes through the compiled tick; the kernels of 5
            profiled replays of each tick graph must be its recorded
            launches; then the adapter traffic with a ninth, unseeded
            sampled request that sends the steps while it decodes to the
            uncompiled int8 + adapter step and back to the tick: the
            eight requests' tokens must equal the all-tick run's
5b. serve-tick  the serve phase's 8 requests (six greedy, two
            seeded-sampled) on the same model twice, with
            FLAGS_compiled_tick off and on: every request's tokens must be
            equal in both lanes; each lane's decode ms/step p50, avg and
            p99, tick ms, TTFT p50, tokens/s and device busy share
            (torch.profiler over a short run), and the tick's graphs:
            captures, each mode's first tick (warm-up + capture), replays
            and kernel launches a replay, checked against 5 profiled
            replays
5c. serve-spec  the same model with speculation_k 4 (the compiled tick is
            off while speculation is configured): the serve phase's
            requests all greedy with (a) the target as its own draft (its
            own draft cache), (b) a 2-layer early-exit draft holding
            copies of the target's embedding, layers 0-1, final norm and
            head, (c) (a) with int8 pools, and (d) the serve traffic as it
            is (request 3 seeded-sampled: its iterations take the plain
            step), (a)-(d) on the first 4 requests with 16 new tokens; each
            against the plain compiled lane's first 16 on the same
            requests: greedy tokens equal before each request's first
            near tie (the plain lane's top-two logit margin under tau =
            2 x the largest logit difference between the plain step's
            route and the batch-4 step or the verify call's, measured by
            teacher-forced replays; a control: a changed token is
            rejected), acceptance >= 90% in (a) and <= 5% in (b), every
            draft page returned and the target's pages equal to the
            prefix tree's, paged decode and RMS norm launched at least as
            the windows and steps need; ms a window, tokens a window, the
            draft / verify / rollback ms, ms a generated token beside the
            plain lane's, peak memory.  Exact lanes (the first 4
            requests): fp32, 2 layers at
            Llama-2 7B and GPT-3 6.7B width (GPT at max_seq_len 2044 = its
            2048 positions less K; 2048 with K refused), 1-layer
            early-exit drafts: spec tokens equal the plain ones
5d. serve-resilience  the same model, bf16, 4 slots: (1) drain under the
            compiled tick (two requests decoding finish, three waiting on
            the pool's pages fail with EngineShutdownError, a submit after
            it raises; the drain's ms); (2) the same drill in a child
            (``--serve-child``, 2 layers at 7B width) on SIGTERM through
            install_preemption_drain, exit 0; (3) the tick's 2nd call
            stalls 30 s under step_timeout_s 5: SchedulerStallError
            within 10 s, a stall dump, a new tick captured, the next
            request's tokens equal a fresh engine's; (4) a model call
            raises: every outstanding future fails with it, one restart,
            served again; (5) three more restarts: memory allocated after
            each within 1% of the first; (6) kv_layout="slots" on the
            serve traffic's first 4 requests: greedy tokens equal the
            paged lane's under the
            tie rule (tau from the slot lane's replay), decode ms/step,
            and exactly in fp32 at 2 layers
5e. serve-telemetry  the same model: (a) the serve traffic under the
            compiled tick with request tracing on (FLAGS_trace_dir, every
            trace kept) and the exporter on: each request's trace one
            engine.request root with its engine.queue, engine.prefill and
            engine.decode spans, one decision, one winner;
            tools/trace_analyze.py --strict and check_telemetry --trace /
            --trace-report on the spools; the merged chrome trace (a span
            event each, a flow for each cross-process parent); greedy
            tokens equal the serve phase's (the tie rule where they part);
            every decode step a compiled tick; tracing's cost: the serve
            prompts' first 64 tokens, all greedy, tracing off / on / on /
            off; (b) the registry's exposition through check_telemetry
            --serving-tick --require-series (the families the run moves)
            and the exporter's file through --snapshots; (c) a 2-layer
            model at 7B width whose decode forward calls .item(): one
            TickFallbackWarning, fallbacks counted, no compiled tick, the
            flag-off lane's tokens, memory within 1 MiB of its run's
5f. serve-fleet  prefill/decode disaggregation across processes on the
            one card (`ServingFleet`, the ``spawn`` context, a router with
            disaggregation on; each replica builds its model from seed 0
            and the weights' checksums must agree): (a) Llama-2 7B, bf16,
            4 slots, context 1024, the tick on, prefill replica-0 ->
            decode replica-1 over the serve traffic (request 5 submitted
            once request 2's prompt pages are in the prefill replica's
            tree): no migration fallback, every request decoded by
            replica-1, no paged decode on replica-0, replica-1's launches
            during the traffic = its replays x its graphs' launches (32
            paged decodes a replay), every decode step a tick, greedy
            tokens equal the serve phase's under the tie rule (tau and the
            margins computed before the serve model is freed), every slot
            free and every page back; migrations, pages and bytes,
            migrate_ms p50 and max, TTFT p50, the decode replica's ms/step,
            the fleet's start, each replica's peak memory; (b) int8 pools
            at 2 layers of 7B width in fp32 (prefill replica-0, decode
            replicas 1 and 2), requests 0-3: tokens equal one int8
            engine's bit for bit, the adopted pages and scales hash equal
            to the sender's rows; (d) that run traced: each request one
            trace over the three processes (router root, prefill,
            engine.migrate, the resumed request), trace_analyze --strict,
            check_telemetry; (c) drills with 48-token prompts and 900 new
            tokens: drain_replica of a decode replica mid-decode (its
            slots finish on the other, no prompt prefilled again, none
            resubmitted), SIGKILL of the other mid-decode (every request
            recovered), flip_role of replica-0 to decode (rejoins at a
            bumped generation); (g) a tensor-parallel decode replica: 7B
            width at 2 layers in bf16, prefill replica-0 (tp 1) -> decode
            replica-1 (tp 2: two ranks, one process each, sharing the card
            through NCCL's socket transport on lo; the leader schedules
            and broadcasts each call's descriptor over gloo, the follower
            replays it), the first 4 serve requests x 32 tokens: the
            gathered weights' digest equal to the tp 1 replica's, greedy
            tokens equal one engine's over the same model under the tie
            rule (the fleet reference's tau), every step a tick replayed on
            both ranks (each rank's launches: 2 paged decodes at 16 local
            heads and 5 RMS norms a replay), paged decode at the local
            shape against its plain version; decode ms/step p50 beside the
            descriptor's broadcast and a tp 1 replica's step, collective
            calls and bytes a step a rank; a drain of the tp 2 replica
            mid-decode onto a tp 1 decode replica (the first slot; the rest
            there or on a second tp 2 replica, as the gossip's loads show:
            all migrated, none resubmitted), a SIGKILL of that tp 2
            replica's follower
            mid-decode (the leader leaves the ring and exits 101, every
            request finishes elsewhere; the time to the lease lapsing)
6. parity   a 2-layer model at the 7B widths in fp32 with the same
            weights served on the CPU (plain versions, the tick's eager
            body) and on the card (kernels, the tick's graphs): greedy and
            seeded-sampled outputs must be identical, with float pools,
            and greedy ones with int8 and fp8 pools under an adapter pool
7. train    Llama-2 7B at full width cut to 8 layers, bf16 O2 through
            amp.decorate, AdamW with fp32 master weights and global-norm
            clipping, B1 x S4096, in two lanes on the same weights and
            batch: eager (2 warm-up and 6 timed steps: step ms, tokens/s,
            MFU, peak memory, the forward, backward, clip and AdamW +
            clear_grad apart, every training kernel's launch count checked
            against the steps taken, the loss falling; torch.profiler over
            one step), then, the eager model freed, CompiledTrainStep
            (call 1 eager, call 2 captures; the same measures, the first
            compiled call's ms, the graph's captures, replays and launches
            a replay, which must equal the eager lane's a step;
            torch.profiler over 3 replays after a warm-up one)
8. train-parity  a 2-layer fp32 model at the 7B widths, the same weights
            and batch, 3 AdamW steps on the CPU (plain versions) and on
            the card (kernels): losses and parameters must agree
8b. train-compiled-parity  eager against CompiledTrainStep on the card,
            bit for bit (losses, every parameter, moment and master, the
            step counter): (a) train-parity's model with its clip, (b) a
            2-layer GPT-2-width fp32 model with attention and residual
            dropout 0.1, (c) (b) in fp16 O2 under a GradScaler and a
            LinearWarmup + cosine schedule with an overflowing batch
            (skipped, the scale halved, sync_scaler equal), (d) (a) with
            two-batch accumulation, (e) (a) with a clip of 1e-3 (its
            scale < 1), (f) (a) with an L2Decay that apply_decay_param_fun
            refuses for every name but one parameter's regularizer
            applies; (a)'s card losses against the CPU's
9. train-gpt2  GPT-2 124M, nothing cut (12 layers, hidden 768, vocab
            50304), attention and residual dropout 0.1, bf16 O2 AdamW, B8
            x S1024, in the train phase's two lanes (the compiled model
            rebuilt from the same seed) through the flash kernels'
            dropout variants, the loss falling
10. gpt2-parity  a 2-layer GPT-2-width fp32 model with attention
            dropout 0.1: 3 AdamW steps on the CPU and on the card from the
            same weights and flash seeds must agree
11. attn-ops  the public attention entry points at GPT-2's shape
            (scaled_dot_product_attention with a boolean mask and
            dropout, flash_attention with segment ids, variable-length
            attention with an additive mask), forward and backward,
            against their plain versions through the masked variants
12. train-optimizers  GPT-2 124M as in phase 9 with a global-norm clip
            of 1.0 under SGD, Momentum (Nesterov), Adagrad, RMSProp
            (centered, momentum 0.9), Adadelta, Adamax and Lamb: each
            lane 2 + 3 steps eager, then rebuilt from the seed through
            CompiledTrainStep (losses equal bit for bit, one capture,
            launches a replay equal to the eager lane's a step, the
            compiled step ms p50); LBFGS on a 2-layer fp32 model for 2
            closure steps (the loss falls; the compiled step falls back
            with one warning)

13. serve-gpt  GPT-3 6.7B, nothing cut (32 layers, hidden 4096, 32
            heads, max_seq_len 2048, vocab 50304; bf16, random weights
            from seed 0) behind the paged Engine with its defaults and
            the tick on: the serve phase's 8 requests, every decode step
            a compiled tick (no fallback) launching paged decode in every
            layer; decode ms/step, TTFT, tokens/s, peak memory, KV pages
            peak, and one replay's device ms against its bound (every
            weight read once but the position table's unread rows)
14. gpt-parity  a 2-layer fp32 GPT at GPT-3 6.7B width on the CPU and the
            card: the engine's greedy and seeded outputs identical (tick
            on), int8 pools under a 2-adapter pool too (the adapters'
            tokens differ from the base's, paged_decode_int8 and
            lora_delta launch); on the card generate with the cache equal
            to generate without it and to the engine's greedy output,
            speculative_generate (K 4, a 1-layer draft) equal to greedy
            generate; beam_search (4 beams) equal on both devices; a
            2-layer GQA Llama at 7B width (8 kv heads): generate with and
            without the cache equal to the engine's output, its dense
            caches holding the kv heads only
15. generate-gpt  serve-gpt's model (GPT-3 6.7B, bf16): generate with the
            cache, each step's last-position logits against the full
            forward of the same ids (teacher-forced), row by row within
            GEN_ROW_TOL (a control: the logits of the step before must be
            rejected); ms a generated token and peak memory
16. train-gpt2-recompute  train-gpt2 with use_recompute=True in both
            lanes: losses equal to the lanes without recompute bit for
            bit, the flash forward kernels launched twice a block a step,
            the backward once; step ms and peak memory beside
            train-gpt2's.  attn-ops adds a learned bias that requires
            grad: no flash kernel launches, the plain route is counted,
            and the bias gradient matches an fp64 autograd reference
17. fit-gpt2  GPT-2 124M width, 6 of its 12 layers, bf16 O2 (``prepare(amp_configs=
            "O2")``), AdamW(1e-4, wd 0.01), B8 x S1024 through
            ``hapi.Model.fit`` with CrossEntropyLoss over
            ``data.pipeline(ds).shard(0, 1).shuffle(seed=0).batch(8)
            .device_prefetch(2)`` (``ds``: rows of seeded random ids):
            (a) at dropout 0.1, 2 + 6 fit steps: the losses equal the
            same ``_forward_loss`` driven by hand through
            CompiledTrainStep bit for bit, one capture, no fallback, the
            launches a replay equal (6 of each flash dropout variant,
            76 Adam); (b) at dropout 0, 2 epochs of 3 steps in child
            processes: SIGTERM after step 2 through PreemptionHandler
            exits 101 and leaves a committed checkpoint, a child started
            beside it resumes with ``fit(resume=True)`` once it exited
            and trains into the reshuffled second epoch, and the losses
            equal an uninterrupted child's bit for bit; (c) the state's
            bytes, a
            synchronous save's ms, how long an async ModelCheckpoint
            blocks the step loop, ``restore_latest``'s ms; the newest
            checkpoint truncated, the older one restored (equal to the
            state a synchronous checkpoint saved), the exposition's ckpt
            families through check_telemetry; (d) fit's step ms p50
            beside the hand lane's, goodput (input-bound share, starved
            steps) and the device busy share of 3 fit steps
18. fit-llama  Llama-2 7B width, 8 of 32 layers (train's cut), bf16 O2,
            AdamW(3e-4, wd 0.01, ClipGradByGlobalNorm(1.0)), B1 x S4096,
            through ``Model.fit`` over an ``io.DataLoader`` of seeded rows
            for 2 + 4 steps: losses equal to the hand-driven compiled lane
            bit for bit, launches a replay equal (17 RMS norm forward and
            backward, 32 rope, 8 of each flash kernel, 75 Adam); fit's and
            the hand lane's step ms p50, the busy share of 3 fit steps;
            the exposition's io family through check_telemetry.  No
            checkpoint (~24 GB of state)
19. sentinel-gpt2  GPT-2 124M, nothing cut, dropout 0.1, B8 x S1024,
            through ``Model.fit`` on CompiledTrainStep under the training
            sentinel (checks and anchors every 8 steps): (a) 16 steps on
            against off, losses and weights bit for bit, the step's two
            graphs (full; cadence, with the squared norm) captured once
            each; (e) that run's train.step_time_ms, tokens/s and
            train.mfu against the phase's CUDA-event step times (MFU
            within 2 points, at most 1), the exporter's lines through
            ``tools/check_telemetry.py --snapshots``, the exposition's jit
            and data families through ``--prometheus --data``; (d) a
            replay with and
            without the sentinel, an anchor in host memory and through
            CheckpointManager, a rollback; (b) a finite loss spike the data
            carries (batch 20 of 32): one rollback into the captured
            graphs, 20 quarantined, the dump through ``--sentinel-dump``,
            the weights equal a clean run without batch 20 bit for bit;
            (c) the eager lane: loss_spike at 12 (rollback) equal to the
            clean run without batch 12, grad_bitflip at 12 (skipped,
            quarantined) equal to a clean run that draws batch 12's
            dropout masks without training on it
20. lora-llama  Llama-2 7B width, 8 of 32 layers, attach_lora(rank 16)
            on the seven projections, the base frozen, bf16 O2, AdamW over
            the factors, B1 x S4096, 2 + 4 fit steps: step ms, MFU, peak
            memory, launches a replay; the eager lane's losses equal bit
            for bit; merge / unmerge bit for bit; save_adapter, then the
            base served with the adapter in the Engine's pool: prefill
            logits within LORA_FLOOR_MULT x the model's bf16 floor of the
            wrapped model's forward and of the fp32 adapted model
21. train-hybrid  the collectives and the hybrid dp x mp step; the
            ranks are children of this script (``--hybrid-child``) over
            NCCL (HYBRID_BACKEND; ranks that share the card through its
            socket transport): (a) Llama-2 7B width, 8 layers, mp 2, bf16
            O2, AdamW + clip 1.0, B1 x S4096 through fleet.init ->
            distributed_model -> CompiledTrainStep(mesh), eager then
            compiled: losses finite, falling, compiled = eager bit for
            bit, the norms' copies equal across ranks, the training
            kernels launched on every rank; step ms, MFU against one
            card, peaks, collectives and bytes a step, graphs, the busy
            share of 3 replays; (b) 2 layers at 7B width fp32, mp 2
            against one rank on the same weights
            (convert.shard_paddle_tpu_state), 3 AdamW steps, and the
            clip's global norm of the first step's gradients; (d) generate
            with a dense and a paged cache = the one rank's tokens; (c)
            GPT-2 124M dp 2 x mp 2, dropout 0.1, bf16 O2: hapi fit over a
            DistributedBatchSampler = the hand-driven CompiledTrainStep on
            the global batches bit for bit, the dp replicas bit for bit,
            the 4 ranks' flash parts (the hash's offsets) = the one-rank
            call
22. train-guard  the hang and failure guardian, the launcher and the
            sentinel across ranks: GPT-2 124M width, 6 of its 12
            layers, dp 2 (two ranks on the card, NCCL), dropout 0.1, bf16 O2, AdamW, the eager lane,
            B4 x S1024 a rank, launched by the port's CollectiveController
            (the ranks are this script's ``--guard-child``; every generator
            reseeded from (step, rank)); (b), (e), (f) run side by side,
            then (c) and (d): (a) 7 steps: the guardian armed, then 2
            turns of off, armed, and armed with a hot-spare snapshot (a
            warm capture timed in the step, the stream before it waited
            out ahead of it): losses bit for bit, each lane's step p50, store writes
            a step, the agent's captures, skips and transfers, the flash
            and Adam launches a rank; (b) through fit, epochs of 2 steps,
            a sharded ModelCheckpoint each epoch (a shard file a rank),
            FLAGS_hot_spare every 2 updates: rank_crash on rank 1 inside
            step 4 -> rank 0 exits 101 with PeerFailureError carrying the
            InjectedFault and parks its snapshot and rank 1's replica ->
            the relaunch restores rank 1 from its buddy's memory (peer)
            and rank 0 from its own parked copy (self), both ranks' losses
            equal (a)'s bit for bit; crash -> resumed first step, snapshot
            bytes, transfer ms, cadences skipped, park ms and bytes;
            (c) collective_delay on rank 1, timeout 3 s:
            rank 0's stall dump through check_telemetry --stall-dump (the
            op, the seq, missing_ranks [1], waited_s < 6 s), the job ends
            nonzero within the timeout and both graces; (d) grad_bitflip
            on rank 1 twice under FLAGS_sentinel: both ranks skip, rank 1
            blamed, SentinelError, the relaunch on one worker with
            PADDLE_ELASTIC_RESIZED=2:1 resumes (b)'s last dp 2 checkpoint
            resharded onto a world of one (its state equal to the saved
            one bit for bit) and trains an epoch; (e) (b) with
            buddy_crash on rank 1 over 4 steps, crashing inside step 2
            after its snapshot of iteration 2 was committed at its buddy
            -> a PeerRestoreWarning, both ranks from the sharded
            checkpoint, losses equal (a)'s; (f) GPT-2 124M at dp 1 x mp
            2 through fit saves a sharded
            checkpoint (each rank its parts), a world-one job resumes it
            equal to the gathered shards bit for bit and its next epoch's
            losses equal a world-one run started from that state
23. train-zero  ZeRO sharding and the semi-auto parallel API: four ranks
            sharing the card over NCCL's socket transport (this script's
            ``--hybrid-child zero``), sharding 2 x mp 2 (dp -1 -> 1):
            (a) benchmarks/run.py config 3 call for call (fleet.init with
            strategy.sharding at stage 3, distributed_model(ParallelGPT),
            AdamW(1e-4), group_sharded_parallel(level="p_g_os"),
            distributed_optimizer) at GPT-3 1.3B width, ZERO_LAYERS of 24
            layers, bf16 O2 (amp.decorate), the [8, 2048] batch placed by
            shard_tensor: losses finite and equal on the 4 ranks, every
            parameter's placements JAX's rule, the flash and Adam kernels
            launched on every rank and no Adam launch on its scalar path;
            step p50 (the slowest rank), collectives and bytes a step,
            launches a step, resident parameter and optimizer-state bytes
            against sharding 1, peaks; (b) 2 layers at the same width in
            fp32: levels os, os_g, p_g_os against one rank (2 AdamW steps
            with the clip: losses and the next batch's within
            ZERO_LOSS_RTOL, the gathered parameters within 2 lr x steps)
            and the api moves bit for bit; (c) save_group_sharded_model
            after (b)'s p_g_os, loaded into one rank's GPTForCausalLM:
            its next-batch loss against the stage-3 run's.  With
            train-hybrid in the run, the ranks start beside its gpt lane
            and wait for this phase (their imports overlapped)
24. train-pipe  pipeline parallelism: fleet.distributed_model(
            GPTForCausalLMPipe) -> PipelineParallel.train_batch on four
            ranks sharing the card over NCCL's socket transport, pp 2 x
            mp 2 (with train-zero in the run, its ranks run this lane
            after their checks; else ``--hybrid-child pipe``), (b) and
            (c) first, 1F1B on each rank, the stage hand-offs point to
            point: (a)
            GPT-3 1.3B
            width, PIPE_LAYERS of 24 layers (2 a stage), bf16 O2,
            AdamW(1e-4) + clip 1.0, the [8, 2048] batch in 4
            micro-batches, 1 + 3 steps: losses finite and equal on the 4
            ranks, each rank's order JAX's 1F1B plan, launches a step a
            rank (flash fwd / dK-dV / dQ 8 each, Adam one a parameter, none
            on the scalar path); step p50 (the slowest rank), p2p and
            collective calls and bytes a step, the tied weight's gradient
            all-reduce, resident bytes, peaks; the flash kernels at the
            path's shape (B2 H8 S2048 D128 causal bf16) and Adam at its
            largest parameter against their plain versions; (b) 2 layers
            at the same width in fp32 and (c) 4 layers in 2 virtual
            stages a rank (small: hidden 1024, vocab 8192), each against
            one rank's GPTForCausalLMPipe at pp 1 on the same weights (3
            AdamW steps: losses within ZERO_LOSS_RTOL, this rank's
            parameters within 2 lr x steps)

The second-to-last line is the kernels' JSON summary, the last line
``{"ok": true, "device": {...}}``.  ``--phases`` runs a subset.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import gc
import hashlib
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
import types
import warnings

import numpy as np
import torch

from paddle_tpu_torch import amp, kernels
from paddle_tpu_torch import data as pdata
from paddle_tpu_torch.distributed.fleet.elastic import ELASTIC_EXIT_CODE
from paddle_tpu_torch.framework.checkpoint_manager import (CheckpointManager,
                                                           step_dir_name)
from paddle_tpu_torch.hapi import Callback, Model, ModelCheckpoint
from paddle_tpu_torch.io import DataLoader, TensorDataset
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels.adam import (adam_scalars, adam_update,
                                           adam_update_ref)
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.kernels.lora import lora_delta, lora_delta_ref
from paddle_tpu_torch.kernels.paged_decode import (gather_pages,
                                                   paged_decode_attention,
                                                   paged_decode_ref,
                                                   split_plan)
from paddle_tpu_torch.kernels import rms_norm as rn
from paddle_tpu_torch.kernels.rms_norm import (rms_norm, rms_norm_bwd,
                                               rms_norm_bwd_ref,
                                               rms_norm_ref)
from paddle_tpu_torch.kernels.rope import rope, rope_ref
from paddle_tpu_torch.incubate.nn.functional import \
    variable_length_memory_efficient_attention
from paddle_tpu_torch.models import (GPTForCausalLM, LlamaForCausalLM,
                                     generation, gpt_config, llama_config)
from paddle_tpu_torch.nn import CrossEntropyLoss
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
from paddle_tpu_torch.observability import exporter, registry, tracing
from paddle_tpu_torch.framework import CompiledTrainStep
from paddle_tpu_torch import optimizer as optim
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.optimizer import lr as lrs
from paddle_tpu_torch.quantization import (KV_QUANT_DTYPES, dequantize_kv,
                                           kv_quant_params, quantize_kv_rows)
from paddle_tpu_torch.serving import (Engine, EngineShutdownError,
                                      PagedKVCache, ReplicaConfig,
                                      RouterConfig, SamplingParams,
                                      SchedulerStallError, ServingConfig,
                                      ServingFleet, SlotKVCache)
from paddle_tpu_torch.serving import stats as sstats
from paddle_tpu_torch.serving.compiled_tick import (CompiledServingTick,
                                                    TickFallbackWarning)
from paddle_tpu_torch.utils import flags as port_flags
from paddle_tpu_torch.utils import monitor

HBM_BYTES_PER_S = 3.35e12                   # H100 SXM data sheet
PEAK_OPS = {torch.bfloat16: 989e12, torch.float16: 989e12,
            torch.float32: 67e12}           # dense; fp32 outside tensor cores
PHASES = ("device", "build", "kernels", "serve", "serve-lora-int8",
          "serve-tick", "serve-spec", "serve-resilience", "serve-telemetry",
          "serve-fleet", "parity", "train", "train-parity",
          "train-compiled-parity", "train-gpt2", "gpt2-parity", "attn-ops",
          "train-optimizers", "serve-gpt", "gpt-parity", "generate-gpt",
          "train-gpt2-recompute", "fit-gpt2", "fit-llama", "sentinel-gpt2",
          "lora-llama", "train-hybrid", "train-zero", "train-pipe",
          "train-sep", "train-moe", "train-guard")
#: generate-gpt: the worst row error (relative to the row's norm) allowed
#: between the cached path's last-position logits and the full forward's
#: at GPT-3 6.7B in bf16.  Both paths round every activation to bf16 (a
#: relative step of 2^-8) and differ in where: the cached attention runs
#: over fp32 caches and rounds its output once, the flash kernel's p·V
#: sums in another order.  Each of the 2 L = 64 residual updates may then
#: round a value to the other side (at most 2^-8 of it), and these
#: independent flips add as a random walk: sqrt(64) * 2^-8 = 0.031.
GEN_ROW_TOL = 0.03125
TRAIN_KERNELS = ("rms_norm", "rms_norm_bwd", "rope", "flash_fwd",
                 "flash_bwd_dkv", "flash_bwd_dq", "flash_bwd_delta", "adam")
FLASH = ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")
DROPOUT_KERNELS = tuple(k + "_dropout" for k in FLASH)
MASKED_KERNELS = tuple(k + "_masked" for k in FLASH)
#: GPT-2 124M's training shape: B 8, 12 heads, S 1024, head dim 64
GPT2_SHAPE = dict(b=8, h=12, s=1024, d=64)


def gpt2_launches(layers, steps):
    """The launches ``steps`` training steps of a GPT-2 with ``layers``
    blocks and attention dropout need: each flash dropout kernel once a
    block a step, the Adam kernel once a parameter a step (12 a block,
    and wte, wpe and ln_f's weight and bias)."""
    return dict({k: layers * steps for k in DROPOUT_KERNELS},
                adam=(12 * layers + 4) * steps)

#: (source under paddle_tpu_torch/, the TPU kernel it replaces)
KERNEL_META = {
    "rms_norm": ("csrc/rms_norm.cu", "paddle_tpu/pallas/fused.py:92"),
    "paged_decode": ("csrc/paged_decode.cu",
                     "paddle_tpu/pallas/flash_attention.py:860"),
    "rms_norm_bwd": ("csrc/rms_norm.cu", "paddle_tpu/pallas/fused.py:112"),
    "rope": ("csrc/rope.cu", "paddle_tpu/pallas/fused.py:204"),
    "flash_fwd": ("csrc/flash_attention_fwd.cu",
                  "paddle_tpu/pallas/flash_attention.py:364"),
    "flash_bwd_dkv": ("csrc/flash_attention_bwd.cu",
                      "paddle_tpu/pallas/flash_attention.py:578"),
    "flash_bwd_dq": ("csrc/flash_attention_bwd.cu",
                     "paddle_tpu/pallas/flash_attention.py:608"),
    # the delta einsum of _pallas_flash_bwd, outside its two pallas_calls
    "flash_bwd_delta": ("csrc/flash_attention_bwd.cu",
                        "paddle_tpu/pallas/flash_attention.py:540"),
    "adam": ("csrc/adam.cu", "paddle_tpu/pallas/fused.py:320"),
    "paged_decode_int8": ("csrc/paged_decode.cu",
                          "paddle_tpu/pallas/flash_attention.py:860"),
    "paged_decode_fp8": ("csrc/paged_decode.cu",
                         "paddle_tpu/pallas/flash_attention.py:860"),
    "lora_delta": ("csrc/lora_delta.cu", "paddle_tpu/serving/adapters.py:105"),
    **{k + v: ("csrc/flash_attention_fwd.cu" if k == "flash_fwd" else
               "csrc/flash_attention_bwd.cu",
               "paddle_tpu/pallas/flash_attention.py:" + line)
       for k, line in zip(FLASH, ("364", "578", "608"))
       for v in ("_dropout", "_masked")},
}
#: the target projections of a Llama layer (the adapter pool wraps each)
LORA_TARGETS = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj",
                "up_proj", "down_proj")


def log(msg):
    print(msg, flush=True)


# ---------------------------------------------------------------- timing
class Timer:
    """Device time of one call: ``reps`` calls, each after a write of
    64 MB that flushes the 50 MB L2 (the serving path finds K/V cold),
    are captured in one CUDA graph and replayed between CUDA events, so
    no host launch time sits between them; the flushes' own time is
    subtracted.  The median of 5 replays, per call.  A call slower than
    1 ms is captured fewer times (at least 3), ~20 ms of work a graph."""

    def __init__(self, dev, reps=20):
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
        self.reps = reps
        self.flush_ms = self._replay_ms(lambda: None, reps) / reps

    def _replay_ms(self, fn, reps):
        for _ in range(3):                  # warm up outside the capture
            self.flush.zero_()
            fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                self.flush.zero_()
                fn()
        times = []
        for _ in range(5):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        del graph
        return float(np.median(times))

    def __call__(self, fn):
        fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        reps = max(3, min(self.reps, int(self.reps / max(
            start.elapsed_time(end), 1e-3))))
        return max(self._replay_ms(fn, reps) / reps - self.flush_ms, 0.0)


def bound(bytes_moved, ops, dtype):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a, b):
    return float((a.detach().float() - b.detach().float()).abs().max())


def row_err(got, want):
    """Largest relative error of a row (the last dim) against its own norm,
    ``|got_r - want_r| / max(|want_r|, 1e-2 x the RMS row norm)``.  Each
    tensor and each row is held to its own scale, so a wrong row of small
    values (the late positions of causal attention, whose gradients are
    ~1/sqrt(position) of the first) shows; the floor only covers rows whose
    exact value is ~0 (dQ of the first causal row)."""
    g = got.detach().float().reshape(-1, got.shape[-1])
    w = want.detach().float().reshape(-1, want.shape[-1])
    norm = w.norm(dim=-1)
    floor = max(1e-2 * float(norm.square().mean().sqrt()), 1e-30)
    return float(((g - w).norm(dim=-1) / norm.clamp_min(floor)).max())


#: per-row tolerances: fp32, sums of up to thousands of terms in another
#: order; 16-bit, one rounding of every output element (2^-9 relative)
#: and, in the flash backward, of p and dS for the tensor cores, with 2-5x
#: room
ROW_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2, torch.float16: 1e-2}


def check_rows(name, pairs, dtype):
    """Each ``(label, got, want)`` row by row within ROW_TOL (`row_err`);
    returns (the largest absolute error, the largest row error) over the
    pairs."""
    worst = 0.0
    for label, got, want in pairs:
        err = row_err(got, want)
        if err > ROW_TOL[dtype] or not torch.isfinite(got).all():
            raise AssertionError(f"{name} {label}: a row is {err:.3e} off "
                                 f"its own norm (tolerance "
                                 f"{ROW_TOL[dtype]:.0e})")
        worst = max(worst, err)
    return max(max_err(got, want) for _, got, want in pairs), worst


def expect_rejected(name, check):
    """A control: ``check`` runs a comparison on a deliberately wrong
    result and must raise; returns the message it raised with."""
    try:
        check()
    except AssertionError as e:
        log(f"[controls] {name}: rejected ({e})")
        return str(e)
    raise AssertionError(f"control {name}: a wrong result passed the check")


def late_half_off(t, seq_dim, by=1.03):
    """``t`` with the second half of its positions 3% off: the wrong
    result a kernel that slips in late causal rows would give."""
    t = t.clone()
    t.narrow(seq_dim, t.shape[seq_dim] // 2,
             t.shape[seq_dim] - t.shape[seq_dim] // 2).mul_(by)
    return t


def check_close(name, got, want, dtype):
    """fp32: rtol = atol = 2e-5.  bf16: compared in fp32 with atol 2e-2
    and rtol 1e-2 (one bf16 ulp is 2^-7 relative; the kernel and the
    plain version sum in different orders and may round a value to the
    neighbouring bf16)."""
    tol = dict(rtol=2e-5, atol=2e-5) if dtype == torch.float32 else \
        dict(rtol=1e-2, atol=2e-2)
    if not torch.allclose(got.float(), want.float(), **tol):
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version, max abs err {max_err(got, want)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite output")


# ---------------------------------------------------------------- phases
def phase_device():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; the port's smoke run needs "
                 "an NVIDIA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    log(card)
    log(f"[device] {name}, {torch.cuda.device_count()} card(s), torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return name, card


def ptxas_report(build_log, source):
    """(kernel, registers, spill store bytes, spill load bytes, stack
    frame bytes) of every kernel ``-Xptxas=-v`` reported for ``source``
    in the build log."""
    section = build_log.split(f"== {source}", 1)[-1].split("\n== ", 1)[0]
    rows, name, spill = [], None, (0, 0, 0)
    for line in section.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "spill stores" in line:
            nums = [int(w) for w in line.replace(",", " ").split()
                    if w.isdigit()]
            spill = (nums[1], nums[2], nums[0])
        elif "Used" in line and "registers" in line and name:
            regs = int(line.split("Used")[1].split()[0])
            rows.append((name, regs) + spill)
            name = None
    return rows


def phase_build():
    t0 = time.monotonic()
    path = _build.build()
    _build.library()
    log(f"[build] {path.name} built in {time.monotonic() - t0:.2f} s "
        f"(nvcc, sm_90a, sources {[p.name for p in _build.sources()]})")
    # the RMS-norm kernels keep a row, the next row and w (and dw's
    # partials) in registers, the paged-decode kernels q, the softmax
    # state and the next stage's K/V rows, the flash kernels their
    # accumulators and score tiles, the LoRA delta its partial sums: no
    # instantiation may spill
    for source in ("rms_norm.cu", "paged_decode.cu",
                   "flash_attention_fwd.cu", "flash_attention_bwd.cu",
                   "lora_delta.cu"):
        rows = ptxas_report(_build.build_log(), source)
        spilled = [r for r in rows if r[2] or r[3]]
        log(f"[build] {source}: {len(rows)} kernels, registers "
            f"{sorted({r[1] for r in rows})}, spill bytes "
            f"{sum(r[2] + r[3] for r in rows)}, largest stack frame "
            f"{max((r[4] for r in rows), default=0)} bytes")
        if source.startswith("flash_attention_"):
            wg = [r for r in rows if "wgmma" in r[0]]
            log(f"[build] {source} wgmma kernels (registers at launch, "
                f"spill bytes): " + ", ".join(
                    f"{r[0]} {r[1]} {r[2] + r[3]}" for r in wg))
            if not wg:
                raise AssertionError(f"{source}: the build log lists no "
                                     "wgmma kernel")
        if not rows or spilled:
            raise AssertionError(f"{source} kernels spill (or the build "
                                 f"log lists none): {spilled or rows}")


def misaligned_rows(dev, rows, n, dtype, gen):
    """[rows, n] random values, contiguous, one element past a 16-byte
    boundary (the generic path)."""
    flat = torch.randn(rows * n + 1, device=dev, generator=gen).to(dtype)
    return flat[1:].view(rows, n)


def rms_case(dev, rows, n, dtype, gen, timer=None, rstd=False,
             misaligned=False):
    """The forward against the plain version (y, and r with ``rstd``, as
    training calls it); timed with ``timer``."""
    x = misaligned_rows(dev, rows, n, dtype, gen) if misaligned else \
        torch.randn(rows, n, device=dev, generator=gen).to(dtype)
    w = (1.0 + 0.1 * torch.randn(n, device=dev, generator=gen)).to(dtype)
    eps = 1e-5
    y, r = rms_norm(x, w, eps, return_rstd=True)
    torch.cuda.synchronize()
    want, want_r = rms_norm_ref(x, w, eps, return_rstd=True)
    name = f"rms_norm[{rows}x{n} {dtype}{' misaligned' if misaligned else ''}]"
    check_close(name, y, want, dtype)
    check_close(name + " r", r, want_r, torch.float32)
    err = max_err(y, want)
    if timer is None:
        return err, None
    es = x.element_size()
    b_ms, b_by = bound(2 * rows * n * es + n * w.element_size()
                       + (4 * rows if rstd else 0), 4 * rows * n, dtype)
    res = dict(ms=timer(lambda: rms_norm(x, w, eps, return_rstd=rstd)),
               plain_ms=timer(lambda: rms_norm_ref(x, w, eps)),
               library_ms=timer(lambda: torch.nn.functional.rms_norm(
                   x, (n,), w, eps)),
               bound_ms=b_ms, bound_by=b_by)
    return err, res


def rms_plan_str(p):
    path = {rn.REG: "registers", rn.STAGED: "staged", rn.GENERIC: "generic"}
    return (f"{path[p.path]}, {p.blocks} blocks x {p.threads} threads, "
            f"{p.rows_per_block} rows a block"
            + (f", {p.ept} elements a thread" if p.path == rn.REG else "")
            + (f", {p.stages} rows staged" if p.path == rn.STAGED else ""))


def last_split_off(offsets, split):
    """The offsets with each row's last live split masked off, where the
    row has more than one: what a merge that dropped that split sees."""
    return [o - o % split - 1 if o >= split else o for o in offsets]


def paged_case(dev, b, h, h_kv, d, psz, n_pages, offsets, dtype, gen,
               free_row=None, timer=None, controls=False):
    """Pools of b * n_pages + 1 pages, a random page table; ``free_row``
    gets an all-zero table at offset 0 (a free slot on scratch page 0).
    The control: the plain version without each row's last live split."""
    pool_pages = 1 + b * n_pages
    k_pool = torch.randn(pool_pages, psz, h_kv, d, device=dev,
                         generator=gen).to(dtype)
    v_pool = torch.randn(pool_pages, psz, h_kv, d, device=dev,
                         generator=gen).to(dtype)
    q = torch.randn(b, h, d, device=dev, generator=gen).to(dtype)
    perm = torch.randperm(pool_pages - 1, device=dev, generator=gen) + 1
    table = perm.reshape(b, n_pages).to(torch.int32)
    off = torch.tensor(offsets, dtype=torch.int32, device=dev)
    if free_row is not None:
        table[free_row] = 0
    out = paged_decode_attention(q, k_pool, v_pool, table, off)
    torch.cuda.synchronize()
    want = paged_decode_ref(q, k_pool, v_pool, table, off)
    name = (f"paged_decode[B={b} H={h} Hkv={h_kv} D={d} psz={psz} "
            f"off={list(offsets)} {dtype}]")
    check_close(name, out, want, dtype)
    err = max_err(out, want)
    if controls:
        split = split_plan(b, h, h_kv, psz, n_pages, dev)[0]
        wrong = paged_decode_ref(q, k_pool, v_pool, table, torch.tensor(
            last_split_off(offsets, split), dtype=torch.int32, device=dev))
        expect_rejected(f"{name} last live split of {split} tokens dropped",
                        lambda: check_close(name, out, wrong, dtype))
    if timer is None:
        return err, None
    es = k_pool.element_size()
    tokens = sum(o + 1 for o in offsets)
    live_pages = sum(o // psz + 1 for o in offsets)
    bytes_moved = (2 * b * h * d * q.element_size()          # q, out
                   + 2 * tokens * h_kv * d * es                # K, V
                   + 4 * live_pages + 4 * b)                   # table, offsets
    b_ms, b_by = bound(bytes_moved, 4 * h * d * tokens, dtype)
    # the library yardstick: SDPA over the cache gathered beforehand
    # (gather not timed), heads expanded for GQA, a boolean mask per row
    s = n_pages * psz
    kg = k_pool[table.long()].reshape(b, s, h_kv, d).transpose(1, 2)
    vg = v_pool[table.long()].reshape(b, s, h_kv, d).transpose(1, 2)
    kg = kg.repeat_interleave(h // h_kv, dim=1).contiguous()
    vg = vg.repeat_interleave(h // h_kv, dim=1).contiguous()
    mask = (torch.arange(s, device=dev)[None, :] <= off.long()[:, None]) \
        [:, None, None, :]
    q4 = q[:, :, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    res = dict(ms=timer(lambda: paged_decode_attention(q, k_pool, v_pool,
                                                       table, off)),
               plain_ms=timer(lambda: paged_decode_ref(q, k_pool, v_pool,
                                                       table, off)),
               library_ms=timer(lambda: sdpa(q4, kg, vg, attn_mask=mask)),
               bound_ms=b_ms, bound_by=b_by)
    return err, res


def rms_bwd_case(dev, rows, n, dtype, gen, timer=None, misaligned=False):
    """The backward against the plain version, dx and dw row by row, and
    dw bit-identical over two calls; timed with ``timer``, then also its
    two launches apart, with two controls."""
    x = misaligned_rows(dev, rows, n, dtype, gen) if misaligned else \
        torch.randn(rows, n, device=dev, generator=gen).to(dtype)
    w = (1.0 + 0.1 * torch.randn(n, device=dev, generator=gen)).to(dtype)
    g = torch.randn(rows, n, device=dev, generator=gen).to(dtype)
    eps = 1e-5
    _, r = rms_norm(x, w, eps, return_rstd=True)
    (dx, dw) = rms_norm_bwd(x, w, r, g)
    _, dw_again = rms_norm_bwd(x, w, r, g)
    torch.cuda.synchronize()
    want_dx, want_dw = rms_norm_bwd_ref(x, w, r, g)
    name = f"rms_norm_bwd[{rows}x{n} {dtype}{' misaligned' if misaligned else ''}]"
    err, rel = check_rows(name, [("dx", dx, want_dx), ("dw", dw, want_dw)],
                          dtype)
    if not torch.equal(dw, dw_again):
        raise AssertionError(f"{name}: dw differs between two calls")
    p = rn.bwd_plan(x, w, g, dx)
    log(f"[kernels] {name}: worst row {rel:.2e} of its norm; dw "
        f"bit-identical over two calls; plan {rms_plan_str(p)}")
    if timer is None:
        return err, None
    # controls: dx without its mean term, r (g w), in the plain version's
    # arithmetic; dw summed from the kernel's own partials with one
    # block's left out
    no_mean = (r[:, None] * g.float() * w.float()).to(dtype)
    expect_rejected(f"{name} dx without the mean term", lambda: check_rows(
        name, [("dx", no_mean, want_dx)], dtype))
    del no_mean
    ws = torch.empty(p.ws_rows, n, dtype=torch.float32, device=dev)
    dx_part, dw_part = torch.empty_like(dx), torch.empty_like(dw)
    rn.launch_bwd_rows(x, w, r, g, dx_part, ws, p)
    k = p.blocks // 2
    short = torch.cat([ws[:k], ws[k + 1:]]).sum(dim=0).to(w.dtype)
    expect_rejected(
        f"{name} dw without block {k}'s partial ({p.rows_per_block} rows)",
        lambda: check_rows(name, [("dw", short, want_dw)], dtype))
    del short
    rows_ms = timer(lambda: rn.launch_bwd_rows(x, w, r, g, dx_part, ws, p))
    dw_ms = timer(lambda: rn.launch_dw_sum(ws, dw_part))
    log(f"[kernels] {name} its two launches apart: dx and dw's partials "
        f"{rows_ms:.4f} ms, dw's column sum over {p.ws_rows} partial rows "
        f"{dw_ms:.4f} ms (workspace read after the L2 flush)")
    es, ws = x.element_size(), w.element_size()
    b_ms, b_by = bound(3 * rows * n * es + 4 * rows + 2 * n * ws,
                       10 * rows * n, dtype)
    # the library yardstick: autograd of F.rms_norm, its forward and
    # backward captured together, less its forward alone
    xg, wg = x.clone().requires_grad_(True), w.clone().requires_grad_(True)

    def lib_fwd_bwd():
        y = torch.nn.functional.rms_norm(xg, (n,), wg, eps)
        torch.autograd.grad(y, (xg, wg), g)
    lib_fwd = timer(lambda: torch.nn.functional.rms_norm(x, (n,), w, eps))
    res = dict(ms=timer(lambda: rms_norm_bwd(x, w, r, g)),
               plain_ms=timer(lambda: rms_norm_bwd_ref(x, w, r, g)),
               library_ms=timer(lib_fwd_bwd) - lib_fwd,
               bound_ms=b_ms, bound_by=b_by)
    return err, res


def rope_case(dev, b, s, h, d, neox, dtype, gen, timer=None):
    """Forward and backward (inverse) against the plain version: the same
    fp32 products and sums, each rounded on its own, so they must be
    equal; the time is the forward's."""
    t = torch.randn(b, s, h, d, device=dev, generator=gen).to(dtype)
    inv = 1.0 / (10000.0 ** (torch.arange(0, d, 2, device=dev).float() / d))
    freqs = torch.outer(torch.arange(s, device=dev).float(), inv)
    emb = torch.cat([freqs, freqs], dim=-1)
    cos, sin = emb.cos(), emb.sin()
    err = 0.0
    for inverse in (False, True):
        got = rope(t, cos, sin, neox, inverse)
        torch.cuda.synchronize()
        want = rope_ref(t, cos, sin, neox, inverse)
        if not torch.equal(got, want):
            raise AssertionError(f"rope[{b}x{s}x{h}x{d} neox={neox} "
                                 f"inverse={inverse} {dtype}]: differs from"
                                 f" the plain version by {max_err(got, want)}")
        err = max(err, max_err(got, want))
    if timer is None:
        return err, None
    b_ms, b_by = bound(2 * t.numel() * t.element_size() + 2 * s * d * 4,
                       6 * t.numel(), dtype)
    res = dict(ms=timer(lambda: rope(t, cos, sin, neox)),
               plain_ms=timer(lambda: rope_ref(t, cos, sin, neox)),
               library_ms=None, bound_ms=b_ms, bound_by=b_by)
    return err, res


def flash_case(dev, b, h, h_kv, s, d, causal, dtype, gen, timer=None,
               controls=False):
    """Head-major, as Llama calls it.  The forward (out, lse) against its
    plain version and the dK/dV and dQ kernels each against theirs on the
    same inputs (the kernel's out and lse, the same delta): out and every
    gradient row by row (`check_rows`), lse 2e-5 (fp32) or 1e-3 (16-bit:
    fp32 sums of up to S exponentials in another order).  The whole
    backward (`flash_attention_bwd`: the delta pass, then both kernels)
    must give the two kernels' tensors bit for bit; the delta pass is held
    against `_delta` (`check_delta`); the plain backward against autograd
    is a CPU test (tests/test_torch_train_kernels.py).  Returns ({kernel:
    max abs err}, {kernel or "flash_bwd": timings} or None)."""
    def mk(heads):
        return torch.randn(b, heads, s, d, device=dev, generator=gen).to(dtype)
    q, k, v, do = mk(h), mk(h_kv), mk(h_kv), mk(h)
    name = f"flash[B{b} H{h}/{h_kv} S{s} D{d} causal={causal} {dtype}]"
    out, lse = fa.flash_attention_fwd(q, k, v, causal, None, True)
    torch.cuda.synchronize()
    out_ref, lse_ref = fa.flash_attention_ref(q, k, v, causal, None, True)
    errs, rels = {}, {}
    errs["flash_fwd"], rels["out"] = check_rows(name, [("out", out, out_ref)],
                                                dtype)
    tol = 2e-5 if dtype == torch.float32 else 1e-3
    if not torch.allclose(lse, lse_ref, rtol=tol, atol=tol):
        raise AssertionError(f"{name}: lse max abs err "
                             f"{max_err(lse, lse_ref)}")
    errs["flash_fwd"] = max(errs["flash_fwd"], max_err(lse, lse_ref))
    delta = fa.flash_bwd_delta(out, do, True)
    errs["flash_bwd_delta"] = check_delta(name, delta, out, do)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal, None, True)
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, causal, None, True)
    torch.cuda.synchronize()
    want_k, want_v = fa.flash_bwd_dkv_ref(q, k, v, do, lse, delta, causal,
                                          None, True)
    errs["flash_bwd_dkv"], rels["dK/dV"] = check_rows(
        name, [("dk", dk, want_k), ("dv", dv, want_v)], dtype)
    want_q = fa.flash_bwd_dq_ref(q, k, v, do, lse, delta, causal, None, True)
    errs["flash_bwd_dq"], rels["dQ"] = check_rows(
        name, [("dq", dq, want_q)], dtype)
    log(f"[kernels] {name}: worst row of its norm " + ", ".join(
        f"{k} {v:.2e}" for k, v in rels.items()))
    grads = fa.flash_attention_bwd(q, k, v, out, lse, do, causal, None, True)
    if not all(torch.equal(a, b) for a, b in zip(grads, (dq, dk, dv))):
        raise AssertionError(f"{name}: flash_attention_bwd differs from its "
                             "two kernels called alone")
    if controls:
        for label, got, want in (("out", out, out_ref), ("dq", dq, want_q),
                                 ("dk", dk, want_k), ("dv", dv, want_v)):
            expect_rejected(f"{name} {label} 3% off in its late half",
                            lambda label=label, got=got, want=want:
                            check_rows(name, [(label, late_half_off(got, 2),
                                               want)], dtype))
    del out_ref, lse_ref, grads, want_k, want_v, want_q
    if timer is None:
        return errs, None
    es = q.element_size()
    el_q, el_kv = b * h * s * d * es, b * h_kv * s * d * es
    rows = 4 * b * h * s                   # one fp32 value a row (lse, delta)
    prod = 2 * b * h * s * s * d * (0.5 if causal else 1.0)   # one product
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gqa = h != h_kv
    timed = {}
    # forward: reads q, k, v, writes out and lse; products q k^T and p v
    b_ms, b_by = bound(2 * el_q + 2 * el_kv + rows, 2 * prod, dtype)
    timed["flash_fwd"] = dict(
        ms=timer(lambda: fa.flash_attention_fwd(q, k, v, causal, None, True)),
        plain_ms=timer(lambda: fa.flash_attention_ref(q, k, v, causal, None,
                                                      True)),
        library_ms=timer(lambda: sdpa(q, k, v, is_causal=causal,
                                      enable_gqa=gqa)),
        bound_ms=b_ms, bound_by=b_by)
    # dK/dV: reads q, k, v, dO, lse, delta, writes dk, dv; products s, dp,
    # dv, dk.  dQ: the same reads, writes dq; products s, dp, dq.  Neither
    # has a PyTorch call of its own (SDPA's backward computes all three)
    for kname, fn, ref, n_prod, out_b in (
            ("flash_bwd_dkv", fa.flash_bwd_dkv, fa.flash_bwd_dkv_ref, 4,
             2 * el_kv),
            ("flash_bwd_dq", fa.flash_bwd_dq, fa.flash_bwd_dq_ref, 3, el_q)):
        b_ms, b_by = bound(2 * el_q + 2 * el_kv + 2 * rows + out_b,
                           n_prod * prod, dtype)
        timed[kname] = dict(
            ms=timer(lambda fn=fn: fn(q, k, v, do, lse, delta, causal, None,
                                      True)),
            plain_ms=timer(lambda ref=ref: ref(q, k, v, do, lse, delta,
                                               causal, None, True)),
            library_ms=None, bound_ms=b_ms, bound_by=b_by)
    # the delta pass: reads out and dO, writes one fp32 value a row; one
    # multiply-add an element (fp32, outside the tensor cores)
    b_ms, b_by = bound(2 * el_q + rows, 2 * b * h * s * d, torch.float32)
    timed["flash_bwd_delta"] = dict(
        ms=timer(lambda: fa.flash_bwd_delta(out, do, True)),
        plain_ms=timer(lambda: fa._delta(out, do, True)),
        library_ms=None, bound_ms=b_ms, bound_by=b_by)
    # the whole backward (delta + both kernels) beside SDPA's backward
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))

    def lib_fwd_bwd():
        o = sdpa(qg, kg, vg, is_causal=causal, enable_gqa=gqa)
        torch.autograd.grad(o, (qg, kg, vg), do)
    b_ms, b_by = bound(4 * el_q + 4 * el_kv + rows, 5 * prod, dtype)
    timed["flash_bwd"] = dict(
        ms=timer(lambda: fa.flash_attention_bwd(q, k, v, out, lse, do,
                                                causal, None, True)),
        plain_ms=timer(lambda: fa.flash_attention_bwd_ref(
            q, k, v, out, lse, do, causal, None, True)),
        library_ms=timer(lib_fwd_bwd) - timed["flash_fwd"]["library_ms"],
        bound_ms=b_ms, bound_by=b_by)
    return errs, timed


def check_delta(name, got, out, dout):
    """The delta pass against `_delta` (fp32 sums of D products in another
    order): each value within 2e-5 of the sum of its terms' magnitudes (2
    (D - 1) fp32 roundings, both ways, with room).  Returns the max abs
    err."""
    want = fa._delta(out, dout, True)
    mag = fa._delta(out.abs(), dout.abs(), True)
    err = (got - want).abs()
    if not bool((err <= 2e-5 * mag + 1e-30).all()) \
            or not torch.isfinite(got).all():
        raise AssertionError(f"{name}: delta pass off by "
                             f"{float((err / mag.clamp_min(1e-30)).max()):.3e}"
                             " of its terms' magnitudes (tolerance 2e-5)")
    return float(err.max())


FEATURE_SEED = 20261016
DEAD_ROW = 3          # the fully masked q row of the last batch


def padding_keep(dev, b, s):
    """A boolean key-padding mask ``[B, 1, S, S]``: batch i keeps its first
    S - 64 i keys, and q row `DEAD_ROW` of the last batch keeps none."""
    keep = torch.ones(b, 1, s, s, dtype=torch.bool, device=dev)
    for i in range(b):
        keep[i, :, :, s - 64 * i:] = i == 0
    keep[b - 1, 0, DEAD_ROW] = False
    return keep


def packed_segments(dev, b, s):
    """int32 segment ids ``[B, S]``: four packed documents a row, their
    borders shifted by 16 tokens a row."""
    pos = torch.arange(s, device=dev)
    return torch.stack([((pos + 16 * i) * 4 // s).clamp_max(3)
                        for i in range(b)]).to(torch.int32)


def feature_inputs(dev, kind, b, h, s, gen):
    """The features of a case and the boolean or additive mask that gives
    SDPA the same function: (kernel features, SDPA's attn_mask or None
    for ``is_causal``, SDPA's dropout_p, a fully masked (batch, row) or
    None).  ``dropout``: 0.1.  ``bias``: an additive N(0, 1) bf16
    ``[B, 1, S, S]``.  ``padding``: `padding_keep`.  ``segments``:
    `packed_segments`."""
    causal = torch.ones(s, s, dtype=torch.bool, device=dev).tril()
    feats = dict(mask=None, segment_ids=None, dropout=0.0,
                 seed=FEATURE_SEED)
    lib_mask, lib_p, dead = None, 0.0, None
    if kind == "dropout":
        feats["dropout"] = lib_p = 0.1
    elif kind == "bias":
        bias = torch.randn(b, 1, s, s, device=dev, generator=gen).bfloat16()
        feats["mask"] = fa.additive_mask(bias)
        lib_mask = bias.masked_fill(~causal, float("-inf"))
    elif kind == "padding":
        keep = padding_keep(dev, b, s)
        dead = (b - 1, DEAD_ROW)
        feats["mask"] = fa.additive_mask(keep)
        lib_mask = keep & causal
    elif kind == "segments":
        seg = packed_segments(dev, b, s)
        feats["segment_ids"] = seg
        lib_mask = (seg[:, None, :, None] == seg[:, None, None, :]) & causal
    return feats, lib_mask, lib_p, dead


def feature_case(dev, kind, b, h, s, d, dtype, gen, timer, controls=False):
    """A feature variant of the three flash kernels at one shape, causal
    and head-major as GPT calls them: the forward (out, lse) and the dK/dV
    and dQ kernels against their plain versions with the same features
    and seed, row by row as `flash_case`; a fully masked row must give
    out 0 and dq 0.  Controls: the forward's out 3% off in its late half
    (every variant); with ``controls``, the plain version at seed + 1,
    the plain version with the hash keyed by the head alone (not b * H +
    h), and with the mask read one row off must be rejected.
    Returns ({variant: max abs err}, {variant or "flash_bwd": timings},
    the plain keep share or None)."""
    def mk():
        return torch.randn(b, h, s, d, device=dev, generator=gen).to(dtype)
    q, k, v, do = mk(), mk(), mk(), mk()
    feats, lib_mask, lib_p, dead = feature_inputs(dev, kind, b, h, s, gen)
    variant = "_dropout" if kind == "dropout" else "_masked"
    name = f"flash {kind}[B{b} H{h} S{s} D{d} causal {dtype}]"
    out, lse = fa.flash_attention_fwd(q, k, v, True, None, True, **feats)
    torch.cuda.synchronize()
    out_ref, lse_ref = fa.flash_attention_ref(q, k, v, True, None, True,
                                              **feats)
    errs, rels = {}, {}
    errs["flash_fwd" + variant], rels["out"] = check_rows(
        name, [("out", out, out_ref)], dtype)
    if not torch.allclose(lse, lse_ref, rtol=1e-3, atol=1e-3):
        raise AssertionError(f"{name}: lse max abs err "
                             f"{max_err(lse, lse_ref)}")
    delta = (do.float() * out.float()).sum(-1).contiguous()
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, True, None, True,
                              **feats)
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, True, None, True, **feats)
    torch.cuda.synchronize()
    want_k, want_v = fa.flash_bwd_dkv_ref(q, k, v, do, lse, delta, True,
                                          None, True, **feats)
    errs["flash_bwd_dkv" + variant], rels["dK/dV"] = check_rows(
        name, [("dk", dk, want_k), ("dv", dv, want_v)], dtype)
    want_q = fa.flash_bwd_dq_ref(q, k, v, do, lse, delta, True, None, True,
                                 **feats)
    errs["flash_bwd_dq" + variant], rels["dQ"] = check_rows(
        name, [("dq", dq, want_q)], dtype)
    del want_k, want_v, want_q
    if dead is not None:
        bi, row = dead
        if out[bi, :, row].any() or dq[bi, :, row].any():
            raise AssertionError(f"{name}: the fully masked row is not 0")
    log(f"[kernels] {name}: worst row of its norm " + ", ".join(
        f"{k_} {v_:.2e}" for k_, v_ in rels.items()))
    # every variant: a forward that slips in late causal rows is rejected
    expect_rejected(f"{name} out 3% off in its late half",
                    lambda: check_rows(name, [("out", late_half_off(out, 2),
                                               out_ref)], dtype))
    share = None
    if feats["dropout"]:
        share = float(fa._keep(FEATURE_SEED, 0.1, b, h, s, dev).float()
                      .mean())
        if abs(share - 0.9) > 1e-3:
            raise AssertionError(f"{name}: keep share {share}")
    if controls and feats["dropout"]:
        wrong, _ = fa.flash_attention_ref(
            q, k, v, True, None, True, **dict(feats, seed=FEATURE_SEED + 1))
        expect_rejected(f"{name} out against the plain version at seed + 1",
                        lambda: check_rows(name, [("out", out, wrong)],
                                           dtype))
        keep_of = fa._keep

        def head_only(seed, p, b_, h_, s_, device, offsets=None):
            return keep_of(seed, p, 1, h_, s_, device).expand(b_, h_, s_, s_)
        fa._keep = head_only
        try:
            wrong, _ = fa.flash_attention_ref(q, k, v, True, None, True,
                                              **feats)
        finally:
            fa._keep = keep_of
        expect_rejected(f"{name} out against the hash keyed by the head "
                        "alone", lambda: check_rows(
                            name, [("out", out, wrong)], dtype))
        del wrong
    if controls and feats["mask"] is not None:
        wrong, _ = fa.flash_attention_ref(
            q, k, v, True, None, True,
            **dict(feats, mask=feats["mask"].roll(1, dims=2)))
        expect_rejected(f"{name} out against the mask read one row off",
                        lambda: check_rows(name, [("out", out, wrong)],
                                           dtype))
        del wrong
    es = q.element_size()
    el = b * h * s * d * es
    rows = 4 * b * h * s
    # one product's flops over the scores this run's data leaves live
    # (causal, not masked out, within one segment): work on the others
    # could be skipped, so the bound does not count it
    live = torch.ones(s, s, dtype=torch.bool, device=dev).tril()
    if feats["mask"] is not None:
        live = live & (feats["mask"] > fa.NEG_INF / 2)
    if feats["segment_ids"] is not None:
        seg = feats["segment_ids"]
        live = live & (seg[:, None, :, None] == seg[:, None, None, :])
    prod = 2 * d * float(live.expand(b, h, s, s).sum())
    del live
    feat_b = 0
    if feats["mask"] is not None:                 # the causal half is read
        feat_b += feats["mask"].numel() * 4 * 0.5
    if feats["segment_ids"] is not None:
        feat_b += b * s * 4
    sdpa = torch.nn.functional.scaled_dot_product_attention
    timed = {}
    b_ms, b_by = bound(4 * el + rows + feat_b, 2 * prod, dtype)
    timed["flash_fwd" + variant] = dict(
        ms=timer(lambda: fa.flash_attention_fwd(q, k, v, True, None, True,
                                                **feats)),
        plain_ms=timer(lambda: fa.flash_attention_ref(q, k, v, True, None,
                                                      True, **feats)),
        library_ms=timer(lambda: sdpa(q, k, v, attn_mask=lib_mask,
                                      dropout_p=lib_p,
                                      is_causal=lib_mask is None)),
        bound_ms=b_ms, bound_by=b_by)
    for kname, fn, ref, n_prod, out_b in (
            ("flash_bwd_dkv", fa.flash_bwd_dkv, fa.flash_bwd_dkv_ref, 4,
             2 * el),
            ("flash_bwd_dq", fa.flash_bwd_dq, fa.flash_bwd_dq_ref, 3, el)):
        b_ms, b_by = bound(4 * el + 2 * rows + feat_b + out_b,
                           n_prod * prod, dtype)
        timed[kname + variant] = dict(
            ms=timer(lambda fn=fn: fn(q, k, v, do, lse, delta, True, None,
                                      True, **feats)),
            plain_ms=timer(lambda ref=ref: ref(q, k, v, do, lse, delta, True,
                                               None, True, **feats)),
            library_ms=None, bound_ms=b_ms, bound_by=b_by)
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))

    def lib_fwd_bwd():
        o = sdpa(qg, kg, vg, attn_mask=lib_mask, dropout_p=lib_p,
                 is_causal=lib_mask is None)
        torch.autograd.grad(o, (qg, kg, vg), do)
    b_ms, b_by = bound(8 * el + rows + feat_b, 5 * prod, dtype)
    timed["flash_bwd"] = dict(
        ms=timer(lambda: fa.flash_attention_bwd(q, k, v, out, lse, do, True,
                                                None, True, **feats)),
        plain_ms=timer(lambda: fa.flash_attention_bwd_ref(
            q, k, v, out, lse, do, True, None, True, **feats)),
        library_ms=timer(lib_fwd_bwd)
        - timed["flash_fwd" + variant]["library_ms"],
        bound_ms=b_ms, bound_by=b_by)
    return errs, timed, share


def seed_case(dev, b, h, s, d, gen):
    """The flash kernels' seed from device memory: each dropout variant's
    forward, dK/dV and dQ (dropout 0.1 alone, and with a key-padding mask)
    called with a host int seed and with the same seed in a 0-dim int64
    tensor on the card (2^31 + 7: the kernels read its low 32 bits) must
    be equal bit for bit.  Control: the device seed + 1 must give another
    forward."""
    def mk():
        return torch.randn(b, h, s, d, device=dev, generator=gen).bfloat16()
    q, k, v, do = mk(), mk(), mk(), mk()
    seed = 2 ** 31 + 7
    on_card = torch.full((), seed, dtype=torch.int64, device=dev)
    for kind, mask in (("dropout", None),
                       ("dropout + padding", fa.additive_mask(
                           padding_keep(dev, b, s)))):
        feats = dict(mask=mask, dropout=0.1)

        def calls(sd):
            out, lse = fa.flash_attention_fwd(q, k, v, True, None, True,
                                              seed=sd, **feats)
            delta = (do.float() * out.float()).sum(-1).contiguous()
            dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, True, None,
                                      True, seed=sd, **feats)
            dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, True, None, True,
                                 seed=sd, **feats)
            return {"out": out, "lse": lse, "dk": dk, "dv": dv, "dq": dq}
        host = calls(seed)
        name = f"flash seed on the card [{kind}, B{b} H{h} S{s} D{d}]"

        def same(got, label):
            for part, t in got.items():
                if not torch.equal(t, host[part]):
                    raise AssertionError(f"{name} {label} {part}: differs "
                                         f"from the host seed's by "
                                         f"{max_err(t, host[part])}")
        same(calls(on_card), "device int64")
        other = calls(on_card + 1)
        expect_rejected(f"{name}: the device seed + 1",
                        lambda: same(other, "seed + 1"))
        log(f"[kernels] {name}: fwd, dK/dV, dQ equal bit for bit with the "
            f"seed as a host int and as a device int64")


def offsets_case(dev, b, h, s, d, gen, dp=2, mp=2):
    """The flash kernels' dropout hash on global indices (the offsets of
    a dp x mp rank's part) at GPT-2's shape, bf16, dropout 0.1: offsets
    ``(0, 0, H)`` give the bits of none (fwd out and lse, dK, dV, dQ);
    each of the dp x mp parts (its rows and heads, offsets ``(rows before
    it, heads before it, H)``) equals its slice of the global call bit for
    bit, fwd and backward; one part against the plain versions with its
    offsets, row by row.  Controls: a part with the local index (no
    offsets) must differ from its slice of the global call, and the plain
    version with the offsets shifted by a row must be rejected."""
    def mk():
        return torch.randn(b, h, s, d, device=dev, generator=gen).bfloat16()
    q, k, v, do = mk(), mk(), mk(), mk()
    feats = dict(dropout=0.1, seed=987)

    def run(q, k, v, do, **kw):
        out, lse = fa.flash_attention_fwd(q, k, v, True, None, True,
                                          **feats, **kw)
        dq, dk, dv = fa.flash_attention_bwd(q, k, v, out, lse, do, True,
                                            None, True, **feats, **kw)
        return dict(out=out, lse=lse, dq=dq, dk=dk, dv=dv)
    whole = run(q, k, v, do)
    zero = run(q, k, v, do, offsets=(0, 0, h))
    for part, t in zero.items():
        if not torch.equal(t, whole[part]):
            raise AssertionError(f"flash offsets (0, 0, {h}): {part} "
                                 f"differs from no offsets")
    rb, hb = b // dp, h // mp
    name = f"flash dropout offsets [B{b} H{h} S{s} D{d}, dp {dp} x mp {mp}]"

    def slices(r, m, got):
        for part, t in got.items():
            want = whole[part][r * rb:(r + 1) * rb, m * hb:(m + 1) * hb]
            if not torch.equal(t, want):
                raise AssertionError(f"{name} part ({r}, {m}) {part}: "
                                     f"differs from the global call's slice")
    for r in range(dp):
        for m in range(mp):
            part = [t[r * rb:(r + 1) * rb, m * hb:(m + 1) * hb]
                    for t in (q, k, v, do)]
            slices(r, m, run(*part, offsets=(r * rb, m * hb, h)))
    part = [t[rb:, hb:] for t in (q, k, v, do)]
    off = (rb, hb, h)
    got = run(*part, offsets=off)
    ref_out, ref_lse = fa.flash_attention_ref(*part[:3], True, None, True,
                                              **feats, offsets=off)
    ref_grads = fa.flash_attention_bwd_ref(*part[:3], got["out"],
                                           got["lse"], part[3], True, None,
                                           True, **feats, offsets=off)
    err, row = check_rows(name, [("out", got["out"], ref_out)] + [
        (n, got[n], w) for n, w in zip(("dq", "dk", "dv"), ref_grads)],
        torch.bfloat16)
    expect_rejected(f"{name}: a part with the local index", lambda: slices(
        1, 1, run(*part)))
    wrong, _ = fa.flash_attention_ref(*part[:3], True, None, True, **feats,
                                      offsets=(rb + 1, hb, h))
    expect_rejected(f"{name}: the plain version a row off", lambda:
                    check_rows(name, [("out", got["out"], wrong)],
                               torch.bfloat16))
    log(f"[kernels] {name}: offsets (0, 0, {h}) = none bit for bit; the "
        f"{dp * mp} parts = their slices of the global call bit for bit "
        f"(fwd, dK, dV, dQ); part (1, 1) against the plain versions: max "
        f"abs err {err:.3e}, worst row {row:.3e}")


def adam_case(dev, n, p_dtype, master, decoupled, wd, gen, timer=None,
              offset=0):
    """One parameter's update, kernel against plain version on copies of
    the same state: w, m1, m2 and the parameter must be equal bit for bit
    (the same fp32 ops, each rounded on its own).  ``offset`` places every
    tensor that many elements off an aligned address (the kernel of one
    element per thread).  The scalars ``[lr, 1 - b1^3, 1 - b2^3]`` are
    made on the card from a device step counter (`adam_scalars`, the
    optimizer's own computation) and read there by both versions.  Then
    the skip flag: set, neither version may change anything; clear, the
    update equals the flagless one.  Control: the kernel's result against
    the plain version at the fourth step's scalars must be rejected."""
    def placed(t):
        buf = torch.empty(t.numel() + offset, device=dev, dtype=t.dtype)
        return buf[offset:].copy_(t)
    w = torch.randn(n, device=dev, generator=gen)
    m1 = 1e-2 * torch.randn(n, device=dev, generator=gen)
    m2 = 1e-4 * torch.rand(n, device=dev, generator=gen)
    g = (1e-2 * torch.randn(n, device=dev, generator=gen)).to(p_dtype)
    lr_t = torch.full((), 3e-4, dtype=torch.float32, device=dev)
    step_t = torch.full((), 3.0, dtype=torch.float32, device=dev)
    hyper = dict(scal=adam_scalars(lr_t, step_t, 0.9, 0.999), b1=0.9,
                 b2=0.999, eps=1e-8, wd=wd, decoupled=decoupled)

    def state():
        p = placed(w.to(p_dtype)) if master else None
        return placed(w), g, placed(m1), placed(m2), p
    got, want = state(), state()
    adam_update(*got, **hyper)
    torch.cuda.synchronize()
    adam_update_ref(*want, **hyper)
    name = (f"adam[n={n} {p_dtype}{' + fp32 master' if master else ''} "
            f"{'AdamW' if decoupled else 'Adam'} wd={wd} offset={offset}]")
    def same(label, xs, ys):
        for part, a, b in zip(("w", "g", "m1", "m2", "p"), xs, ys):
            if a is not None and not torch.equal(a, b):
                raise AssertionError(f"{name} {label} {part}: differs by "
                                     f"{max_err(a, b)}")
    same("kernel against the plain version", got, want)
    other = state()
    adam_update_ref(*other, **dict(hyper, scal=adam_scalars(
        lr_t, step_t + 1.0, 0.9, 0.999)))
    expect_rejected(f"{name} against the fourth step's scalars",
                    lambda: same("kernel against the fourth step", got,
                                 other))
    del other
    for flag in (True, False):
        skip = torch.full((), flag, dtype=torch.bool, device=dev)
        for fn in (adam_update, adam_update_ref):
            before, after = state(), state()
            fn(*after, **hyper, skip=skip)
            if flag:
                same(f"{fn.__name__} with the skip flag set", after, before)
            else:
                same(f"{fn.__name__} with the skip flag clear", after, got)
    log(f"[kernels] {name}: device scalars, bit for bit; skip flag set: "
        f"nothing written (kernel and plain version)")
    if timer is None:
        return 0.0, None
    es = g.element_size()
    b_ms, b_by = bound(24 * n + es * n + (es * n if master else 0), 15 * n,
                       torch.float32)
    # the library yardstick: torch._fused_adamw_ (AdamW(fused=True)'s
    # kernel) on the fp32 master and moments with an fp32 gradient; it
    # writes no 16-bit parameter
    lib = [[placed(w)], [g.float()], [placed(m1)], [placed(m2)], [],
           [torch.tensor(3.0, device=dev)]]

    def fused_adamw():
        torch._fused_adamw_(*lib, lr=3e-4, beta1=hyper["b1"],
                            beta2=hyper["b2"], weight_decay=wd,
                            eps=hyper["eps"], amsgrad=False, maximize=False)
    res = dict(ms=timer(lambda: adam_update(*got, **hyper)),
               plain_ms=timer(lambda: adam_update_ref(*want, **hyper)),
               library_ms=timer(fused_adamw) if decoupled else None,
               bound_ms=b_ms, bound_by=b_by)
    return 0.0, res


def adam_clip_case(dev, n, gen, timer):
    """The global-norm clip's scale inside the Adam kernel: a bf16
    gradient with its fp32 master under AdamW, ``gscale`` = 0.3712 (a
    clip below the norm) as the fourth device scalar.  Kernel against
    `adam_update_ref` bit for bit (w, m1, m2, the bf16 parameter); and
    against the clip applied first (`ClipGradByGlobalNorm.__call__`'s
    ``(g.float() * s).to(bf16)``) then the unclipped update.  Controls
    that must be rejected: the unclipped update (``gscale`` 1), and the
    scale applied without the rounding to bf16.  (A ``gscale`` one fp32
    ulp off is no control here: a bf16 g has 8 significant bits, so no
    product g·s lies within 2^-24 of a bf16 rounding boundary and the
    rounding absorbs the change.)
    Returns the kernel's timing (the Llama step's Adam launches all carry
    the clip's scale)."""
    w = torch.randn(n, device=dev, generator=gen)
    m1 = 1e-2 * torch.randn(n, device=dev, generator=gen)
    m2 = 1e-4 * torch.rand(n, device=dev, generator=gen)
    g = (1e-2 * torch.randn(n, device=dev, generator=gen)).bfloat16()
    lr_t = torch.full((), 3e-4, dtype=torch.float32, device=dev)
    step_t = torch.full((), 3.0, dtype=torch.float32, device=dev)
    gs = torch.full((), 0.3712, dtype=torch.float32, device=dev)
    hyper = dict(b1=0.9, b2=0.999, eps=1e-8, wd=0.01, decoupled=True)

    def scal(s=gs):
        return adam_scalars(lr_t, step_t, 0.9, 0.999, gscale=s)

    def state(grad=g):
        return [w.clone(), grad, m1.clone(), m2.clone(),
                torch.empty(n, device=dev, dtype=torch.bfloat16)]
    name = "adam_clip[4096 x 11008 bf16 + fp32 master AdamW, gscale 0.3712]"

    def same(label, xs, ys):
        for part, a, b in zip(("w", "g", "m1", "m2", "p"), xs, ys):
            if part != "g" and not torch.equal(a, b):
                raise AssertionError(f"{name} {label} {part}: differs by "
                                     f"{max_err(a, b)}")
    got, want = state(), state()
    adam_update(*got, scal(), **hyper)
    torch.cuda.synchronize()
    adam_update_ref(*want, scal(), **hyper)
    same("kernel against the plain version", got, want)
    first = state((g.float() * gs).to(torch.bfloat16))
    adam_update_ref(*first, scal(None), **hyper)
    same("kernel against the clip applied first", got, first)
    del first
    for label, other in (
            ("the unclipped update (gscale 1)", (state(), scal(None))),
            ("the scale without the rounding to bf16",
             (state((g.float() * gs)), scal(None)))):
        st, sc = other
        adam_update_ref(*st, sc, **hyper)
        expect_rejected(f"{name} against {label}",
                        lambda: same(f"kernel against {label}", got, st))
        del st
    log(f"[kernels] {name}: bit for bit with the plain version and with "
        f"the clip applied first")
    b_ms, b_by = bound(24 * n + 2 * n + 2 * n, 16 * n, torch.float32)
    # the library yardstick: torch._fused_adamw_ with grad_scale = 1 / s
    # (it divides each gradient by it) on the fp32 master and moments and
    # an fp32 gradient; it writes no bf16 parameter
    lib = [[w.clone()], [g.float()], [m1.clone()], [m2.clone()], [],
           [torch.tensor(3.0, device=dev)]]
    inv = 1.0 / gs

    def fused_adamw():
        torch._fused_adamw_(*lib, lr=3e-4, beta1=0.9, beta2=0.999,
                            weight_decay=0.01, eps=1e-8, amsgrad=False,
                            maximize=False, grad_scale=inv)
    sc = scal()                         # made once: its own launches untimed
    res = dict(ms=timer(lambda: adam_update(*got, sc, **hyper)),
               plain_ms=timer(lambda: adam_update_ref(*want, sc, **hyper)),
               library_ms=timer(fused_adamw), bound_ms=b_ms, bound_by=b_by)
    return 0.0, res


def quant_pools(dev, name, pool_pages, psz, h_kv, d, gen):
    """int8 / fp8 pools holding the codes of N(0, 1) rows, each token's
    row scaled by its own U(0.2, 5) factor so that neighbouring rows'
    scales differ, and their per-row scales (`quantize_kv_rows`)."""
    sd, qmax = KV_QUANT_DTYPES[name]
    out = []
    for _ in range(2):
        x = torch.randn(pool_pages, psz, h_kv, d, device=dev, generator=gen)
        x *= 0.2 + 4.8 * torch.rand(pool_pages, psz, 1, 1, device=dev,
                                    generator=gen)
        out.extend(quantize_kv_rows(x, qmax, sd))
        del x
    k_pool, k_scale, v_pool, v_scale = out
    return k_pool, v_pool, k_scale, v_scale


def quant_paged_case(dev, name, b, h, h_kv, d, psz, n_pages, offsets, gen,
                     timer=None, controls=False):
    """The quantized variant against its plain version (dequantize the
    gathered pages, fp32 softmax) with a bf16 query, row by row; the
    control: the plain version with every token's scales taken from its
    neighbour row (a kernel that reads the scale row off by one)."""
    dtype = torch.bfloat16
    pool_pages = 1 + b * n_pages
    k_pool, v_pool, k_scale, v_scale = quant_pools(dev, name, pool_pages, psz,
                                                   h_kv, d, gen)
    q = torch.randn(b, h, d, device=dev, generator=gen).to(dtype)
    table = (torch.randperm(pool_pages - 1, device=dev, generator=gen) + 1) \
        .reshape(b, n_pages).to(torch.int32)
    off = torch.tensor(offsets, dtype=torch.int32, device=dev)
    kw = dict(k_scale=k_scale, v_scale=v_scale)
    out = paged_decode_attention(q, k_pool, v_pool, table, off, **kw)
    torch.cuda.synchronize()
    want = paged_decode_ref(q, k_pool, v_pool, table, off, **kw)
    label = (f"paged_decode_{name}[B={b} H={h} Hkv={h_kv} D={d} psz={psz} "
             f"off={list(offsets)} bf16 q]")
    err, rel = check_rows(label, [("out", out, want)], dtype)
    log(f"[kernels] {label}: worst row {rel:.2e} of its norm")
    if controls:
        shifted = {k: v.roll(1, dims=1).contiguous() for k, v in kw.items()}
        wrong = paged_decode_ref(q, k_pool, v_pool, table, off, **shifted)
        expect_rejected(f"{label} scales one row off", lambda: check_rows(
            label, [("out", out, wrong)], dtype))
    if timer is None:
        return err, None
    tokens = sum(o + 1 for o in offsets)
    live_pages = sum(o // psz + 1 for o in offsets)
    bytes_moved = (2 * b * h * d * q.element_size()          # q, out
                   + 2 * tokens * h_kv * d * k_pool.element_size()
                   + 2 * tokens * 4                          # scales
                   + 4 * live_pages + 4 * b)                 # table, offsets
    ops = 4 * h * d * tokens + 2 * h_kv * d * tokens         # + dequantize
    b_ms, b_by = bound(bytes_moved, ops, dtype)
    # the library yardstick: SDPA over the cache gathered and dequantized
    # beforehand (neither timed), heads expanded for GQA
    s = n_pages * psz
    pt = table.long()

    def deq(pool, sc):
        return dequantize_kv(gather_pages(pool, pt), sc[pt]) \
            .reshape(b, s, h_kv, d).transpose(1, 2) \
            .repeat_interleave(h // h_kv, dim=1).to(dtype).contiguous()
    kg, vg = deq(k_pool, k_scale), deq(v_pool, v_scale)
    mask = (torch.arange(s, device=dev)[None, :] <= off.long()[:, None]) \
        [:, None, None, :]
    q4 = q[:, :, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    res = dict(ms=timer(lambda: paged_decode_attention(q, k_pool, v_pool,
                                                       table, off, **kw)),
               plain_ms=timer(lambda: paged_decode_ref(q, k_pool, v_pool,
                                                       table, off, **kw)),
               library_ms=timer(lambda: sdpa(q4, kg, vg, attn_mask=mask)),
               bound_ms=b_ms, bound_by=b_by)
    return err, res


def lora_case(dev, seq, din, dout, dtype, gen, timer=None, controls=False,
              ns=4, rp=16, pool=5):
    """The gathered delta against its plain version, row by row: ``ns``
    rows through four distinct pool slots (0, the identity, among them),
    factors N(0, 0.02).  The control: the plain version with idx shifted
    by one row."""
    x = torch.randn(ns, seq, din, device=dev, generator=gen).to(dtype)
    a = (0.02 * torch.randn(pool, din, rp, device=dev, generator=gen)) \
        .to(dtype)
    b = (0.02 * torch.randn(pool, rp, dout, device=dev, generator=gen)) \
        .to(dtype)
    a[0], b[0] = 0, 0
    sc = torch.tensor([0.0, 1.0, 2.0, 0.5, 1.0], device=dev).to(dtype)
    idx = torch.tensor([0, 1, 2, 3][:ns], dtype=torch.int32, device=dev)
    out = lora_delta(x, a, b, sc, idx)
    torch.cuda.synchronize()
    want = lora_delta_ref(x, a, b, sc, idx)
    label = f"lora_delta[{ns}x{seq} {din}->{dout} rank {rp} {dtype}]"
    err, rel = check_rows(label, [("delta", out, want)], dtype)
    if out[0].any():
        raise AssertionError(f"{label}: the identity slot's rows are not 0")
    log(f"[kernels] {label}: worst row {rel:.2e} of its norm")
    if controls:
        wrong = lora_delta_ref(x, a, b, sc, idx.roll(1))
        expect_rejected(f"{label} idx shifted by one row", lambda: check_rows(
            label, [("delta", out, wrong)], dtype))
    if timer is None:
        return err, None
    es = x.element_size()
    distinct = len(set(idx.tolist()))
    b_ms, b_by = bound(es * (ns * seq * din + distinct * (din * rp + rp * dout
                                                           + 1)
                             + ns * seq * dout) + 4 * ns,
                       2 * ns * seq * rp * (din + dout) + ns * seq * dout,
                       dtype)
    # the library yardstick: two bmm over stacks gathered beforehand (the
    # scale folded into B, not timed)
    i = idx.long()
    ag, bg = a[i], b[i] * sc[i][:, None, None]
    res = dict(ms=timer(lambda: lora_delta(x, a, b, sc, idx)),
               plain_ms=timer(lambda: lora_delta_ref(x, a, b, sc, idx)),
               library_ms=timer(lambda: torch.bmm(torch.bmm(x, ag), bg)),
               bound_ms=b_ms, bound_by=b_by)
    return err, res


def fmt(res):
    lib = res["library_ms"]
    lib = "—" if lib is None else f"{lib:.4f} ms"
    return (f"kernel {res['ms']:.4f} ms, plain {res['plain_ms']:.4f} ms, "
            f"library {lib}, bound {res['bound_ms']:.5f}"
            f" ms ({res['bound_by']})")


def phase_kernels(dev):
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    timer = Timer(dev)
    errs = {"rms_norm": 0.0, "paged_decode": 0.0}
    timed = {}
    # the Timer's floor: one captured launch of a PyTorch kernel that does
    # next to nothing (an in-place add on 4 elements), a yardstick only
    tiny = torch.zeros(4, device=dev)
    floor_ms = timer(lambda: tiny.add_(1.0))
    log(f"[kernels] Timer floor (one in-place add on a 4-element tensor): "
        f"{floor_ms:.4f} ms")
    # RMS norm: a decode step (4 rows), a 4 x 32 prefill chunk, 4096 rows
    # (with r, as training calls it)
    for dtype in (torch.float32, torch.bfloat16):
        for rows in (4, 128, 4096):
            err, res = rms_case(dev, rows, 4096, dtype, gen, timer,
                                rstd=rows == 4096)
            errs["rms_norm"] = max(errs["rms_norm"], err)
            plan = rn.device_plan(torch.empty(0, device=dev, dtype=dtype),
                                  rows, 4096, True)
            log(f"[kernels] rms_norm rows={rows} N=4096 {dtype}"
                f"{' with r' if rows == 4096 else ''}: max abs err "
                f"{err:.3e}; {fmt(res)}; plan {rms_plan_str(plan)}"
                + (f"; Timer floor {floor_ms:.4f} ms" if rows == 4 else ""))
            timed[("rms_norm", rows, dtype)] = res
        # the staged path (N 16384), the generic loop (N 100; rows off
        # 16-byte alignment)
        for rows, n, mis in ((300, 16384, False), (3, 100, False),
                             (128, 4096, True)):
            err, _ = rms_case(dev, rows, n, dtype, gen, misaligned=mis)
            errs["rms_norm"] = max(errs["rms_norm"], err)
    # paged decode: Llama-2 7B heads (32/32, D 128, page 16) and 70B's
    # GQA heads (64/8); ragged offsets with a free row at 0, page edges,
    # a 4000-token row, and the serving run's 1024-token table; a 32-row
    # batch of long rows (one split-free grid already fills the card);
    # offsets on the edges of the planned split
    edge = split_plan(4, 32, 32, 16, 64, dev)[0]
    cases = [
        ("7b-serve", dict(b=4, h=32, h_kv=32, d=128, psz=16, n_pages=64,
                          offsets=(100, 300, 500, 620))),
        ("7b-edges", dict(b=4, h=32, h_kv=32, d=128, psz=16, n_pages=256,
                          offsets=(0, 15, 496, 4000), free_row=0)),
        ("7b-bounds", dict(b=4, h=32, h_kv=32, d=128, psz=16, n_pages=64,
                           offsets=(511, 512, 1023, 16))),
        ("70b-gqa", dict(b=4, h=64, h_kv=8, d=128, psz=16, n_pages=256,
                         offsets=(3000, 1, 256, 77))),
        ("7b-batch32", dict(b=32, h=32, h_kv=32, d=128, psz=16, n_pages=64,
                            offsets=tuple(900 + 4 * i for i in range(31))
                            + (1023,))),
        ("7b-split-edges", dict(b=4, h=32, h_kv=32, d=128, psz=16,
                                n_pages=64, offsets=(edge - 1, edge,
                                                     edge + 1, 2 * edge))),
    ]
    for dtype in (torch.float32, torch.bfloat16):
        for label, kw in cases:
            err, res = paged_case(
                dev, dtype=dtype, gen=gen, timer=timer,
                controls=label == "7b-serve" and dtype == torch.bfloat16,
                **kw)
            errs["paged_decode"] = max(errs["paged_decode"], err)
            split, n_splits = split_plan(kw["b"], kw["h"], kw["h_kv"],
                                         kw["psz"], kw["n_pages"], dev)
            log(f"[kernels] paged_decode {label} {dtype}: {n_splits} splits "
                f"of {split} tokens; max abs err {err:.3e}; {fmt(res)}")
            timed[("paged_decode", label, dtype)] = res
    errs.update({k: 0.0 for k in ("rms_norm_bwd", "rope", "flash_fwd",
                                  "flash_bwd_dkv", "flash_bwd_dq",
                                  "flash_bwd_delta", "adam")})
    # RMS-norm backward: the training shape (4096 tokens x 4096), the
    # staged path (N 16384) and the generic loop (N 100; misaligned rows)
    for dtype in (torch.float32, torch.bfloat16):
        err, res = rms_bwd_case(dev, 4096, 4096, dtype, gen, timer)
        errs["rms_norm_bwd"] = max(errs["rms_norm_bwd"], err)
        log(f"[kernels] rms_norm_bwd rows=4096 N=4096 {dtype}: max abs err "
            f"{err:.3e}; {fmt(res)}")
        timed[("rms_norm_bwd", dtype)] = res
        for rows, n, mis in ((300, 16384, False), (3, 100, False),
                             (128, 4096, True)):
            err, _ = rms_bwd_case(dev, rows, n, dtype, gen, misaligned=mis)
            errs["rms_norm_bwd"] = max(errs["rms_norm_bwd"], err)
    # rope: the training shape in bf16 (neox), interleaved fp32 small
    err, res = rope_case(dev, 1, 4096, 32, 128, True, torch.bfloat16, gen,
                         timer)
    log(f"[kernels] rope [1, 4096, 32, 128] neox bf16 fwd+bwd: max abs err "
        f"{err:.3e}; {fmt(res)}")
    timed[("rope", "train")] = res
    err, _ = rope_case(dev, 2, 37, 4, 64, False, torch.float32, gen)
    log(f"[kernels] rope [2, 37, 4, 64] interleaved fp32 fwd+bwd: max abs "
        f"err {err:.3e}")
    # flash attention: the training shape, Llama-2 70B's GQA heads, a
    # non-causal call and a ragged sequence in fp32 and bf16
    cases = [
        ("7b-train", dict(b=1, h=32, h_kv=32, s=4096, d=128, causal=True,
                          dtype=torch.bfloat16), True),
        ("70b-gqa", dict(b=1, h=64, h_kv=8, s=2048, d=128, causal=True,
                         dtype=torch.bfloat16), True),
        ("non-causal", dict(b=1, h=32, h_kv=32, s=1024, d=128,
                            causal=False, dtype=torch.bfloat16), False),
        ("ragged-bf16", dict(b=1, h=32, h_kv=32, s=1000, d=128, causal=True,
                             dtype=torch.bfloat16), False),
        ("ragged-fp32", dict(b=1, h=32, h_kv=32, s=1000, d=128, causal=True,
                             dtype=torch.float32), False),
    ]
    for label, kw, time_it in cases:
        case_errs, res = flash_case(dev, gen=gen,
                                    timer=timer if time_it else None,
                                    controls=label == "7b-train", **kw)
        for kname, err in case_errs.items():
            errs[kname] = max(errs[kname], err)
        msg = (f"[kernels] flash {label}: max abs err fwd "
               f"{case_errs['flash_fwd']:.3e}, dK/dV "
               f"{case_errs['flash_bwd_dkv']:.3e}, dQ "
               f"{case_errs['flash_bwd_dq']:.3e}")
        if res is not None:
            msg += (f"; fwd {fmt(res['flash_fwd'])}; dK/dV "
                    f"{fmt(res['flash_bwd_dkv'])}; dQ "
                    f"{fmt(res['flash_bwd_dq'])}; delta "
                    f"{fmt(res['flash_bwd_delta'])}; whole backward (delta"
                    f" + dK/dV + dQ) {fmt(res['flash_bwd'])}")
            for kname, r in res.items():
                timed[(kname, label)] = r
        log(msg)
    # the feature variants at GPT-2's training shape (B8 H12 S1024 D64,
    # causal, bf16), and the same kernels without features at that shape
    g2 = GPT2_SHAPE
    case_errs, res = flash_case(dev, g2["b"], g2["h"], g2["h"], g2["s"],
                                g2["d"], True, torch.bfloat16, gen, timer)
    for kname, err in case_errs.items():
        errs[kname] = max(errs[kname], err)
    log(f"[kernels] flash gpt2 (no features): fwd {fmt(res['flash_fwd'])}; "
        f"dK/dV {fmt(res['flash_bwd_dkv'])}; dQ {fmt(res['flash_bwd_dq'])}; "
        f"delta {fmt(res['flash_bwd_delta'])}; whole backward "
        f"{fmt(res['flash_bwd'])}")
    errs.update({k: 0.0 for k in DROPOUT_KERNELS + MASKED_KERNELS})
    for kind in ("dropout", "bias", "padding", "segments"):
        case_errs, res, share = feature_case(
            dev, kind, g2["b"], g2["h"], g2["s"], g2["d"], torch.bfloat16,
            gen, timer, controls=kind in ("dropout", "bias"))
        for kname, err in case_errs.items():
            errs[kname] = max(errs[kname], err)
        if share is not None:
            log(f"[kernels] plain keep share at dropout 0.1: {share:.6f} "
                f"(B8 H12 S1024, every score)")
        v = "_dropout" if kind == "dropout" else "_masked"
        log(f"[kernels] flash {kind} gpt2: max abs err fwd "
            f"{case_errs['flash_fwd' + v]:.3e}, dK/dV "
            f"{case_errs['flash_bwd_dkv' + v]:.3e}, dQ "
            f"{case_errs['flash_bwd_dq' + v]:.3e}; fwd "
            f"{fmt(res['flash_fwd' + v])}; dK/dV "
            f"{fmt(res['flash_bwd_dkv' + v])}; dQ "
            f"{fmt(res['flash_bwd_dq' + v])}; whole backward "
            f"{fmt(res['flash_bwd'])}")
        for kname, r in res.items():
            timed[(kname, kind)] = r
    seed_case(dev, g2["b"], g2["h"], g2["s"], g2["d"], gen)
    offsets_case(dev, g2["b"], g2["h"], g2["s"], g2["d"], gen)
    # Adam: the 7B-width MLP weight (4096 x 11008) in bf16 with its fp32
    # master under AdamW, as the train phase updates it; an fp32 parameter
    # with a ragged tail under L2-coupled Adam; a misaligned fp16 one
    err, res = adam_case(dev, 4096 * 11008, torch.bfloat16, True, True, 0.01,
                         gen, timer)
    log(f"[kernels] adam 4096 x 11008 bf16 + fp32 master AdamW, gscale 1: "
        f"bitwise equal; {fmt(res)}")
    timed[("adam", "unclipped")] = res
    err, res = adam_clip_case(dev, 4096 * 11008, gen, timer)
    log(f"[kernels] adam_clip 4096 x 11008 bf16 + fp32 master AdamW, gscale "
        f"< 1: bitwise equal; {fmt(res)} (library: torch._fused_adamw_ with "
        f"grad_scale)")
    timed[("adam", "train")] = res
    adam_case(dev, 4096 + 3, torch.float32, False, False, 0.1, gen)
    adam_case(dev, 1001, torch.float16, True, True, 0.0, gen, offset=1)
    log("[kernels] adam fp32 n=4099 Adam (L2) and fp16 n=1001 misaligned: "
        "bitwise equal")
    # quantized paged decode: the int8 engine's 32-token pages at the
    # serving run's table (max_seq_len 1024) and Llama-2 70B's GQA heads
    for name in ("int8", "fp8"):
        kname = "paged_decode_" + name
        errs[kname] = 0.0
        for label, kw in (
                ("7b-serve", dict(b=4, h=32, h_kv=32, d=128, psz=32,
                                  n_pages=32, offsets=(100, 300, 500, 620))),
                ("70b-gqa", dict(b=4, h=64, h_kv=8, d=128, psz=32,
                                 n_pages=128, offsets=(3000, 1, 256, 77)))):
            err, res = quant_paged_case(dev, name, gen=gen, timer=timer,
                                        controls=label == "7b-serve", **kw)
            errs[kname] = max(errs[kname], err)
            split, n_splits = split_plan(kw["b"], kw["h"], kw["h_kv"],
                                         kw["psz"], kw["n_pages"], dev)
            log(f"[kernels] {kname} {label}: {n_splits} splits of {split} "
                f"tokens; max abs err {err:.3e}; {fmt(res)}")
            timed[(kname, label)] = res
    # LoRA delta: a decode step (4 rows x 1) and a prefill chunk (4 x 32)
    # through the three projection geometries of Llama-2 7B, rank pool 16
    errs["lora_delta"] = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for seq in (1, 32):
            for din, dout in ((4096, 4096), (4096, 11008), (11008, 4096)):
                time_it = dtype == torch.bfloat16
                err, res = lora_case(
                    dev, seq, din, dout, dtype, gen,
                    timer=timer if time_it else None,
                    controls=time_it and seq == 1 and dout == 11008)
                errs["lora_delta"] = max(errs["lora_delta"], err)
                if res is not None:
                    log(f"[kernels] lora_delta 4x{seq} {din}->{dout} rank 16 "
                        f"{dtype}: max abs err {err:.3e}; {fmt(res)}")
                    timed[("lora_delta", seq, din, dout)] = res
    return errs, {"rms_norm": timed[("rms_norm", 4, torch.bfloat16)],
                  "paged_decode": timed[("paged_decode", "7b-serve",
                                         torch.bfloat16)],
                  "rms_norm_bwd": timed[("rms_norm_bwd", torch.bfloat16)],
                  "rope": timed[("rope", "train")],
                  **{k: timed[(k, "7b-train")] for k in (
                      "flash_fwd", "flash_bwd_dkv", "flash_bwd_dq",
                      "flash_bwd_delta")},
                  "adam": timed[("adam", "train")],
                  "paged_decode_int8": timed[("paged_decode_int8",
                                              "7b-serve")],
                  "paged_decode_fp8": timed[("paged_decode_fp8", "7b-serve")],
                  "lora_delta": timed[("lora_delta", 1, 4096, 11008)],
                  **{k: timed[(k, "dropout")] for k in DROPOUT_KERNELS},
                  **{k: timed[(k, "bias")] for k in MASKED_KERNELS}}


def device_rows(prof):
    """(name, device ms, count) of the work that ran on the card: kernels,
    copies and memsets.  The CPU-side ops that launched them also carry a
    device time (their kernels'), so summing every event counts the card's
    work twice."""
    from torch.autograd import DeviceType
    return [(e.key, e.device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.device_time_total > 0]


def serve_requests(vocab, seed=0):
    """8 requests: 17..600-token prompts, two sharing a 64-token prefix,
    six greedy and two seeded-sampled, 32 new tokens each."""
    rng = np.random.default_rng(seed)
    lens = [17, 600] + [int(n) for n in rng.integers(65, 600, 6)]
    prompts = [rng.integers(0, vocab, (n,)).astype(np.int32) for n in lens]
    # request 5 shares request 2's first 64 tokens (4 pages): it is
    # admitted after a slot frees, by when request 2's prompt pages sit
    # in the prefix tree
    prompts[5][:64] = prompts[2][:64]
    sampling = [SamplingParams() for _ in lens]
    sampling[3] = SamplingParams(temperature=0.8, top_k=50, top_p=0.95,
                                 seed=3)
    sampling[6] = SamplingParams(temperature=1.0, top_p=0.9,
                                 repetition_penalty=1.1, seed=6)
    return prompts, sampling


def profile_decode(model, dev, vocab, tick=True, tag="profile", top=12):
    """torch.profiler over a short serving run (2 greedy requests, one
    chunk of prefill, 16 decode steps) with FLAGS_compiled_tick set to
    ``tick`` (a warm-up request captures the tick's graph first): device
    time by kernel and the device's busy share of the wall time, which it
    returns."""
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, vocab, (n,)).astype(np.int32)
               for n in (20, 30)]
    port_flags.set_flags({"FLAGS_compiled_tick": tick})
    try:
        with Engine(model, ServingConfig(num_slots=4, max_seq_len=1024,
                                         cache_dtype="bfloat16")) as eng:
            eng.generate(prompts[0], max_new_tokens=2)      # warm
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.monotonic()
                futs = [eng.submit(p, max_new_tokens=17) for p in prompts]
                for f in futs:
                    f.result(timeout=300)
                wall_ms = (time.monotonic() - t0) * 1e3
            st = serve_stats(eng)
    finally:
        port_flags.set_flags({"FLAGS_compiled_tick": True})
    rows = device_rows(prof)
    busy_ms = sum(r[1] for r in rows)
    log(f"[{tag}] profiled: wall {wall_ms:.1f} ms, device busy "
        f"{busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}%), decode steps "
        f"{st['decode_steps']} ({st['tick_compiled_hits']} compiled "
        f"ticks), prefill calls {st['prefill_calls']}")
    for key, ms, count in sorted(rows, key=lambda r: -r[1])[:top]:
        log(f"[{tag}]   {ms:9.3f} ms  {count:6d}x  {key[:90]}")
    return busy_ms / wall_ms


def profile_long(model, dev, vocab, prompt_len=900, steps=16):
    """torch.profiler over one long request (a ~900-token prompt, 16
    decode steps): paged decode's device time per decode step and the
    device's busy share of the wall time."""
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(10)
    prompt = rng.integers(0, vocab, (prompt_len,)).astype(np.int32)
    with Engine(model, ServingConfig(num_slots=4, max_seq_len=1024,
                                     cache_dtype="bfloat16")) as eng:
        eng.generate(prompt[:20], max_new_tokens=2)     # warm
        steps0 = eng.stats()["decode_steps"]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            eng.submit(prompt, max_new_tokens=steps + 1).result(timeout=300)
            wall_ms = (time.monotonic() - t0) * 1e3
        n_steps = eng.stats()["decode_steps"] - steps0
    rows = device_rows(prof)
    busy_ms = sum(r[1] for r in rows)
    paged = [r for r in rows if "paged_decode" in r[0]]
    paged_ms = sum(r[1] for r in paged)
    log(f"[profile-long] one {prompt_len}-token prompt, {n_steps} decode "
        f"steps: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
        f"({100 * busy_ms / wall_ms:.1f}%), paged decode {paged_ms:.3f} ms "
        f"device ({paged_ms / max(n_steps, 1):.3f} ms a decode step, "
        f"{sum(r[2] for r in paged)} kernel launches)")
    for key, ms, count in sorted(paged, key=lambda r: -r[1]):
        log(f"[profile-long]   {ms:9.3f} ms  {count:6d}x  {key[:90]}")


class ServeRecord:
    """Every observation an engine makes through
    ``paddle_tpu_torch.serving.stats.observe``, kept by the script in lists
    (the registry's histograms keep bucket counts, three a decade, so
    their percentiles are estimates) and cleared when an engine's start
    resets the serving families: the exact decode, tick, TTFT and prefill
    percentiles the serving phases report.  `install` wraps the two
    module functions for the script's run; the engine keeps no list."""

    def __init__(self):
        self.hists = {}
        self._installed = False

    def install(self):
        if self._installed:
            return
        self._installed = True
        observe, reset = sstats.observe, sstats.reset_serving_stats

        def record(name, value):
            self.hists.setdefault(name, []).append(float(value))
            observe(name, value)

        def reset_all():
            self.hists = {}
            reset()
        sstats.observe = record
        sstats.reset_serving_stats = reset_all


SERVE_RECORD = ServeRecord()
#: the engine's histograms (`serving.stats` names)
SERVE_HISTS = ("ttft_ms", "prefill_ms", "prefill_chunk_ms", "decode_ms",
               "tick_ms", "spec_draft_ms", "spec_verify_ms",
               "spec_rollback_ms", "adapter.adapter_load_ms")


def serve_stats(eng):
    """``eng.stats()`` (the registry's ``serving_stats()``, read before the
    next engine starts) with, from `SERVE_RECORD`, each histogram's exact
    ``_avg`` / ``_p50`` / ``_p99`` (None before its first observation)
    and ``prefill_calls`` (one ``prefill_ms`` observation a prefill model
    call), and from the registry the raw ``slot_steps`` /
    ``slot_steps_active`` counters and the per-adapter series of
    ``requests_routed_adapter`` as ``requests_routed_adapter_by_adapter``."""
    st = dict(eng.stats())
    for name in SERVE_HISTS:
        vals = np.asarray(SERVE_RECORD.hists.get(name, ()), np.float64)
        key = name.rsplit(".", 1)[-1]
        for suffix, fn in (("_avg", np.mean), ("_p50", np.median),
                           ("_p99", lambda a: np.percentile(a, 99))):
            st[key + suffix] = float(fn(vals)) if vals.size else None
    st["prefill_calls"] = len(SERVE_RECORD.hists.get("prefill_ms", ()))
    for name in ("slot_steps", "slot_steps_active"):    # occupancy's parts
        st[name] = monitor.get_monitor_value("serving." + name)
    prefix = "serving.adapter.requests_routed_adapter{adapter="
    st["requests_routed_adapter_by_adapter"] = {
        k[len(prefix):-1]: int(v) for k, v in monitor.all_stats().items()
        if k.startswith(prefix)}
    return st


def jit_fallbacks():
    """The process's ``jit.compiled_step_fallback`` count: eager steps a
    compiled train step took because it was not eligible."""
    return monitor.get_monitor_value("jit.compiled_step_fallback")


def build_7b(dev):
    cfg = llama_config("llama2-7b")
    t0 = time.monotonic()
    model = LlamaForCausalLM(cfg, device=dev, dtype=torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    log(f"[serve] Llama-2 7B ({model.num_params() / 1e9:.2f} B params, "
        f"bf16, random weights, seed 0) built in "
        f"{time.monotonic() - t0:.1f} s")
    return model


def serve_run(model, dev, scfg, prompts, sampling, adapter_ids=None,
              max_new=32, tick=True, bind=None):
    """One Engine run over the requests, from launch counts at 0, with
    FLAGS_compiled_tick set to ``tick``: returns (outputs, stats, launch
    counts, wall s, peak GB, the engine); every request must give
    ``max_new`` in-vocab tokens, and with the tick on every decode step
    must be a compiled tick (no fallback, none latched at run time)
    unless the configuration blocks the tick statically (speculation, the
    slot layout: one TickFallbackWarning at start, no compiled tick).
    ``bind(engine)`` runs before the engine starts."""
    vocab = model.config.vocab_size
    adapter_ids = adapter_ids or [None] * len(prompts)
    port_flags.set_flags({"FLAGS_compiled_tick": tick})
    try:
        eng = Engine(model, scfg)
        if bind is not None:
            bind(eng)
        torch.cuda.reset_peak_memory_stats(dev)
        kernels.reset_launch_counts()
        t0 = time.monotonic()
        with eng:
            futs = [eng.submit(p, max_new_tokens=max_new, sampling=s,
                               adapter_id=a)
                    for p, s, a in zip(prompts, sampling, adapter_ids)]
            outs = [f.result(timeout=900) for f in futs]
        wall = time.monotonic() - t0
    finally:
        port_flags.set_flags({"FLAGS_compiled_tick": True})
    counts = kernels.launch_counts()
    st = serve_stats(eng)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    hits, falls = st["tick_compiled_hits"], st["tick_fallbacks"]
    # a static blocker is known from the configuration; a fallback latched
    # at run time (a mode's first call failed) fails the run
    static = eng._tick is not None and eng._tick._static_blocker()
    reason = eng._tick is not None and eng._tick.fallback_reason
    if tick and static and (hits or reason != static[1]):
        raise AssertionError(f"the tick is blocked by {static[1]!r}, yet "
                             f"{hits} compiled ticks, fallback {reason!r}")
    if tick and not static and (hits == 0 or hits != st["decode_steps"]
                                or falls or reason):
        raise AssertionError(f"compiled ticks {hits} of {st['decode_steps']}"
                             f" decode steps, fallbacks {falls}, fallback "
                             f"{reason!r}")
    if not tick and (hits or eng._tick is not None):
        raise AssertionError(f"FLAGS_compiled_tick off, yet {hits} ticks")
    for o in outs:
        if o.output_ids.size != max_new or o.finish_reason != "length":
            raise AssertionError(f"request {o.request_id}: {o.output_ids.size}"
                                 f" tokens, finish {o.finish_reason}")
        if not ((o.output_ids >= 0) & (o.output_ids < vocab)).all():
            raise AssertionError(f"request {o.request_id}: token outside "
                                 "the vocab")
    return outs, st, counts, wall, peak_gb, eng


def fmt_graphs(eng):
    """The tick's graphs by mode: captures, the first tick's ms (warm-up,
    capture and the first replay, while the live requests wait), replays,
    launches a replay."""
    first = eng._tick.first_tick_ms
    return ", ".join(f"{mode}: {cap} capture(s), first tick "
                     f"{first[mode]:.1f} ms, {rep} replays, launches a "
                     f"replay {launches}" for mode, (cap, rep, launches)
                     in sorted(eng._tick.graph_stats().items()))


def fmt_decode(st):
    """decode ms/step p50, avg and p99 and tick ms p50 and avg."""
    return (f"decode {st['decode_ms_p50']:.2f} ms/step p50 "
            f"({st['decode_ms_avg']:.2f} avg, {st['decode_ms_p99']:.2f} "
            f"p99) over {st['decode_steps']} steps, tick "
            f"{st['tick_ms_p50']:.2f} ms p50 ({st['tick_ms_avg']:.2f} avg)")


#: the kernel wrappers a decode step runs -> the kernel that one wrapper
#: launch runs once (paged decode's merge runs only when the plan splits)
REPLAY_KERNELS = {
    ("rms_norm",): ("rms_fwd",),
    ("paged_decode", "paged_decode_int8", "paged_decode_fp8"):
        ("paged_decode_split",),
    ("lora_delta",): ("lora_delta_kernel",),
    ("rope",): ("rope_vec_kernel", "rope_scalar_kernel"),
}


#: idle seconds on each side of a profiled window's edges.  The profiler
#: keeps a kernel's record only when its start and end, taken on the card's
#: clock and converted to the host's, fall inside the window that the host
#: opened and closed; without the idle time kernels next to an edge were
#: dropped (serve-gpt's 5 replays once counted 147 paged decodes of 160;
#: scripts/profile_window_check.py counts such windows with and without it)
PROFILE_EDGE_S = 0.1


def profile_replays(step, n=5):
    """`device_rows` of ``n`` replays of a captured tick graph, profiled
    after one warm-up replay under the profiler (its tracing set up, not
    recorded); the kernels they ran must be the graph's recorded launches
    a replay (what every replay adds to the launch counts) times ``n``."""
    from torch.profiler import ProfilerActivity, profile, schedule
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 acc_events=True) as prof:
        for reps in (1, n):
            time.sleep(PROFILE_EDGE_S)
            for _ in range(reps):
                step.graph.replay()
            torch.cuda.synchronize()
            time.sleep(PROFILE_EDGE_S)
            prof.step()
    rows = device_rows(prof)
    covered = {w for names in REPLAY_KERNELS for w in names}
    if set(step.launches) - covered:
        raise AssertionError(f"a replay launches {step.launches}; no kernel "
                             "name is known for "
                             f"{set(step.launches) - covered}")
    bad = []
    for names, kernel_names in REPLAY_KERNELS.items():
        want = n * sum(step.launches.get(w, 0) for w in names)
        hits = [(key[:60], c) for key, _, c in rows
                if any(k in key for k in kernel_names)]
        got = sum(c for _, c in hits)
        if got != want:
            bad.append(f"{'/'.join(names)}: {got} kernels in {n} replays, "
                       f"{want} recorded ({hits})")
    if bad:
        raise AssertionError("; ".join(bad))
    return rows


def check_replays(eng, tag):
    """`profile_replays` of each of the engine's tick graphs (after the
    engine stopped: every row dead, the same kernels at the same shapes)."""
    for mode, step in sorted(eng._tick.steps.items()):
        profile_replays(step)
        log(f"[{tag}] {mode} graph: the kernels of 5 profiled replays are "
            f"5 x its recorded launches {step.launches}")


def check_launches(counts, need):
    for name, n in need.items():
        if counts[name] < n or counts[name] == 0:
            raise AssertionError(f"{name}: {counts[name]} launches, expected"
                                 f" >= {n}")


def phase_serve(dev, model):
    cfg = model.config
    prompts, sampling = serve_requests(cfg.vocab_size)
    scfg = ServingConfig(num_slots=4, max_seq_len=1024,
                         cache_dtype="bfloat16")
    outs, st, counts, wall, peak_gb, eng = serve_run(
        model, dev, scfg, prompts, sampling)
    decode_steps = st["decode_steps"]
    prefill_calls = st["prefill_calls"]
    calls = decode_steps + prefill_calls
    need = {"paged_decode": cfg.num_layers * decode_steps,
            "rms_norm": (2 * cfg.num_layers + 1) * calls}
    check_launches(counts, need)
    if st.get("prefix_cache_hits", 0) < 1:
        raise AssertionError("the shared 64-token prefix was not reused")
    log(f"[serve] 8 requests ({sum(p.size for p in prompts)} prompt tokens,"
        f" {st['tokens_generated']} generated) in {wall:.2f} s: TTFT p50 "
        f"{st['ttft_ms_p50']:.1f} ms, {fmt_decode(st)}, prefill chunk {st['prefill_chunk_ms_p50']:.2f} ms p50 over "
        f"{prefill_calls} calls, {st['tokens_generated'] / wall:.1f} "
        f"tokens/s wall ({st['tokens_per_sec']:.1f} engine), prefix hits "
        f"{st['prefix_cache_hits']}, peak memory {peak_gb:.2f} GB, KV pages "
        f"peak {st['kv_pages_peak']} of 16 tokens")
    log(f"[serve] launches {counts} (needed >= {need})")
    log(f"[serve] compiled ticks {st['tick_compiled_hits']} of "
        f"{decode_steps} decode steps, fallbacks {st['tick_fallbacks']}; "
        f"graphs {fmt_graphs(eng)}")
    profile_decode(model, dev, cfg.vocab_size)
    profile_long(model, dev, cfg.vocab_size)
    return counts, st, outs


def adapter_spec(model, seed, rank, targets, alpha=None, std=0.02):
    """An in-memory adapter_spec over ``model``'s target projections: A
    and B N(0, std) from a numpy seed (B nonzero, so the adapter acts)."""
    rng = np.random.default_rng(seed)
    spec = {}
    for name, mod in model.named_modules():
        if name.rsplit(".", 1)[-1] in targets:
            din, dout = mod.weight.shape
            spec[name] = {
                "A": std * rng.standard_normal((din, rank), np.float32),
                "B": std * rng.standard_normal((rank, dout), np.float32),
                "rank": rank, "alpha": float(alpha or rank)}
    return spec


def serve_adapters(model):
    """The three adapters of the serve-lora-int8 phase, from seed 7."""
    return {"a": adapter_spec(model, 7, 16, LORA_TARGETS),
            "b": adapter_spec(model, 8, 8, ("q_proj", "v_proj")),
            "c": adapter_spec(model, 9, 16, ("gate_proj", "up_proj",
                                             "down_proj"), alpha=32.0)}


def phase_serve_lora(dev, model, float_st=None):
    """int8 KV pools and a LoRA adapter pool on the serve phase's model
    and traffic; then the same traffic without the pool; then the pages
    in use at equal load for bf16, int8 and fp8 pools, fp8 serving."""
    cfg = model.config
    prompts, sampling = serve_requests(cfg.vocab_size)
    ids = [None, None, "a", "b", "c", "a", "b", "c"]
    t0 = time.monotonic()
    specs = serve_adapters(model)
    log(f"[serve-lora-int8] adapters a (rank 16, all 7 projections), b "
        f"(rank 8, q/v), c (rank 16, alpha 32, MLP), N(0, 0.02) from seeds "
        f"7-9, made in {time.monotonic() - t0:.1f} s")
    scfg = ServingConfig(num_slots=4, max_seq_len=1024, cache_dtype="int8",
                         max_adapters=4, adapter_rank_pool=16,
                         adapters=specs)
    outs, st, counts, wall, peak_gb, eng = serve_run(
        model, dev, scfg, prompts, sampling, ids)
    n_proj = len(LORA_TARGETS) * cfg.num_layers
    calls = st["decode_steps"] + st["prefill_calls"]
    need = {"paged_decode_int8": cfg.num_layers * st["decode_steps"],
            "lora_delta": n_proj * calls}
    check_launches(counts, need)
    if counts["paged_decode"] != 0:
        raise AssertionError(f"the int8 engine launched the float kernel "
                             f"{counts['paged_decode']} times")
    if st.get("prefix_cache_hits", 0) < 1:
        raise AssertionError("the shared 64-token prefix was not reused "
                             "inside adapter a's scope")
    if st["adapters_loaded"] != 3:
        raise AssertionError(f"adapters_loaded {st['adapters_loaded']}, "
                             "expected 3")
    float_pages = float_st["kv_pages_peak"] if float_st else "not measured"
    log(f"[serve-lora-int8] 8 requests (2 base, 6 under 3 adapters) in "
        f"{wall:.2f} s: {fmt_decode(st)}, TTFT p50 {st['ttft_ms_p50']:.1f} ms, prefill chunk "
        f"{st['prefill_chunk_ms_p50']:.2f} ms p50 over {st['prefill_calls']} "
        f"calls, {st['tokens_generated'] / wall:.1f} tokens/s wall, peak "
        f"memory {peak_gb:.2f} GB, KV pages peak {st['kv_pages_peak']} of 32 "
        f"tokens (the bf16 serve phase: {float_pages} of 16), prefix hits "
        f"{st['prefix_cache_hits']}, adapters loaded {st['adapters_loaded']} "
        f"in {st['adapter_load_ms_avg']:.1f} ms avg, routed "
        f"{st['requests_routed_adapter_by_adapter']}")
    log(f"[serve-lora-int8] launches {counts} (needed >= {need})")
    log(f"[serve-lora-int8] compiled ticks {st['tick_compiled_hits']} of "
        f"{st['decode_steps']} decode steps, fallbacks "
        f"{st['tick_fallbacks']}; graphs {fmt_graphs(eng)}")
    check_replays(eng, "serve-lora-int8")
    del eng
    lora_counts = counts
    lane_switch_run(model, scfg, prompts, sampling, ids, outs)
    # the pool's cost: the same traffic, int8 pools, no adapter pool
    _, st0, _, wall0, _, _ = serve_run(model, dev, ServingConfig(
        num_slots=4, max_seq_len=1024, cache_dtype="int8"), prompts, sampling)
    log(f"[serve-lora-int8] without the adapter pool: decode "
        f"{st0['decode_ms_p50']:.2f} ms/step p50 ({st0['decode_ms_avg']:.2f} "
        f"avg), TTFT p50 {st0['ttft_ms_p50']:.1f} ms, "
        f"{st0['tokens_generated'] / wall0:.1f} tokens/s wall: the pool adds "
        f"{st['decode_ms_p50'] - st0['decode_ms_p50']:.2f} ms a decode step "
        f"({n_proj} delta launches)")
    # equal load: 4 greedy requests of 240 prompt + 16 new tokens, in
    # step with each other (one length), filling whole 32-token pages, no
    # prefix cache; then the fp8 run's launches
    rng = np.random.default_rng(5)
    short = [rng.integers(0, cfg.vocab_size, (240,)).astype(np.int32)
             for _ in range(4)]
    greedy = [SamplingParams()] * len(short)
    peaks = {}
    for dtype in ("bfloat16", "int8", "fp8"):
        _, st_d, counts_d, _, _, _ = serve_run(model, dev, ServingConfig(
            num_slots=4, max_seq_len=1024, cache_dtype=dtype,
            enable_prefix_cache=False), short, greedy, max_new=16)
        peaks[dtype] = st_d["kv_pages_peak"]
        if dtype == "fp8":
            fp8_counts = counts_d
            check_launches(counts_d, {"paged_decode_fp8": cfg.num_layers
                                      * st_d["decode_steps"]})
            log(f"[serve-lora-int8] fp8 engine, 4 requests x 16 tokens: "
                f"decode {st_d['decode_ms_p50']:.2f} ms/step p50, "
                f"paged_decode_fp8 launches {counts_d['paged_decode_fp8']} "
                f"over {st_d['decode_steps']} steps")
    if not peaks["int8"] * 2 == peaks["fp8"] * 2 == peaks["bfloat16"]:
        raise AssertionError(f"pages in use at equal load {peaks}: the "
                             "quantized pools should hold half")
    log(f"[serve-lora-int8] KV pages peak at equal load (4 x 256 tokens): "
        f"{peaks}")
    return lora_counts, fp8_counts


def lane_switch_run(model, scfg, prompts, sampling, ids, want):
    """The serve-lora-int8 traffic once more with a ninth request, unseeded
    and sampled under adapter a: the first four requests are submitted,
    then, when the first completes, the ninth and the last four.  While
    the ninth decodes, the tick is blocked (one TickFallbackWarning,
    tick.fallbacks counted): the engine flushes the device's tokens to the
    host, runs the uncompiled int8 + adapter step, and once the ninth
    ends rebuilds the tick's state from the live requests and replays
    (the last four, queued behind it with 32 tokens each to its 3,
    outlast it).  The eight requests' tokens must equal ``want`` (the
    all-tick run), the steps must go tick, uncompiled, tick, and the
    launch counts must cover the steps taken in both lanes."""
    cfg = model.config
    extra = np.random.default_rng(11).integers(
        0, cfg.vocab_size, (17,)).astype(np.int32)
    eng = Engine(model, scfg)
    lanes = []
    kernels.reset_launch_counts()
    with eng:
        tick_step = eng._tick.step

        def traced_step():
            lanes.append(tick_step())
            return lanes[-1]
        eng._tick.step = traced_step        # set before any request
        futs = [eng.submit(p, max_new_tokens=32, sampling=s, adapter_id=a)
                for p, s, a in list(zip(prompts, sampling, ids))[:4]]
        futs[0].result(timeout=900)
        xfut = eng.submit(extra, max_new_tokens=3, adapter_id="a",
                          sampling=SamplingParams(temperature=1.0, top_k=50))
        futs += [eng.submit(p, max_new_tokens=32, sampling=s, adapter_id=a)
                 for p, s, a in list(zip(prompts, sampling, ids))[4:]]
        outs = [f.result(timeout=900) for f in futs]
        xout = xfut.result(timeout=900)
    st = serve_stats(eng)
    counts = kernels.launch_counts()
    for w, g in zip(want, outs):
        if not np.array_equal(w.output_ids, g.output_ids):
            raise AssertionError(
                f"request {g.request_id}: all-tick {w.output_ids.tolist()} "
                f"!= with lane switches {g.output_ids.tolist()}")
    if xout.output_ids.size != 3 or not (
            (xout.output_ids >= 0) & (xout.output_ids < cfg.vocab_size)).all():
        raise AssertionError(f"the unseeded request gave "
                             f"{xout.output_ids.tolist()}")
    hits, falls = st["tick_compiled_hits"], st["tick_fallbacks"]
    off = [i for i, ran in enumerate(lanes) if not ran]
    if not off or not any(lanes[:off[0]]) or not any(lanes[off[-1] + 1:]) \
            or hits + falls != st["decode_steps"] or falls != len(off):
        raise AssertionError(f"steps {''.join('TU'[not r] for r in lanes)} "
                             f"(T tick, U uncompiled), {hits} compiled "
                             f"ticks, {falls} fallbacks, "
                             f"{st['decode_steps']} decode steps")
    n_proj = len(LORA_TARGETS) * cfg.num_layers
    calls = st["decode_steps"] + st["prefill_calls"]
    need = {"paged_decode_int8": cfg.num_layers * st["decode_steps"],
            "rms_norm": (2 * cfg.num_layers + 1) * calls,
            "lora_delta": n_proj * calls}
    check_launches(counts, need)
    log(f"[serve-lora-int8] lane switches: a ninth request (unseeded, "
        f"sampled, adapter a, 3 tokens) after the first completed; steps "
        f"{''.join('TU'[not r] for r in lanes)} (T tick, U uncompiled): "
        f"{hits} compiled ticks, {falls} fallbacks; the eight requests' "
        f"tokens equal the all-tick run's; launches {counts} (needed >= "
        f"{need})")


def phase_serve_tick(dev, model):
    """The serve phase's traffic in both lanes on the same model: the
    tokens must be equal request by request; each lane's decode ms/step,
    TTFT and tokens/s, its device busy share over a short profiled run,
    and the tick's graphs."""
    cfg = model.config
    prompts, sampling = serve_requests(cfg.vocab_size)
    scfg = ServingConfig(num_slots=4, max_seq_len=1024,
                         cache_dtype="bfloat16")
    runs = {}
    for lane, tick in (("uncompiled", False), ("tick", True)):
        outs, st, counts, wall, _, eng = serve_run(
            model, dev, scfg, prompts, sampling, tick=tick)
        busy = profile_decode(model, dev, cfg.vocab_size, tick=tick,
                              tag=f"serve-tick {lane}")
        runs[lane] = outs
        log(f"[serve-tick] {lane}: {fmt_decode(st)}, TTFT p50 "
            f"{st['ttft_ms_p50']:.1f} ms, "
            f"{st['tokens_generated'] / wall:.1f} tokens/s wall "
            f"({st['tokens_per_sec']:.1f} engine), device busy {100 * busy:.1f}% "
            f"(profiled run), compiled ticks {st['tick_compiled_hits']}, "
            f"paged_decode launches {counts['paged_decode']}, rms_norm "
            f"{counts['rms_norm']}")
        if tick:
            tick_steps = eng._tick.steps
            log(f"[serve-tick] graphs {fmt_graphs(eng)}")
    for a, b in zip(runs["uncompiled"], runs["tick"]):
        if not np.array_equal(a.output_ids, b.output_ids):
            raise AssertionError(
                f"request {a.request_id}: uncompiled "
                f"{a.output_ids.tolist()} != tick {b.output_ids.tolist()}")
    log("[serve-tick] every request's 32 tokens equal in both lanes "
        "(6 greedy, 2 seeded-sampled)")
    time_replays(model, tick_steps)


# ---------------------------------------------------------- serve-spec
#: draft tokens a speculative window (ServingConfig.speculation_k)
SPEC_K = 4
#: the speculative lanes' new tokens (the plain lanes keep the serve
#: phase's 32: serve-resilience and serve-telemetry take them)
SPEC_NEW = 16
#: the serve phases' slot capacity
SERVE_LEN = 1024


def serve_cfg(**kw):
    return ServingConfig(num_slots=4, max_seq_len=SERVE_LEN,
                         cache_dtype="bfloat16", **kw)


def early_exit_draft(model, layers, dev):
    """The self-speculative draft of Draft & Verify (Zhang et al., ACL
    2024) and LayerSkip (Elhoushi et al., 2024): a model of ``layers``
    blocks at the target's width holding copies of its embeddings, first
    ``layers`` blocks, final norm and head."""
    cfg = dataclasses.replace(model.config, num_layers=layers)
    draft = type(model)(cfg, device=dev,
                        dtype=next(model.parameters()).dtype).eval()
    keys = set(draft.state_dict())
    draft.load_state_dict({k: v for k, v in model.state_dict().items()
                           if k in keys})
    return draft


def hist(name):
    return SERVE_RECORD.hists.get(name, [])


def decode_ms_per_token(eng, st, n_requests):
    """Decode-side ms a generated token: the decode steps' and the
    speculative windows' wall time over the tokens they emitted (each
    request's first token comes from its prefill)."""
    ms = sum(sum(hist(n)) for n in (
        "decode_ms", "spec_draft_ms", "spec_verify_ms", "spec_rollback_ms"))
    return ms / max(st["tokens_generated"] - n_requests, 1)


def replay_logits(model, prompt, tokens, dtype="bfloat16", window=1, rows=1,
                  slots=False):
    """Teacher-forced last-position logits of ``tokens`` after ``prompt``
    through the engine's cache routes, fp32 ``[len(tokens), V]`` (row j
    predicts tokens[j]).  Paged: the prompt prefilled by 32-token chunk
    calls, then ``tokens[:-1]`` fed ``window`` at a time: 1 is the plain
    decode step (the paged-decode kernel), SPEC_K + 1 the verify call (the
    gather route); ``rows`` copies of the sequence fill a batch of that
    size.  ``slots``: the slot lane, a batch-1 prefill into a dense cache
    written into a SlotKVCache, then [rows, 1] steps at per-row offsets."""
    cfg = model.config
    dev = next(model.parameters()).device
    h_kv = getattr(cfg, "num_kv_heads", cfg.num_heads)
    seq = list(prompt) + list(tokens)
    out = []
    with torch.no_grad():
        if slots:
            cache = SlotKVCache(cfg.num_layers, rows, SERVE_LEN, h_kv,
                                cfg.head_dim, dtype=dtype, device=dev)
            pre = generation.init_kv_caches(
                cfg.num_layers, 1, SERVE_LEN, h_kv, cfg.head_dim,
                dtype=dtype, device=dev)
            logits = model(torch.tensor(prompt[None], device=dev),
                           caches=pre)
            out.append(logits[0, -1].float())
            for r in range(rows):
                cache.allocate()
                cache.write_prefill(r, pre, prompt.size)
            del pre
        else:
            psz = 16 * (1 if kv_quant_params(dtype) is None else 2)
            cache = PagedKVCache(cfg.num_layers, rows, SERVE_LEN + SPEC_K,
                                 h_kv, cfg.head_dim, page_size=psz,
                                 dtype=dtype, device=dev)
            for _ in range(rows):
                cache.allocate(cache.pages_per_slot)
            off = 0
            while off < prompt.size:
                seg = prompt[off:off + 32]
                tok = np.zeros((rows, 32), np.int32)
                tok[:, :seg.size] = seg
                for r in range(rows):
                    cache.ensure_capacity(r, off + seg.size - 1)
                views = cache.prefill_view(list(range(rows)), [off] * rows)
                logits = model(torch.tensor(tok, device=dev), caches=views)
                off += seg.size
            out.append(logits[0, seg.size - 1].float())
            for r in range(rows):
                cache.set_offset(r, prompt.size)
        pos = prompt.size
        while pos < len(seq) - 1:
            w = 1 if slots else min(window, len(seq) - 1 - pos)
            tok = np.tile(np.asarray(seq[pos:pos + w], np.int32), (rows, 1))
            if not slots:
                for r in range(rows):
                    cache.ensure_capacity(r, pos + w - 1)
            logits = model(torch.tensor(tok, device=dev),
                           caches=cache.layer_caches())
            out.extend(logits[0, i].float() for i in range(w))
            pos += w
            if slots:
                cache.advance(range(rows))
            else:
                for r in range(rows):
                    cache.set_offset(r, pos)
    return torch.stack(out)


def margins_of(logits):
    top2 = logits.topk(2, dim=-1).values
    return (top2[:, 0] - top2[:, 1]).cpu().numpy()


def gap_shift(a, b, top=5):
    """The largest change, from route ``a``'s logits to route ``b``'s, of
    the gaps between ``a``'s top token and its next ``top - 1`` at each
    position: how far the other route moves the decisions at the head of
    the distribution (a token flips only where its gap is below this)."""
    idx = a.topk(top, dim=-1).indices
    ga = a.gather(1, idx[:, :1]) - a.gather(1, idx[:, 1:])
    gb = b.gather(1, idx[:, :1]) - b.gather(1, idx[:, 1:])
    return float((ga - gb).abs().max())


def tie_margin(tag, model, prompts, outs, dtype, route):
    """The tie margin tau: the plain lane decodes in batches of 4, the
    other lane through ``route`` (keyword arguments of `replay_logits`),
    so a decision can move between them by at most the largest `gap_shift`
    from the batch-1 plain replay to the batch-4 one plus the largest to
    the route's, measured on requests 0 and 1 (17 and 600 prompt tokens)
    teacher-forced with the plain lane's tokens.  Returns tau and those
    two requests' plain top-two margins ({i: [T]}); the largest |logit|
    difference is logged beside each shift."""
    base = {i: replay_logits(model, prompts[i], outs[i].output_ids, dtype)
            for i in (0, 1)}
    shifts, diffs = {}, {}
    # a route that is the batch-4 step itself is replayed once
    for name, kw in dict((("batch 4", dict(rows=4)), route)).items():
        other = {i: replay_logits(model, prompts[i], outs[i].output_ids,
                                  dtype, **kw) for i in base}
        shifts[name] = max(gap_shift(base[i], other[i]) for i in base)
        diffs[name] = max(float((base[i] - other[i]).abs().max())
                          for i in base)
    tau = sum(shifts.values())
    margins = {i: margins_of(b) for i, b in base.items()}
    allm = np.concatenate(list(margins.values()))
    log(f"[{tag}] {dtype} routes against the batch-1 plain step, the "
        f"largest shift of a top gap (of a logit): "
        + ", ".join(f"{k} {shifts[k]:.4f} ({diffs[k]:.4f})" for k in shifts)
        + f"; tie margin tau = {tau:.4f}; requests 0 and 1's top-two "
        f"margins: median {np.median(allm):.4f}, "
        f"{100 * np.mean(allm < tau):.1f}% under tau")
    return tau, margins


def plain_margins(model, prompts, plain, lanes, dtype, have):
    """The plain lane's top-two margins ({i: [L]}) of each greedy request
    up to the furthest first divergence of any of ``lanes`` (lists of
    outputs; None for a request not compared), from batch-1 replays, or
    from ``have`` where it reaches that far: the tie rule reads a margin
    only where a lane leaves the plain lane."""
    out = {}
    for i, ref in enumerate(plain):
        firsts = [np.flatnonzero(o[i].output_ids != ref.output_ids)
                  for o in lanes if o[i] is not None]
        need = max([int(d[0]) + 1 for d in firsts if d.size], default=0)
        if not firsts:
            continue
        if i in have and len(have[i]) >= need:
            out[i] = have[i]
        elif need:
            out[i] = margins_of(replay_logits(
                model, prompts[i], ref.output_ids[:need], dtype))
        else:
            out[i] = np.zeros(0)
    return out


def tie_rule(want, got, margins, tau):
    """The first position where ``got`` leaves ``want`` must be a near
    tie of the plain lane (top-two margin under ``tau``): before it the
    two sequences share their history, so a divergence where the margin
    is wider is a fault.  Returns (the offending position or None, the
    positions compared: up to and including the first divergence)."""
    want, got = np.asarray(want), np.asarray(got)
    diff = np.flatnonzero(want != got)
    if not diff.size:
        return None, len(want)
    j = int(diff[0])
    return (j if margins[j] >= tau else None), j + 1


def check_ties(tag, lane, plain, outs, margins, tau):
    """Every greedy request of ``outs`` (None for one not compared)
    against the plain lane's under `tie_rule` (``margins`` reach each
    request's first divergence); logs the positions compared and each
    first divergence with its margin."""
    compared = total = 0
    firsts = []
    for i, o in enumerate(outs):
        if o is None:
            continue
        want, got, m = plain[i].output_ids, o.output_ids, margins[i]
        bad, n = tie_rule(want, got, m, tau)
        if bad is not None:
            raise AssertionError(
                f"[{tag}] {lane}: request {i} leaves the plain lane at token "
                f"{bad}, where its margin {m[bad]:.4f} >= tau {tau:.4f}: "
                f"{got.tolist()} != {want.tolist()}")
        compared += n
        total += len(want)
        diverged = n < len(want) or got[-1] != want[-1]
        firsts.append(f"{i}:{n - 1} ({m[n - 1]:.3f})" if diverged
                      else f"{i}:-")
    log(f"[{tag}] {lane}: every greedy request equals the plain lane's "
        f"tokens up to a divergence at a near tie ({compared} of {total} "
        f"positions compared); first divergence (margin) by request "
        f"{', '.join(firsts)}")


def tie_control(tag, plain, margins, tau, vocab):
    """The rule must reject a token changed where the plain lane's margin
    is wide: the first such position of the requests in ``margins``."""
    for i, m in margins.items():
        wide = np.flatnonzero(m >= tau)
        if wide.size:
            break
    else:
        raise AssertionError(f"[{tag}] no margin reaches tau {tau:.4f}: "
                             "the rule would accept any divergence")
    j = int(wide[0])
    wrong = [None] * len(plain)
    ids = plain[i].output_ids.copy()
    ids[j] = (ids[j] + 1) % vocab
    wrong[i] = types.SimpleNamespace(output_ids=ids)
    expect_rejected(f"{tag} tie rule, request {i}'s token {j} changed "
                    f"(margin {m[j]:.4f})",
                    lambda: check_ties(tag, "control", plain, wrong,
                                       {i: m}, tau))


class VerifyLog(torch.nn.Module):
    """Wraps a speculative engine's target: after each verify call (K + 1
    tokens a row) it finds, from the engine's offsets, each active row's
    usable proposals and records, where the window rejected one, the gap
    between the target's token and the rejected proposal in the verify
    logits.  With the target as its own draft a rejection is a near tie
    of the two routes: the gap stays under the tie margin."""

    def __init__(self, inner):
        super().__init__()
        self.inner = inner
        self.config = inner.config
        self.eng = None
        self.gaps = []
        self.rejected = 0       # proposals rejected, the tail after a gap

    def forward(self, ids, caches=None):
        logits = self.inner(ids, caches=caches)
        eng = self.eng
        if eng is not None and ids.shape[1] == SPEC_K + 1:
            top = logits.argmax(-1).cpu().numpy()
            tok = ids.cpu().numpy()
            for s in eng._active:
                # the draft took K steps from its offset before this call
                lag = int(eng.cache.offsets[s]) - (
                    int(eng.draft_cache.offsets[s]) - SPEC_K)
                cap = max(0, SPEC_K - lag)
                a = 0
                while a < cap and tok[s, a + 1] == top[s, a]:
                    a += 1
                if a < cap:
                    self.rejected += cap - a
                    row = logits[s, a].float()
                    self.gaps.append(float(row[top[s, a]]
                                           - row[tok[s, a + 1]]))
        return logits


def check_spec_launches(tag, lane, cfg, dcfg, st, counts, quant=False,
                        norms=True):
    """A speculative run's launches against lower bounds: the draft's K
    steps a window and the plain steps launch paged decode in every
    layer; with ``norms`` (Llama), every draft step, verify call and plain
    step launches the RMS norm 2 L + 1 times."""
    windows, steps = st["spec_windows"], st.get("decode_steps", 0)
    name = "paged_decode_int8" if quant else "paged_decode"
    need = {name: dcfg.num_layers * SPEC_K * windows
            + cfg.num_layers * steps}
    if norms:
        need["rms_norm"] = (2 * dcfg.num_layers + 1) * SPEC_K * windows \
            + (2 * cfg.num_layers + 1) * (windows + steps)
    check_launches(counts, need)
    got = {k: counts[k] for k in need}
    log(f"[{tag}] {lane} launches {got} (needed >= {need})")


def spec_line(tag, lane, eng, st, wall, peak_gb, n_req, plain_ms):
    """Logs a speculative lane: windows, ms and (all-greedy lanes) tokens a
    window, acceptance, the three phases' averages, ms a generated token
    against the plain compiled lane's, TTFT, tokens/s, peak memory."""
    windows = st["spec_windows"]
    spec_ms = sum(sum(hist(n)) for n in (
        "spec_draft_ms", "spec_verify_ms", "spec_rollback_ms"))
    per_tok = decode_ms_per_token(eng, st, n_req)
    win = ""
    if windows:
        if not st.get("decode_steps", 0):
            # every slot step was a window's: each active row emitted its
            # accepted run plus one token
            rows = st["slot_steps_active"]
            emitted = st["spec_accepted_tokens"] + rows
            win = (f"{emitted / windows:.2f} tokens a window over "
                   f"{rows / windows:.2f} active slots "
                   f"({emitted / rows:.2f} a slot), ")
        rate = st["spec_acceptance_rate"]
        win = (f"{windows} windows, {spec_ms / windows:.2f} ms a window, "
               f"{win}acceptance "
               f"{'-' if rate is None else format(rate, '.4f')} "
               f"({st['spec_accepted_tokens']} of "
               f"{st['spec_proposed_tokens']}), draft / verify / rollback "
               f"{st['spec_draft_ms_avg']:.2f} / "
               f"{st['spec_verify_ms_avg']:.2f} / "
               f"{st['spec_rollback_ms_avg']:.3f} ms avg, ")
    log(f"[{tag}] {lane}: {win}{st.get('decode_steps', 0)} plain steps, "
        f"{per_tok:.2f} ms a generated token (plain compiled "
        f"{plain_ms:.2f}, x{per_tok / plain_ms:.2f}), TTFT p50 "
        f"{st['ttft_ms_p50']:.1f} ms, {st['tokens_generated'] / wall:.1f} "
        f"tokens/s wall, peak {peak_gb:.2f} GB")


def check_pages(tag, lane, eng):
    tree = eng.prefix_tree.cached_pages() if eng.prefix_tree else 0
    d_use = eng.draft_cache.pages_in_use if eng.draft_cache else 0
    if d_use or eng.cache.pages_in_use != tree:
        raise AssertionError(f"[{tag}] {lane}: draft pages in use {d_use}, "
                             f"target {eng.cache.pages_in_use}, tree {tree}")


def exact_lanes(tag, dev, prompts, layers=2, gpt=False):
    """fp32 models at full width, 2 layers, fp32 pools: the speculative
    lane with a 1-layer early-exit draft and, for Llama, with the target
    as its own draft (acceptance >= 90%: in fp32 the two routes' logits
    agree far inside a top-two margin) gives the plain compiled lane's
    tokens for every request, with no tolerance.  GPT serves at
    max_seq_len 2048 - K, its KV capacity exactly its 2048 learned
    positions; 2048 with K is refused."""
    if gpt:
        cfg = gpt_config("gpt3-6.7b", num_layers=layers, max_seq_len=2048)
        model = GPTForCausalLM(cfg, device=dev, seed=1).eval()
        max_len = cfg.max_seq_len - SPEC_K
    else:
        cfg = llama_config("llama2-7b", num_layers=layers)
        model = LlamaForCausalLM(cfg, device=dev, seed=1).eval()
        max_len = SERVE_LEN
    name = "GPT-3 6.7B" if gpt else "Llama-2 7B"
    greedy = [SamplingParams()] * len(prompts)
    base = dict(num_slots=4, max_seq_len=max_len, cache_dtype="float32")
    plain = serve_run(model, dev, ServingConfig(**base), prompts, greedy)[0]
    drafts = [("a 1-layer early-exit draft", early_exit_draft(model, 1, dev))]
    if not gpt:
        drafts.append(("the target as its own draft", model))
    for label, draft in drafts:
        outs, st, counts, _, _, eng = serve_run(model, dev, ServingConfig(
            draft_model=draft, speculation_k=SPEC_K, **base), prompts,
            greedy)
        for a, b in zip(plain, outs):
            if not np.array_equal(a.output_ids, b.output_ids):
                raise AssertionError(
                    f"[{tag}] {name} fp32, {label}, request {a.request_id}:"
                    f" spec {b.output_ids.tolist()} != plain "
                    f"{a.output_ids.tolist()}")
        check_pages(tag, f"{name} fp32", eng)
        check_spec_launches(tag, f"{name} fp32, {label}", cfg, draft.config,
                            st, counts, norms=not gpt)
        rate = st["spec_acceptance_rate"]
        if draft is model and rate < 0.9:
            raise AssertionError(f"[{tag}] {name} fp32 agreeing draft: "
                                 f"acceptance {rate:.4f} (>= 0.9 needed)")
        log(f"[{tag}] {name} width, {layers} layers, fp32 pools, {label}, "
            f"max_seq_len {max_len}: every request's {len(prompts)} x 32 "
            f"tokens equal the plain lane's (acceptance {rate:.4f}, "
            f"{st['spec_windows']} windows)")
    if gpt:
        try:
            Engine(model, ServingConfig(
                num_slots=4, max_seq_len=cfg.max_seq_len,
                speculation_k=SPEC_K, draft_model=drafts[0][1]))
        except ValueError as e:
            log(f"[{tag}] {name}: max_seq_len {cfg.max_seq_len} with K "
                f"{SPEC_K} refused ({e})")
        else:
            raise AssertionError(f"[{tag}] GPT served past its positions")


def phase_serve_spec(dev, model):
    """Llama-2 7B, bf16, 4 slots, context 1024, K 4, the first 4 of the
    serve phase's requests with SPEC_NEW new tokens (the plain lanes: the
    8 requests with 32, the first SPEC_NEW compared): (a) the target as its own
    draft (own draft cache), all greedy; (b) a 2-layer early-exit draft and
    (c) (a) with int8 pools, all greedy, and (d) the traffic as it is
    (request 3 seeded-sampled: speculation disengages while it decodes).
    Greedy tokens against the plain compiled lane's under the tie rule;
    acceptance, pages, launches, ms a window and a token, peak memory.
    Then the exact fp32 lanes."""
    tag = "serve-spec"
    cfg = model.config
    prompts, sampling = serve_requests(cfg.vocab_size)
    greedy = [SamplingParams()] * len(prompts)
    n = len(prompts)
    plain = {}
    for label, dtype, samp in (("bf16", "bfloat16", greedy),
                               ("int8", "int8", greedy),
                               ("as-is", "bfloat16", sampling)):
        outs, st, _, wall, peak, eng = serve_run(
            model, dev, ServingConfig(num_slots=4, max_seq_len=SERVE_LEN,
                                      cache_dtype=dtype), prompts, samp)
        plain[label] = (outs, decode_ms_per_token(eng, st, n))
        log(f"[{tag}] plain compiled lane, {label}: {fmt_decode(st)}, "
            f"{plain[label][1]:.2f} ms a generated token, peak {peak:.2f} GB")
    draft2 = early_exit_draft(model, 2, dev)
    # the agreeing lanes' target is wrapped to record each rejection's gap
    # in the verify logits (and is its own draft, wrapped alike)
    # the lanes serve the first 4 requests only (request 3 is
    # seeded-sampled): the script's time budget
    lanes = (("(a) agreeing", None, "bfloat16", greedy[:4], "bf16"),
             ("(b) early exit", draft2, "bfloat16", greedy[:4], "bf16"),
             ("(c) agreeing int8", None, "int8", greedy[:4], "int8"),
             ("(d) serve traffic", model, "bfloat16", sampling[:4],
              "as-is"))
    results, gaps = {}, {}
    for lane, draft, dtype, samp, ref in lanes:
        target = VerifyLog(model) if draft is None else model
        outs, st, counts, wall, peak, eng = serve_run(
            target, dev, ServingConfig(num_slots=4, max_seq_len=SERVE_LEN,
                                       cache_dtype=dtype,
                                       draft_model=draft or target,
                                       speculation_k=SPEC_K),
            prompts[:len(samp)], samp, max_new=SPEC_NEW,
            bind=lambda e: setattr(target, "eng", e) if draft is None
            else None)
        # requests a lane did not serve are not compared (None)
        results[lane] = [o if samp[i].greedy else None
                         for i, o in enumerate(outs)] \
            + [None] * (n - len(outs)), st
        if isinstance(target, VerifyLog):
            rejected = st["spec_proposed_tokens"] - st["spec_accepted_tokens"]
            if target.rejected != rejected:
                raise AssertionError(
                    f"[{tag}] {lane}: {target.rejected} rejected proposals "
                    f"recorded of {rejected}")
            gaps[lane] = np.asarray(target.gaps)
            target.eng = None
        spec_line(tag, lane, eng, st, wall, peak, len(samp), plain[ref][1])
        check_spec_launches(tag, lane, cfg, (draft or target).config, st,
                            counts, quant=dtype == "int8")
        check_pages(tag, lane, eng)
        del eng, target
    # the tie margins: tau from the verify route on requests 0 and 1, the
    # plain lanes' margins where a lane leaves them
    verify = ("verify windows", dict(window=SPEC_K + 1))
    tau, m0 = tie_margin(tag, model, prompts, plain["bf16"][0], "bfloat16",
                         verify)
    tau8, m08 = tie_margin(tag, model, prompts, plain["int8"][0], "int8",
                           verify)
    tie_control(tag, plain["bf16"][0], m0, tau, cfg.vocab_size)
    refs = {"bf16": ("bfloat16", m0, tau), "int8": ("int8", m08, tau8),
            "as-is": ("bfloat16", {}, tau)}
    # the lanes' SPEC_NEW tokens against the plain lanes' first SPEC_NEW
    head = {ref: [types.SimpleNamespace(output_ids=o.output_ids[:SPEC_NEW])
                  for o in plain[ref][0]] for ref in refs}
    margins = {}
    for ref, (dtype, have, _) in refs.items():
        margins[ref] = plain_margins(
            model, prompts, head[ref],
            [results[lane][0] for lane, _, _, _, r in lanes if r == ref],
            dtype, have)
    for lane, _, dtype, samp, ref in lanes:
        t = refs[ref][2]
        if lane in gaps:
            g = gaps[lane]
            if (g >= t).any():
                raise AssertionError(f"[{tag}] {lane}: verify gaps "
                                     f"{np.sort(g)[-5:]} (tau {t:.4f})")
            log(f"[{tag}] {lane}: each of the {g.size} windows that "
                f"rejected a proposal of the target's own draft did so at a "
                f"near tie: the verify logits' gap from the target's token "
                f"to the proposal {float(g.max()) if g.size else 0:.4f} at "
                f"most (median {float(np.median(g)) if g.size else 0:.4f})"
                f" < tau {t:.4f}")
        check_ties(tag, lane, head[ref], results[lane][0], margins[ref], t)
    results = {lane: st for lane, (_, st) in results.items()}
    acc_b = results["(b) early exit"]["spec_acceptance_rate"]
    if acc_b > 0.05:
        raise AssertionError(f"[{tag}] acceptance (b) {acc_b:.4f} (<= 0.05 "
                             "needed)")
    st_d = results["(d) serve traffic"]
    if not (st_d["spec_windows"] and st_d.get("decode_steps", 0)):
        raise AssertionError(f"[{tag}] (d): {st_d['spec_windows']} windows, "
                             f"{st_d.get('decode_steps', 0)} plain steps")
    del draft2
    torch.cuda.empty_cache()
    # the exact lanes serve the first 4 requests: the script's time budget
    exact_lanes(tag, dev, prompts[:4])
    torch.cuda.empty_cache()
    gpt_prompts, _ = serve_requests(50257)
    exact_lanes(tag, dev, gpt_prompts[:4], gpt=True)
    torch.cuda.empty_cache()
    return plain["as-is"][0], margins["as-is"]


# ---------------------------------------------------- serve-resilience
class FailOnce(torch.nn.Module):
    """Wraps a model: the first forward after ``arm`` is set raises."""

    def __init__(self, inner):
        super().__init__()
        self.inner = inner
        self.config = inner.config
        self.arm = False

    def forward(self, ids, caches=None):
        if self.arm:
            self.arm = False
            raise RuntimeError("injected model failure")
        return self.inner(ids, caches=caches)


def drain_setup(vocab, seed=4, n=5, plen=100, max_new=32):
    """``n`` distinct ``plen``-token prompts and a pool of exactly two
    requests' pages (prompt + max_new at 16 tokens a page): two decode,
    the rest wait on pages however many slots are free."""
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, vocab, (plen,)).astype(np.int32)
               for _ in range(n)]
    return prompts, 2 * (-(-(plen + max_new) // 16))


def drain_drill(eng, prompts, max_new, kill=None):
    """Two requests decoding, three queued behind them; then ``kill()``
    (a SIGTERM) or `Engine.drain`.  Returns the facts: the in-flight
    tokens, the queued failures, whether a later submit raised, the
    drain's ms."""
    inflight = [eng.submit(p, max_new_tokens=max_new) for p in prompts[:2]]
    t0 = time.monotonic()
    while eng.stats().get("active_slots", 0) < 2:
        if time.monotonic() - t0 > 300:
            raise AssertionError("two requests never decoded together")
        time.sleep(0.002)
    queued = [eng.submit(p, max_new_tokens=max_new) for p in prompts[2:]]
    t0 = time.monotonic()
    if kill is None:
        eng.drain(deadline_s=120)
    else:
        kill()
    res = {"tokens": [], "queued_failed": 0, "rejected": 0, "errors": []}
    for f in inflight:
        try:
            o = f.result(timeout=300)
            res["tokens"].append(int(o.output_ids.size))
        except Exception as e:          # noqa: BLE001 - reported
            res["errors"].append(f"{type(e).__name__}: {e}")
    for f in queued:
        try:
            f.result(timeout=300)
            res["errors"].append("a queued request completed")
        except EngineShutdownError:
            res["queued_failed"] += 1
        except Exception as e:          # noqa: BLE001 - reported
            res["errors"].append(f"{type(e).__name__}: {e}")
    while eng._thread is not None and time.monotonic() - t0 < 300:
        time.sleep(0.002)               # the drain's shutdown
    res["drain_ms"] = (time.monotonic() - t0) * 1e3
    try:
        eng.submit(prompts[0])
        res["errors"].append("a submit after the drain was accepted")
    except EngineShutdownError:
        res["rejected"] = 1
    return res


def check_drain(tag, res, max_new):
    want = {"tokens": [max_new] * 2, "queued_failed": 3, "rejected": 1,
            "errors": []}
    got = {k: res[k] for k in want}
    if got != want:
        raise AssertionError(f"[{tag}] drain: {got}, expected {want}")


def serve_child(outdir, dev=None):
    """serve-resilience's SIGTERM child: a 2-layer model at Llama-2 7B
    width (bf16, seed 0) behind an Engine with `install_preemption_drain`;
    two requests decode, three wait, then the process sends itself
    SIGTERM.  The drill's facts go to ``outdir/drain.json``."""
    dev = dev or torch.device("cuda", 0)
    model = LlamaForCausalLM(llama_config("llama2-7b", num_layers=2),
                             device=dev, dtype=torch.bfloat16, seed=0).eval()
    prompts, pool = drain_setup(model.config.vocab_size, max_new=64)
    eng = Engine(model, serve_cfg(kv_pool_pages=pool)).start()
    handler = eng.install_preemption_drain(deadline_s=120)
    res = drain_drill(eng, prompts, 64,
                      kill=lambda: os.kill(os.getpid(), signal.SIGTERM))
    res["preempted"] = handler.preempted()
    res["cancelled_drain"] = eng.stats()["requests_cancelled_drain"]
    with open(os.path.join(outdir, "drain.json"), "w") as f:
        json.dump(res, f)


def stalled_run(orig, calls):
    """`CompiledServingTick._run` whose 2nd call sleeps 30 s in slices an
    asynchronous exception can land between."""
    def run(self):
        calls.append(time.monotonic())
        if len(calls) == 2:
            t0 = time.monotonic()
            while time.monotonic() - t0 < 30.0:
                time.sleep(0.01)
        return orig(self)
    return run


def phase_serve_resilience(dev, model, plain=None, margins=None):
    """The serve phase's model, bf16, 4 slots: (1) drain under the
    compiled tick; (2) a SIGTERM drill in a child; (3) a stalled tick;
    (4) a crash; (5) memory across three restarts; (6) the slot layout."""
    tag = "serve-resilience"
    cfg = model.config
    vocab = cfg.vocab_size
    fr_path = os.path.join(tempfile.mkdtemp(prefix="serve-resil-"),
                           "flight.json")
    port_flags.set_flags({"FLAGS_flight_recorder_path": fr_path})
    # (1) drain: two decode, three wait on the pool's pages
    prompts, pool = drain_setup(vocab)
    eng = Engine(model, serve_cfg(kv_pool_pages=pool)).start()
    kernels.reset_launch_counts()
    res = drain_drill(eng, prompts, 32)
    counts = kernels.launch_counts()
    check_drain(tag, res, 32)
    st = serve_stats(eng)
    if st["tick_compiled_hits"] != st.get("decode_steps", 0) or \
            not st.get("decode_steps", 0):
        raise AssertionError(f"[{tag}] drain: {st['tick_compiled_hits']} "
                             f"ticks of {st.get('decode_steps', 0)} steps")
    check_launches(counts, {"paged_decode": cfg.num_layers
                            * st.get("decode_steps", 0),
                            "rms_norm": (2 * cfg.num_layers + 1)
                            * (st.get("decode_steps", 0)
                               + st["prefill_calls"])})
    log(f"[{tag}] (1) drain under the compiled tick: 2 in-flight requests "
        f"finished with 32 tokens, 3 queued failed (EngineShutdownError), "
        f"a later submit raised; drain {res['drain_ms']:.1f} ms; "
        f"{st['tick_compiled_hits']} compiled ticks; launches paged_decode "
        f"{counts['paged_decode']}, rms_norm {counts['rms_norm']}")
    # (2) SIGTERM in a child
    d = tempfile.mkdtemp(prefix="serve-child-")
    t0 = time.monotonic()
    env = dict(os.environ,
               FLAGS_flight_recorder_path=os.path.join(d, "flight.json"))
    p = subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--serve-child", d], capture_output=True, text=True,
                       timeout=600, env=env)
    if p.returncode != 0:
        raise AssertionError(f"[{tag}] child exited {p.returncode}:\n"
                             + (p.stdout + p.stderr)[-3000:])
    with open(os.path.join(d, "drain.json")) as f:
        child = json.load(f)
    check_drain(tag, child, 64)
    with open(os.path.join(d, "flight.json")) as fh:
        reason = json.load(fh)["reason"]
    if not child["preempted"] or child["cancelled_drain"] != 3 or \
            reason != "sigterm":
        raise AssertionError(f"[{tag}] child: {child}, dump {reason}")
    log(f"[{tag}] (2) SIGTERM child (2 layers at 7B width, "
        f"install_preemption_drain): 2 in-flight finished with 64 tokens, 3 "
        f"queued failed, a later submit raised, exit 0; drain "
        f"{child['drain_ms']:.1f} ms; {time.monotonic() - t0:.1f} s with "
        "the child's start")
    # (3) a stalled tick
    short = serve_requests(vocab)[0][0]           # 17 prompt tokens
    calls = []
    orig = CompiledServingTick._run
    CompiledServingTick._run = stalled_run(orig, calls)
    try:
        eng = Engine(model, serve_cfg(step_timeout_s=5.0,
                                      max_scheduler_restarts=2)).start()
        tick0 = eng._tick
        t0 = time.monotonic()
        f = eng.submit(short, max_new_tokens=8)
        exc = f.exception(timeout=60)
        fail_s = time.monotonic() - t0
        if not isinstance(exc, SchedulerStallError) or fail_s > 10:
            raise AssertionError(f"[{tag}] stall: {exc!r} after "
                                 f"{fail_s:.1f} s")
        t1 = time.monotonic()
        out = eng.generate(short, max_new_tokens=8, timeout=300)
        again_s = time.monotonic() - t1
        st = serve_stats(eng)
        graphs = eng._tick.graph_stats()
        captures = 1 if dev.type == "cuda" else 0   # a CPU tick runs eagerly
        if eng._tick is tick0 or graphs.get("greedy", (-1,))[0] != captures:
            raise AssertionError(f"[{tag}] stall: the tick was not rebuilt "
                                 f"and captured again ({graphs})")
        eng.shutdown()
    finally:
        CompiledServingTick._run = orig
    with Engine(model, serve_cfg()) as fresh:
        want = fresh.generate(short, max_new_tokens=8).output_ids
    if not np.array_equal(out.output_ids, want):
        raise AssertionError(f"[{tag}] after the stall {out.output_ids} != "
                             f"a fresh engine's {want}")
    with open(fr_path) as fh:
        dump = json.load(fh)
    if dump["reason"] != "serving-stall" or not dump["stall"]["threads"]:
        raise AssertionError(f"[{tag}] stall dump: {dump.get('reason')}")
    log(f"[{tag}] (3) tick call 2 stalled 30 s, step_timeout_s 5: the future "
        f"failed with SchedulerStallError after {fail_s:.2f} s, stalls "
        f"{st['scheduler_stalls']}, restarts {st['scheduler_restarts']}; the "
        f"new tick captured again (graphs {graphs}) and served the next "
        f"request in {again_s:.2f} s, its tokens equal a fresh engine's; "
        f"the dump holds {len(dump['stall']['threads'])} threads' stacks")
    # (4) a crash, (5) memory across three more restarts
    wrapped = FailOnce(model)
    eng = Engine(wrapped, serve_cfg(max_scheduler_restarts=4)).start()
    try:
        wrapped.arm = True
        futs = [eng.submit(p, max_new_tokens=8) for p in
                serve_requests(vocab)[0][:3]]
        errs = [f.exception(timeout=300) for f in futs]
        if not all(isinstance(e, RuntimeError) and "injected" in str(e)
                   for e in errs):
            raise AssertionError(f"[{tag}] crash: {errs}")
        if eng.stats()["scheduler_restarts"] != 1:
            raise AssertionError(f"[{tag}] crash: restarts "
                                 f"{eng.stats()['scheduler_restarts']}")
        out = eng.generate(short, max_new_tokens=8, timeout=300)
        if not np.array_equal(out.output_ids, want):
            raise AssertionError(f"[{tag}] after the crash {out.output_ids}"
                                 f" != {want}")
        log(f"[{tag}] (4) a model call raised: all 3 outstanding futures "
            f"failed with it, scheduler_restarts 1, the engine served again "
            f"(tokens equal a fresh engine's)")
        levels = []
        for _ in range(3):
            wrapped.arm = True
            f = eng.submit(short, max_new_tokens=8)
            if "injected" not in str(f.exception(timeout=300)):
                raise AssertionError(f"[{tag}] restart: no crash")
            eng.generate(short, max_new_tokens=8, timeout=300)
            torch.cuda.synchronize()
            levels.append(torch.cuda.memory_allocated(dev))
        st = serve_stats(eng)
    finally:
        eng.shutdown()
    spread = max(abs(lv - levels[0]) for lv in levels) / levels[0]
    if spread > 0.01 or st["scheduler_restarts"] != 4:
        raise AssertionError(f"[{tag}] memory after restarts {levels} "
                             f"(spread {spread:.4%}), restarts "
                             f"{st['scheduler_restarts']}")
    log(f"[{tag}] (5) three more restarts, each serving a request through a "
        f"new cache and a new captured tick: memory allocated after each "
        f"{[round(lv / 1e9, 4) for lv in levels]} GB (spread "
        f"{100 * spread:.4f}%)")
    # (6) the slot layout, on the first 4 requests (the script's time)
    prompts, sampling = serve_requests(vocab)
    if plain is None:
        plain = serve_run(model, dev, serve_cfg(), prompts, sampling)[0]
    prompts, sampling, plain = prompts[:4], sampling[:4], plain[:4]
    n = len(prompts)
    outs, st, counts, wall, peak, eng = serve_run(
        model, dev, serve_cfg(kv_layout="slots"), prompts, sampling)
    outs = [o if sampling[i].greedy else None for i, o in enumerate(outs)]
    tau, _ = tie_margin(tag, model, prompts, plain, "bfloat16",
                        ("slot lane", dict(slots=True)))
    margins = plain_margins(model, prompts, plain, [outs], "bfloat16",
                            margins or {})
    check_ties(tag, "slots", plain, outs, margins, tau)
    check_launches(counts, {"rms_norm": (2 * cfg.num_layers + 1) * (
        st.get("decode_steps", 0) + st["prefill_calls"])})
    log(f"[{tag}] (6) kv_layout='slots' on the serve traffic: "
        f"{fmt_decode(st)}, TTFT p50 {st['ttft_ms_p50']:.1f} ms, "
        f"{st['tokens_generated'] / wall:.1f} tokens/s wall, peak "
        f"{peak:.2f} GB, tick fallbacks {st['tick_fallbacks']}, rms_norm "
        f"launches {counts['rms_norm']}")
    small = LlamaForCausalLM(llama_config("llama2-7b", num_layers=2),
                             device=dev, seed=1).eval()
    greedy = [SamplingParams()] * n
    a = serve_run(small, dev, ServingConfig(num_slots=4,
                                            max_seq_len=SERVE_LEN),
                  prompts, greedy)[0]
    b = serve_run(small, dev, ServingConfig(num_slots=4,
                                            max_seq_len=SERVE_LEN,
                                            kv_layout="slots"),
                  prompts, greedy)[0]
    for x, y in zip(a, b):
        if not np.array_equal(x.output_ids, y.output_ids):
            raise AssertionError(f"[{tag}] fp32 slots {y.output_ids} != "
                                 f"paged {x.output_ids}")
    log(f"[{tag}] (6) fp32, 2 layers at 7B width: the slot lane's tokens "
        f"equal the paged lane's for all {n} requests")
    port_flags.set_flags({"FLAGS_flight_recorder_path": ""})


def run_check_telemetry(tag, *args):
    """``tools/check_telemetry.py`` with ``args``; the phase fails unless it
    exits 0.  Returns its output."""
    chk = subprocess.run([sys.executable, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tools", "check_telemetry.py"), *args],
        capture_output=True, text=True, timeout=120)
    if chk.returncode != 0:
        raise AssertionError(f"[{tag}] check_telemetry {' '.join(args)}: "
                             f"{chk.stdout}{chk.stderr}")
    return chk.stdout


def check_exposition(tag, series, *flags):
    """The registry's Prometheus exposition, written to a file, through
    ``check_telemetry --prometheus`` with ``flags`` and every name of
    ``series`` required; returns the file's path."""
    path = os.path.join(tempfile.mkdtemp(prefix="metrics-"), "metrics.prom")
    with open(path, "w") as f:
        f.write(registry.render_prometheus())
    out = run_check_telemetry(tag, "--prometheus", path, *flags,
                              "--require-series", *series)
    log(f"[{tag}] exposition through check_telemetry "
        f"{' '.join(flags)} with {len(series)} required series: "
        f"{out.strip().splitlines()[0]}")
    return path


#: the span names of one request's trace (observability/tracing.py)
TRACE_SPANS = ("engine.request", "engine.queue", "engine.prefill",
               "engine.decode")
#: the serving families serve-telemetry's run moves, as the exposition
#: names them
TELEMETRY_SERIES = (
    "serving_requests_submitted", "serving_requests_completed",
    "serving_tokens_generated", "serving_ttft_ms", "serving_decode_ms",
    "serving_tick_ms", "serving_tick_compiled_hits", "serving_kv_pages_peak",
    "serving_kv_pages_in_use", "serving_prefix_cache_hits",
    "serving_request_tokens", "serving_trace_spans",
    "serving_trace_decisions")


def check_traces(tag, merged, n):
    """Every one of ``n`` traces: one decision, one ``engine.request``
    root and its ``engine.queue`` / ``engine.prefill`` / ``engine.decode``
    children, the root the one winner."""
    traces = merged["traces"]
    if len(traces) != n:
        raise AssertionError(f"[{tag}] {len(traces)} traces for {n} requests")
    for tr in traces:
        spans = tr.get("spans") or []
        roots = [s for s in spans if s["parent"] is None]
        winners = [s for s in spans if s.get("winner")]
        names = sorted(s["name"] for s in spans)
        if tr["decision_count"] != 1 or names != sorted(TRACE_SPANS) or \
                len(roots) != 1 or roots[0]["name"] != "engine.request" or \
                [w["span"] for w in winners] != [roots[0]["span"]] or \
                any(s["parent"] != roots[0]["span"] for s in spans
                    if s is not roots[0]):
            raise AssertionError(f"[{tag}] trace {tr['trace_id']}: "
                                 f"{tr['decision_count']} decisions, spans "
                                 f"{[(s['name'], s['parent']) for s in spans]}")


class HostRead(torch.nn.Module):
    """A model whose decode forward reads one value to the host (a
    ``.item()``), which one captured tick cannot hold."""

    def __init__(self, inner):
        super().__init__()
        self.inner = inner
        self.config = inner.config
        self.reads = 0

    def forward(self, ids, caches=None):
        logits = self.inner(ids, caches=caches)
        if ids.shape[1] == 1:
            float(logits[0, -1, 0].item())                  # the host read
            self.reads += 1
        return logits


def allocated_and_workspaces(dev):
    """(``memory_allocated`` without cuBLAS's workspaces, the workspaces'
    bytes) after a collection.  torch keeps a cuBLAS workspace for each
    stream cuBLAS ran on (32 MiB on an H100) for the process's life; they
    are read, then cleared, so that the next lane starts with none."""
    gc.collect()
    torch.cuda.synchronize()
    raw = torch.cuda.memory_allocated(dev)
    torch._C._cuda_clearCublasWorkspaces()
    clean = torch.cuda.memory_allocated(dev)
    return clean, raw - clean


#: bytes by which the memory left after the fallback lane may differ from
#: the flag-off lane's (cuBLAS's workspaces apart)
FALLBACK_MEM_SLACK = 2 ** 20


def tick_fallback_drill(tag, dev, prompts):
    """serve-telemetry (c): a 2-layer model at 7B width whose decode
    forward reads the host serves two greedy requests with the defaults,
    the tick off and then on: one TickFallbackWarning, fallbacks counted
    and no compiled tick, the requests complete with the flag-off lane's
    tokens.  Memory (`allocated_and_workspaces`, each engine alive) is
    read from before the model is built: after the fallback lane it must
    be within ``FALLBACK_MEM_SLACK`` of the flag-off lane's, and the
    fallback lane may hold one cuBLAS workspace more than the flag-off
    lane's, for its engine's one side stream (the tick's warm-up runs
    there), and no more."""
    base = allocated_and_workspaces(dev)[0]
    model = HostRead(LlamaForCausalLM(
        llama_config("llama2-7b", num_layers=2), device=dev,
        dtype=torch.bfloat16, seed=2).eval())
    lanes = {}
    for tick in (False, True):
        port_flags.set_flags({"FLAGS_compiled_tick": tick})
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                eng = Engine(model, ServingConfig())
                with eng:
                    outs = [eng.generate(p, max_new_tokens=16)
                            for p in prompts]
                st = eng.stats()
        finally:
            port_flags.set_flags({"FLAGS_compiled_tick": True})
        mem, ws = allocated_and_workspaces(dev)
        warned = [w for w in caught
                  if issubclass(w.category, TickFallbackWarning)]
        lanes[tick] = (outs, st, mem - base, ws, warned, eng._tick)
        del eng
    (off, _, mem_off, ws_off, _, _), (on, st, mem_on, ws_on, warned, tick) \
        = lanes[False], lanes[True]
    if len(warned) != 1 or st["tick_fallbacks"] <= 0 or \
            st["tick_compiled_hits"] != 0 or tick.fallback_reason is None \
            or tick.steps:
        raise AssertionError(f"[{tag}] (c) warnings "
                             f"{[str(w.message) for w in warned]}, "
                             f"fallbacks {st['tick_fallbacks']}, hits "
                             f"{st['tick_compiled_hits']}")
    for a, b in zip(off, on):
        if b.finish_reason != "length" or \
                not np.array_equal(a.output_ids, b.output_ids):
            raise AssertionError(f"[{tag}] (c) {b.output_ids} "
                                 f"({b.finish_reason}) != flag off "
                                 f"{a.output_ids}")
    if abs(mem_on - mem_off) > FALLBACK_MEM_SLACK or ws_off <= 0 or \
            ws_on - ws_off > ws_off:
        raise AssertionError(f"[{tag}] (c) memory after the fallback run "
                             f"{mem_on} B above the model's start (cuBLAS "
                             f"workspaces {ws_on} B) against the flag-off "
                             f"run's {mem_off} B (workspaces {ws_off} B)")
    log(f"[{tag}] (c) a decode forward that reads the host "
        f"({model.reads} reads): one TickFallbackWarning "
        f"({str(warned[0].message)[:110]}...), {st['tick_fallbacks']} "
        f"fallbacks, 0 compiled ticks, {len(on)} requests complete with the "
        f"flag-off lane's tokens; memory allocated after the run above the "
        f"model's start {mem_on} B against {mem_off} B flag off "
        f"({mem_on - mem_off:+d} B, limit {FALLBACK_MEM_SLACK} B), cuBLAS "
        f"workspaces {ws_on} B against {ws_off} B flag off")


def tracing_overhead(tag, model, dev, prompts, trace_dir, pairs=2):
    """The serve prompts cut to their first 64 tokens, all greedy (every
    tick the greedy graph: the serve traffic's two seeded requests make
    its decode times a mixture of the greedy and the mixed replay), in
    ``pairs`` pairs of lanes with tracing off and on, the order turning
    each pair (off, on, on, off, ...): each lane's decode ms/step p50 and
    avg, and on - off."""
    prompts = [p[:64] for p in prompts]
    greedy = [SamplingParams()] * len(prompts)
    lanes = []
    for rep in range(pairs):
        for on in ((False, True) if rep % 2 == 0 else (True, False)):
            tracing.reset()
            port_flags.set_flags({
                "FLAGS_trace_dir": trace_dir if on else "",
                "FLAGS_trace_latency_threshold_ms": 0.0})
            try:
                st = serve_run(model, dev, serve_cfg(), prompts, greedy)[1]
            finally:
                port_flags.set_flags({
                    "FLAGS_trace_dir": "",
                    "FLAGS_trace_latency_threshold_ms": 250.0})
            if st["trace_spans"] != (4 * len(prompts) if on else 0):
                raise AssertionError(f"[{tag}] tracing {on}: "
                                     f"{st['trace_spans']} spans")
            lanes.append((on, st["decode_ms_p50"], st["decode_ms_avg"]))
    tracing.reset()
    p50 = {on: np.mean([p for o, p, _ in lanes if o == on])
           for on in (False, True)}
    order = "/".join("on" if o else "off" for o, _, _ in lanes)
    log(f"[{tag}] (a) tracing's cost, the serve prompts' first 64 tokens, "
        f"all greedy, lanes {order}: decode ms/step p50 {[round(p, 3) for _, p, _ in lanes]} (avg "
        f"{[round(a, 3) for _, _, a in lanes]}); on - off "
        f"{p50[True] - p50[False]:+.3f} ms "
        f"({100 * (p50[True] - p50[False]) / p50[False]:+.2f}%)")


def phase_serve_telemetry(dev, model, plain=None, serve_st=None,
                          margins=None):
    """The serve phase's model and traffic with request tracing on: (a)
    every request's trace, trace_analyze --strict, the merged chrome
    trace, the tokens against the serve phase's under the tie rule, every
    decode step a compiled tick; (b) the exposition and the exporter's
    snapshots through check_telemetry; (c) the tick's fallback."""
    tag = "serve-telemetry"
    cfg = model.config
    prompts, sampling = serve_requests(cfg.vocab_size)
    if plain is None or serve_st is None:
        plain, serve_st = serve_run(model, dev, serve_cfg(), prompts,
                                    sampling)[:2]
    root = tempfile.mkdtemp(prefix="serve-telemetry-")
    trace_dir = os.path.join(root, "traces")
    snap_path = os.path.join(root, "metrics.jsonl")
    tracing.reset()
    port_flags.set_flags({"FLAGS_trace_dir": trace_dir,
                          "FLAGS_trace_latency_threshold_ms": 0.0,
                          "FLAGS_metrics_export_path": snap_path})
    try:
        outs, st, counts, wall, peak_gb, eng = serve_run(
            model, dev, serve_cfg(), prompts, sampling)
    finally:
        port_flags.set_flags({"FLAGS_trace_dir": "",
                              "FLAGS_trace_latency_threshold_ms": 250.0,
                              "FLAGS_metrics_export_path": ""})
        exporter.stop_exporter()        # its last snapshot
    # (a) the traces
    merged = tracing.merge_spools(trace_dir)
    check_traces(tag, merged, len(prompts))
    merged_path = tracing.write_merged(merged, os.path.join(root,
                                                            "merged.json"))
    report_path = os.path.join(root, "report.json")
    ana = subprocess.run([sys.executable, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tools", "trace_analyze.py"),
        "--trace-dir", trace_dir, "--strict", "--out", report_path],
        capture_output=True, text=True, timeout=120)
    if ana.returncode != 0:
        raise AssertionError(f"[{tag}] trace_analyze --strict: "
                             f"{ana.stdout}{ana.stderr}")
    run_check_telemetry(tag, "--trace", merged_path, "--trace-report",
                        report_path)
    chrome = tracing.export_chrome(merged, os.path.join(root, "chrome.json"))
    with open(chrome) as f:
        events = json.load(f)["traceEvents"]
    spans = {s["span"]: s for tr in merged["traces"] for s in tr["spans"]}
    cross = sum(1 for s in spans.values() if s["parent"] in spans and
                (spans[s["parent"]]["proc"], spans[s["parent"]]["pid"])
                != (s["proc"], s["pid"]))
    flows = sum(1 for e in events if e["ph"] == "s")
    boxes = sum(1 for e in events if e["ph"] == "X")
    if flows != cross or boxes != len(spans):
        raise AssertionError(f"[{tag}] chrome trace: {boxes} spans of "
                             f"{len(spans)}, {flows} flows for {cross} "
                             "cross-process parents")
    greedy = [o if sampling[i].greedy else None for i, o in enumerate(outs)]
    if any(o is not None and not np.array_equal(o.output_ids,
                                                plain[i].output_ids)
           for i, o in enumerate(greedy)):
        tau, have = tie_margin(tag, model, prompts, plain, "bfloat16",
                               ("traced tick", dict(rows=4)))
        check_ties(tag, "traced", plain, greedy, plain_margins(
            model, prompts, plain, [greedy], "bfloat16",
            {**have, **(margins or {})}), tau)
        same = "the serve phase's under the tie rule"
    else:
        same = "the serve phase's exactly"
    spool_bytes = sum(os.path.getsize(os.path.join(trace_dir, f))
                      for f in os.listdir(trace_dir))
    log(f"[{tag}] (a) the serve traffic traced (threshold 0: every trace "
        f"kept) in {wall:.2f} s: {fmt_decode(st)}; tracing off (serve) "
        f"{serve_st['decode_ms_p50']:.2f} ms/step p50; TTFT p50 "
        f"{st['ttft_ms_p50']:.1f} ms; {st['trace_spans']} spans, "
        f"{st['trace_decisions_kept']} of "
        f"{st['trace_decisions']} decisions kept, {st['trace_spools']} "
        f"spool(s), {spool_bytes} spool bytes; every trace one root, its "
        f"queue, prefill and decode spans, one decision, one winner; "
        f"trace_analyze --strict: {ana.stdout.strip().splitlines()[0]}; "
        f"chrome trace {boxes} spans, {flows} flows ({cross} cross-process "
        f"parents); greedy tokens equal {same}; compiled ticks "
        f"{st['tick_compiled_hits']} of {st['decode_steps']} decode steps; "
        f"launches rms_norm {counts['rms_norm']}, paged_decode "
        f"{counts['paged_decode']}; peak {peak_gb:.2f} GB")
    # (b) the exposition and the exporter's snapshots
    check_exposition(tag, TELEMETRY_SERIES, "--serving-tick")
    snaps = run_check_telemetry(tag, "--snapshots", snap_path)
    log(f"[{tag}] (b) exporter snapshots of the run: "
        f"{snaps.strip().splitlines()[0]}")
    tracing_overhead(tag, model, dev, prompts, os.path.join(root, "ab"))
    shutil.rmtree(root, ignore_errors=True)
    # (c) the tick's fallback
    tick_fallback_drill(tag, dev, prompts[:2])


# ----------------------------------------------------------- serve-fleet
#: the int8 lane's and the drills' depth (2 of Llama-2 7B's 32 layers)
FLEET_LAYERS = 2
#: the drills' requests: the first 48 tokens of the int8 lane's prompts,
#: then 900 new tokens, so that every request is still decoding on a
#: 2-layer replica when a drill lands (a SIGTERM is seen within 0.25 s)
DRILL_PROMPT, DRILL_NEW = 48, 900


def fleet_factory(dev, dtype, layers=None):
    """The replicas' model factory: a picklable partial of the port's
    class, so each spawned replica builds the model itself on the card
    from seed 0 (this script is the spawned processes' main module, but
    the factory needs nothing of it)."""
    kw = {} if layers is None else {"num_layers": layers}
    return functools.partial(LlamaForCausalLM, llama_config("llama2-7b", **kw),
                             device=str(dev), dtype=dtype, seed=0)


def tensor_digest(t, chunk=1 << 22):
    """``t``'s sum and sum of squares in fp64 (a device tensor), taken in
    chunks of ``chunk`` elements, so its fp64 copies stay small beside the
    replica's peak memory."""
    acc = torch.zeros(2, dtype=torch.float64, device=t.device)
    for c in t.detach().reshape(-1).split(chunk):
        c = c.double()
        acc += torch.stack([c.sum(), c.square().sum()])
    return acc


def weights_digest(model, chunk=1 << 22):
    """Each parameter's `tensor_digest`, read in one transfer: the
    checksum two processes compare before any token."""
    with torch.no_grad():
        return torch.stack([tensor_digest(p, chunk)
                            for p in model.parameters()]).cpu().tolist()


def tp_fleet_model(dtype, layers):
    """(g)'s model factory (top-level: a spawned replica imports this
    script as its main module): Llama-2 7B width at ``layers`` layers as
    `ParallelLlamaForCausalLM` from seed 0 on the card, each rank its part
    of the global draw.  ``gathered_digest`` is the global weights'
    digest, each parameter gathered over mp as it is built (at mp 1 the
    whole model's): equal digests mean the ranks hold one model."""
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.models import ParallelLlamaForCausalLM
    model = ParallelLlamaForCausalLM(
        llama_config("llama2-7b", num_layers=layers), device="cuda",
        dtype=dtype, seed=0)
    splits = convert._splits(model)
    with torch.no_grad():
        model.gathered_digest = torch.stack([
            tensor_digest(convert._gather_part(p, splits.get(n)))
            for n, p in model.named_parameters()]).cpu().tolist()
    return model


def _pages_digest(parts):
    h = hashlib.sha256()
    for t in parts:
        if t is not None:
            h.update(t.contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def log_pages(eng):
    """From now on, hash every slot's pages the engine's cache exports
    (the bytes of the sender's pool rows) and, after each adoption, the
    adopted pages read back from the receiver's pools: equal hashes mean
    equal bytes."""
    cache, log_ = eng.cache, []
    export, adopt = cache.export_pages, cache.adopt_pages

    def export_pages(slot):
        out = export(slot)
        log_.append(("sent", _pages_digest(out[1:])))
        return out

    def adopt_pages(*a, **kw):
        slot = adopt(*a, **kw)
        if slot is not None:
            log_.append(("adopted", _pages_digest(export(slot)[1:])))
        return slot
    cache.export_pages, cache.adopt_pages = export_pages, adopt_pages
    eng.page_log = log_


def fleet_probe(name, op="read", arg=None):
    """An rpc target run inside replica ``name``'s process: ``"reset"``
    zeroes the kernels' launch counts and the exact histograms (installing
    `SERVE_RECORD` there), ``"digest"`` returns `weights_digest`,
    ``"pages"`` starts `log_pages`, ``"flags"`` sets flags, ``"cached"``
    whether the prefix tree holds ``arg``'s full pages (read-only),
    ``"read"`` returns what the phase checks."""
    from paddle_tpu_torch.distributed import collective
    from paddle_tpu_torch.serving import fleet as sfleet
    from paddle_tpu_torch.serving import tp_replica
    eng = sfleet._REPLICAS[name].engine
    SERVE_RECORD.install()
    if op == "reset":
        SERVE_RECORD.hists = {}
        kernels.reset_launch_counts()
        if eng.mirror is not None:
            eng.mirror.send_ms.clear()
        return None
    if op == "digest":
        return weights_digest(eng.model)
    if op == "gdigest":
        return eng.model.gathered_digest
    if op == "pages":
        return log_pages(eng)
    if op == "flags":
        return port_flags.set_flags(arg)
    if op == "cached":
        tree, node = eng.prefix_tree, None
        with eng._lock:
            node = tree.root
            for i in range(len(arg) // tree.page_size):
                node = node.children.get(tree._page_key(arg, i))
                if node is None:
                    return False
        return True
    hists = {k: list(v) for k, v in SERVE_RECORD.hists.items()}
    return {"counts": kernels.launch_counts(), "stats": dict(eng.stats()),
            "hists": hists, "graphs": eng._tick.graph_stats()
            if eng._tick is not None else {},
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9
            if torch.cuda.is_available() else 0.0,
            "pages_in_use": eng.cache.pages_in_use,
            "free_slots": eng.cache.free_slots,
            "num_slots": eng.cache.num_slots,
            "tree_pages": eng.prefix_tree.cached_pages()
            if eng.prefix_tree is not None else 0,
            "active": len(eng._active), "pending": len(eng._pending),
            "page_log": list(getattr(eng, "page_log", ())),
            "collectives": collective.counts(),
            "graph_collectives": eng._tick.graph_collectives()
            if eng._tick is not None else {},
            "descriptors": None if eng.mirror is None else eng.mirror.seq,
            "send_ms": [] if eng.mirror is None else list(eng.mirror.send_ms),
            "follower": None if eng.mirror is None else (tp_replica.peer_stats(
                sfleet._REPLICAS[name].store, eng.mirror.ctx.key, 1)
                or {}).get("stats")}


def probe(names, op="read", arg=None):
    from paddle_tpu_torch.distributed import rpc
    return {n: rpc.rpc_sync(n, fleet_probe, args=(n, op, arg), timeout=120)
            for n in names}


def fleet_reference(dev, model, plain=None):
    """What the fleet's 7B tokens are held to, as host data kept after the
    model is freed: the serve phase's single-engine outputs (run here when
    the serve phase did not), the tie margin tau (the largest shift of a
    top gap from the plain step at batch 1 to batch 4, teacher-forced),
    each greedy request's top-two margins over its tokens, and the
    weights' digest."""
    tag = "serve-fleet"
    prompts, sampling = serve_requests(model.config.vocab_size)
    if plain is None:
        plain = serve_run(model, dev, serve_cfg(), prompts, sampling)[0]
    # the replicas run the serve phase's shapes: a [4, 32] prefill chunk
    # call and a 4-slot tick, so the one route is the batch-4 step
    tau, have = tie_margin(tag, model, prompts, plain, "bfloat16",
                           ("batch 4", dict(rows=4)))
    margins = {i: have[i] if i in have else margins_of(replay_logits(
        model, prompts[i], plain[i].output_ids, "bfloat16"))
        for i, s in enumerate(sampling) if s.greedy}
    return {"plain": [types.SimpleNamespace(output_ids=o.output_ids.copy())
                      for o in plain],
            "tau": tau, "margins": margins, "digest": weights_digest(model)}


def replica_cfg(ttl, tp=1):
    return ReplicaConfig(heartbeat_interval_s=0.5, heartbeat_ttl_s=ttl,
                         tensor_parallel_degree=tp)


def start_fleet(factory, roles, scfg, warmup=None, ttl=10.0, tps=None):
    """A `ServingFleet` of ``roles`` (tensor-parallel degrees ``tps``, one
    a replica; None: 1 each) behind a disaggregating router (leases of
    ``ttl`` s); returns it and the seconds from spawn to every replica
    ``ready``."""
    fleet = ServingFleet(
        factory, len(roles), scfg, replica_cfg(ttl),
        RouterConfig(heartbeat_ttl_s=ttl, poll_interval_s=0.1,
                     disaggregation=True, rpc_timeout_s=600.0,
                     request_timeout_s=600.0),
        warmup_prompt=warmup, roles=roles,
        replica_configs=None if tps is None
        else [replica_cfg(ttl, t) for t in tps])
    t0 = time.monotonic()
    try:
        fleet.start(warmup_timeout_s=600)
    except BaseException:
        fleet.shutdown()
        raise
    return fleet, time.monotonic() - t0


def check_digests(tag, digests, want=None):
    vals = list(digests.values()) + ([want] if want is not None else [])
    if any(v != vals[0] for v in vals):
        diff = max(abs(x - y) for v in vals for a, b in zip(v, vals[0])
                   for x, y in zip(a, b))
        raise AssertionError(f"[{tag}] the replicas' weights differ: {diff}")


def pct(vals, q):
    return float(np.percentile(np.asarray(vals, np.float64), q)) \
        if len(vals) else float("nan")


def fleet_main_path(tag, dev, ref):
    """(a) Llama-2 7B, bf16, 4 slots, context 1024, the tick on: prefill
    replica-0 → decode replica-1 over the serve traffic."""
    cfg = llama_config("llama2-7b")
    prompts, sampling = serve_requests(cfg.vocab_size)
    warm = np.arange(1, 40, dtype=np.int32)
    fleet, start_s = start_fleet(fleet_factory(dev, torch.bfloat16),
                                 ["prefill", "decode"], serve_cfg(), warm)
    names = ["replica-0", "replica-1"]
    try:
        check_digests(tag, probe(names, "digest"), ref["digest"])
        # both tick modes captured on the decode replica before the counts
        # start: a greedy and a seeded, penalised request migrate there
        for sp in (SamplingParams(), SamplingParams(
                temperature=1.0, top_p=0.9, repetition_penalty=1.1, seed=1)):
            fleet.generate(warm, max_new_tokens=4, sampling=sp, timeout=600)
        probe(names, "reset")
        before = probe(names)
        # request 5 once request 2's prompt pages are in the prefill
        # replica's tree: that replica frees a slot as soon as a prompt's
        # pages have moved (not after its 32 tokens, as the single engine
        # does), so it could admit request 5 before request 2's prefill ends
        t0 = time.monotonic()
        futs = {i: fleet.submit(prompts[i], max_new_tokens=32,
                                sampling=sampling[i])
                for i in range(len(prompts)) if i != 5}
        wait_for(tag, "request 2's prompt pages in the prefill replica's "
                 "tree", lambda: probe(["replica-0"], "cached",
                                       prompts[2][:64])["replica-0"],
                 timeout=600)
        futs[5] = fleet.submit(prompts[5], max_new_tokens=32,
                               sampling=sampling[5])
        outs = [futs[i].result(timeout=600) for i in range(len(prompts))]
        wall = time.monotonic() - t0
        after = probe(names)
        route = list(SERVE_RECORD.hists.get("router.route_latency_ms",
                                            ()))[-len(prompts):]
    finally:
        fleet.shutdown()
    p, d = after["replica-0"], after["replica-1"]
    dp = {k: d["stats"][k] - before["replica-1"]["stats"][k]
          for k in ("decode_steps", "tick_compiled_hits", "prefill_chunks")}
    pp = {k: p["stats"][k] - before["replica-0"]["stats"][k]
          for k in ("migration_fallbacks", "migrations", "prefix_cache_hits",
                    "migration_pages_sent", "prefill_chunks")}
    replays = {m: (g[0] - before["replica-1"]["graphs"].get(m, (0, 0))[0],
                   g[1] - before["replica-1"]["graphs"].get(m, (0, 0))[1],
                   g[2]) for m, g in d["graphs"].items()}
    bad = [o.request_id for o in outs if o.decoded_by != "replica-1"]
    if bad or pp["migration_fallbacks"] or pp["migrations"] != 8:
        raise AssertionError(f"[{tag}] (a) requests {bad} not decoded by "
                             f"replica-1; {pp}")
    if p["counts"]["paged_decode"]:
        raise AssertionError(f"[{tag}] (a) the prefill replica launched "
                             f"{p['counts']['paged_decode']} paged decodes")
    if not (dp["tick_compiled_hits"] == dp["decode_steps"] > 0) or \
            dp["prefill_chunks"]:
        raise AssertionError(f"[{tag}] (a) decode replica {dp}")
    need = {k: sum(r * launches.get(k, 0) for _, r, launches
                   in replays.values()) for k in ("paged_decode", "rms_norm")}
    if any(c for c, _, _ in replays.values()) or \
            need["paged_decode"] != cfg.num_layers * sum(
                r for _, r, _ in replays.values()) or \
            {k: d["counts"][k] for k in need} != need:
        raise AssertionError(f"[{tag}] (a) decode replica launches "
                             f"{d['counts']} for replays {replays}")
    if pp["prefix_cache_hits"] < 1:
        raise AssertionError(f"[{tag}] (a) no prefix hit on the prefill "
                             "replica")
    # every slot free and every page back: in the free list or held by a
    # prefix tree (the prefill replica's prompts; the decode replica's own
    # warm-up prompt: adopted pages never enter a tree)
    for r in (p, d):
        if r["free_slots"] != r["num_slots"] or r["active"] or \
                r["pages_in_use"] != r["tree_pages"]:
            raise AssertionError(f"[{tag}] (a) pages left: prefill "
                                 f"{p['pages_in_use']} (tree "
                                 f"{p['tree_pages']}), decode "
                                 f"{d['pages_in_use']} (tree "
                                 f"{d['tree_pages']})")
    greedy = [o if sampling[i].greedy else None for i, o in enumerate(outs)]
    check_ties(tag, "(a) fleet", ref["plain"], greedy, ref["margins"],
               ref["tau"])
    for i, o in enumerate(outs):
        if o.output_ids.size != 32 or not (
                (o.output_ids >= 0) & (o.output_ids < cfg.vocab_size)).all():
            raise AssertionError(f"[{tag}] (a) request {i}: {o.output_ids}")
    mig = p["hists"].get("migration.migrate_ms", [])
    dec = d["hists"].get("decode_ms", [])
    # a bf16 page: K and V of 16 tokens in every layer
    page_bytes = cfg.num_layers * 2 * 16 * cfg.num_kv_heads * \
        cfg.head_dim * 2
    ttft = [o.ttft_ms for o in outs]
    log(f"[{tag}] (a) Llama-2 7B bf16 prefill replica-0 -> decode "
        f"replica-1 (4 slots each, context 1024, one card, two processes): "
        f"fleet start (spawn -> both ready, warm-up included) {start_s:.1f} "
        f"s; 8 requests in {wall:.2f} s; {pp['migrations']} migrations, "
        f"{pp['migration_pages_sent']} pages, "
        f"{pp['migration_pages_sent'] * page_bytes / 1e9:.3f} GB sent; "
        f"migrate_ms p50 {pct(mig, 50):.1f} max {max(mig):.1f} ("
        f"{pp['migration_pages_sent'] * page_bytes / sum(mig) / 1e6:.3f} "
        f"GB/s over the transfers' sum); TTFT p50 at "
        f"the router {pct(ttft, 50):.1f} ms (the prefill replica's first "
        f"token); router route latency p50 {pct(route, 50):.1f} ms; decode "
        f"replica {pct(dec, 50):.2f} ms/step p50, {pct(dec, 99):.2f} p99 "
        f"over {dp['decode_steps']} steps (time-sliced with the prefill "
        f"replica's work); fallbacks 0; prefix hits "
        f"{pp['prefix_cache_hits']} (prefill replica; its tree keeps "
        f"{p['tree_pages']} pages); peak memory prefill {p['peak_gb']:.2f}"
        f" GB, decode {d['peak_gb']:.2f} GB")
    log(f"[{tag}] (a) decode replica: compiled ticks "
        f"{dp['tick_compiled_hits']} of {dp['decode_steps']} decode steps, "
        f"graphs (captures, replays, launches a replay) during the traffic "
        f"{replays}, launches {({k: d['counts'][k] for k in need})} = "
        f"{need}; prefill replica: paged_decode 0, rms_norm "
        f"{p['counts']['rms_norm']} over {pp['prefill_chunks']} chunk rows;"
        f" every slot free, every page back (in use only the trees' pages: "
        f"prefill {p['tree_pages']}, decode {d['tree_pages']} of its own "
        f"warm-up)")
    return {"paged_decode": d["counts"]["paged_decode"],
            "rms_norm": d["counts"]["rms_norm"] + p["counts"]["rms_norm"]}


def fleet_int8_reference(tag, dev, prompts, sampling, max_new):
    """The 2-layer fp32 model behind one int8 engine: ({max_new: the
    tokens the int8 fleet must equal bit for bit}, the weights' digest)."""
    model = fleet_factory(dev, torch.float32, FLEET_LAYERS)()
    digest = weights_digest(model)
    with Engine(model, ServingConfig(num_slots=4, max_seq_len=SERVE_LEN,
                                     cache_dtype="int8")) as eng:
        futs = [eng.submit(p, max_new_tokens=max_new, sampling=s)
                for p, s in zip(prompts, sampling)]
        outs = {max_new: [f.result(timeout=600).output_ids for f in futs]}
    del model
    torch.cuda.empty_cache()
    return outs, digest


def wait_for(tag, what, cond, timeout=120.0):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"[{tag}] timed out waiting for {what}")
        time.sleep(0.02)


def fleet_drills(tag, dev):
    """(b) int8 pools at 2 layers in fp32, (d) traced, then (c) the
    drills, on one fleet: prefill replica-0, decode replicas 1 and 2."""
    prompts, sampling = serve_requests(llama_config("llama2-7b").vocab_size)
    prompts, sampling = prompts[:4], sampling[:4]
    drill = [p[:DRILL_PROMPT] for p in prompts]
    ref, digest = fleet_int8_reference(tag, dev, prompts, sampling, 32)
    ref[DRILL_NEW] = fleet_int8_reference(tag, dev, drill, sampling,
                                          DRILL_NEW)[0][DRILL_NEW]
    root = tempfile.mkdtemp(prefix="serve-fleet-")
    trace_dir = os.path.join(root, "traces")
    env = {"FLAGS_trace_dir": trace_dir,
           "FLAGS_trace_latency_threshold_ms": "0"}
    tracing.reset()
    port_flags.set_flags({"FLAGS_trace_dir": trace_dir,
                          "FLAGS_trace_latency_threshold_ms": 0.0})
    os.environ.update(env)              # the replicas read it at import
    try:
        fleet, start_s = start_fleet(
            fleet_factory(dev, torch.float32, FLEET_LAYERS),
            ["prefill", "decode", "decode"],
            ServingConfig(num_slots=4, max_seq_len=SERVE_LEN,
                          cache_dtype="int8"), ttl=3.0)
    finally:
        for k in env:
            os.environ.pop(k, None)
    names = ["replica-0", "replica-1", "replica-2"]
    try:
        check_digests(tag, probe(names, "digest"), digest)
        probe(names, "pages")
        # (b) + (d)
        futs = [fleet.submit(p, max_new_tokens=32, sampling=s)
                for p, s in zip(prompts, sampling)]
        outs = [f.result(timeout=600) for f in futs]
        for i, (o, want) in enumerate(zip(outs, ref[32])):
            if not np.array_equal(o.output_ids, want) or \
                    o.decoded_by not in names[1:]:
                raise AssertionError(f"[{tag}] (b) request {i} by "
                                     f"{o.decoded_by}: {o.output_ids} != "
                                     f"{want}")
        st = probe(names)
        sent = [h for n in names for k, h in st[n]["page_log"]
                if k == "sent"]
        adopted = [h for n in names for k, h in st[n]["page_log"]
                   if k == "adopted"]
        if len(sent) != 4 or sorted(sent) != sorted(adopted):
            raise AssertionError(f"[{tag}] (b) pages sent {sent} != adopted "
                                 f"{adopted}")
        log(f"[{tag}] (b) int8 pools, 2 layers at 7B width, fp32 (prefill "
            f"replica-0, decode replicas 1 and 2; start {start_s:.1f} s): "
            f"requests 0-3's tokens equal one int8 engine's bit for bit, "
            f"decoded by {[o.decoded_by for o in outs]}; the adopted pages "
            f"and scales read back from the receivers' pools hash equal to "
            f"the sender's exported rows ({len(sent)} of {len(sent)})")
        fleet.collect_traces(out_path=os.path.join(root, "merged.json"))
        probe(names, "flags", {"FLAGS_trace_dir": ""})
        port_flags.set_flags({"FLAGS_trace_dir": "",
                              "FLAGS_trace_latency_threshold_ms": 250.0})
        check_fleet_traces(tag, root, len(prompts))
        # (c2) drain of a decode replica mid-decode: its slots go to the
        # other decode replica (the drain's peer pick ranks decode first)
        base = fleet.stats()
        r = probe(names)
        resumed0 = {n: r[n]["stats"]["migration_resumed_requests"]
                    for n in names}
        futs = [fleet.submit(p, max_new_tokens=DRILL_NEW, sampling=s)
                for p, s in zip(drill, sampling)]

        def adopted():
            r.update(probe(names[1:]))
            return sum(r[n]["stats"]["migration_resumed_requests"]
                       - resumed0[n] for n in names[1:]) == 4
        wait_for(tag, "the 4 requests adopted by the decode replicas",
                 adopted)
        drained = max(names[1:], key=lambda n: r[n]["active"])
        survivor = next(n for n in names[1:] if n != drained)
        r = probe(names)
        chunks = r["replica-0"]["stats"]["prefill_chunks"]
        resumed = r[survivor]["stats"]["migration_resumed_requests"]
        in_flight = r[drained]["active"]
        proc = fleet._procs[drained]
        fleet.drain_replica(drained)
        outs = [f.result(timeout=600) for f in futs]
        proc.join(120)
        check_drill(tag, "(c2) drain", outs, ref[DRILL_NEW])
        after = fleet.stats()
        # a request's decoded_by names the replica that adopted it from
        # the prefill replica; the drained slots' second hop shows in the
        # survivor's resumed requests
        r = probe(["replica-0", survivor])
        moved = r[survivor]["stats"]["migration_resumed_requests"] - resumed
        if r["replica-0"]["stats"]["prefill_chunks"] != chunks or \
                not 0 < moved == in_flight or proc.exitcode != 0 or \
                after["router_resubmissions"] != base["router_resubmissions"]:
            raise AssertionError(
                f"[{tag}] (c2) prefill chunks {chunks} -> "
                f"{r['replica-0']['stats']['prefill_chunks']}, {moved} of "
                f"{in_flight} slots moved, resubmissions "
                f"{after['router_resubmissions']}, exit {proc.exitcode}")
        log(f"[{tag}] (c2) drain of {drained} with {in_flight} requests "
            f"decoding: all {moved} migrated to {survivor} and finished "
            f"there, tokens equal the int8 engine's; no request lost or "
            f"resubmitted, no prompt prefilled again (replica-0's prefill "
            f"chunk rows {chunks} before and after); {drained} exited 0")
        # (c1) SIGKILL of the other decode replica mid-decode
        base = fleet.stats()
        resumed = probe([survivor])[survivor]["stats"][
            "migration_resumed_requests"]
        futs = [fleet.submit(p, max_new_tokens=DRILL_NEW, sampling=s)
                for p, s in zip(drill, sampling)]

        def holds_all():
            r = probe([survivor])[survivor]
            return r["stats"]["migration_resumed_requests"] - resumed == 4
        wait_for(tag, f"the 4 requests adopted by {survivor}", holds_all)
        busy = probe([survivor])[survivor]["active"]
        fleet.kill_replica(survivor)
        outs = [f.result(timeout=600) for f in futs]
        check_drill(tag, "(c1) kill", outs, ref[DRILL_NEW])
        after = fleet.stats()
        log(f"[{tag}] (c1) SIGKILL of {survivor} with {busy} requests "
            f"decoding: every request recovered, tokens equal the int8 "
            f"engine's; decoded by {[o.decoded_by for o in outs]}; router "
            f"failovers {after['router_failovers'] - base['router_failovers']}"
            f", resubmissions "
            f"{after['router_resubmissions'] - base['router_resubmissions']}")
        # (c3) a role flip
        gen0 = fleet.replica_states(detail=True)["replica-0"]["gen"]
        t0 = time.monotonic()
        fleet.flip_role("replica-0", "decode", warmup_timeout_s=300)
        flip_s = time.monotonic() - t0
        info = fleet.replica_states(detail=True)["replica-0"]
        wait_for(tag, "the flipped replica in the ring",
                 lambda: "replica-0" in fleet.router.ring.members)
        out = fleet.generate(prompts[0], max_new_tokens=32,
                             sampling=sampling[0], timeout=600)
        if info["gen"] <= gen0 or info["role"] != "decode" or \
                not np.array_equal(out.output_ids, ref[32][0]):
            raise AssertionError(f"[{tag}] (c3) after the flip {info} "
                                 f"(generation was {gen0}): {out}")
        log(f"[{tag}] (c3) flip_role replica-0 prefill -> decode in "
            f"{flip_s:.1f} s: rejoined as {info['role']} at generation "
            f"{info['gen']} (was {gen0}), serves request 0 with the same "
            "tokens")
    finally:
        port_flags.set_flags({"FLAGS_trace_dir": "",
                              "FLAGS_trace_latency_threshold_ms": 250.0})
        tracing.reset()
        fleet.shutdown()
        shutil.rmtree(root, ignore_errors=True)


def check_drill(tag, what, outs, want):
    for i, (o, w) in enumerate(zip(outs, want)):
        if not np.array_equal(o.output_ids, w):
            raise AssertionError(f"[{tag}] {what}: request {i} by "
                                 f"{o.decoded_by}: {o.output_ids} != {w}")


def check_fleet_traces(tag, root, n):
    """(d) The merged spools of the router's and the replicas'
    processes: each routed request one trace across three processes
    (the router's root, the prefill replica's engine.request with its
    prefill and engine.migrate spans, the decode replica's resumed
    engine.request with its decode); trace_analyze --strict and
    check_telemetry on it."""
    merged_path = os.path.join(root, "merged.json")
    with open(merged_path) as f:
        traces = json.load(f)["traces"]
    routed = [tr for tr in traces if any(
        s["name"].startswith("router.") and s["parent"] is None
        for s in tr.get("spans") or [])]
    if len(routed) != n:
        raise AssertionError(f"[{tag}] (d) {len(routed)} routed traces for "
                             f"{n} requests")
    for tr in routed:
        spans = tr["spans"]
        names = {s["name"] for s in spans}
        procs = {s["proc"] for s in spans}
        resumed = [s for s in spans if s["name"] == "engine.request"
                   and (s.get("attrs") or {}).get("resumed")]
        if tr["decision_count"] != 1 or len(procs) != 3 or len(resumed) != 1 \
                or not {"engine.prefill", "engine.migrate",
                        "engine.decode"} <= names:
            raise AssertionError(f"[{tag}] (d) trace {tr['trace_id']}: "
                                 f"{sorted((s['name'], s['proc']) for s in spans)}")
        mig = [s for s in spans if s["name"] == "engine.migrate"]
        if resumed[0]["parent"] != mig[0]["span"]:
            raise AssertionError(f"[{tag}] (d) the resumed request's parent "
                                 "is not the transfer span")
    report = os.path.join(root, "report.json")
    ana = subprocess.run([sys.executable, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tools", "trace_analyze.py"),
        "--trace", merged_path, "--strict", "--out", report],
        capture_output=True, text=True, timeout=120)
    if ana.returncode != 0:
        raise AssertionError(f"[{tag}] (d) trace_analyze --strict: "
                             f"{ana.stdout}{ana.stderr}")
    run_check_telemetry(tag, "--trace", merged_path, "--trace-report", report)
    log(f"[{tag}] (d) {n} routed requests, each one trace over "
        f"{len({s['proc'] for tr in routed for s in tr['spans']})} processes"
        f" (router root -> prefill -> engine.migrate -> the resumed "
        f"request's decode), one decision each; trace_analyze --strict: "
        f"{ana.stdout.strip().splitlines()[0]}; check_telemetry passed")


#: (g)'s drain and kill requests: the drill prompts, this many new tokens
TP_DRILL_NEW = 256


def smi_card():
    """The card's name and power limit as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def graph_delta(after, before):
    """{mode: replays since ``before``} of a rank's tick graphs (a
    `CompiledServingTick.graph_stats` as the probe or the beat reads it:
    mode -> (captures, replays, launches))."""
    return {m: g[1] - (before or {}).get(m, (0, 0, {}))[1]
            for m, g in (after or {}).items()}


def per_step_traffic(after, before, replays, graph_coll, steps):
    """{op: (calls, bytes) a decode step}: the eager collectives counted
    between ``before`` and ``after`` plus each graph's collectives a
    replay times its replays, over ``steps``."""
    out = {}
    for op, (c, b) in (after or {}).items():
        c0, b0 = (before or {}).get(op, (0, 0))
        out[op] = [c - c0, b - b0]
    for mode, n in replays.items():
        for op, (c, b) in (graph_coll or {}).get(mode, {}).items():
            acc = out.setdefault(op, [0, 0])
            acc[0] += n * c
            acc[1] += n * b
    return {op: (c / steps, b / steps) for op, (c, b) in out.items() if c}


def fmt_traffic(t):
    return ", ".join(f"{op} {c:.2f} calls {b / 1024:.1f} KiB"
                     for op, (c, b) in sorted(t.items()))


def router_idle(fleet):
    """Whether the router's view of every replica shows no queued or
    active request (its least-loaded decode pick then falls to the name
    order)."""
    with fleet.router._lock:
        loads = [v.load for v in fleet.router._replicas.values()]
    return all(ld.get("queue_depth", 0) + ld.get("active_slots", 0) == 0
               for ld in loads)


def synced_follower(name):
    """The leader's probe once its follower's beat has caught up with
    every descriptor the leader sent."""
    deadline = time.monotonic() + 60
    while True:
        r = probe([name])[name]
        fol = r["follower"]
        if fol is not None and fol["calls"] == r["descriptors"]:
            return r
        if time.monotonic() > deadline:
            raise AssertionError(f"[serve-fleet] (g) {name}'s follower ran "
                                 f"{fol and fol['calls']} of "
                                 f"{r['descriptors']} descriptors")
        time.sleep(0.1)


def fleet_tp_drill(tag, dev, ref):
    """(g) A tensor-parallel replica: Llama-2 7B width in bf16 at
    FLEET_LAYERS layers, a tp 1 prefill replica-0 and a tp 2 decode
    replica-1 whose two ranks share the card through NCCL's socket
    transport on ``lo``; the first 4 serve requests, 32 new tokens, the
    tick on.  Checked: the gathered weights' digest equals the tp 1
    replica's and this process's; greedy tokens equal the tp 1 lane's
    (one engine over the same model here) but at near ties (the fleet
    reference's tau); the decode replica's every step a tick replay on
    both ranks, each rank's rms_norm and paged_decode launches; paged
    decode at the local shape (B 4, H = H_kv = 16, D 128, page 16) against
    its plain version.  Then a drain of the tp 2 replica mid-decode onto
    the tp 1 decode replica-2 (its first slot; the others there or on a
    second tp 2 replica-3, as the gossip's loads show), and a SIGKILL of
    replica-3's follower mid-decode once it decodes alone (the four
    replicas start together): nothing lost; the time from the kill to
    the lease lapsing.  Printed: decode ms/step p50 and the collective calls
    and bytes a step a rank, beside the card's name and power limit."""
    cfg = llama_config("llama2-7b", num_layers=FLEET_LAYERS)
    L = cfg.num_layers
    prompts, sampling = serve_requests(cfg.vocab_size)
    prompts, sampling = prompts[:4], sampling[:4]
    drill = [p[:DRILL_PROMPT] for p in prompts]
    factory = functools.partial(tp_fleet_model, torch.bfloat16, FLEET_LAYERS)
    model = factory()                   # mp 1: replica-0's model
    plain = serve_run(model, dev, serve_cfg(), prompts, sampling)[0]
    margins = {i: margins_of(replay_logits(model, prompts[i],
                                           plain[i].output_ids, "bfloat16"))
               for i, s in enumerate(sampling) if s.greedy}
    digest = model.gathered_digest
    del model
    torch.cuda.empty_cache()
    warm = np.arange(1, 40, dtype=np.int32)
    # every replica the drill needs starts at once: the tp 2 decode
    # replica-1, a tp 1 decode replica-2 (the drain's survivor) and a tp 2
    # replica-3 (the follower kill's); with the router's view idle, its
    # least-loaded decode pick falls to the name order, replica-1 first
    fleet, start_s = start_fleet(factory, ["prefill", "decode", "decode",
                                           "decode"], serve_cfg(), warm,
                                 ttl=3.0, tps=[1, 2, 1, 2])
    names = ["replica-0", "replica-1"]
    idle = functools.partial(wait_for, tag, "the router's view idle",
                             lambda: router_idle(fleet))
    try:
        check_digests(tag, probe([f"replica-{i}" for i in range(4)],
                                 "gdigest"), digest)
        for sp in (SamplingParams(), SamplingParams(
                temperature=1.0, top_p=0.9, repetition_penalty=1.1, seed=1)):
            idle()
            fleet.generate(warm, max_new_tokens=4, sampling=sp, timeout=600)
        idle()
        probe(names, "reset")
        before = synced_follower("replica-1")
        t0 = time.monotonic()
        futs = [fleet.submit(p, max_new_tokens=32, sampling=s)
                for p, s in zip(prompts, sampling)]
        outs = [f.result(timeout=600) for f in futs]
        wall = time.monotonic() - t0
        after = synced_follower("replica-1")
        lead0 = probe(["replica-0"])["replica-0"]
        # the drain of the tp 2 replica-1 mid-decode: each slot goes to the
        # decode peer least loaded in the gossip, then by name, so the
        # first to the tp 1 replica-2 and the rest to it or the tp 2
        # replica-3 as their loads show
        decoders = ["replica-1", "replica-2", "replica-3"]
        idle()
        base = fleet.stats()
        r = probe(decoders)
        adopted0 = {n: r[n]["stats"]["migration_resumed_requests"]
                    for n in decoders}
        futs = [fleet.submit(p, max_new_tokens=TP_DRILL_NEW, sampling=s)
                for p, s in zip(drill, sampling)]

        def all_adopted():
            r.update(probe(decoders))
            return sum(r[n]["stats"]["migration_resumed_requests"]
                       - adopted0[n] for n in decoders) == len(drill)
        wait_for(tag, "the drill requests adopted by the decode replicas",
                 all_adopted)
        survivors = ["replica-2", "replica-3"]
        r = probe(["replica-1"] + survivors)
        in_flight = r["replica-1"]["active"]
        resumed0 = {n: r[n]["stats"]["migration_resumed_requests"]
                    for n in survivors}
        ranks = fleet._ranks["replica-1"]
        fleet.drain_replica("replica-1")
        douts = [f.result(timeout=600) for f in futs]
        for p in ranks:
            p.join(120)
        r = probe(survivors)
        moved = {n: r[n]["stats"]["migration_resumed_requests"]
                 - resumed0[n] for n in survivors}
        tp1_dec = r["replica-2"]["hists"].get("decode_ms", [])
        dstats = fleet.stats()
        # replica-3 alone decodes once replica-2 drained; its follower is
        # SIGKILLed mid-decode
        fleet.drain_replica("replica-2")
        fleet._procs["replica-2"].join(120)
        wait_for(tag, "replica-3 alone beside the prefill replica",
                 lambda: sorted(fleet.router.ring.members)
                 == ["replica-0", "replica-3"], timeout=600)
        kbase = fleet.stats()
        adopted0 = probe(["replica-3"])["replica-3"]["stats"][
            "migration_resumed_requests"]
        futs = [fleet.submit(p, max_new_tokens=TP_DRILL_NEW, sampling=s)
                for p, s in zip(drill, sampling)]
        wait_for(tag, "the drill requests adopted by replica-3", lambda:
                 probe(["replica-3"])["replica-3"]["stats"][
                     "migration_resumed_requests"] - adopted0 == len(drill))
        busy = probe(["replica-3"])["replica-3"]["active"]
        t_kill = time.monotonic()
        fleet.kill_replica("replica-3", rank=1)
        wait_for(tag, "replica-3's lease to lapse", lambda: "replica-3"
                 not in fleet.replica_states(), timeout=120)
        lapse_s = time.monotonic() - t_kill
        kouts = [f.result(timeout=600) for f in futs]
        leader3 = fleet._procs["replica-3"]
        leader3.join(60)
        kstats = fleet.stats()
    finally:
        fleet.shutdown()
    d = after
    steps = d["stats"]["decode_steps"] - before["stats"]["decode_steps"]
    hits = d["stats"]["tick_compiled_hits"] - \
        before["stats"]["tick_compiled_hits"]
    bad = [o.request_id for o in outs if o.decoded_by != "replica-1"]
    if bad or not (hits == steps > 0) or \
            d["stats"]["prefill_chunks"] != before["stats"]["prefill_chunks"]:
        raise AssertionError(f"[{tag}] (g) requests {bad} not decoded by the "
                             f"tp 2 replica; ticks {hits} of {steps} steps")
    for i, o in enumerate(outs):
        if o.output_ids.size != 32 or not (
                (o.output_ids >= 0) & (o.output_ids < cfg.vocab_size)).all():
            raise AssertionError(f"[{tag}] (g) request {i}: {o.output_ids}")
    greedy = [o if sampling[i].greedy else None for i, o in enumerate(outs)]
    check_ties(tag, "(g) tp 2 decode replica", plain, greedy, margins,
               ref["tau"])
    # replays on both ranks, and each rank's launches: L paged decodes and
    # 2 L + 1 RMS norms a replay (adopted pages: no prefill here)
    ranks_seen = {"leader": (d["graphs"], before["graphs"], d["counts"],
                             None),
                  "follower": (d["follower"]["graphs"],
                               before["follower"]["graphs"],
                               d["follower"]["launches"],
                               before["follower"]["launches"])}
    replays, launched = {}, {}
    for rank, (g1, g0, c1, c0) in ranks_seen.items():
        replays[rank] = graph_delta(g1, g0)
        n = sum(replays[rank].values())
        launched[rank] = {k: c1.get(k, 0) - (c0 or {}).get(k, 0)
                          for k in ("paged_decode", "rms_norm")}
        want = {"paged_decode": L * n, "rms_norm": (2 * L + 1) * n}
        if n != steps or launched[rank] != want:
            raise AssertionError(f"[{tag}] (g) {rank}: replays "
                                 f"{replays[rank]} for {steps} steps, "
                                 f"launches {launched[rank]} != {want}")
    if replays["leader"] != replays["follower"]:
        raise AssertionError(f"[{tag}] (g) the ranks' replays differ: "
                             f"{replays}")
    gen = torch.Generator(device=dev).manual_seed(21)
    offs = [int(p.size) + 31 for p in prompts]
    err, _ = paged_case(dev, 4, 16, 16, 128, 16, max(offs) // 16 + 1, offs,
                        torch.bfloat16, gen)
    traffic = {
        "leader": per_step_traffic(d["collectives"], before["collectives"],
                                   replays["leader"], d["graph_collectives"],
                                   steps),
        "follower": per_step_traffic(
            d["follower"]["collectives"], before["follower"]["collectives"],
            replays["follower"], d["follower"]["graph_collectives"], steps)}
    dec = d["hists"].get("decode_ms", [])
    send = d["send_ms"]
    pre_launches = {k: lead0["counts"].get(k, 0)
                    for k in ("paged_decode", "rms_norm")}
    card = smi_card()
    log(f"[{tag}] (g) Llama-2 7B width, {L} layers, bf16: prefill replica-0 "
        f"(tp 1) -> decode replica-1 (tp 2: two ranks of 16 of 32 heads "
        f"and 5504 of 11008 MLP columns each, NCCL's socket transport on lo"
        f", one card), 4 requests x 32 new tokens: fleet start (replicas "
        f"0-3, tp 1, 2, 1, 2) {start_s:.1f} s; gathered weights' digests "
        f"equal to the tp 1 replicas'; "
        f"{len(prompts)} requests in {wall:.2f} s, decoded by replica-1; "
        f"decode replica {pct(dec, 50):.2f} ms/step p50, "
        f"{pct(dec, 99):.2f} p99 over {steps} steps, every one a compiled "
        f"tick, of which the leader's descriptor broadcast (gloo) "
        f"{pct(send, 50):.2f} ms p50 over {len(send)} descriptors; the tp 1 "
        f"decode replica-2 of the drain below {pct(tp1_dec, 50):.2f} ms/step"
        f" p50 over {len(tp1_dec)} steps; {card}")
    log(f"[{tag}] (g) replays a rank {replays['leader']}; launches "
        f"leader {launched['leader']}, follower {launched['follower']} "
        f"({L} paged_decode and {2 * L + 1} rms_norm a replay on each "
        f"rank); paged_decode[B=4 H=Hkv=16 D=128 psz=16 bf16] at offsets "
        f"{offs}: max |err| {err:.3e} against its plain version; the prefill"
        f" replica's launches {pre_launches}")
    log(f"[{tag}] (g) collective traffic a decode step (registry "
        f"dist.collective_*, graphs' collectives a replay x replays): "
        f"leader {fmt_traffic(traffic['leader'])}; follower "
        f"{fmt_traffic(traffic['follower'])}; {card}")
    lost = [i for i, o in enumerate(douts)
            if o.output_ids.size != TP_DRILL_NEW]
    if lost or moved["replica-2"] < 1 or \
            sum(moved.values()) != in_flight or \
            [p.exitcode for p in ranks] != [0, 0] or \
            dstats["router_resubmissions"] != base["router_resubmissions"]:
        raise AssertionError(
            f"[{tag}] (g) drain: short {lost}, {moved} of {in_flight} slots "
            f"moved by survivor, exits {[p.exitcode for p in ranks]}, "
            f"resubmissions "
            f"{base['router_resubmissions']} -> "
            f"{dstats['router_resubmissions']}")
    lost = [i for i, o in enumerate(kouts)
            if o.output_ids.size != TP_DRILL_NEW]
    if lost or leader3.exitcode != ELASTIC_EXIT_CODE:
        raise AssertionError(f"[{tag}] (g) follower kill: short {lost}, "
                             f"replica-3's leader exit {leader3.exitcode}")
    log(f"[{tag}] (g) drain of the tp 2 replica-1 with {in_flight} requests "
        f"decoding: all migrated (both ranks' heads gathered into global "
        f"pages), {moved['replica-2']} to the tp 1 replica-2 and "
        f"{moved['replica-3']} to the tp 2 replica-3 (its ranks keeping "
        f"their heads), and finished there, {TP_DRILL_NEW} tokens each; no "
        f"resubmission; both ranks exited 0."
        f" SIGKILL of the tp 2 replica-3's follower with {busy} requests "
        f"decoding: the leader left the ring {lapse_s:.2f} s after the kill "
        f"(lease ttl 3.0 s) and exited {leader3.exitcode}; every request "
        f"finished elsewhere ({TP_DRILL_NEW} tokens), router failovers "
        f"{kstats['router_failovers'] - kbase['router_failovers']}, "
        f"resubmissions "
        f"{kstats['router_resubmissions'] - kbase['router_resubmissions']}")
    return {"paged_decode": launched, "traffic": traffic,
            "decode_ms_p50": pct(dec, 50)}


def phase_serve_fleet(dev, ref):
    """Prefill/decode disaggregation across processes on one card: (a) the
    7B main path, (b) int8 at 2 layers bit for bit, (d) one traced run,
    (c) the drills, (g) a tensor-parallel decode replica.  Returns the
    decode replica's launch counts of (a)."""
    tag = "serve-fleet"
    counts = fleet_main_path(tag, dev, ref)
    torch.cuda.empty_cache()
    fleet_drills(tag, dev)
    torch.cuda.empty_cache()
    fleet_tp_drill(tag, dev, ref)
    return counts


def decode_weight_bytes(model, rows=4):
    """Bytes of weights a decode step of ``rows`` rows must read: every
    parameter once, but of a table only gathered (Llama's token
    embedding, GPT's position table; GPT's token table is also its head,
    read whole) only the ``rows`` rows it gathers."""
    gathered = model.gpt.wpe.weight if isinstance(model, GPTForCausalLM) \
        else model.llama.embed_tokens.weight
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    return weight_bytes - (gathered.shape[0] - rows) * gathered.shape[1] * \
        gathered.element_size()


def time_replays(model, steps, reps=20, tag="serve-tick"):
    """Device time of one replay of each mode's graph (CUDA events over
    ``reps`` replays, after the engine stopped: every row dead, the same
    kernels at the same shapes), by kernel group (`profile_replays`: 5,
    whose kernels must be the recorded launches), beside the step's
    bound: every weight but a gathered table's unread rows read once."""
    weight_bytes = decode_weight_bytes(model)
    bound_ms = weight_bytes / HBM_BYTES_PER_S * 1e3
    times = {}
    for mode, step in sorted(steps.items()):
        graph = step.graph
        graph.replay()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            graph.replay()
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / reps
        times[mode] = (ms, bound_ms)
        groups = kernel_groups(profile_replays(step), per=5)
        log(f"[{tag}] one {mode} replay: {ms:.3f} ms device (CUDA "
            f"events, {reps} replays); bound {bound_ms:.3f} ms "
            f"({weight_bytes / 1e9:.2f} GB of weights / 3.35 TB/s), "
            f"{100 * bound_ms / ms:.1f}% of it; by group "
            f"{fmt_groups(groups, 3)} (profiled, a replay; its kernels = "
            f"the recorded launches {step.launches})")
    return times


def phase_parity(dev):
    """The same 2-layer fp32 model on the CPU and on the card."""
    cfg = llama_config("llama2-7b", num_layers=2, max_seq_len=256)
    t0 = time.monotonic()
    cpu_model = LlamaForCausalLM(cfg, device="cpu", seed=1)
    card_model = LlamaForCausalLM(cfg, device=dev, seed=1)
    card_model.load_state_dict(cpu_model.state_dict())
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in (5, 40, 23)]
    # three greedy requests and two seeded-sampled ones, 4 slots: the
    # tick's "mixed" mode, then its "greedy" one
    subs = [(p, SamplingParams()) for p in prompts] + [
        (prompts[1], SamplingParams(temperature=0.8, top_k=50, top_p=0.95,
                                    seed=3)),
        (prompts[2], SamplingParams(temperature=1.0, top_p=0.9,
                                    repetition_penalty=1.1, seed=6))]
    outs = {}
    before = kernels.launch_counts()
    for label, model in (("cpu", cpu_model), ("card", card_model)):
        with Engine(model, ServingConfig(num_slots=4)) as eng:
            futs = [eng.submit(p, max_new_tokens=8, sampling=sp)
                    for p, sp in subs]
            outs[label] = [f.result(timeout=600).output_ids for f in futs]
        st = serve_stats(eng)
        if st["tick_compiled_hits"] == 0 or st["tick_fallbacks"]:
            raise AssertionError(f"{label}: compiled ticks "
                                 f"{st['tick_compiled_hits']}, fallbacks "
                                 f"{st['tick_fallbacks']}")
    after = kernels.launch_counts()
    for a, b in zip(outs["cpu"], outs["card"]):
        if not np.array_equal(a, b):
            raise AssertionError(f"greedy or seeded outputs differ: cpu "
                                 f"{a.tolist()} card {b.tolist()}")
    if any(after[k] == before[k] for k in ("rms_norm", "paged_decode")):
        raise AssertionError(f"the card run skipped a kernel: {before} → "
                             f"{after}")
    log(f"[parity] 2-layer 7B-width fp32, the compiled tick on both: greedy "
        f"and seeded outputs identical on the CPU and the card for 3 + 2 "
        f"requests ({time.monotonic() - t0:.1f} s): "
        f"{[o.tolist() for o in outs['card']]}")
    # quantized pools under an adapter pool: a base and an adapter request
    # on one prompt, on each device
    t0 = time.monotonic()
    spec = adapter_spec(cpu_model, 7, 16, LORA_TARGETS, std=0.05)
    for name in ("int8", "fp8"):
        scfg = ServingConfig(num_slots=4, cache_dtype=name, max_adapters=2,
                             adapter_rank_pool=16, adapters={"a": spec})
        outs = {}
        before = kernels.launch_counts()
        for label, model in (("cpu", cpu_model), ("card", card_model)):
            with Engine(model, scfg) as eng:
                futs = [eng.submit(prompts[1], max_new_tokens=8,
                                   adapter_id=aid) for aid in (None, "a")]
                outs[label] = [f.result(timeout=600).output_ids
                               for f in futs]
        after = kernels.launch_counts()
        for a, b in zip(outs["cpu"], outs["card"]):
            if not np.array_equal(a, b):
                raise AssertionError(f"{name} + adapter: greedy outputs "
                                     f"differ: cpu {a.tolist()} card "
                                     f"{b.tolist()}")
        if np.array_equal(*outs["card"]):
            raise AssertionError(f"{name}: the adapter request decoded the "
                                 "base request's tokens")
        skipped = [k for k in ("paged_decode_" + name, "lora_delta")
                   if after[k] == before[k]]
        if skipped:
            raise AssertionError(f"the card run skipped {skipped}")
        log(f"[parity] {name} pools + adapter pool: greedy outputs identical"
            f" on the CPU and the card, base {outs['card'][0].tolist()}, "
            f"adapter {outs['card'][1].tolist()}")
    log(f"[parity] quantized + adapter runs took "
        f"{time.monotonic() - t0:.1f} s")


def train_batch(vocab, seq, seed=0):
    """One batch of random token ids; labels are the ids shifted by one,
    the last position ignored."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (1, seq)).astype(np.int64)
    labels = np.roll(ids, -1, axis=1)
    labels[:, -1] = -100
    return torch.from_numpy(ids), torch.from_numpy(labels)


def train_step(model, opt, ids, labels, marks=None):
    """One eager training step; with ``marks`` (five CUDA events) the
    forward, backward, the global-norm clip (its `scale`, wrapped for the
    step by two event records; without that clip the span is empty) and
    the update + ``clear_grad`` are timed on the card's timeline."""
    if marks:
        marks[0].record()
    _, loss = model(ids, labels=labels)
    if marks:
        marks[1].record()
    loss.backward()
    if marks:
        marks[2].record()
    clip = opt._grad_clip
    timed = marks and isinstance(clip, ClipGradByGlobalNorm)
    if timed:
        def scale(params_grads):
            marks[2].record()
            s = ClipGradByGlobalNorm.scale(clip, params_grads)
            marks[3].record()
            return s
        clip.scale = scale
    try:
        opt.step()
    finally:
        if timed:
            del clip.scale
    if marks and not timed:
        marks[3].record()
    opt.clear_grad()
    if marks:
        marks[4].record()
    return float(loss.detach())


def make_trainer(cfg, dev, dtype, seed, lr=3e-4):
    model = LlamaForCausalLM(cfg, device=dev, dtype=torch.float32, seed=seed)
    opt = AdamW(learning_rate=lr, parameters=model.parameters(),
                weight_decay=0.01, grad_clip=ClipGradByGlobalNorm(1.0))
    if dtype != torch.float32:
        model, opt = amp.decorate(model, opt, level="O2", dtype=dtype)
    return model, opt


def kernel_groups(rows, per=1):
    """Device ms by group of `device_rows`, divided by ``per``."""
    groups = {}
    for key, ms, _ in rows:
        k = key.lower()
        group = ("collectives (NCCL)" if "nccl" in k else
                 "flash attention (ours)" if "flash_" in k else
                 "adam (ours)" if "adam_kernel" in k else
                 "clip norm (torch _foreach_norm)" if "lpnorm" in k else
                 "paged decode + lora delta (ours)" if any(t in k for t in (
                     "paged_decode", "lora")) else
                 "rms norm + rope (ours)" if any(t in k for t in (
                     "rms_fwd", "rms_bwd", "rms_dw", "rope")) else
                 "GEMM (cuBLAS)" if any(t in k for t in (
                     "nvjet", "gemm", "cutlass", "xmma")) else
                 "elementwise, reductions, copies (torch)")
        groups[group] = groups.get(group, 0.0) + ms / per
    return groups


def fmt_groups(groups, digits=1):
    return ", ".join(f"{g} {ms:.{digits}f} ms" for g, ms in
                     sorted(groups.items(), key=lambda x: -x[1]))


def profile_train_step(model, opt, ids, labels, tag="train-profile"):
    """torch.profiler over one training step: device time by kernel and
    the device's busy share of the step's wall time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        train_step(model, opt, ids, labels)
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    rows = device_rows(prof)
    busy_ms = sum(r[1] for r in rows)
    log(f"[{tag}] one step: wall {wall_ms:.1f} ms, device busy "
        f"{busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}%)")
    log(f"[{tag}] by group: " + fmt_groups(kernel_groups(rows)))
    for key, ms, count in sorted(rows, key=lambda r: -r[1])[:15]:
        log(f"[{tag}]   {ms:9.3f} ms  {count:6d}x  {key[:90]}")


def eager_lane(tag, model, opt, ids, labels, dev, warmup, steps):
    """The eager lane: ``warmup`` + ``steps`` calls of `train_step` (the
    forward, backward and optimizer parts timed by CUDA events); returns
    its losses, host times, parts, peak memory and launch counts."""
    torch.cuda.reset_peak_memory_stats(dev)
    before = kernels.launch_counts()
    losses, times, parts = [], [], []
    for i in range(warmup + steps):
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        t1 = time.monotonic()
        losses.append(train_step(model, opt, ids, labels, marks))
        torch.cuda.synchronize()
        times.append((time.monotonic() - t1) * 1e3)
        if i >= warmup:
            parts.append([marks[j].elapsed_time(marks[j + 1])
                          for j in range(4)])
    after = kernels.launch_counts()
    return dict(losses=losses, times=times, parts=parts,
                peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
                counts={k: after[k] - before[k] for k in after})


def compiled_lane(tag, model, opt, ids, labels, dev, warmup, steps):
    """The compiled lane: `CompiledTrainStep` over the same forward; call
    1 is its eager warm-up, call 2 captures and replays; returns the
    losses, host times, peak memory and the step object."""
    torch.cuda.reset_peak_memory_stats(dev)
    cs = CompiledTrainStep(lambda x, y: model(x, labels=y)[1], opt,
                           network=model)
    fallbacks = jit_fallbacks()
    losses, times = [], []
    for _ in range(warmup + steps):
        t1 = time.monotonic()
        losses.append(float(cs(ids, labels)))
        torch.cuda.synchronize()
        times.append((time.monotonic() - t1) * 1e3)
    if not cs.compiled or jit_fallbacks() != fallbacks:
        raise AssertionError(f"[{tag}] the compiled lane fell back: "
                             f"{cs.fallback_reason}")
    return dict(losses=losses, times=times, cs=cs,
                peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9)


def lane_line(tag, label, lane, warmup, steps, tokens, flops):
    """Logs a lane's losses, step ms p50, tokens/s, MFU and peak memory;
    returns its step ms p50."""
    step_ms = float(np.median(lane["times"][warmup:]))
    mfu = flops / (step_ms / 1e3) / PEAK_OPS[torch.bfloat16]
    lane["step_ms"], lane["mfu"] = step_ms, mfu
    log(f"[{tag}] {label} losses {[round(x, 4) for x in lane['losses']]}")
    log(f"[{tag}] {label} step {step_ms:.2f} ms p50 over {steps} timed "
        f"steps (all: {[round(t, 1) for t in lane['times']]}), "
        f"{tokens / (step_ms / 1e3):.0f} tokens/s, MFU {100 * mfu:.1f}% "
        f"({flops / 1e12:.2f} TFLOP a step), peak memory "
        f"{lane['peak_gb']:.2f} GB")
    return step_ms


def profile_compiled(cs, ids, labels, tag, n=3, groups=None):
    """torch.profiler over ``n`` compiled steps after one warm-up step
    under the profiler (its tracing set up, not recorded): the device's
    busy share of their wall time and the time by group (into the dict
    ``groups`` too, ms a step, when given)."""
    from torch.profiler import ProfilerActivity, profile, schedule
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 acc_events=True) as prof:
        for reps in (1, n):
            time.sleep(PROFILE_EDGE_S)
            t0 = time.monotonic()
            for _ in range(reps):
                cs(ids, labels)
            torch.cuda.synchronize()
            wall_ms = (time.monotonic() - t0) * 1e3
            time.sleep(PROFILE_EDGE_S)
            prof.step()
    rows = device_rows(prof)
    busy_ms = sum(r[1] for r in rows)
    log(f"[{tag}] {n} replays: wall {wall_ms / n:.2f} ms a step, device "
        f"busy {busy_ms / n:.2f} ms ({100 * busy_ms / wall_ms:.1f}%)")
    by_group = kernel_groups(rows, n)
    log(f"[{tag}] by group a step: " + fmt_groups(by_group, 2))
    for key, ms, count in sorted(rows, key=lambda r: -r[1])[:8]:
        log(f"[{tag}]   {ms / n:9.3f} ms  {count / n:7.1f}x a step  "
            f"{key[:80]}")
    if groups is not None:
        groups.update(by_group, wall=wall_ms / n)
    return busy_ms / wall_ms


def check_compiled_losses(tag, comp, eager):
    """The compiled lane's losses: finite, falling, and equal bit for bit
    to the eager lane's (same seed, weights and batch)."""
    if not all(np.isfinite(comp)):
        raise AssertionError(f"[{tag}] compiled: non-finite loss: {comp}")
    if not comp[-1] < comp[0]:
        raise AssertionError(f"[{tag}] compiled: the loss did not fall: "
                             f"{comp}")
    if comp != eager:
        raise AssertionError(f"[{tag}] compiled losses {comp} differ from "
                             f"the eager lane's {eager}")


def check_replay_launches(tag, eager, n_eager, cs):
    """Each training kernel's launches in one replay of the full graph
    equal the eager lane's launches a step."""
    (label, (captures, replays, per_replay)), = [
        kv for kv in cs.graph_stats().items() if kv[0].startswith("full")]
    per_step = {}
    for k, c in eager.items():
        if c:
            if c % n_eager:
                raise AssertionError(f"[{tag}] {k}: {c} launches in "
                                     f"{n_eager} eager steps")
            per_step[k] = c // n_eager
    if per_step != per_replay or captures != 1:
        raise AssertionError(f"[{tag}] launches a replay {per_replay} "
                             f"(captures {captures}) differ from the eager "
                             f"lane's a step {per_step}")
    log(f"[{tag}] graphs {cs.graph_stats()}: launches a replay equal the "
        f"eager lane's a step")


def phase_train(dev, warmup=2, steps=6):
    """Llama-2 7B width, 8 of its 32 layers (memory: 16 B a parameter under
    O2 AdamW), bf16 O2, B1 x S4096, one batch repeated: the eager lane,
    then (the eager model freed: the two do not fit together) the same
    model from the same seed through `CompiledTrainStep`."""
    cfg = llama_config("llama2-7b", num_layers=8)
    seq = 4096
    t0 = time.monotonic()
    model, opt = make_trainer(cfg, dev, torch.bfloat16, seed=0)
    ids, labels = (t.to(dev) for t in train_batch(cfg.vocab_size, seq))
    n_params = model.num_params()
    n_tensors = len(list(model.parameters()))
    n_matmul = n_params - model.llama.embed_tokens.weight.numel()
    torch.cuda.synchronize()
    log(f"[train] Llama-2 7B width, {cfg.num_layers} layers "
        f"({n_params / 1e9:.3f} B params), bf16 O2, AdamW(3e-4, wd 0.01, "
        f"clip 1.0), B1 x S{seq}; built in {time.monotonic() - t0:.1f} s")
    kernels.reset_launch_counts()
    eager = eager_lane("train", model, opt, ids, labels, dev, warmup, steps)
    losses, counts = eager["losses"], eager["counts"]
    n = warmup + steps
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")
    need = {k: cfg.num_layers * n for k in TRAIN_KERNELS}
    need["adam"] = n_tensors * n                       # one per parameter
    for name, k in need.items():
        if counts[name] < k:
            raise AssertionError(f"{name}: {counts[name]} launches, expected "
                                 f">= {k}")
    tokens = ids.numel()
    # MFU: 6 N T (N every parameter but the input embedding, whose lookup
    # does no product; forward and backward) plus causal attention, 3 x 2
    # S^2 hidden per layer (two products of 2 S^2 D per head, halved by the
    # mask; forward and backward), over 989 TFLOP/s
    flops = 6 * n_matmul * tokens + \
        6 * tokens * seq * cfg.hidden_size * cfg.num_layers
    lane_line("train", "eager", eager, warmup, steps, tokens, flops)
    fwd_ms, bwd_ms, clip_ms, opt_ms = np.median(np.asarray(eager["parts"]),
                                                axis=0)
    log(f"[train] eager step parts p50 (CUDA events): forward + loss "
        f"{fwd_ms:.1f} ms, backward {bwd_ms:.1f} ms, clip {clip_ms:.2f} ms, "
        f"AdamW + clear_grad {opt_ms:.1f} ms")
    log(f"[train] eager launches {counts} (needed >= {need})")
    profile_train_step(model, opt, ids, labels)
    del model, opt
    torch.cuda.empty_cache()
    model, opt = make_trainer(cfg, dev, torch.bfloat16, seed=0)
    kernels.reset_launch_counts()
    comp = compiled_lane("train", model, opt, ids, labels, dev, warmup,
                         steps)
    main_counts = kernels.launch_counts()
    check_launches(main_counts, need)   # call 1 eager + 7 replays
    lane_line("train", "compiled", comp, warmup, steps, tokens, flops)
    check_compiled_losses("train", comp["losses"], losses)
    log(f"[train] compiled: first compiled call (capture + first replay) "
        f"{comp['times'][1]:.1f} ms; losses equal to the eager lane's bit "
        f"for bit")
    check_replay_launches("train", counts, n, comp["cs"])
    profile_compiled(comp["cs"], ids, labels, "train-profile")
    del model, opt, comp
    torch.cuda.empty_cache()
    return main_counts


def phase_train_parity(dev, steps=2):
    """The same fp32 2-layer model at the 7B widths, the same weights and
    batch, 2 AdamW steps on the CPU (plain versions) and on the card
    (kernels).  Tolerances: losses 1e-4 relative (fp32 sums in other
    orders); parameters: AdamW moves an element by ~lr whatever its
    gradient's size, so an element whose gradient is at the fp32 noise
    floor may step differently: all but 1 in 10^4 elements within 1e-5,
    and every element within 2 lr per step."""
    cfg = llama_config("llama2-7b", num_layers=2, max_seq_len=256)
    t0 = time.monotonic()
    cpu_model, cpu_opt = make_trainer(cfg, "cpu", torch.float32, seed=1)
    card_model, card_opt = make_trainer(cfg, dev, torch.float32, seed=1)
    card_model.load_state_dict(cpu_model.state_dict())
    ids, labels = train_batch(cfg.vocab_size, 256, seed=1)
    cpu_losses = [train_step(cpu_model, cpu_opt, ids, labels)
                  for _ in range(steps)]
    before = kernels.launch_counts()
    card_losses = [train_step(card_model, card_opt, ids.to(dev),
                              labels.to(dev)) for _ in range(steps)]
    after = kernels.launch_counts()
    if not np.allclose(card_losses, cpu_losses, rtol=1e-4, atol=0):
        raise AssertionError(f"losses differ: cpu {cpu_losses} card "
                             f"{card_losses}")
    skipped = [k for k in TRAIN_KERNELS if after[k] == before[k]]
    if skipped:
        raise AssertionError(f"the card run skipped {skipped}")
    cpu_sd, card_sd = cpu_model.state_dict(), card_model.state_dict()
    worst = {}
    for name in ("llama.embed_tokens.weight",
                 "llama.layers.0.self_attn.q_proj.weight",
                 "llama.layers.1.mlp.down_proj.weight",
                 "llama.layers.1.input_layernorm.weight", "lm_head.weight"):
        diff = (card_sd[name].cpu() - cpu_sd[name]).abs()
        off = float((diff > 1e-5).float().mean())
        worst[name] = (float(diff.max()), off)
        if off > 1e-4 or float(diff.max()) > 2 * 3e-4 * steps:
            raise AssertionError(f"{name}: max diff {float(diff.max()):.3e},"
                                 f" share above 1e-5 {off:.2e}")
    log(f"[train-parity] 2-layer 7B-width fp32, S256, {steps} AdamW steps: "
        f"losses cpu {cpu_losses} card {card_losses}; parameters (max diff,"
        f" share > 1e-5) {worst} ({time.monotonic() - t0:.1f} s)")
    del card_model, card_opt
    torch.cuda.empty_cache()
    return cpu_losses


def eager_update(fwd, opt, scaler, accum, x, y, update):
    """The eager lane as a training loop writes it (the compiled step's
    default eager step): the loss, scaled and divided by the accumulation
    count for the backward; on an update the scaler's (or the
    optimizer's) step and cleared gradients."""
    loss = fwd(x, y)
    bwd = scaler.scale(loss) if scaler is not None else loss
    if accum > 1:
        bwd = bwd * (1.0 / accum)
    bwd.backward()
    if update:
        if scaler is not None:
            scaler.step(opt)
        else:
            opt.step()
        opt.clear_grad()
    return loss


def parity_lane(build, batches, compiled, accum=1, scaler_kw=None):
    """One lane over ``batches``: ``build()`` → (model, opt, forward,
    scheduler or None).  Returns the losses, the step counter after each
    call, every parameter, moment and master, the scaler's state and the
    step object (None in the eager lane)."""
    model, opt, fwd, sched = build()
    opt._ensure_state()
    scaler = amp.GradScaler(**scaler_kw) if scaler_kw else None
    cs = CompiledTrainStep(fwd, opt, scaler=scaler, network=model,
                           accumulate_grad_batches=accum) \
        if compiled else None
    losses, steps = [], []
    fallbacks = jit_fallbacks()
    for i, (x, y) in enumerate(batches):
        update = (i + 1) % accum == 0
        loss = cs(x, y, update) if compiled else \
            eager_update(fwd, opt, scaler, accum, x, y, update)
        if update and sched is not None:
            sched.step()
        losses.append(loss.detach().float().reshape(1))
        steps.append(opt._step_tensor.clone())
    if compiled:
        cs.sync_scaler()
        if not cs.compiled or jit_fallbacks() != fallbacks:
            raise AssertionError(f"the compiled lane fell back: "
                                 f"{cs.fallback_reason}")
    state = {f"param {n}": p.detach().clone()
             for n, p in model.named_parameters()}
    for name, vals in opt._state.items():
        for i, v in enumerate(vals):
            if v is not None:
                state[f"{name}.{i}"] = v.clone()
    state["step_tensor"] = opt._step_tensor.clone()
    out = dict(losses=torch.cat(losses), steps=torch.stack(steps),
               state=state, scaler=scaler.state_dict() if scaler else None,
               stats=cs.graph_stats() if compiled else None)
    del model, opt, fwd, cs
    torch.cuda.empty_cache()
    return out


def compare_lanes(label, eager, comp):
    """Eager and compiled must agree bit for bit (tolerance: none)."""
    bad = [k for k in ("losses", "steps") if not torch.equal(eager[k],
                                                             comp[k])]
    bad += [k for k, v in eager["state"].items()
            if not torch.equal(v, comp["state"][k])]
    if eager["scaler"] != comp["scaler"]:
        bad.append(f"scaler {eager['scaler']} != {comp['scaler']}")
    if bad:
        raise AssertionError(f"[train-compiled-parity] {label}: eager and "
                             f"compiled differ in {bad[:8]} (losses "
                             f"{eager['losses'].tolist()} / "
                             f"{comp['losses'].tolist()})")
    log(f"[train-compiled-parity] {label}: losses "
        f"{comp['losses'].tolist()}, step counter "
        f"{comp['steps'].tolist()}, {len(comp['state'])} tensors (every "
        f"parameter, moment and master, the counter) equal bit for bit; "
        f"graphs {comp['stats']}")


def phase_train_compiled_parity(dev, cpu_losses=None, steps=4):
    """Eager against compiled on the card, bit for bit: (a) the 2-layer
    fp32 Llama of train-parity (the same weights, built on the CPU) with
    its global-norm clip; (b) a 2-layer GPT-2-width fp32 model with
    attention and residual dropout 0.1; (c) (b) in fp16 O2 under a
    GradScaler (2^16, growth every 2 steps) and a LinearWarmup into
    CosineAnnealingDecay schedule, one batch marked so that its loss is
    multiplied by 1e4 and a gradient overflows: that step is skipped (the
    counter stays), the scale halves and ``sync_scaler()`` equals the
    eager scaler; (d) (a) with accumulate_grad_batches=2; (e) (a) with a
    clip of 1e-3, whose scale (checked < 1 on the first batch) the Adam
    kernel applies; (f) (a) with `L2Decay` weight decay that
    ``apply_decay_param_fun`` refuses for every name and one parameter's
    ``regularizer`` turns on.  Then (a)'s card losses against the CPU's
    under train-parity's tolerance."""
    t0 = time.monotonic()
    cfg = llama_config("llama2-7b", num_layers=2, max_seq_len=256)
    cpu_model, cpu_opt = make_trainer(cfg, "cpu", torch.float32, seed=1)
    init = {k: v.clone() for k, v in cpu_model.state_dict().items()}
    ids, labels = train_batch(cfg.vocab_size, 256, seed=1)
    if cpu_losses is None:
        cpu_losses = [train_step(cpu_model, cpu_opt, ids, labels)
                      for _ in range(3)]
    del cpu_model, cpu_opt
    batches = [(ids.to(dev), labels.to(dev))] * steps

    def llama():
        model, opt = make_trainer(cfg, dev, torch.float32, seed=1)
        model.load_state_dict(init)
        return model, opt, lambda x, y: model(x, labels=y)[1], None
    kernels.reset_launch_counts()
    a = {c: parity_lane(llama, batches, c) for c in (False, True)}
    compare_lanes("(a) Llama 2-layer fp32, clip 1.0", a[False], a[True])
    card = a[True]["losses"][:len(cpu_losses)].tolist()
    if not np.allclose(card, cpu_losses, rtol=1e-4, atol=0):
        raise AssertionError(f"(a) card losses {card} against the CPU's "
                             f"{cpu_losses}")
    log(f"[train-compiled-parity] (a) compiled card losses {card} against "
        f"the CPU's {cpu_losses}: within 1e-4 relative")
    d = {c: parity_lane(llama, batches, c, accum=2) for c in (False, True)}
    compare_lanes("(d) (a) with accumulate_grad_batches=2", d[False],
                  d[True])

    def llama_with(clip_norm, decay):
        """(a)'s model with AdamW(clip ``clip_norm``) and, with ``decay``,
        weight decay as an `L2Decay` that no name passes
        (``apply_decay_param_fun``) but one parameter's ``regularizer``."""
        def build():
            model, _, fwd, _ = llama()
            kw = {}
            if decay:
                kw = dict(weight_decay=optim.L2Decay(0.01),
                          apply_decay_param_fun=lambda name: False)
                model.llama.layers[0].mlp.down_proj.weight.regularizer = \
                    optim.L2Decay(0.01)
            opt = AdamW(learning_rate=3e-4, parameters=model.parameters(),
                        grad_clip=ClipGradByGlobalNorm(clip_norm), **kw)
            return model, opt, fwd, None
        return build
    model, _, fwd, _ = llama()
    fwd(*batches[0]).backward()
    scale = float(ClipGradByGlobalNorm(1e-3).scale(
        [(p, p.grad) for p in model.parameters()]))
    del model, fwd
    if not scale < 1.0:
        raise AssertionError(f"(e) the clip's scale {scale} is not < 1")
    e = {c: parity_lane(llama_with(1e-3, False), batches, c)
         for c in (False, True)}
    compare_lanes(f"(e) (a) with clip 1e-3 (the first step's scale "
                  f"{scale:.4e})", e[False], e[True])
    f = {c: parity_lane(llama_with(1.0, True), batches, c)
         for c in (False, True)}
    compare_lanes("(f) (a) with L2Decay(0.01), apply_decay_param_fun "
                  "False for every name, one parameter's regularizer",
                  f[False], f[True])
    del init
    gcfg = gpt_config("gpt2-124m", num_layers=2, max_seq_len=256,
                      attn_dropout=0.1, dropout=0.1)
    gids, glabels = (t.to(dev) for t in gpt2_batch(gcfg.vocab_size, 2, 256,
                                                    seed=1))

    def gpt(dtype):
        def build():
            model, opt = make_gpt_trainer(gcfg, dev, torch.float32, 1, 3e-4,
                                          ClipGradByGlobalNorm(1.0))
            sched = None
            if dtype != torch.float32:
                model, opt = amp.decorate(model, opt, level="O2",
                                          dtype=dtype)
                sched = lrs.LinearWarmup(lrs.CosineAnnealingDecay(
                    3e-4, T_max=8), warmup_steps=2, start_lr=1e-5,
                    end_lr=3e-4)
                opt.set_lr_scheduler(sched)

            def fwd(x, y):
                loss = model(x, labels=y)[1]
                # the marked batch (label 0 ignored): loss x 1e4
                return loss * torch.where(y[0, 0] == -100, 1e4, 1.0)
            return model, opt, fwd, sched
        return build
    b = {c: parity_lane(gpt(torch.float32), [(gids, glabels)] * steps, c)
         for c in (False, True)}
    compare_lanes("(b) GPT-2-width 2-layer fp32, dropout 0.1", b[False],
                  b[True])
    marked = glabels.clone()
    marked[0, 0] = -100
    cbatches = [(gids, glabels)] * 3 + [(gids, marked), (gids, glabels)]
    scaler_kw = dict(init_loss_scaling=2.0 ** 16, incr_every_n_steps=2)
    c = {k: parity_lane(gpt(torch.float16), cbatches, k, scaler_kw=scaler_kw)
         for k in (False, True)}
    compare_lanes("(c) (b) in fp16 O2, GradScaler, LinearWarmup + cosine",
                  c[False], c[True])
    st = c[True]["steps"].tolist()
    if st[3] != st[2] or st[4] != st[2] + 1 or \
            c[True]["scaler"]["scale"] != 2.0 ** 16 or \
            not np.isfinite(c[True]["losses"][3].item()):
        raise AssertionError(f"(c) the marked step: counter {st}, scaler "
                             f"{c[True]['scaler']}")
    log(f"[train-compiled-parity] (c) the marked step (4th) was skipped: "
        f"counter {st}; the scale grew to 2^17 after two good steps and "
        f"halved at the overflow: {c[True]['scaler']} (the eager scaler's "
        f"{c[False]['scaler']})")
    log(f"[train-compiled-parity] launches {kernels.launch_counts()} "
        f"({time.monotonic() - t0:.1f} s)")


def gpt2_batch(vocab, b, seq, seed=0):
    """bench.py's batch: B x (S + 1) random ids from a numpy seed, the
    first S the inputs and the last S the labels."""
    rng = np.random.default_rng(seed)
    data = rng.integers(0, vocab, (b, seq + 1)).astype(np.int64)
    return (torch.from_numpy(data[:, :-1].copy()),
            torch.from_numpy(data[:, 1:].copy()))


def make_gpt_trainer(cfg, dev, dtype, seed, lr, grad_clip=None):
    model = GPTForCausalLM(cfg, device=dev, dtype=torch.float32, seed=seed)
    opt = AdamW(learning_rate=lr, parameters=model.parameters(),
                weight_decay=0.01, grad_clip=grad_clip)
    if dtype != torch.float32:
        model, opt = amp.decorate(model, opt, level="O2", dtype=dtype)
    return model, opt


def phase_train_gpt2(dev, warmup=2, steps=6):
    """GPT-2 124M as bench.py trains it (AdamW(1e-4, weight_decay=0.01),
    B8 x S1024) with GPT-2's published dropouts (attention, residual and
    embedding 0.1), bf16 O2; nothing cut.  The eager lane, then the model
    rebuilt from the same seed through `CompiledTrainStep`."""
    cfg = gpt_config("gpt2-124m", max_seq_len=1024, attn_dropout=0.1,
                     dropout=0.1)
    b, seq = 8, 1024
    t0 = time.monotonic()
    model, opt = make_gpt_trainer(cfg, dev, torch.bfloat16, seed=0, lr=1e-4)
    ids, labels = (t.to(dev) for t in gpt2_batch(cfg.vocab_size, b, seq))
    n_params = model.num_params()            # every parameter but wpe
    n_tensors = len(list(model.parameters()))
    torch.cuda.synchronize()
    log(f"[train-gpt2] GPT-2 124M ({cfg.num_layers} layers, hidden "
        f"{cfg.hidden_size}, {cfg.num_heads} heads, vocab {cfg.vocab_size};"
        f" {model.num_params(non_embedding=False) / 1e6:.2f} M params, "
        f"{n_params / 1e6:.2f} M without wpe, {n_tensors} tensors), dropout "
        f"0.1 (attention, residual, embedding), bf16 O2, AdamW(1e-4, wd "
        f"0.01), B{b} x S{seq}; built in {time.monotonic() - t0:.1f} s")
    kernels.reset_launch_counts()
    eager = eager_lane("train-gpt2", model, opt, ids, labels, dev, warmup,
                       steps)
    losses, counts = eager["losses"], eager["counts"]
    n = warmup + steps
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")
    need = {k: cfg.num_layers * n for k in DROPOUT_KERNELS}
    need["adam"] = n_tensors * n                  # one per parameter
    check_launches(counts, need)
    plain = {k: counts[k] for k in FLASH + MASKED_KERNELS if counts[k]}
    if plain:
        raise AssertionError(f"training launched other flash variants: "
                             f"{plain}")
    tokens = ids.numel()
    # MFU: 6 N T (N every parameter but wpe: the tied wte does the head's
    # product) plus causal attention, 6 T S hidden L, over 989 TFLOP/s
    flops = 6 * n_params * tokens + \
        6 * tokens * seq * cfg.hidden_size * cfg.num_layers
    lane_line("train-gpt2", "eager", eager, warmup, steps, tokens, flops)
    fwd_ms, bwd_ms, _, opt_ms = np.median(np.asarray(eager["parts"]),
                                          axis=0)
    log(f"[train-gpt2] eager step parts p50 (CUDA events): forward + loss "
        f"{fwd_ms:.1f} ms, backward {bwd_ms:.1f} ms, AdamW + clear_grad "
        f"{opt_ms:.1f} ms (no clip)")
    log(f"[train-gpt2] eager launches {counts} (needed >= {need})")
    profile_train_step(model, opt, ids, labels, "train-gpt2-profile")
    del model, opt
    torch.cuda.empty_cache()
    model, opt = make_gpt_trainer(cfg, dev, torch.bfloat16, seed=0, lr=1e-4)
    kernels.reset_launch_counts()
    comp = compiled_lane("train-gpt2", model, opt, ids, labels, dev, warmup,
                         steps)
    main_counts = kernels.launch_counts()
    check_launches(main_counts, need)   # call 1 eager + 7 replays
    lane_line("train-gpt2", "compiled", comp, warmup, steps, tokens, flops)
    check_compiled_losses("train-gpt2", comp["losses"], losses)
    log(f"[train-gpt2] compiled: first compiled call (capture + first "
        f"replay) {comp['times'][1]:.1f} ms; losses equal to the eager "
        f"lane's bit for bit")
    check_replay_launches("train-gpt2", counts, n, comp["cs"])
    profile_compiled(comp["cs"], ids, labels, "train-gpt2-profile")
    lanes = {label: {k: lane[k] for k in ("losses", "step_ms", "peak_gb")}
             for label, lane in (("eager", eager), ("compiled", comp))}
    del model, opt, comp
    torch.cuda.empty_cache()
    return main_counts, lanes


#: the train-optimizers phase's lanes: GPT-2 124M with each optimizer
#: the JAX package has besides Adam/AdamW (their options non-default)
OTHER_OPTIMIZERS = {
    "SGD": lambda ps: optim.SGD(0.1, parameters=ps, weight_decay=0.01),
    "Momentum": lambda ps: optim.Momentum(0.01, 0.9, parameters=ps,
                                          use_nesterov=True),
    "Adagrad": lambda ps: optim.Adagrad(0.01, parameters=ps,
                                        initial_accumulator_value=0.1),
    "RMSProp": lambda ps: optim.RMSProp(1e-4, centered=True, momentum=0.9,
                                        parameters=ps),
    "Adadelta": lambda ps: optim.Adadelta(1.0, parameters=ps),
    "Adamax": lambda ps: optim.Adamax(1e-3, parameters=ps,
                                      weight_decay=0.01),
    "Lamb": lambda ps: optim.Lamb(1e-3, parameters=ps),
}


def phase_train_optimizers(dev, warmup=2, steps=3):
    """GPT-2 124M (nothing cut, dropouts 0.1, bf16 O2, B8 x S1024) with
    `ClipGradByGlobalNorm(1.0)` under each other optimizer: a lane rebuilt
    from seed 0, 2 + 3 eager steps, then the model rebuilt from seed 0
    through `CompiledTrainStep`.  Losses finite, compiled equal to eager
    bit for bit, one capture, launches a replay equal to the eager lane's
    a step.  Then `LBFGS` on a 2-layer GPT-2-width fp32 model (dropout
    off: the closure must give the same loss for the same weights) for
    2 closure steps: the loss falls, and `CompiledTrainStep` falls back
    with one warning."""
    import warnings
    cfg = gpt_config("gpt2-124m", max_seq_len=1024, attn_dropout=0.1,
                     dropout=0.1)
    b, seq = 8, 1024
    ids, labels = (t.to(dev) for t in gpt2_batch(cfg.vocab_size, b, seq))
    n = warmup + steps

    def build(name):
        model = GPTForCausalLM(cfg, device=dev, dtype=torch.float32, seed=0)
        opt = OTHER_OPTIMIZERS[name](model.parameters())
        opt._grad_clip = ClipGradByGlobalNorm(1.0)
        return amp.decorate(model, opt, level="O2", dtype=torch.bfloat16)
    rows = {}
    for name in OTHER_OPTIMIZERS:
        tag = f"train-optimizers {name}"
        model, opt = build(name)
        kernels.reset_launch_counts()
        eager = eager_lane(tag, model, opt, ids, labels, dev, warmup, steps)
        del model, opt
        torch.cuda.empty_cache()
        model, opt = build(name)
        comp = compiled_lane(tag, model, opt, ids, labels, dev, warmup,
                             steps)
        if not all(np.isfinite(eager["losses"])) or \
                comp["losses"] != eager["losses"]:
            raise AssertionError(f"[{tag}] losses: eager {eager['losses']}, "
                                 f"compiled {comp['losses']}")
        check_replay_launches(tag, eager["counts"], n, comp["cs"])
        step_ms = float(np.median(comp["times"][warmup:]))
        eager_ms = float(np.median(eager["times"][warmup:]))
        rows[name] = step_ms
        log(f"[train-optimizers] {name}: losses {eager['losses']} equal in "
            f"both lanes; eager {eager_ms:.2f} ms, compiled {step_ms:.2f} "
            f"ms p50 a step; peak {comp['peak_gb']:.2f} GB")
        del model, opt, comp, eager
        torch.cuda.empty_cache()
    log(f"[train-optimizers] compiled step ms p50 by optimizer: "
        f"{ {k: round(v, 2) for k, v in rows.items()} }")
    small = gpt_config("gpt2-124m", num_layers=2, max_seq_len=256)
    model = GPTForCausalLM(small, device=dev, dtype=torch.float32, seed=1)
    x, y = (t.to(dev) for t in gpt2_batch(small.vocab_size, 2, 256, seed=1))
    opt = optim.LBFGS(learning_rate=1.0, max_iter=4, history_size=10,
                      line_search_fn="strong_wolfe",
                      parameters=model.parameters())

    def closure():
        opt.clear_grad()
        loss = model(x, labels=y)[1]
        loss.backward()
        return loss
    with torch.no_grad():
        first = float(model(x, labels=y)[1])
    losses = [float(opt.step(closure)) for _ in range(2)]
    with torch.no_grad():
        last = float(model(x, labels=y)[1])
    if not last < first or not all(np.isfinite(losses)):
        raise AssertionError(f"[train-optimizers] LBFGS: loss {first} -> "
                             f"{losses} -> {last}")
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        cs = CompiledTrainStep(lambda a, c: model(a, labels=c)[1], opt,
                               network=model)
    fell = [w for w in rec if "LBFGS.step is overridden" in str(w.message)]
    if len(fell) != 1 or cs.compiled or cs.fallback_reason is None:
        raise AssertionError(f"[train-optimizers] LBFGS: the compiled step "
                             f"did not fall back once: {rec}, "
                             f"{cs.fallback_reason}")
    log(f"[train-optimizers] LBFGS 2-layer fp32 (strong_wolfe, 4 "
        f"iterations a step): loss {first:.4f} -> {last:.4f}; compiled "
        f"step: one warning, fallback {cs.fallback_reason!r}")
    del model, opt, cs
    torch.cuda.empty_cache()


def phase_gpt2_parity(dev, steps=3, lr=3e-4):
    """A 2-layer GPT-2-width fp32 model with attention dropout 0.1 (the
    residual dropout off: its masks come from torch's device generators,
    which differ between the CPU and the card), built on the CPU and
    loaded onto the card, both models' flash generators on one seed: 3
    AdamW steps (clip 1.0) must agree to train-parity's tolerances."""
    cfg = gpt_config("gpt2-124m", num_layers=2, max_seq_len=256,
                     attn_dropout=0.1, dropout=0.0)
    t0 = time.monotonic()
    clip = ClipGradByGlobalNorm(1.0)
    cpu_model, cpu_opt = make_gpt_trainer(cfg, "cpu", torch.float32, 1, lr,
                                          clip)
    card_model, card_opt = make_gpt_trainer(cfg, dev, torch.float32, 1, lr,
                                            clip)
    card_model.load_state_dict(cpu_model.state_dict())
    ids, labels = gpt2_batch(cfg.vocab_size, 1, 256, seed=1)
    cpu_losses = [train_step(cpu_model, cpu_opt, ids, labels)
                  for _ in range(steps)]
    before = kernels.launch_counts()
    card_losses = [train_step(card_model, card_opt, ids.to(dev),
                              labels.to(dev)) for _ in range(steps)]
    after = kernels.launch_counts()
    if not np.allclose(card_losses, cpu_losses, rtol=1e-4, atol=0):
        raise AssertionError(f"losses differ: cpu {cpu_losses} card "
                             f"{card_losses}")
    skipped = [k for k in DROPOUT_KERNELS if after[k] == before[k]]
    if skipped:
        raise AssertionError(f"the card run skipped {skipped}")
    cpu_sd, card_sd = cpu_model.state_dict(), card_model.state_dict()
    worst = {}
    for name in ("gpt.wte.weight", "gpt.wpe.weight",
                 "gpt.h.0.attn.qkv_proj.weight", "gpt.h.0.attn.qkv_proj.bias",
                 "gpt.h.1.mlp.fc_out.weight", "gpt.h.1.ln_1.weight"):
        diff = (card_sd[name].cpu() - cpu_sd[name]).abs()
        off = float((diff > 1e-5).float().mean())
        worst[name] = (float(diff.max()), off)
        if off > 1e-4 or float(diff.max()) > 2 * lr * steps:
            raise AssertionError(f"{name}: max diff {float(diff.max()):.3e},"
                                 f" share above 1e-5 {off:.2e}")
    log(f"[gpt2-parity] 2-layer GPT-2-width fp32, attention dropout 0.1, "
        f"B1 x S256, {steps} AdamW steps: losses cpu {cpu_losses} card "
        f"{card_losses}; parameters (max diff, share > 1e-5) {worst}; the "
        f"card's dropout launches "
        f"{ {k: after[k] - before[k] for k in DROPOUT_KERNELS} } "
        f"({time.monotonic() - t0:.1f} s)")
    del card_model, card_opt
    torch.cuda.empty_cache()


def phase_attn_ops(dev):
    """The public attention entry points at GPT-2's shape ([B, S, H, D],
    bf16), forward and backward under autograd, each against its plain
    version (the same features and seed): scaled_dot_product_attention
    (boolean key-padding mask with a fully masked row, dropout 0.1,
    causal), flash_attention with four segments a row (causal), and
    variable-length attention with an additive length mask (not causal).
    Every call goes through the masked variants."""
    g2 = GPT2_SHAPE
    b, h, s, d = g2["b"], g2["h"], g2["s"], g2["d"]
    gen = torch.Generator(device=dev).manual_seed(5)

    def mk():
        return torch.randn(b, s, h, d, device=dev, generator=gen).bfloat16()
    q, k, v, do = mk(), mk(), mk(), mk()
    keep = padding_keep(dev, b, s)
    seg = packed_segments(dev, b, s)
    pos = torch.arange(s, device=dev)
    lens = torch.tensor([s - 100 * i for i in range(b)], device=dev)
    length_mask = torch.where(pos[None, None, None, :] < lens[:, None, None,
                                                              None],
                              0.0, fa.NEG_INF).expand(b, 1, s, s)
    seed = fa.draw_seed(torch.Generator().manual_seed(11))
    cases = [
        ("scaled_dot_product_attention", True,
         dict(mask=fa.additive_mask(keep), dropout=0.1, seed=seed),
         lambda q_, k_, v_: F.scaled_dot_product_attention(
             q_, k_, v_, attn_mask=keep, dropout_p=0.1, is_causal=True,
             generator=torch.Generator().manual_seed(11))),
        ("flash_attention(segment_ids)", True, dict(segment_ids=seg),
         lambda q_, k_, v_: fa.flash_attention(q_, k_, v_, causal=True,
                                               segment_ids=seg)),
        ("variable_length_memory_efficient_attention", False,
         dict(mask=length_mask),
         lambda q_, k_, v_: variable_length_memory_efficient_attention(
             q_, k_, v_, seq_lens=lens, kv_seq_lens=lens, mask=length_mask)),
    ]
    kernels.reset_launch_counts()
    for label, causal, feats, op in cases:
        qa, ka, va = (t.clone().requires_grad_(True) for t in (q, k, v))
        out = op(qa, ka, va)
        out.backward(do)
        torch.cuda.synchronize()
        out_ref, lse_ref = fa.flash_attention_ref(q, k, v, causal, None,
                                                  False, **feats)
        grads_ref = fa.flash_attention_bwd_ref(q, k, v, out_ref, lse_ref, do,
                                               causal, None, False, **feats)
        err, rel = check_rows(label, [
            ("out", out, out_ref), ("dq", qa.grad, grads_ref[0]),
            ("dk", ka.grad, grads_ref[1]), ("dv", va.grad, grads_ref[2])],
            torch.bfloat16)
        log(f"[attn-ops] {label}: forward and backward against the plain "
            f"version, worst row {rel:.2e} of its norm, max abs err "
            f"{err:.3e}")
        del qa, ka, va, out, out_ref, grads_ref
    counts = kernels.launch_counts()
    check_launches(counts, {k_: len(cases) for k_ in MASKED_KERNELS})
    log(f"[attn-ops] launches {counts}")
    trainable_mask_case(dev, gen)
    return counts


def trainable_mask_case(dev, gen, b=2):
    """A learned bias ``[1, H, S, S]`` that requires grad at GPT-2's H, S
    and D (bf16 q, k, v; B 2): the op takes its plain version, launches no
    kernel and counts the route; the bias gradient against an fp64
    autograd reference on the same bf16 inputs and the same bf16 output
    gradient (the plain version sums in fp32: the largest error within
    1e-5 of the largest element), and a control (the bias gradient of the
    non-causal call) rejected."""
    g2 = GPT2_SHAPE
    h, s, d = g2["h"], g2["s"], g2["d"]
    q, k, v, do = (torch.randn(b, s, h, d, device=dev, generator=gen)
                   .bfloat16() for _ in range(4))
    bias = torch.randn(1, h, s, s, device=dev, generator=gen)

    def reference(causal):
        rb = bias.double().requires_grad_(True)
        qd, kd, vd = (t.double().transpose(1, 2) for t in (q, k, v))
        logits = qd @ kd.transpose(-1, -2) / d ** 0.5 + rb
        if causal:
            logits = logits.masked_fill(~torch.ones(
                s, s, dtype=torch.bool, device=dev).tril(), float("-inf"))
        out = (torch.softmax(logits, dim=-1) @ vd).transpose(1, 2)
        (out * do.double()).sum().backward()
        return out, rb.grad
    before = kernels.launch_counts()
    routes = fa.flash_attention.plain_routes
    tb = bias.clone().requires_grad_(True)
    out = fa.flash_attention(q, k, v, attn_mask=tb, causal=True)
    out.backward(do)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    if after != before or fa.flash_attention.plain_routes != routes + 1:
        raise AssertionError(f"[attn-ops] trainable mask: launches "
                             f"{ {k_: after[k_] - before[k_] for k_ in after} }"
                             f", plain routes {routes} -> "
                             f"{fa.flash_attention.plain_routes}")
    ref_out, ref_grad = reference(True)

    def grad_err(want):
        # the largest error against the gradient's largest element
        return float((tb.grad.double() - want).abs().max()
                     / want.abs().max())
    err = grad_err(ref_grad)
    out_err = max_err(out, ref_out)
    if err > 1e-5 or out_err > 2e-2:
        raise AssertionError(f"[attn-ops] trainable mask: bias gradient "
                             f"{err:.3e} relative, output {out_err:.3e}")
    control = grad_err(reference(False)[1])
    if control <= 1e-5:
        raise AssertionError(f"[controls] trainable mask: the non-causal "
                             f"gradient passed ({control:.3e})")
    log(f"[attn-ops] trainable bias [1, {h}, {s}, {s}] (B{b}, bf16 q/k/v): "
        f"no flash launch, plain routes {routes} -> "
        f"{fa.flash_attention.plain_routes}; bias gradient against fp64 "
        f"autograd: max error {err:.3e} of its largest element (tolerance "
        f"1e-5), output max abs err "
        f"{out_err:.3e}")
    log(f"[controls] trainable mask: the non-causal gradient rejected "
        f"({control:.3e})")


# ---------------------------------------------------------------------------
# GPT serving, generation and recompute
# ---------------------------------------------------------------------------

def build_gpt_6_7b(dev):
    cfg = gpt_config("gpt3-6.7b", max_seq_len=2048)
    t0 = time.monotonic()
    model = GPTForCausalLM(cfg, device=dev, dtype=torch.bfloat16,
                           seed=0).eval()
    torch.cuda.synchronize()
    log(f"[serve-gpt] GPT-3 6.7B ({cfg.num_layers} layers, hidden "
        f"{cfg.hidden_size}, {cfg.num_heads} heads, max_seq_len "
        f"{cfg.max_seq_len}, vocab {cfg.vocab_size}; "
        f"{model.num_params(non_embedding=False) / 1e9:.2f} B params, bf16,"
        f" random weights, seed 0) built in {time.monotonic() - t0:.1f} s")
    return model


def phase_serve_gpt(dev, model):
    """The serve phase's 8 requests through the engine's defaults (paged
    KV, chunked prefill, prefix cache; 4 slots, bf16 pools, the model's
    2048-token context) with the tick on: every decode step a compiled
    tick, paged decode launched in every layer of every step; then one
    replay of each tick graph against its bound."""
    cfg = model.config
    prompts, sampling = serve_requests(cfg.vocab_size)
    scfg = ServingConfig(num_slots=4, cache_dtype="bfloat16")
    outs, st, counts, wall, peak_gb, eng = serve_run(
        model, dev, scfg, prompts, sampling)
    decode_steps = st["decode_steps"]
    need = {"paged_decode": cfg.num_layers * decode_steps}
    check_launches(counts, need)
    # every decode step is a replay of a graph that launches paged decode
    # once a layer
    per_replay = {mode: launches for mode, (_, _, launches)
                  in eng._tick.graph_stats().items()}
    if any(launches.get("paged_decode") != cfg.num_layers
           for launches in per_replay.values()):
        raise AssertionError(f"a tick graph's launches {per_replay}: not "
                             f"{cfg.num_layers} paged decodes a replay")
    if st.get("prefix_cache_hits", 0) < 1:
        raise AssertionError("the shared 64-token prefix was not reused")
    log(f"[serve-gpt] 8 requests ({sum(p.size for p in prompts)} prompt "
        f"tokens, {st['tokens_generated']} generated) in {wall:.2f} s: TTFT "
        f"p50 {st['ttft_ms_p50']:.1f} ms, {fmt_decode(st)}, "
        f"{st['tokens_generated'] / wall:.1f} tokens/s wall "
        f"({st['tokens_per_sec']:.1f} engine), peak memory {peak_gb:.2f} GB,"
        f" KV pages peak {st['kv_pages_peak']} of 16 tokens, prefix hits "
        f"{st['prefix_cache_hits']}")
    log(f"[serve-gpt] launches {counts} (needed >= {need}; the graphs' "
        f"launches a replay {per_replay})")
    log(f"[serve-gpt] compiled ticks {st['tick_compiled_hits']} of "
        f"{decode_steps} decode steps, fallbacks {st['tick_fallbacks']}; "
        f"graphs {fmt_graphs(eng)}")
    times = time_replays(model, eng._tick.steps, tag="serve-gpt")
    return counts, st, times


def _cpu_and_card(build, dev):
    cpu = build("cpu").eval()
    card = build(dev).eval()
    card.load_state_dict(cpu.state_dict())
    return cpu, card


def _gpt_adapter(model, seed, rank, std=0.02):
    return adapter_spec(model, seed, rank,
                        ("qkv_proj", "out_proj", "fc_in", "fc_out"), std=std)


def _engine_outputs(model, scfg, subs, max_new=8):
    with Engine(model, scfg) as eng:
        futs = [eng.submit(p, max_new_tokens=max_new, sampling=sp,
                           adapter_id=a) for p, sp, a in subs]
        outs = [f.result(timeout=600).output_ids for f in futs]
    st = serve_stats(eng)
    if st["tick_compiled_hits"] == 0 or st["tick_fallbacks"] or \
            st["tick_compiled_hits"] != st["decode_steps"]:
        raise AssertionError(f"compiled ticks {st['tick_compiled_hits']} of "
                             f"{st['decode_steps']}, fallbacks "
                             f"{st['tick_fallbacks']}")
    return outs


def _same(label, a, b):
    for x, y in zip(a, b):
        if not np.array_equal(np.asarray(x), np.asarray(y)):
            raise AssertionError(f"[gpt-parity] {label}: {np.asarray(x)} != "
                                 f"{np.asarray(y)}")


def _generate_checks(tag, model, dev, prompts, engine_outs, max_new=8):
    """On the card: generate with the cache equals generate without it
    and the engine's greedy tokens, prompt by prompt."""
    for p, want in zip(prompts, engine_outs):
        ids = torch.from_numpy(p[None].astype(np.int64)).to(dev)
        cached = model.generate(ids, max_new)[0, p.size:].cpu().numpy()
        full = model.generate(ids, max_new, use_cache=False)[0, p.size:] \
            .cpu().numpy()
        _same(f"{tag} generate cache / full", [cached], [full])
        _same(f"{tag} generate / engine", [cached], [want])


def phase_gpt_parity(dev):
    """A 2-layer fp32 GPT at GPT-3 6.7B width (and a GQA Llama at 7B
    width), the same weights on the CPU and on the card."""
    t0 = time.monotonic()
    cfg = gpt_config("gpt3-6.7b", num_layers=2, max_seq_len=256)
    cpu, card = _cpu_and_card(
        lambda d: GPTForCausalLM(cfg, device=d, seed=1), dev)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in (5, 40, 23)]
    greedy = [(p, SamplingParams(), None) for p in prompts]
    subs = greedy + [
        (prompts[1], SamplingParams(temperature=0.8, top_k=50, top_p=0.95,
                                    seed=3), None),
        (prompts[2], SamplingParams(temperature=1.0, top_p=0.9,
                                    repetition_penalty=1.1, seed=6), None)]
    kernels.reset_launch_counts()
    outs = {}
    for label, model in (("cpu", cpu), ("card", card)):
        outs[label] = _engine_outputs(model, ServingConfig(num_slots=4),
                                      subs)
    float_counts = kernels.launch_counts()
    _same("engine greedy + seeded cpu / card", outs["cpu"], outs["card"])
    log(f"[gpt-parity] engine, tick on, float pools: greedy and seeded "
        f"outputs identical on the CPU and the card for 3 + 2 requests: "
        f"{[o.tolist() for o in outs['card']]}")
    specs = {"a": _gpt_adapter(cpu, 7, 16, std=0.05),
             "b": _gpt_adapter(cpu, 8, 8, std=0.05)}
    scfg = ServingConfig(num_slots=4, cache_dtype="int8", max_adapters=2,
                         adapter_rank_pool=16, adapters=specs)
    lsubs = [(prompts[1], SamplingParams(), a) for a in (None, "a", "b")]
    kernels.reset_launch_counts()
    louts = {label: _engine_outputs(model, scfg, lsubs)
             for label, model in (("cpu", cpu), ("card", card))}
    lora_counts = kernels.launch_counts()
    _same("int8 + adapters cpu / card", louts["cpu"], louts["card"])
    base, a_out, b_out = louts["card"]
    if np.array_equal(base, a_out) or np.array_equal(base, b_out):
        raise AssertionError("an adapter request decoded the base tokens")
    skipped = [k for k in ("paged_decode_int8", "lora_delta")
               if lora_counts[k] == 0]
    if skipped or float_counts["paged_decode"] == 0:
        raise AssertionError(f"the card runs skipped {skipped}: "
                             f"{float_counts}, {lora_counts}")
    log(f"[gpt-parity] int8 pools + 2-adapter pool: identical on the CPU "
        f"and the card: base {base.tolist()}, a {a_out.tolist()}, b "
        f"{b_out.tolist()}; card launches paged_decode "
        f"{float_counts['paged_decode']} (float run), paged_decode_int8 "
        f"{lora_counts['paged_decode_int8']}, lora_delta "
        f"{lora_counts['lora_delta']}")
    kernels.reset_launch_counts()
    _generate_checks("gpt", card, dev, prompts, outs["card"][:3])
    gen_counts = kernels.launch_counts()
    if gen_counts["flash_fwd"] == 0:
        raise AssertionError(f"generate without the cache launched no flash "
                             f"forward: {gen_counts}")
    dcfg = gpt_config("gpt3-6.7b", num_layers=1, max_seq_len=256)
    draft = GPTForCausalLM(dcfg, device=dev, seed=2).eval()
    ids = torch.from_numpy(np.stack([prompts[1][:23], prompts[2]])
                           .astype(np.int64)).to(dev)
    want = card.generate(ids, 12)
    spec = generation.speculative_generate(card, draft, ids, 12,
                                           speculation_k=4)
    _same("speculative_generate / generate", [spec.cpu()], [want.cpu()])
    bid = torch.from_numpy(prompts[0][None].astype(np.int64))
    beams = {"cpu": generation.beam_search(cpu, bid, 4, num_beams=4),
             "card": generation.beam_search(card, bid.to(dev), 4,
                                            num_beams=4).cpu()}
    _same("beam_search cpu / card", [beams["cpu"]], [beams["card"]])
    log(f"[gpt-parity] card: generate with the cache = without it = the "
        f"engine's greedy tokens for 3 prompts (flash_fwd launches "
        f"{gen_counts['flash_fwd']}); speculative_generate (K 4, 1-layer "
        f"draft, B2, 12 tokens) = greedy generate "
        f"{want[:, -12:].tolist()}; beam_search (4 beams, 4 tokens) equal "
        f"on the CPU and the card {beams['card'][0, -4:].tolist()}")
    del cpu, card, draft
    torch.cuda.empty_cache()
    lcfg = llama_config("llama2-7b", num_layers=2, num_kv_heads=8,
                        max_seq_len=256)
    l_cpu, l_card = _cpu_and_card(
        lambda d: LlamaForCausalLM(lcfg, device=d, seed=3), dev)
    prompts = [p % lcfg.vocab_size for p in prompts]
    greedy = [(p, SamplingParams(), None) for p in prompts]
    louts = {label: _engine_outputs(model, ServingConfig(num_slots=4),
                                    greedy)
             for label, model in (("cpu", l_cpu), ("card", l_card))}
    _same("GQA Llama engine cpu / card", louts["cpu"], louts["card"])
    made = []
    real = generation.init_kv_caches

    def spy(*a, **kw):
        made.append(real(*a, **kw))
        return made[-1]
    generation.init_kv_caches = spy
    try:
        _generate_checks("GQA Llama", l_card, dev, prompts, louts["card"])
    finally:
        generation.init_kv_caches = real
    shapes = {tuple(c["k"].shape) for caches in made for c in caches}
    if any(sh[2] != lcfg.num_kv_heads for sh in shapes):
        raise AssertionError(f"dense caches {shapes}: not "
                             f"{lcfg.num_kv_heads} kv heads")
    log(f"[gpt-parity] GQA Llama (32 heads, 8 kv heads, 2 layers, 7B "
        f"width): engine identical on the CPU and the card, card generate "
        f"with the cache = without it = the engine's tokens; dense caches "
        f"{sorted(shapes)} ({time.monotonic() - t0:.1f} s in all)")
    del l_cpu, l_card
    torch.cuda.empty_cache()


def phase_generate_gpt(dev, model, b=2, prompt_len=64, new=16):
    """generate with the cache at GPT-3 6.7B in bf16: each step's
    last-position logits (recorded by a forward hook) against the full
    forward of the ids generate returned, teacher-forced, row by row
    within GEN_ROW_TOL; a control shifts the steps by one."""
    cfg = model.config
    rng = np.random.default_rng(12)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, prompt_len))
                           ).to(dev)
    model.generate(ids, 2)                              # warm
    steps = []
    hook = model.register_forward_hook(
        lambda m, a, out: steps.append(out[:, -1, :].float()))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.monotonic()
    try:
        out = model.generate(ids, new)
        torch.cuda.synchronize()
    finally:
        hook.remove()
    ms = (time.monotonic() - t0) * 1e3
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    if out.shape != (b, prompt_len + new) or len(steps) != new:
        raise AssertionError(f"generate gave {tuple(out.shape)} with "
                             f"{len(steps)} model calls")
    with torch.no_grad():
        full = model(out[:, :-1]).float()
    want = full[:, prompt_len - 1:, :]                 # [B, new, V]
    got = torch.stack(steps, dim=1)
    pairs = [(f"step {i}", got[:, i], want[:, i]) for i in range(new)]
    errs = [row_err(g, w) for _, g, w in pairs]
    worst = max(errs)
    if not worst <= GEN_ROW_TOL or not torch.isfinite(got).all():
        raise AssertionError(f"[generate-gpt] cached logits off the full "
                             f"forward's: worst row {worst:.3e} > "
                             f"{GEN_ROW_TOL} ({[f'{e:.2e}' for e in errs]})")
    shifted = max(row_err(got[:, i], want[:, i - 1]) for i in range(1, new))
    if shifted <= GEN_ROW_TOL:
        raise AssertionError(f"[controls] generate-gpt: the logits of the "
                             f"step before passed ({shifted:.3e})")
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    log(f"[generate-gpt] GPT-3 6.7B bf16, B{b}, {prompt_len}-token prompts, "
        f"{new} new tokens (fp32 dense caches): {ms / new:.2f} ms a token "
        f"({ms:.1f} ms in all), peak memory {peak_gb:.2f} GB; each step's "
        f"logits against the teacher-forced full forward: worst row "
        f"{worst:.3e} of its norm (tolerance {GEN_ROW_TOL}), argmax equal "
        f"in {100 * agree:.1f}% of rows")
    log(f"[controls] generate-gpt: the step before's logits rejected, worst "
        f"row {shifted:.3e}")
    return ms / new, peak_gb


def phase_train_gpt2_recompute(dev, plain=None, warmup=2, steps=6):
    """train-gpt2 (GPT-2 124M, dropouts 0.1, bf16 O2, AdamW(1e-4), B8 x
    S1024) with ``use_recompute=True``: the eager lane, then the model
    rebuilt from the same seed through `CompiledTrainStep`.  Each lane's
    losses must equal the lanes without recompute bit for bit (``plain``:
    train-gpt2's results; without them its eager lane runs here), the
    flash forward kernels launch twice a block a step and the backward
    ones once."""
    base = dict(max_seq_len=1024, attn_dropout=0.1, dropout=0.1)
    cfg = gpt_config("gpt2-124m", **base, use_recompute=True)
    b, seq = 8, 1024
    ids, labels = (t.to(dev) for t in gpt2_batch(cfg.vocab_size, b, seq))
    n = warmup + steps
    if plain is None:
        model, opt = make_gpt_trainer(gpt_config("gpt2-124m", **base), dev,
                                      torch.bfloat16, seed=0, lr=1e-4)
        lane = eager_lane("train-gpt2", model, opt, ids, labels, dev,
                          warmup, steps)
        plain = dict(eager=lane, compiled=dict(losses=lane["losses"],
                                               step_ms=None, peak_gb=None))
        del model, opt
        torch.cuda.empty_cache()
    model, opt = make_gpt_trainer(cfg, dev, torch.bfloat16, seed=0, lr=1e-4)
    kernels.reset_launch_counts()
    eager = eager_lane("train-gpt2-recompute", model, opt, ids, labels, dev,
                       warmup, steps)
    counts = eager["counts"]
    need = {"flash_fwd_dropout": 2 * cfg.num_layers * n,
            "flash_bwd_dkv_dropout": cfg.num_layers * n,
            "flash_bwd_dq_dropout": cfg.num_layers * n}
    if any(counts[k] != v for k, v in need.items()):
        raise AssertionError(f"[train-gpt2-recompute] eager launches "
                             f"{counts}, expected {need}")
    if eager["losses"] != plain["eager"]["losses"]:
        raise AssertionError(f"[train-gpt2-recompute] eager losses "
                             f"{eager['losses']} differ from train-gpt2's "
                             f"{plain['eager']['losses']}")
    tokens = ids.numel()
    n_params = model.num_params()
    flops = 6 * n_params * tokens + \
        6 * tokens * seq * cfg.hidden_size * cfg.num_layers
    lane_line("train-gpt2-recompute", "eager", eager, warmup, steps, tokens,
              flops)
    del model, opt
    torch.cuda.empty_cache()
    model, opt = make_gpt_trainer(cfg, dev, torch.bfloat16, seed=0, lr=1e-4)
    kernels.reset_launch_counts()
    comp = compiled_lane("train-gpt2-recompute", model, opt, ids, labels,
                         dev, warmup, steps)
    main_counts = kernels.launch_counts()
    if any(main_counts[k] != v for k, v in need.items()):
        raise AssertionError(f"[train-gpt2-recompute] compiled launches "
                             f"{main_counts}, expected {need}")
    lane_line("train-gpt2-recompute", "compiled", comp, warmup, steps,
              tokens, flops)
    check_compiled_losses("train-gpt2-recompute", comp["losses"],
                          plain["compiled"]["losses"])
    check_replay_launches("train-gpt2-recompute", counts, n, comp["cs"])
    for label, lane in (("eager", eager), ("compiled", comp)):
        ref = plain[label]
        diff = "" if ref.get("step_ms") is None else (
            f"; train-gpt2 {ref['step_ms']:.2f} ms, {ref['peak_gb']:.2f} GB"
            f" (step {lane['step_ms'] - ref['step_ms']:+.2f} ms, peak "
            f"{lane['peak_gb'] - ref['peak_gb']:+.2f} GB)")
        log(f"[train-gpt2-recompute] {label}: losses equal to train-gpt2's "
            f"bit for bit; {lane['step_ms']:.2f} ms a step p50, peak "
            f"{lane['peak_gb']:.2f} GB{diff}")
    log(f"[train-gpt2-recompute] launches (compiled lane: call 1 eager + "
        f"replays) {main_counts}: the flash forward twice a block a step")
    del model, opt, comp
    torch.cuda.empty_cache()
    return main_counts


# ---------------------------------------------------------------- fit
class TokenRows:
    """``n`` rows of ``seq + 1`` random token ids from a numpy seed; a row
    is ``(ids, labels)``, the labels the ids shifted by one."""

    def __init__(self, n, vocab, seq, seed=0):
        rng = np.random.default_rng(seed)
        self.rows = rng.integers(0, vocab, (n, seq + 1))

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, i):
        return self.rows[i, :-1], self.rows[i, 1:]


class StepLog(Callback):
    """Each step's loss (fit reads it back at ``log_freq=1``) and the
    host time between step ends; with ``sigterm_at`` it sends this
    process SIGTERM after that step (a preemption notice), and with
    ``path`` it appends each loss to that file."""

    def __init__(self, sigterm_at=None, path=None):
        super().__init__()
        self.losses, self.times = [], []
        self.sigterm_at, self.path = sigterm_at, path
        self._t = None
        self._it = 0

    def on_train_batch_begin(self, step, logs=None):
        if self._t is None:
            self._t = time.monotonic()

    def on_train_batch_end(self, step, logs=None):
        now = time.monotonic()
        self.times.append((now - self._t) * 1e3)
        self._t = now
        self.losses.append(logs["loss"])
        if self.path:
            with open(self.path, "a") as f:
                f.write(repr(logs["loss"]) + "\n")
        if self._it == self.sigterm_at:
            os.kill(os.getpid(), signal.SIGTERM)
        self._it += 1


#: fit-gpt2's depth: GPT-2 124M's width, 12 blocks cut to 6 (the card
#: script's time; sentinel-gpt2 keeps all 12)
FIT_LAYERS = 6


def fit_gpt2_model(dev, dropout, seed=0, lr=1e-4, layers=12):
    """GPT-2 124M (``layers`` of its 12 blocks) behind ``hapi.Model``: bf16
    O2 through ``prepare(amp_configs="O2")``, AdamW(lr, wd 0.01),
    CrossEntropyLoss."""
    cfg = gpt_config("gpt2-124m", max_seq_len=1024, attn_dropout=dropout,
                     dropout=dropout, num_layers=layers)
    net = GPTForCausalLM(cfg, device=dev, dtype=torch.float32, seed=seed)
    opt = AdamW(learning_rate=lr, parameters=net.parameters(),
                weight_decay=0.01)
    return Model(net).prepare(opt, CrossEntropyLoss(), amp_configs="O2")


def gpt2_pipeline(rows, prefetch=True):
    pipe = pdata.pipeline(TokenRows(rows, 50304, 1024)).shard(0, 1) \
        .shuffle(seed=0).batch(8)
    return pipe.device_prefetch(2) if prefetch else pipe


def hand_lane(model, batches, dev):
    """``model._forward_loss`` driven by hand through `CompiledTrainStep`
    over ``batches`` (host tensors, put on the card first): the losses,
    each step's host ms (to the loss read back) and the step object."""
    cs = CompiledTrainStep(model._forward_loss, model._optimizer,
                           network=model.network)
    staged = [tuple(t.to(dev) for t in b) for b in batches]
    torch.cuda.synchronize()
    fallbacks = jit_fallbacks()
    losses, times = [], []
    for x, y in staged:
        t0 = time.monotonic()
        losses.append(float(cs(x, y)))
        times.append((time.monotonic() - t0) * 1e3)
    if not cs.compiled or jit_fallbacks() != fallbacks:
        raise AssertionError(f"the hand lane fell back: {cs.fallback_reason}")
    return losses, times, cs


def replay_launches(cs):
    (label, (captures, _replays, per)), = [
        kv for kv in cs.graph_stats().items() if kv[0].startswith("full")]
    return captures, per


def fit_graph(tag, cs, fallbacks):
    """fit's compiled step ``cs``, which must not have fallen back (no
    ``jit.compiled_step_fallback`` counted over the fit, ``fallbacks``):
    its graphs and ``(captures, launches a replay)``."""
    if not cs or not cs.compiled or fallbacks or \
            cs.fallback_reason is not None:
        raise AssertionError(f"[{tag}] fit's compiled step fell back: "
                             f"{cs and cs.fallback_reason}")
    return cs.graph_stats(), replay_launches(cs)


def check_fit_step(tag, graph, hand_cs, want):
    """fit's compiled step (`fit_graph`) captured once and launches a
    replay what the hand lane's does, with ``want`` among them."""
    stats, (captures, per) = graph
    hand_captures, hand_per = replay_launches(hand_cs)
    if captures != 1 or hand_captures != 1 or per != hand_per:
        raise AssertionError(f"[{tag}] fit: {captures} captures, {per} a "
                             f"replay; hand lane {hand_captures}, {hand_per}")
    wrong = {k: per.get(k) for k, n in want.items() if per.get(k) != n}
    if wrong:
        raise AssertionError(f"[{tag}] launches a replay {per}: {wrong} "
                             f"differ from {want}")
    log(f"[{tag}] fit's graph {stats}; launches a replay equal the hand "
        f"lane's")


def same_losses(tag, got, want):
    if got != want or not all(np.isfinite(got)):
        raise AssertionError(f"[{tag}] losses {got} differ from {want}")


def profile_fit_steps(model, pipe, tag, n=3):
    """torch.profiler over ``n`` fit steps after one (all replays): the
    device's busy share of their wall time."""
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CUDA], acc_events=True)
    marks = {}

    class Window(Callback):
        def on_train_batch_begin(self, step, logs=None):
            if step == 1:
                torch.cuda.synchronize()
                prof.start()
                marks["t0"] = time.monotonic()

        def on_train_batch_end(self, step, logs=None):
            if step == n:
                torch.cuda.synchronize()
                marks["wall"] = (time.monotonic() - marks["t0"]) * 1e3
                prof.stop()

    model.fit(pipe, epochs=1, num_iters=n + 1, verbose=0, log_freq=1,
              callbacks=[Window()])
    rows = device_rows(prof)
    busy = sum(r[1] for r in rows)
    log(f"[{tag}] {n} fit steps: wall {marks['wall'] / n:.2f} ms a step, "
        f"device busy {busy / n:.2f} ms ({100 * busy / marks['wall']:.1f}%)")
    log(f"[{tag}] by group a step: " + fmt_groups(kernel_groups(rows, n), 2))
    return busy / marks["wall"]


def fit_child(mode, outdir, dev=None):
    """fit-gpt2 (b)'s child: 2 epochs of 3 steps at dropout 0 with a
    ModelCheckpoint in ``outdir/ckpt`` saving every second epoch, but for
    ``full``, the uninterrupted reference run (its 1.74 GB saves would
    only lengthen the phase; the SIGTERM handler is armed only while fit
    checkpoints, which it does not need); ``preempt`` sends SIGTERM after
    step 2 (fit saves and exits with ELASTIC_EXIT_CODE), ``resume``
    continues from the newest checkpoint, the rest of the first epoch and
    the second, reshuffled (the pipeline's next epoch).  Each loss is
    appended to ``outdir/losses.log``."""
    model = fit_gpt2_model(dev or torch.device("cuda", 0), dropout=0.0,
                           layers=FIT_LAYERS)
    if mode == "resume":
        # started beside the preempted child: built, it waits for the
        # parent's word that the preempted child's checkpoint is in
        wait_for_file(os.path.join(outdir, "go"))
    cb = StepLog(sigterm_at=1 if mode == "preempt" else None,
                 path=os.path.join(outdir, "losses.log"))
    model.fit(gpt2_pipeline(24), epochs=2, verbose=0, log_freq=1,
              callbacks=[cb],
              save_dir=None if mode == "full" else os.path.join(outdir,
                                                                "ckpt"),
              save_freq=2, max_to_keep=1, resume=mode == "resume")


def start_children(jobs):
    """Start every ``(mode, outdir)`` child of `fit_child` together."""
    return [(subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--fit-child", mode,
         outdir], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True), mode) for mode, outdir in jobs]


def wait_children(procs, timeout=600):
    """Wait for `start_children`'s ``procs``; returns their exit codes (a
    child past ``timeout`` is killed)."""
    codes = []
    for p, mode in procs:
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        codes.append(p.returncode)
        if p.returncode not in (0, ELASTIC_EXIT_CODE):
            log(f"[fit-gpt2] child {mode} exited {p.returncode}:\n"
                + out[-3000:])
    return codes


def read_losses(path):
    with open(path) as f:
        return f.read().split()


def state_bytes(state):
    total = 0
    for v in (state.values() if isinstance(state, dict) else state):
        if torch.is_tensor(v):
            total += v.numel() * v.element_size()
        elif isinstance(v, (dict, list, tuple)):
            total += state_bytes(v)
    return total


def checkpoint_numbers(model, batch, root):
    """fit-gpt2 (c): the state's bytes, a synchronous save's ms, how long
    an async save blocks the step loop (alone, and while the one before
    is still writing), ``restore_latest``'s ms; the newest checkpoint
    truncated, ``restore_latest`` must restore the older one, which must
    equal the synchronous checkpoint of the same state."""
    dev = model._device()
    sync = ModelCheckpoint(save_dir=os.path.join(root, "sync"))
    sync.set_model(model)
    state, _ = sync._state(1)
    nbytes = state_bytes(state)
    del state
    # the state the sync and the first async checkpoint hold
    want = {k: v.detach().cpu().clone()
            for k, v in model.network.state_dict().items()}
    torch.cuda.synchronize()
    save_sum = monitor.get_monitor_value("ckpt.save_ms.sum")
    t0 = time.monotonic()
    sync.save_now(1)
    sync_ms = (time.monotonic() - t0) * 1e3
    manager_ms = monitor.get_monitor_value("ckpt.save_ms.sum") - save_sum
    acb = ModelCheckpoint(save_dir=os.path.join(root, "async"),
                          async_save=True)
    acb.set_model(model)
    t0 = time.monotonic()
    acb.save_now(1)
    first_block = (time.monotonic() - t0) * 1e3
    step_ms = []
    for _ in range(3):                  # steps while the save writes
        t0 = time.monotonic()
        model.train_batch([batch[0]], [batch[1]])
        step_ms.append((time.monotonic() - t0) * 1e3)
    blocked_sum = monitor.get_monitor_value("ckpt.save_blocked_ms.sum")
    t0 = time.monotonic()
    acb.save_now(2)
    second_block = (time.monotonic() - t0) * 1e3
    waited = monitor.get_monitor_value("ckpt.save_blocked_ms.sum") - \
        blocked_sum
    acb.manager.wait()
    log(f"[fit-gpt2] checkpoint state {nbytes / 1e9:.3f} GB (bf16 params, "
        f"fp32 masters and moments); sync save {sync_ms:.1f} ms "
        f"(manager {manager_ms:.1f} ms); async save blocks "
        f"the loop {first_block:.2f} ms, then {second_block:.1f} ms "
        f"({waited:.1f} ms of it waiting for the previous save); steps "
        f"while it wrote {[round(t, 1) for t in step_ms]} ms")
    mgr = CheckpointManager(os.path.join(root, "async"), map_location=dev)
    t0 = time.monotonic()
    _, step = mgr.restore_latest()
    torch.cuda.synchronize()
    restore_ms = (time.monotonic() - t0) * 1e3
    newest = os.path.join(root, "async", step_dir_name(step), "state.pkl")
    with open(newest, "r+b") as f:
        f.truncate(os.path.getsize(newest) // 2)
    got = mgr.restore_latest()
    if got is None or got[1] != step - 1:
        raise AssertionError(f"[fit-gpt2] truncated ckpt-{step}: restored "
                             f"{got and got[1]}, expected {step - 1}")
    for k, v in want.items():
        if not torch.equal(got[0]["model"][k].cpu(), v):
            raise AssertionError(f"[fit-gpt2] async checkpoint's {k} differs"
                                 f" from the synchronous one of that state")
    log(f"[fit-gpt2] restore_latest {restore_ms:.1f} ms; ckpt-{step} "
        f"truncated: skipped, ckpt-{step - 1} restored, equal to the state "
        f"the sync checkpoint saved")
    return dict(bytes=nbytes, sync_ms=sync_ms, first_block_ms=first_block,
                second_block_ms=second_block, restore_ms=restore_ms)


def phase_fit_gpt2(dev, warmup=2, steps=6):
    """GPT-2 124M width, FIT_LAYERS of 12 layers, bf16 O2, AdamW(1e-4, wd
    0.01), B8 x S1024 through ``hapi.Model.fit`` over ``data.pipeline(ds).shard(0, 1)
    .shuffle(seed=0).batch(8).device_prefetch(2)``: (a) at dropout 0.1
    the losses and launches a replay of 2 + 6 fit steps equal the same
    ``_forward_loss`` driven by hand through CompiledTrainStep; (b) at
    dropout 0, SIGTERM after step 2 of 2 epochs of 3 in a child: exit 101
    and a committed checkpoint, a child started beside it resumes once it
    exited and crosses into the second epoch, the losses equal an
    uninterrupted child's; (c) the checkpoint's numbers; (d) fit's step
    ms beside the hand lane's, goodput, the busy share of 3 fit steps."""
    n = warmup + steps
    t0 = time.monotonic()
    model = fit_gpt2_model(dev, dropout=0.1, layers=FIT_LAYERS)
    log(f"[fit-gpt2] GPT-2 124M width, {FIT_LAYERS} of 12 layers, dropout 0.1, bf16 O2 (prepare), AdamW(1e-4,"
        f" wd 0.01), B8 x S1024, data.pipeline ... device_prefetch(2); built"
        f" in {time.monotonic() - t0:.1f} s")
    clock = StepLog()
    pipe = gpt2_pipeline(8 * n)
    kernels.reset_launch_counts()
    fallbacks = jit_fallbacks()
    model.fit(pipe, epochs=1, verbose=0, log_freq=1, callbacks=[clock])
    fallbacks = jit_fallbacks() - fallbacks
    counts = kernels.launch_counts()
    check_launches(counts, gpt2_launches(FIT_LAYERS, n))
    good = pipe.goodput.snapshot()
    hand = fit_gpt2_model(dev, dropout=0.1, layers=FIT_LAYERS)
    hand_losses, hand_times, hand_cs = hand_lane(
        hand, list(gpt2_pipeline(8 * n, prefetch=False)), dev)
    same_losses("fit-gpt2", clock.losses, hand_losses)
    check_fit_step("fit-gpt2", fit_graph("fit-gpt2", model._compiled_step,
                                         fallbacks),
                   hand_cs,
                   gpt2_launches(FIT_LAYERS, 1))
    del hand, hand_cs
    torch.cuda.empty_cache()
    fit_ms = float(np.median(clock.times[warmup:]))
    hand_ms = float(np.median(hand_times[warmup:]))
    log(f"[fit-gpt2] (a) {n} fit steps: losses {clock.losses}, equal to the "
        f"hand lane's bit for bit; launches {counts}")
    log(f"[fit-gpt2] (d) step {fit_ms:.2f} ms p50 through fit (all: "
        f"{[round(t, 1) for t in clock.times]}), hand lane {hand_ms:.2f} ms "
        f"(all: {[round(t, 1) for t in hand_times]}); goodput {good}")
    clock.set_model(None)               # the callback held the model
    busy = profile_fit_steps(model, gpt2_pipeline(40), "fit-gpt2-profile")
    root = tempfile.mkdtemp(prefix="fit-gpt2-")
    try:
        batch = next(iter(gpt2_pipeline(8, prefetch=False)))
        ckpt = checkpoint_numbers(model, [t.to(dev) for t in batch], root)
        check_exposition("fit-gpt2 (c)", ("ckpt_save_ms", "ckpt_saves",
                                          "ckpt_restores",
                                          "ckpt_save_blocked_ms"))
        del model
        torch.cuda.empty_cache()
        full, pre = (os.path.join(root, d) for d in ("full", "preempt"))
        for d in (full, pre):
            os.makedirs(d)
        procs = start_children([("full", full), ("preempt", pre),
                                ("resume", pre)])
        try:
            codes = wait_children(procs[1:2])
            first = read_losses(os.path.join(pre, "losses.log"))
            committed = CheckpointManager(
                os.path.join(pre, "ckpt")).latest_step()
            if codes != [ELASTIC_EXIT_CODE] or len(first) != 2 or \
                    committed is None:
                raise AssertionError(
                    f"[fit-gpt2] (b) preempted child: exit {codes}, "
                    f"{len(first)} steps, checkpoint {committed}")
            open(os.path.join(pre, "go"), "w").close()
            codes = wait_children([procs[0], procs[2]])
        finally:
            for p, _ in procs:
                if p.poll() is None:
                    p.kill()
        if codes != [0, 0]:
            raise AssertionError(f"[fit-gpt2] (b) the uninterrupted and "
                                 f"the resumed child exited {codes}")
        resumed = read_losses(os.path.join(pre, "losses.log"))
        whole = read_losses(os.path.join(full, "losses.log"))
        if resumed != whole or len(whole) != 6:
            raise AssertionError(f"[fit-gpt2] (b) preempted + resumed "
                                 f"{resumed} != uninterrupted {whole}")
        log(f"[fit-gpt2] (b) SIGTERM after step 2 of 2 epochs of 3: exit "
            f"{ELASTIC_EXIT_CODE}, ckpt-{committed} committed; resumed "
            f"mid-epoch and trained into the reshuffled second epoch, the "
            f"6 losses equal the uninterrupted run's bit for bit: {whole}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return dict(fit_ms=fit_ms, hand_ms=hand_ms, busy=busy, goodput=good,
                **ckpt)


def phase_fit_llama(dev, warmup=2, steps=4):
    """Llama-2 7B width, 8 of 32 layers (phase 7's cut), bf16 O2,
    AdamW(3e-4, wd 0.01, ClipGradByGlobalNorm(1.0)), B1 x S4096, through
    ``Model.fit`` over a DataLoader of seeded rows for 2 + 4 steps (then
    the busy share of 3 more fit steps); then the same model from the
    same seed driven by hand through CompiledTrainStep (the two do not
    fit on the card together): equal losses and launches a replay.  The
    DataLoader runs 2 worker processes over the shared-memory queue:
    every batch must come from one, and none fall back to threads."""
    cfg = llama_config("llama2-7b", num_layers=8)
    n = warmup + steps
    rows = TokenRows(n, cfg.vocab_size, 4096).rows
    loader = DataLoader(TensorDataset([rows[:, :-1], rows[:, 1:]]),
                        batch_size=1, shuffle=False, num_workers=2)
    fallbacks0 = monitor.get_monitor_value("io.worker_fallbacks")

    def build():
        net = LlamaForCausalLM(cfg, device=dev, dtype=torch.float32, seed=0)
        opt = AdamW(learning_rate=3e-4, parameters=net.parameters(),
                    weight_decay=0.01, grad_clip=ClipGradByGlobalNorm(1.0))
        return Model(net).prepare(opt, CrossEntropyLoss(),
                                  amp_configs="O2")
    model = build()
    clock = StepLog()
    kernels.reset_launch_counts()
    fallbacks = jit_fallbacks()
    model.fit(loader, epochs=1, verbose=0, log_freq=1, shuffle=False,
              callbacks=[clock])
    counts = kernels.launch_counts()
    # every batch from a worker process over the shared-memory queue
    pids = list(loader.batch_pids)
    worker_fallbacks = monitor.get_monitor_value("io.worker_fallbacks") - \
        fallbacks0
    if len(pids) != n or os.getpid() in pids or len(set(pids)) != 2 or \
            worker_fallbacks:
        raise AssertionError(
            f"[fit-llama] the DataLoader's batches came from pids {pids} "
            f"(this process {os.getpid()}; want {n} batches from 2 worker "
            f"processes), io.worker_fallbacks {worker_fallbacks} (want 0)")
    need = {k: cfg.num_layers * n for k in TRAIN_KERNELS}
    need["adam"] = 75 * n
    check_launches(counts, need)
    graph = fit_graph("fit-llama", model._compiled_step,
                      jit_fallbacks() - fallbacks)
    # fit-llama's input is the io.DataLoader: its families on the registry
    check_exposition("fit-llama", ("io_batches_fetched", "io_fetch_ms"))
    fit_ms = float(np.median(clock.times[warmup:]))
    clock.set_model(None)
    busy = profile_fit_steps(model, loader, "fit-llama-profile")
    del model                    # with its compiled step and graph pool
    torch.cuda.empty_cache()
    hand = build()
    hand_losses, hand_times, hand_cs = hand_lane(hand, list(loader), dev)
    same_losses("fit-llama", clock.losses, hand_losses)
    check_fit_step("fit-llama", graph, hand_cs,
                   dict(rms_norm=17, rms_norm_bwd=17, rope=32, flash_fwd=8,
                        flash_bwd_dkv=8, flash_bwd_dq=8, adam=75))
    hand_ms = float(np.median(hand_times[warmup:]))
    log(f"[fit-llama] {n} fit steps: losses {clock.losses}, equal to the "
        f"hand lane's bit for bit; launches {counts}; the DataLoader's "
        f"{len(pids)} batches from 2 worker processes (pids "
        f"{sorted(set(pids))}, this process {os.getpid()}) over the "
        f"shared-memory queue, io.worker_fallbacks {worker_fallbacks}")
    log(f"[fit-llama] step {fit_ms:.2f} ms p50 through fit (all: "
        f"{[round(t, 1) for t in clock.times]}), hand lane {hand_ms:.2f} ms "
        f"(all: {[round(t, 1) for t in hand_times]})")
    del hand, hand_cs
    torch.cuda.empty_cache()
    return dict(fit_ms=fit_ms, hand_ms=hand_ms, busy=busy)


# ------------------------------------------------ the sentinel and LoRA
#: sentinel-gpt2's flags: a check every 8 steps, an anchor at most every 8,
#: the loss z-score over the last 8 accepted losses (at least 4)
SENTINEL_FLAGS = {"FLAGS_sentinel_check_every": 8,
                  "FLAGS_sentinel_anchor_every": 8,
                  "FLAGS_sentinel_window": 8}
#: lora-llama: the served adapter's prefill logits may differ from the
#: wrapped model's forward, and from the fp32 adapted model, by this many
#: times the model's bf16 floor, measured in the same run: the worst row
#: error (relative to its norm) of the bf16 base's logits against the fp32
#: base's.  Both bf16 paths round every activation (and the wrapped one the
#: weight W + A B s, the pool x W + (x A) B s) as the base does, in other
#: places, so each sits about one floor from the fp32 function; two floors
#: bound their distance.  A pool that dropped the adapter sits as far from
#: the adapted model as the base does (the control).
LORA_FLOOR_MULT = 2.0


class SentinelLog(Callback):
    """Each step's loss (``log_freq=1``), the fit's sentinel (its
    ``report()`` kept as ``report`` once the fit ends, when
    `sentinel_fit` drops the log's references to the model: a log kept
    for its losses must not keep a model and its graphs' pool alive), and
    a pair of CUDA events around each step (batch begin to batch end, on
    the current stream): the phase's own device step times."""

    def __init__(self):
        super().__init__()
        self.losses, self.events = [], []
        self.sentinel = self.report = None

    def on_train_batch_begin(self, step, logs=None):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.events.append([ev])

    def on_train_batch_end(self, step, logs=None):
        self.losses.append(logs["loss"])
        self.sentinel = self.model._sentinel
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.events[-1].append(ev)

    def step_ms(self):
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.events]


def spike_loader(steps, vocab, spike=None, skip=(), seed=0):
    """A DataLoader of ``steps`` batches of 8 x 1024 tokens: every batch the
    same 8 seeded rows (the model learns them and the loss falls), batch
    ``spike`` 8 other random rows (random ids, random labels: a finite loss
    spike the data carries), the batches in ``skip`` left out (a clean
    run)."""
    rng = np.random.default_rng(seed)
    same = rng.integers(0, vocab, (8, 1025))
    other = rng.integers(0, vocab, (8, 1025))
    skip = {skip} if isinstance(skip, int) else set(skip)
    rows = np.concatenate([other if k == spike else same
                           for k in range(steps) if k not in skip])
    return DataLoader(TensorDataset([rows[:, :-1], rows[:, 1:]]),
                      batch_size=8, shuffle=False)


def sentinel_fit(model, data, tag, sentinel, compiled=True, fault="",
                 callbacks=(), dump=None):
    """``model.fit(data)`` for one epoch (the loss read each step) with
    FLAGS_sentinel, the compiled step and the fault spec set; returns the
    `SentinelLog` (its ``sentinel`` the fit's, or None)."""
    port_flags.set_flags(dict(SENTINEL_FLAGS, FLAGS_sentinel=sentinel,
                              FLAGS_compiled_train_step=compiled,
                              FLAGS_fault_inject=fault,
                              FLAGS_sentinel_dump_path=dump or ""))
    rec = SentinelLog()
    fallbacks = jit_fallbacks()
    try:
        model.fit(data, epochs=1, verbose=0, log_freq=1, shuffle=False,
                  callbacks=[rec, *callbacks])
        rec.jit_fallbacks = jit_fallbacks() - fallbacks
        if rec.sentinel is not None:
            rec.report = rec.sentinel.report()
        rec.sentinel = None
        rec.set_model(None)
    finally:
        port_flags.set_flags({"FLAGS_sentinel": False,
                              "FLAGS_compiled_train_step": True,
                              "FLAGS_fault_inject": ""})
    if not all(np.isfinite(rec.losses)):
        raise AssertionError(f"[{tag}] non-finite logged losses {rec.losses}")
    return rec


def weights(model):
    return {k: v.detach().clone() for k, v in
            model.network.state_dict().items()}


def same_weights(tag, got, want):
    bad = [k for k, v in want.items()
           if not torch.equal(got[k].view(torch.uint8)
                              if got[k].dtype == torch.bfloat16 else got[k],
                              v.view(torch.uint8)
                              if v.dtype == torch.bfloat16 else v)]
    if bad:
        worst = max(float((got[k].float() - want[k].float()).abs().max())
                    for k in bad)
        raise AssertionError(f"[{tag}] {len(bad)} of {len(want)} tensors "
                             f"differ (worst {worst:.3e}): {bad[:4]}")


def check_dump(tag, path):
    """``tools/check_telemetry.py --sentinel-dump`` on ``path``; returns the
    dump's action."""
    run_check_telemetry(tag, "--sentinel-dump", path)
    with open(path) as f:
        return json.load(f)["sentinel"]["action"]


def graph_ms(step, n=10):
    """The device ms of one replay of a `CapturedStep`'s graph: ``n``
    replays between two CUDA events (no seed refill: timing only)."""
    step.graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(n):
        step.graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def host_ms(fn):
    torch.cuda.synchronize()
    t0 = time.monotonic()
    out = fn()
    torch.cuda.synchronize()
    return (time.monotonic() - t0) * 1e3, out


def sentinel_graphs(tag, cs, fallbacks):
    """The sentinel step's graphs: a full and a cadence (``+health``) graph
    of one batch signature, each captured once, and no
    ``jit.compiled_step_fallback`` over its fit (``fallbacks``); returns
    {label: step}."""
    stats = cs.graph_stats()
    caps = {k: v[0] for k, v in stats.items()}
    if len(caps) != 2 or set(caps.values()) != {1} or fallbacks or \
            not cs.compiled:
        raise AssertionError(f"[{tag}] graphs {stats}, fallbacks "
                             f"{fallbacks}")
    return {("health" if key[3] else "full"): st
            for key, st in cs._steps.items()}


def phase_sentinel_gpt2(dev, n=16):
    """GPT-2 124M, nothing cut, dropout 0.1, bf16 O2, AdamW, B8 x S1024,
    through ``Model.fit`` on CompiledTrainStep under the training sentinel
    (check and anchor every 8 steps, z-score window 8):
    (a) 16 steps with FLAGS_sentinel on against off: losses and weights
    bit for bit, no anomaly, each of the step's two graphs (full, and the
    cadence one with the squared norm) captured once; (e) the same run's
    telemetry: train.step_time_ms p50, tokens/s and train.mfu against the
    phase's own CUDA-event step times, the exporter's lines through
    ``tools/check_telemetry.py --snapshots``; (b) a spike the data carries
    (batch 20 of 32 random rows after 20 batches of one memorised set):
    one rollback into the captured graphs (no new capture), 20
    quarantined, the dump through ``--sentinel-dump``, the weights equal
    to a clean run without batch 20; (c) the eager lane: ``loss_spike``
    at 12 (a rollback) against the clean run without batch 12, and
    ``grad_bitflip`` at 12 (skipped by the unit-scale scaler's found-inf,
    quarantined) against a clean run that draws batch 12's dropout masks
    without training on it; (d) the sentinel's cost: one replay of each
    graph against the run without it, an anchor in host memory and
    through CheckpointManager, a rollback."""
    from paddle_tpu_torch.framework.checkpoint_manager import \
        validate_finite_state
    from paddle_tpu_torch.observability import REGISTRY, exporter
    vocab = 50304
    root = tempfile.mkdtemp(prefix="sentinel-gpt2-")
    out = {}
    try:
        # (a) healthy, on against off
        kernels.reset_launch_counts()
        off = fit_gpt2_model(dev, dropout=0.1)
        rec_off = sentinel_fit(off, gpt2_pipeline(8 * n), "sentinel-gpt2",
                               sentinel=False)
        w_off = weights(off)
        (_, off_step), = [kv for kv in off._compiled_step._steps.items()]
        off_ms = graph_ms(off_step)
        del off, off_step
        torch.cuda.empty_cache()
        snap_path = os.path.join(root, "metrics.jsonl")
        REGISTRY.get("train.step_time_ms").reset()
        port_flags.set_flags({"FLAGS_metrics_export_path": snap_path})
        on = fit_gpt2_model(dev, dropout=0.1)
        kernels.reset_launch_counts()
        try:
            rec_on = sentinel_fit(on, gpt2_pipeline(8 * n), "sentinel-gpt2",
                                  sentinel=True)
        finally:
            port_flags.set_flags({"FLAGS_metrics_export_path": ""})
            exporter.stop_exporter()
        counts = kernels.launch_counts()
        check_launches(counts, dict({k: 12 * n for k in DROPOUT_KERNELS},
                                    adam=148 * n))
        rep = rec_on.report
        if rep["anomalies"] or rep["rollbacks"] or rep["skips"]:
            raise AssertionError(f"[sentinel-gpt2] (a) healthy run: {rep}")
        same_losses("sentinel-gpt2", rec_on.losses, rec_off.losses)
        same_weights("sentinel-gpt2", weights(on), w_off)
        graphs = sentinel_graphs("sentinel-gpt2", on._compiled_step,
                                 rec_on.jit_fallbacks)
        log(f"[sentinel-gpt2] (a) {n} fit steps, sentinel on = off bit for "
            f"bit: losses {rec_on.losses}; {len(w_off)} tensors equal; "
            f"report {rep}; graphs {on._compiled_step.graph_stats()}; "
            f"launches {counts}")
        # (e) the telemetry of the run under the sentinel
        sm = on.step_metrics.snapshot()
        ev_ms = rec_on.step_ms()[2:]
        ev_p50 = float(np.median(ev_ms))
        flops = sm["flops_per_step"]
        peak = on.step_metrics.peak_flops()
        ev_mfu = flops / (ev_p50 / 1e3) / peak
        hist = sm["step_time_ms"]
        p50 = hist["p50"]
        tok_s = sm["tokens_per_sec"]
        if not (sm["mfu"] <= 1.0 and abs(sm["mfu"] - ev_mfu) < 0.02):
            raise AssertionError(f"[sentinel-gpt2] (e) train.mfu {sm['mfu']}"
                                 f" against the phase's {ev_mfu}")
        snaps = run_check_telemetry("sentinel-gpt2 (e)", "--snapshots",
                                    snap_path)
        check_exposition("sentinel-gpt2 (e)", (
            "jit_compiled_step_hit", "jit_compiled_step_compile",
            "data_batches", "data_fetch_ms", "data_starved_steps",
            "data_prefetch_occupancy", "data_input_bound"), "--data")
        log(f"[sentinel-gpt2] (e) train.step_time_ms p50 {p50:.3f} ms (the "
            f"registry's estimate within a bucket of 3 a decade; min "
            f"{hist['min']:.3f}, avg {hist['avg']:.3f}, max {hist['max']:.3f}"
            f" over {hist['count']} steps) against the phase's CUDA events: "
            f"p50 {ev_p50:.3f} (all "
            f"{[round(t, 2) for t in ev_ms]}); train.tokens_per_sec "
            f"{tok_s:.0f} (last step); step FLOPs {flops:.4e} (the "
            f"counter); train.mfu {sm['mfu']:.4f} against the phase's "
            f"{ev_mfu:.4f} (peak {peak:.4e}); memory "
            f"{sm['memory']}; exporter lines pass --snapshots: "
            f"{snaps.strip()}")
        # (d) the sentinel's costs
        full_ms = graph_ms(graphs["full"])
        health_ms = graph_ms(graphs["health"])
        snap_ms, state = host_ms(on._sentinel_snapshot)
        valid_ms, _ = host_ms(lambda: validate_finite_state(state))
        mgr = CheckpointManager(os.path.join(root, "anchor"),
                                map_location=dev)
        disk_ms, _ = host_ms(lambda: mgr.save_anchor(state, step=1))
        restore_ms, _ = host_ms(lambda: on._sentinel_restore(state))
        disk_restore_ms, _ = host_ms(
            lambda: on._sentinel_restore(mgr.restore_anchor()[0]))
        del state
        log(f"[sentinel-gpt2] (d) one replay: without the sentinel "
            f"{off_ms:.3f} ms, with it {full_ms:.3f} ms (+{full_ms - off_ms:.3f}"
            f"), a cadence replay {health_ms:.3f} ms (+{health_ms - off_ms:.3f}"
            f"); an anchor in host memory {snap_ms:.1f} ms snapshot + "
            f"{valid_ms:.1f} ms finiteness check; through CheckpointManager "
            f"{disk_ms:.1f} ms more; a rollback from host memory "
            f"{restore_ms:.1f} ms, from the anchor dir {disk_restore_ms:.1f}"
            f" ms")
        out.update(off_ms=off_ms, full_ms=full_ms, health_ms=health_ms,
                   snap_ms=snap_ms + valid_ms, disk_ms=disk_ms,
                   restore_ms=restore_ms, disk_restore_ms=disk_restore_ms,
                   p50=p50, ev_p50=ev_p50, mfu=sm["mfu"], ev_mfu=ev_mfu,
                   tok_s=tok_s)
        del on, graphs
        torch.cuda.empty_cache()
        # (b) a spike the data carries, the compiled lane
        k, nb = 20, 32
        dump = os.path.join(root, "b.json")
        model = fit_gpt2_model(dev, dropout=0.1, lr=3e-4)
        rec = sentinel_fit(model, spike_loader(nb, vocab, spike=k),
                           "sentinel-gpt2", sentinel=True, dump=dump)
        rep = rec.report
        quarantined = rep["quarantined"]
        if rep["rollbacks"] != 1 or k not in quarantined or \
                rep["anomalies"][0]["step"] != k or \
                rep["anomalies"][0]["signal"] != "loss_spike":
            raise AssertionError(f"[sentinel-gpt2] (b) {rep}; losses "
                                 f"{rec.losses}")
        sentinel_graphs("sentinel-gpt2 (b)", model._compiled_step,
                        rec.jit_fallbacks)
        action = check_dump("sentinel-gpt2", dump)
        w_b = weights(model)
        del model
        torch.cuda.empty_cache()
        clean = fit_gpt2_model(dev, dropout=0.1, lr=3e-4)
        rec_clean = sentinel_fit(clean, spike_loader(nb, vocab, spike=k,
                                                     skip=quarantined),
                                 "sentinel-gpt2", sentinel=False)
        same_weights("sentinel-gpt2 (b)", w_b, weights(clean))
        log(f"[sentinel-gpt2] (b) batch {k} of {nb} random: {rep}; dump "
            f"'{action}' passes --sentinel-dump; each graph captured once; "
            f"weights equal the clean run without batches {quarantined} bit "
            f"for bit (its losses {[round(v, 4) for v in rec_clean.losses]});"
            f" the run's losses {[round(v, 4) for v in rec.losses]}")
        del clean, w_b
        torch.cuda.empty_cache()
        # (c) the eager lane's seams
        k, nc = 12, 24
        dump = os.path.join(root, "c.json")
        model = fit_gpt2_model(dev, dropout=0.1, lr=3e-4)
        rec = sentinel_fit(model, spike_loader(nc, vocab), "sentinel-gpt2",
                           sentinel=True, compiled=False, dump=dump,
                           fault=f"loss_spike:at_step={k},scale=1e6")
        rep = rec.report
        quarantined = rep["quarantined"]
        if rep["rollbacks"] != 1 or k not in quarantined or \
                rep["anomalies"][0]["step"] != k:
            raise AssertionError(f"[sentinel-gpt2] (c) loss_spike {rep}")
        action = check_dump("sentinel-gpt2", dump)
        w_c = weights(model)
        del model
        clean = fit_gpt2_model(dev, dropout=0.1, lr=3e-4)
        sentinel_fit(clean, spike_loader(nc, vocab, skip=quarantined),
                     "sentinel-gpt2", sentinel=False, compiled=False)
        same_weights("sentinel-gpt2 (c) loss_spike", w_c, weights(clean))
        log(f"[sentinel-gpt2] (c) eager loss_spike at {k}: {rep}; dump "
            f"'{action}'; weights equal the clean run without batches "
            f"{quarantined}")
        del clean
        clean = fit_gpt2_model(dev, dropout=0.1, lr=3e-4)
        sentinel_fit(clean, spike_loader(nc, vocab, skip=k), "sentinel-gpt2",
                     sentinel=False, compiled=False)
        w_clean = weights(clean)
        del clean
        model = fit_gpt2_model(dev, dropout=0.1, lr=3e-4)
        rec = sentinel_fit(model, spike_loader(nc, vocab), "sentinel-gpt2",
                           sentinel=True, compiled=False,
                           fault=f"grad_bitflip:at_step={k}")
        rep = rec.report
        if rep["rollbacks"] or rep["skips"] != 1 or rep["quarantined"] != [k]:
            raise AssertionError(f"[sentinel-gpt2] (c) grad_bitflip {rep}")
        w_f = weights(model)
        del model
        diff = max(float((w_f[key].float() - v.float()).abs().max())
                   for key, v in w_clean.items())
        batch_k = next(b for i, b in enumerate(spike_loader(nc, vocab))
                       if i == k)

        class DrawMasks(Callback):
            """After step k - 1, a no-grad forward of batch k in training
            mode: it draws the dropout masks and flash seeds the skipped
            step drew, and trains nothing."""

            def on_train_batch_end(self, step, logs=None):
                if step == k - 1:
                    with torch.no_grad(), self.model._autocast():
                        self.model.network(batch_k[0].to(dev))
        ref = fit_gpt2_model(dev, dropout=0.1, lr=3e-4)
        sentinel_fit(ref, spike_loader(nc, vocab, skip=k), "sentinel-gpt2",
                     sentinel=False, compiled=False, callbacks=[DrawMasks()])
        same_weights("sentinel-gpt2 (c) grad_bitflip", w_f, weights(ref))
        log(f"[sentinel-gpt2] (c) eager grad_bitflip at {k}: {rep}; weights "
            f"equal a clean run that draws batch {k}'s masks without training "
            f"on it, bit for bit; against the clean run that never draws "
            f"them: max difference {diff:.3e} (the skipped step's dropout "
            f"draws, ROADMAP Queue C)")
        out["bitflip_vs_clean"] = diff
        del ref
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


def phase_lora_llama(dev, warmup=2, steps=4):
    """Llama-2 7B width, 8 of 32 layers (train's cut), ``attach_lora(rank
    16)`` on the seven default projections, ``mark_only_lora_trainable``,
    bf16 O2, AdamW(1e-3, wd 0.01) over the factors, B1 x S4096, through
    ``Model.fit`` on CompiledTrainStep for 2 + 4 steps: the step ms, MFU
    (the FLOPs counter), peak memory and launches a replay; the eager
    lane's losses equal bit for bit; ``merge`` then ``unmerge`` restores
    every weight bit for bit (the merged forward equal to the unmerged);
    ``save_adapter`` / ``load_adapter_state``; the same 8-layer base served
    by the Engine with the adapter in its pool (one request under it, one
    without), and the pool's prefill logits against the wrapped model's
    forward and the fp32 adapted model within LORA_FLOOR_MULT x the bf16
    floor."""
    from paddle_tpu_torch.nn import (attach_lora, load_adapter,
                                     load_adapter_state, lora_layers,
                                     mark_only_lora_trainable, save_adapter)
    cfg = llama_config("llama2-7b", num_layers=8)
    n = warmup + steps
    rows = TokenRows(n, cfg.vocab_size, 4096).rows
    loader = DataLoader(TensorDataset([rows[:, :-1], rows[:, 1:]]),
                        batch_size=1, shuffle=False)

    def build():
        net = LlamaForCausalLM(cfg, device=dev, dtype=torch.float32, seed=0)
        names = attach_lora(net, rank=16)
        mark_only_lora_trainable(net)
        opt = AdamW(learning_rate=1e-3, weight_decay=0.01,
                    parameters=[p for p in net.parameters()
                                if p.requires_grad])
        return Model(net).prepare(opt, CrossEntropyLoss(),
                                  amp_configs="O2"), names
    model, names = build()
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launch_counts()
    clock = StepLog()
    fallbacks = jit_fallbacks()
    model.fit(loader, epochs=1, verbose=0, log_freq=1, shuffle=False,
              callbacks=[clock])
    fallbacks = jit_fallbacks() - fallbacks
    counts = kernels.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    need = {k: cfg.num_layers * n for k in TRAIN_KERNELS}
    need["adam"] = 2 * len(names) * n
    check_launches(counts, need)
    cs = model._compiled_step
    stats = cs.graph_stats()
    if not cs.compiled or fallbacks or len(stats) != 1:
        raise AssertionError(f"[lora-llama] compiled step {stats}, "
                             f"{cs.fallback_reason}")
    sm = model.step_metrics.snapshot()
    fit_ms = float(np.median(clock.times[warmup:]))
    compiled_losses = clock.losses
    clock.set_model(None)
    del model, cs
    torch.cuda.empty_cache()
    log(f"[lora-llama] {len(names)} projections wrapped (rank 16), "
        f"{2 * len(names)} factors train; {n} fit steps: losses "
        f"{compiled_losses}; step {fit_ms:.2f} ms p50 (all "
        f"{[round(t, 1) for t in clock.times]}), train.step_time_ms p50 "
        f"{sm['step_time_ms']['p50']:.2f}, train.mfu {sm['mfu']:.4f} (FLOPs "
        f"{sm['flops_per_step']:.4e} a step), peak {peak_gb:.2f} GB; graph "
        f"{stats}; launches {counts}")
    port_flags.set_flags({"FLAGS_compiled_train_step": False})
    try:
        model, _ = build()
        eager = StepLog()
        model.fit(loader, epochs=1, verbose=0, log_freq=1, shuffle=False,
                  callbacks=[eager])
    finally:
        port_flags.set_flags({"FLAGS_compiled_train_step": True})
    same_losses("lora-llama", compiled_losses, eager.losses)
    eager.set_model(None)
    net = model.network
    net.eval()
    prompt = torch.from_numpy(rows[:1, :512]).to(dev)
    layers = lora_layers(net)
    before = {k: lyr.weight.detach().clone() for k, lyr in layers.items()}
    with torch.no_grad():
        want = net(prompt)
        for lyr in layers.values():
            lyr.merge()
        merged = net(prompt)
        for lyr in layers.values():
            lyr.unmerge()
    if not torch.equal(merged, want):
        raise AssertionError("[lora-llama] the merged forward differs")
    for k, lyr in layers.items():
        if not torch.equal(lyr.weight.view(torch.int16),
                           before[k].view(torch.int16)):
            raise AssertionError(f"[lora-llama] unmerge did not restore {k}")
    root = tempfile.mkdtemp(prefix="lora-llama-")
    try:
        save_adapter(net, root)
        spec = load_adapter_state(root)
        log(f"[lora-llama] the eager lane's {n} losses equal the compiled "
            f"lane's bit for bit; merge then unmerge restores all "
            f"{len(layers)} weights bit for bit, the merged forward equal to "
            f"the unmerged; save_adapter -> load_adapter_state: {len(spec)} "
            f"layers")
        return serve_lora(dev, cfg, rows, n, net, spec, root, prompt, want,
                          dict(fit_ms=fit_ms, mfu=sm["mfu"], peak_gb=peak_gb,
                               per_replay=stats))
    finally:
        shutil.rmtree(root, ignore_errors=True)


def serve_lora(dev, cfg, rows, n, net, spec, root, prompt, want, out):
    """lora-llama's serving half: the trained adapter (``spec``, saved in
    ``root``) in the Engine's pool over the same base, and its prefill
    logits against the wrapped model's forward ``want`` and the fp32
    adapted model."""
    from paddle_tpu_torch.nn import attach_lora, load_adapter
    # the fp32 reference: the same base in fp32, the trained factors (their
    # exact fp32 values) on it; without the factors (B = 0: W + A 0 s is W)
    # it is the base, whose bf16 run gives the model's bf16 floor
    ref = LlamaForCausalLM(cfg, device=dev, dtype=torch.float32, seed=0)
    attach_lora(ref, rank=16)
    ref.eval()
    with torch.no_grad():
        ref_base = ref(prompt).float()
        load_adapter(ref, root)
        ref_lora = ref(prompt).float()
    del ref
    base = LlamaForCausalLM(cfg, device=dev, dtype=torch.float32, seed=0)
    with torch.no_grad():
        for p in base.parameters():
            p.data = p.data.to(torch.bfloat16)
    frozen = {k: v for k, v in net.state_dict().items()
              if k.rsplit(".", 1)[-1] not in ("lora_A", "lora_B")}
    same_weights("lora-llama base", base.state_dict(), frozen)
    base.eval()
    prompts = [rows[0, :300].astype(np.int32), rows[1 % n, :200]
               .astype(np.int32)]
    scfg = ServingConfig(num_slots=2, max_seq_len=1024, max_adapters=2,
                         adapter_rank_pool=16, adapters={"trained": spec})
    outs, st, scounts, wall, speak, eng = serve_run(
        base, dev, scfg, prompts, [SamplingParams()] * 2,
        ["trained", None], max_new=16)
    pool = eng.adapter_pool
    slot = pool.acquire("trained")
    try:
        with torch.no_grad(), pool.activate(pool.row_tensor([slot])):
            got = base(prompt)
    finally:
        pool.release("trained")
    with torch.no_grad():
        plain = base(prompt)
    floor = row_err(plain, ref_base)
    tol = LORA_FLOOR_MULT * floor
    err = row_err(got, want)
    err_ref = row_err(got, ref_lora)
    err_wrapped = row_err(want, ref_lora)
    err_base = row_err(plain, ref_lora)
    if not (err <= tol and err_ref <= tol) or not torch.isfinite(got).all():
        raise AssertionError(
            f"[lora-llama] served prefill logits: row error {err:.3e} "
            f"against the wrapped forward, {err_ref:.3e} against fp32; "
            f"tolerance {tol:.3e} ({LORA_FLOOR_MULT} x the bf16 floor "
            f"{floor:.3e})")
    if not err_base > tol:
        raise AssertionError(f"[lora-llama] control: the base without the "
                             f"adapter is {err_base:.3e} from the fp32 "
                             f"adapted model, within {tol:.3e}")
    check_launches(scounts, {
        "lora_delta": len(spec) * (st["decode_steps"] + st["prefill_calls"]),
        "paged_decode": cfg.num_layers * st["decode_steps"]})
    log(f"[lora-llama] served from the engine's pool: 2 requests x 16 "
        f"tokens ({st['decode_ms_p50']:.2f} ms/step p50, launches "
        f"lora_delta {scounts['lora_delta']}, paged_decode "
        f"{scounts['paged_decode']}); prefill logits of a 512-token prompt, "
        f"worst row error of its norm: served against the wrapped model's "
        f"forward {err:.3e}, against the fp32 adapted model {err_ref:.3e} "
        f"(the wrapped forward {err_wrapped:.3e}); tolerance {tol:.3e} = "
        f"{LORA_FLOOR_MULT} x the bf16 floor {floor:.3e} (the bf16 base "
        f"against the fp32 base); control: the base without the adapter "
        f"{err_base:.3e} from the fp32 adapted model")
    del eng, pool, base
    torch.cuda.empty_cache()
    return dict(out, err=err, err_ref=err_ref, floor=floor,
                err_base=err_base)


# ---------------------------------------------------------- train-hybrid
#: train-hybrid's process groups: NCCL.  Ranks that share one card (the
#: usual case here: one H100) each take an NCCL host id of their own and
#: NCCL's socket transport on the loopback interface
#: (`distributed.env.one_card_nccl_env`, which `init_parallel_env` sets
#: when the ranks name their card and outnumber the cards;
#: tools/torch_nccl_one_card.py shows every collective and an all_reduce
#: captured in a CUDA graph working so, and torch's NCCL barrier and
#: process-group teardown hang such ranks: they end with a token
#: all-reduce and exit without a teardown).
#: With a card a rank, plain NCCL.  gloo is not a lane on the card: it
#: takes no CUDA tensors there and cannot be captured.
HYBRID_BACKEND = "nccl"
#: the one-card train phase's compiled step on the same model and batch
#: (PR 13 final, phase 7): the single-card figure train-hybrid (a) is set
#: against
TRAIN_ONE_CARD_MS = 106.06


def hybrid_strategy(dp, mp):
    from paddle_tpu_torch.distributed import fleet
    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": dp, "mp_degree": mp}
    return s


def hybrid_init(dev, world, dp, mp, outdir, lane):
    """This rank joins ``lane``'s process group (a file rendezvous in
    ``outdir``) and the dp x mp topology."""
    from paddle_tpu_torch.distributed import env, fleet
    env.init_parallel_env(
        backend=HYBRID_BACKEND, device=dev, world_size=world,
        rank=int(os.environ["RANK"]),
        init_method="file://" + os.path.join(outdir, f"rdzv-{lane}"))
    return fleet.init(is_collective=True, strategy=hybrid_strategy(dp, mp),
                      backend=HYBRID_BACKEND, device=dev)


def collective_counts():
    """{op: (calls, bytes)} of the registry's ``dist.collective_*``."""
    calls = registry.REGISTRY.get("dist.collective_calls")
    nbytes = registry.REGISTRY.get("dist.collective_bytes")
    if calls is None:
        return {}
    out = {}
    for op in ("all_reduce", "all_gather", "reduce_scatter", "broadcast",
               "barrier", "send", "recv"):
        c = calls.labels(op=op).value
        if c:
            out[op] = (c, nbytes.labels(op=op).value)
    return out


def per_step(after, before, n):
    return {op: ((c - before.get(op, (0, 0))[0]) / n,
                 (b - before.get(op, (0, 0))[1]) / n)
            for op, (c, b) in after.items()
            if c != before.get(op, (0, 0))[0]}


def replicated_digest(model):
    """sha256 of the parameters every mp rank holds a copy of (the
    norms): equal across the ranks when the copies stayed in step."""
    h = hashlib.sha256()
    for name, p in model.named_parameters():
        if not getattr(p, "mp_split", False):
            h.update(name.encode())
            h.update(p.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def params_digest(model):
    h = hashlib.sha256()
    for name, p in model.named_parameters():
        h.update(name.encode())
        h.update(p.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def timed_steps(step, ids, labels, n):
    losses, times = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        losses.append(float(step(ids, labels)))
        torch.cuda.synchronize()
        times.append((time.monotonic() - t0) * 1e3)
    return losses, times


def hybrid_llama_lane(dev, rank, world, outdir, warmup=2, steps=3):
    """(a) Llama-2 7B width, 8 layers (phase 7's cut), mp = world, bf16
    O2, AdamW(3e-4, wd 0.01, clip 1.0), B1 x S4096: the eager lane
    (CompiledTrainStep with FLAGS_compiled_train_step off: call after call
    `_default_eager_step`'s mesh tail), then, the model freed, the same
    seed through the compiled lane; (b) and (d) on the same ranks after."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.models import ParallelLlamaForCausalLM
    hcg = hybrid_init(dev, world, 1, world, outdir, "llama")
    cfg = llama_config("llama2-7b", num_layers=8)
    seq = 4096
    ids, labels = (t.to(dev) for t in train_batch(cfg.vocab_size, seq))
    out = {"rank": rank, "mp_rank": hcg.get_model_parallel_rank()}

    def build():
        model = fleet.distributed_model(ParallelLlamaForCausalLM(
            cfg, device=dev, dtype=torch.float32, seed=0))
        opt = AdamW(learning_rate=3e-4, parameters=model.parameters(),
                    weight_decay=0.01, grad_clip=ClipGradByGlobalNorm(1.0))
        return amp.decorate(model, opt, level="O2", dtype=torch.bfloat16)

    for lane in ("eager", "compiled"):
        model, opt = build()
        n_global = model.num_params()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        port_flags.set_flags({"FLAGS_compiled_train_step":
                              lane == "compiled"})
        cs = CompiledTrainStep(lambda x, y: model(x, labels=y)[1], opt,
                               network=model, mesh=hcg.mesh)
        kernels.reset_launch_counts()
        before = collective_counts()
        losses, times = timed_steps(cs, ids, labels, warmup + steps)
        counts = kernels.launch_counts()
        res = dict(losses=losses, times=times,
                   peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
                   launches={k: v for k, v in counts.items() if v},
                   coll=per_step(collective_counts(), before,
                                 warmup + steps),
                   compiled=cs.compiled, digest=replicated_digest(model))
        if lane == "compiled":
            res["graphs"] = {k: [c, r, l] for k, (c, r, l) in
                             cs.graph_stats().items()}
            res["groups"] = {}
            res["busy"] = profile_compiled(cs, ids, labels,
                                           f"train-hybrid r{rank}",
                                           groups=res["groups"])
        out[lane] = res
        del model, opt, cs
        gc.collect()
        torch.cuda.empty_cache()
    port_flags.set_flags({"FLAGS_compiled_train_step": True})
    out["n_params"] = n_global
    if rank == 0:                     # the gpt lane's ranks may start
        open(os.path.join(outdir, "a-done"), "w").close()
    out.update(hybrid_parity(dev, rank, hcg))
    return out


def first_grad_norm(model, ids, labels):
    """The clip's global norm of ``model``'s gradients on one batch
    (`nn.clip.global_norm`: a split model's shards summed over mp, its
    copies counted once) and the copies' share of the norm's square; the
    gradients are dropped after."""
    from paddle_tpu_torch.nn.clip import global_norm
    model(ids, labels=labels)[1].backward()
    params = [p for p in model.parameters() if p.grad is not None]
    norm = float(global_norm([(p, p.grad) for p in params]))
    rep = sum(float(p.grad.float().square().sum()) for p in params
              if not getattr(p, "mp_split", False))
    for p in params:
        p.grad = None
    return norm, rep / norm ** 2


def hybrid_parity(dev, rank, hcg, steps=3, new=8):
    """(b) and (d): Llama-2 7B width, 2 layers, fp32, S256.  Every rank
    draws the one-rank model (seed 1) and takes its state; rank 0 runs it
    (generate with a dense and a paged cache, then 3 AdamW steps); the mp
    ranks load their shards of the same state
    (`convert.shard_paddle_tpu_state`), generate the same ways, train the
    same 3 steps through the compiled mesh lane, and the global state is
    gathered to rank 0, which compares."""
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.models import ParallelLlamaForCausalLM
    cfg = llama_config("llama2-7b", num_layers=2, max_seq_len=256)
    ids, labels = (t.to(dev) for t in train_batch(cfg.vocab_size, 256,
                                                  seed=1))
    prompt = ids[:, :32].repeat(2, 1)
    one, opt = make_trainer(cfg, dev, torch.float32, seed=1)
    state = {k: v.detach().cpu().numpy().copy() for k, v in
             one.state_dict().items()}
    ref = {}
    if rank == 0:
        one.eval()
        ref["dense"] = one.generate(prompt, new).cpu().tolist()
        ref["paged"] = one.generate(prompt, new, page_size=16).cpu().tolist()
        one.train()
        ref["norm"] = first_grad_norm(one, ids, labels)[0]
        ref["losses"] = [train_step(one, opt, ids, labels)
                         for _ in range(steps)]
        ref["state"] = {k: v.detach().cpu().numpy() for k, v in
                        one.state_dict().items()}
    del one, opt
    torch.cuda.empty_cache()
    tp = fleet.distributed_model(ParallelLlamaForCausalLM(
        cfg, device=dev, dtype=torch.float32, seed=1))
    convert.load_paddle_tpu_state(tp, convert.shard_paddle_tpu_state(state,
                                                                     tp))
    del state
    tp.eval()
    kernels.reset_launch_counts()
    got = {"dense": tp.generate(prompt, new).cpu().tolist()}
    mid = kernels.launch_counts()["paged_decode"]
    got["paged"] = tp.generate(prompt, new, page_size=16).cpu().tolist()
    got["paged_decodes"] = kernels.launch_counts()["paged_decode"] - mid
    got["heads"] = tp.cache_kv_heads
    tp.train()
    got["norm"], got["rep_share"] = first_grad_norm(tp, ids, labels)
    opt = AdamW(learning_rate=3e-4, parameters=tp.parameters(),
                weight_decay=0.01, grad_clip=ClipGradByGlobalNorm(1.0))
    cs = CompiledTrainStep(lambda x, y: tp(x, labels=y)[1], opt, network=tp,
                           mesh=hcg.mesh)
    got["losses"] = [float(cs(ids, labels)) for _ in range(steps)]
    final = convert.gather_paddle_tpu_state(tp, dst=0)
    out = {"parity": got}
    if rank == 0:
        lr = 3e-4
        worst, frac, name_worst = 0.0, 0.0, None
        for name, want in ref["state"].items():
            err = np.abs(final[name] - want)
            frac = max(frac, float(np.mean(err > 1e-5)))
            if float(err.max()) > worst:
                worst, name_worst = float(err.max()), name
        got.update(ref_dense=ref["dense"], ref_paged=ref["paged"],
                   ref_losses=ref["losses"], ref_norm=ref["norm"],
                   worst=worst, frac=frac,
                   worst_name=name_worst, bound=2 * lr * steps)
    return out


class LocalLogits(torch.nn.Module):
    """A parallel GPT's logits as its loss reads them: the rank's
    vocabulary slice (``ParallelGPTForCausalLM.forward`` with labels,
    without the loss), so ``hapi.Model`` drives the model with the loss
    on the slice (`LocalLMLoss`) and no gather."""

    def __init__(self, lm):
        super().__init__()
        self.lm = lm

    def forward(self, ids):
        from paddle_tpu_torch.distributed import topology
        from paddle_tpu_torch.distributed.fleet.mp_layers import copy_to_mp
        hidden = self.lm.gpt(ids)
        return F.linear(copy_to_mp(hidden, topology.mp_group()),
                        self.lm.gpt.wte.weight.T)


class LocalLMLoss:
    """The parallel GPT's loss on `LocalLogits`: the masked mean of
    `ParallelCrossEntropy` (JAX ``_masked_parallel_ce``)."""

    def __init__(self, lm):
        self.fn = lm.loss_fn

    def __call__(self, logits, labels):
        from paddle_tpu_torch.models.gpt_parallel import _masked_parallel_ce
        return _masked_parallel_ce(self.fn, logits, labels)


def hybrid_gpt_model(dev, lr=1e-4, layers=12):
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.models import ParallelGPTForCausalLM
    cfg = gpt_config("gpt2-124m", max_seq_len=1024, attn_dropout=0.1,
                     dropout=0.1, num_layers=layers)
    lm = fleet.distributed_model(ParallelGPTForCausalLM(
        cfg, device=dev, dtype=torch.float32, seed=0))
    net = LocalLogits(lm)
    opt = AdamW(learning_rate=lr, parameters=net.parameters(),
                weight_decay=0.01)
    return Model(net).prepare(opt, LocalLMLoss(lm), amp_configs="O2")


#: train-hybrid (c)'s steps a lane: 2 warm-up (the eager call, the
#: capture) and 2 replays
HYBRID_GPT_STEPS = 4


def hybrid_gpt_lane(dev, rank, world, outdir, n=HYBRID_GPT_STEPS,
                    per_rank=4):
    """(c) GPT-2 124M, dp 2 x mp 2, dropout 0.1, bf16 O2 (prepare), AdamW
    (1e-4, wd 0.01), B8 x S1024 (4 rows a dp rank): ``fit`` over a
    DistributedBatchSampler, then the same ``_forward_loss`` by hand
    through CompiledTrainStep on the global batches (the dp ranks' rows),
    from the same seed; the masks of a flash call split over dp and mp
    (module 13) hashed for the parent."""
    from paddle_tpu_torch.io import DistributedBatchSampler
    hcg = hybrid_init(dev, world, 2, world // 2, outdir, "gpt")
    dp_rank, mp_rank = (hcg.get_data_parallel_rank(),
                        hcg.get_model_parallel_rank())
    rows = TokenRows(2 * per_rank * n, 50304, 1024)
    out = {"rank": rank, "dp_rank": dp_rank, "mp_rank": mp_rank}
    model = hybrid_gpt_model(dev)
    # started beside the llama lane's (b) and (d): the steps wait for it
    wait_for_file(os.path.join(outdir, "llama-done"))
    clock = StepLog()
    kernels.reset_launch_counts()
    fallbacks = jit_fallbacks()
    model.fit(rows, batch_size=per_rank, epochs=1, shuffle=False, verbose=0,
              log_freq=1, callbacks=[clock])
    cs = model._compiled_step
    out["fit"] = dict(losses=clock.losses, times=clock.times,
                      launches={k: v for k, v in
                                kernels.launch_counts().items() if v},
                      fallbacks=jit_fallbacks() - fallbacks,
                      compiled=bool(cs and cs.compiled),
                      graphs={k: [c, r, l] for k, (c, r, l) in
                              cs.graph_stats().items()},
                      digest=params_digest(model.network))
    clock.set_model(None)
    del model, cs
    gc.collect()
    torch.cuda.empty_cache()
    hand = hybrid_gpt_model(dev)
    cs = CompiledTrainStep(hand._forward_loss, hand._optimizer,
                           network=hand.network, mesh=hcg.mesh)
    samplers = [list(DistributedBatchSampler(rows, per_rank, num_replicas=2,
                                             rank=r)) for r in range(2)]
    losses, times, coll = [], [], None
    for k in range(n):
        before = collective_counts()
        idx = samplers[0][k] + samplers[1][k]
        x = torch.from_numpy(np.stack([rows[i][0] for i in idx])).to(dev)
        y = torch.from_numpy(np.stack([rows[i][1] for i in idx])).to(dev)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        losses.append(float(cs(x, y)))
        times.append((time.monotonic() - t0) * 1e3)
        if coll is None:              # call 1, the eager step
            coll = per_step(collective_counts(), before, 1)
    out["hand"] = dict(losses=losses, times=times, compiled=cs.compiled,
                       digest=params_digest(hand.network), coll=coll)
    del hand, cs
    torch.cuda.empty_cache()
    # the flash masks of this rank's part of a global call: rows
    # 4 dp .. 4 dp + 3, heads 6 mp .. 6 mp + 5 of [8, 12, 1024, 64]
    g = torch.Generator(device=dev).manual_seed(5)
    q, k, v = (torch.randn(8, 12, 1024, 64, device=dev, generator=g)
               .to(torch.bfloat16) for _ in range(3))
    part = [t[4 * dp_rank:4 * dp_rank + 4, 6 * mp_rank:6 * mp_rank + 6]
            for t in (q, k, v)]
    o, _ = fa.flash_attention_fwd(*part, True, None, True, dropout=0.1,
                                  seed=1234,
                                  offsets=(4 * dp_rank, 6 * mp_rank, 12))
    out["mask_part"] = hashlib.sha256(
        o.float().cpu().numpy().tobytes()).hexdigest()[:16]
    if os.path.exists(os.path.join(outdir, "moe-too")):
        # train-moe on the same ranks and topology (dp 2 x mp 2)
        del q, k, v, part, o
        gc.collect()
        torch.cuda.empty_cache()
        out["moe"] = moe_lane(dev, rank, hcg)
    return out


HYBRID_LANES = {"llama": (hybrid_llama_lane, 2),
                "gpt": (hybrid_gpt_lane, 4)}


def hybrid_child(lane, outdir):
    """A rank of ``lane`` (RANK in the environment): its card is its own
    when the host has one a rank, else card 0; writes its results to
    ``outdir/<lane>-<rank>.json`` and ends with a token all-reduce and
    an exit without a process-group teardown (see HYBRID_BACKEND)."""
    fn, world = HYBRID_LANES[lane]
    rank = int(os.environ["RANK"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    idx = rank if torch.cuda.device_count() >= world else 0
    dev = torch.device("cuda", idx)
    torch.cuda.set_device(dev)
    code = 0
    try:
        res = fn(dev, rank, world, outdir)
        from paddle_tpu_torch.distributed import collective
        collective.barrier()
    except BaseException:  # noqa: BLE001 — written for the parent
        import traceback
        res = {"error": traceback.format_exc()}
        code = 1
    with open(os.path.join(outdir, f"{lane}-{rank}.json"), "w") as f:
        json.dump(res, f)
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)


def wait_for_file(path, procs=(), timeout=600):
    """Wait until ``path`` exists (False: one of ``procs`` ended first)."""
    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} did not appear in {timeout} s")
        if any(p.poll() is not None for p, _ in procs):
            return os.path.exists(path)
        time.sleep(0.2)
    return True


def start_hybrid(lane, outdir):
    """Start ``lane``'s ranks (children of this script); returns them."""
    _, world = HYBRID_LANES[lane]
    procs = []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world),
                   PYTHONUNBUFFERED="1")
        logf = open(os.path.join(outdir, f"{lane}-{r}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--hybrid-child",
             lane, outdir], stdout=logf, stderr=subprocess.STDOUT,
            env=env), logf))
    return procs


def wait_hybrid(lane, outdir, procs, timeout=600, tag="train-hybrid"):
    """Wait for ``lane``'s ranks, echo each rank's output and return the
    ranks' results."""
    _, world = HYBRID_LANES[lane]
    deadline = time.monotonic() + timeout
    codes = []
    for p, logf in procs:
        try:
            codes.append(p.wait(timeout=max(deadline - time.monotonic(), 1)))
        except subprocess.TimeoutExpired:
            for q, _ in procs:
                q.kill()
            codes.append("timeout")
        logf.close()
    outs = []
    for r in range(world):
        with open(os.path.join(outdir, f"{lane}-{r}.log")) as f:
            for line in f.read().splitlines()[-40:]:
                log(f"[{tag} {lane} r{r}] {line}")
        path = os.path.join(outdir, f"{lane}-{r}.json")
        outs.append(json.load(open(path)) if os.path.exists(path) else
                    {"error": f"no result (exit {codes[r]})"})
    bad = [(r, o["error"]) for r, o in enumerate(outs) if "error" in o]
    if bad or any(c != 0 for c in codes):
        raise AssertionError(f"[{tag}] {lane}: exits {codes}; "
                             f"{bad[0][1] if bad else ''}")
    return outs


def fmt_coll(coll):
    return ", ".join(f"{op} {c:g} calls {b / 1e6:.1f} MB"
                     for op, (c, b) in sorted(coll.items()))


def check_hybrid_llama(outs, warmup=2, steps=3):
    """(a), (b), (d) from the ranks of the llama lane."""
    tag = "train-hybrid"
    cfg = llama_config("llama2-7b", num_layers=8)
    seq = 4096
    for o in outs:
        e, c = o["eager"], o["compiled"]
        if not all(np.isfinite(c["losses"])) or \
                not c["losses"][-1] < c["losses"][0]:
            raise AssertionError(f"[{tag}] (a) r{o['rank']}: losses "
                                 f"{c['losses']} not finite and falling")
        if c["losses"] != e["losses"] or not c["compiled"]:
            raise AssertionError(f"[{tag}] (a) r{o['rank']}: compiled "
                                 f"{c['losses']} (compiled {c['compiled']})"
                                 f" != eager {e['losses']}")
        need = {k: cfg.num_layers * (warmup + steps) for k in
                ("rms_norm", "rms_norm_bwd", "rope", "flash_fwd",
                 "flash_bwd_dkv", "flash_bwd_dq")}
        need["adam"] = 75 * (warmup + steps)
        for lane in (e, c):
            short = {k: lane["launches"].get(k, 0) for k, n in need.items()
                     if lane["launches"].get(k, 0) < n}
            if short:
                raise AssertionError(f"[{tag}] (a) r{o['rank']}: launches "
                                     f"{short} below {need}")
    digests = {o["compiled"]["digest"] for o in outs} | \
        {o["eager"]["digest"] for o in outs}
    if len(digests) != 1:
        raise AssertionError(f"[{tag}] (a) the mp ranks' copies of the "
                             f"replicated parameters differ: {digests}")
    tokens = seq
    flops = 6 * (outs[0]["n_params"] - cfg.vocab_size * cfg.hidden_size) * \
        tokens + 6 * tokens * seq * cfg.hidden_size * cfg.num_layers
    for lane in ("eager", "compiled"):
        ms = [float(np.median(o[lane]["times"][warmup:])) for o in outs]
        step_ms = max(ms)
        mfu = flops / (step_ms / 1e3) / PEAK_OPS[torch.bfloat16]
        losses = [round(x, 4) for x in outs[0][lane]["losses"]]
        times = [round(t, 1) for t in outs[0][lane]["times"]]
        log(f"[{tag}] (a) {lane}: losses {losses}; step {step_ms:.2f} ms "
            f"p50 (ranks {[round(m, 2) for m in ms]}, all r0 {times}), "
            f"{tokens / (step_ms / 1e3):.0f} tokens/s, MFU {100 * mfu:.1f}% "
            f"of one card's 989 TFLOP/s ({flops / 1e12:.2f} TFLOP a step; "
            f"the one-card train phase: {TRAIN_ONE_CARD_MS} ms, PR 13); "
            f"peak {[round(o[lane]['peak_gb'], 2) for o in outs]} GB by rank")
    for o in outs:
        c = o["compiled"]
        grp = dict(c["groups"])
        wall = grp.pop("wall")
        nccl = grp.pop("collectives (NCCL)", 0.0)
        log(f"[{tag}] (a) r{o['rank']}: collectives a step (eager lane) "
            f"{fmt_coll(o['eager']['coll'])}; graphs {c['graphs']}; "
            f"launches {c['launches']}; 3 profiled replays: {wall:.1f} ms "
            f"a step, busy {100 * c['busy']:.1f}% of it with its own "
            f"kernels, of which NCCL's {nccl:.1f} ms (they wait for the "
            f"other rank and the transfer), the rest "
            f"{sum(grp.values()):.1f} ms ({fmt_groups(grp, 1)})")
    log(f"[{tag}] (a) compiled = eager bit for bit on every rank; the "
        f"replicated parameters equal on every rank ({digests.pop()})")
    p = outs[0]["parity"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(p["losses"],
                                                  p["ref_losses"]))
    if rel > 1e-4 or p["frac"] > 1e-4 or p["worst"] > p["bound"]:
        raise AssertionError(f"[{tag}] (b) mp 2 vs one rank: losses "
                             f"{p['losses']} vs {p['ref_losses']} (rel "
                             f"{rel:.2e}), params worst {p['worst']:.2e} "
                             f"({p['worst_name']}), {p['frac']:.2e} of "
                             f"elements above 1e-5")
    norm_rel = max(abs(o["parity"]["norm"] - p["ref_norm"]) / p["ref_norm"]
                   for o in outs)
    # 1e-5: the two sums take the same squares in other orders (fp32,
    # ~1e-7 apart); a copy counted twice moves the norm by half the
    # copies' share of its square (6.5e-5 here), a shard not summed over
    # mp by ~29%
    if not norm_rel <= 1e-5:
        raise AssertionError(f"[{tag}] (b) the clip's global norm of the "
                             f"first step's gradients: mp 2 "
                             f"{[o['parity']['norm'] for o in outs]} vs one "
                             f"rank {p['ref_norm']} (rel {norm_rel:.2e})")
    log(f"[{tag}] (b) the clip's global norm of the first step's "
        f"gradients: {p['norm']:.6e} on every mp rank vs one rank "
        f"{p['ref_norm']:.6e} (rel {norm_rel:.2e} <= 1e-5; shards not "
        f"summed over mp would move it by ~29%, the replicated copies, "
        f"{p['rep_share']:.2e} of its square, counted twice by "
        f"{p['rep_share'] / 2:.2e})")
    log(f"[{tag}] (b) fp32, 2 layers at 7B width, 3 AdamW steps: losses "
        f"{p['losses']} vs one rank {p['ref_losses']} (worst rel "
        f"{rel:.2e} <= 1e-4); gathered parameters: worst {p['worst']:.2e} "
        f"({p['worst_name']}) <= 2 lr x 3 = {p['bound']:.1e}, "
        f"{p['frac']:.2e} of elements above 1e-5 (<= 1e-4)")
    for o in outs:
        q = o["parity"]
        if q["dense"] != p["ref_dense"] or q["paged"] != p["ref_paged"] or \
                q["paged_decodes"] != 2 * 7 or q["heads"] != 16:
            raise AssertionError(f"[{tag}] (d) r{o['rank']}: tokens "
                                 f"{q['dense']} / {q['paged']} vs one rank "
                                 f"{p['ref_dense']} / {p['ref_paged']}; "
                                 f"paged decodes {q['paged_decodes']}, heads "
                                 f"{q['heads']}")
    log(f"[{tag}] (d) generate, fp32, 2 layers at 7B width, mp 2: the "
        f"dense and the paged cache (14 paged decodes a rank on 16 local "
        f"heads) give the one-rank model's tokens on both ranks: "
        f"{p['ref_dense'][0][-8:]}")


def check_hybrid_gpt(outs, dev, warmup=2, n=HYBRID_GPT_STEPS):
    tag = "train-hybrid"
    need = dict({k: 12 * n for k in DROPOUT_KERNELS}, adam=148 * n)
    for o in outs:
        f, h = o["fit"], o["hand"]
        short = {k: f["launches"].get(k, 0) for k, m in need.items()
                 if f["launches"].get(k, 0) < m}
        if short:
            raise AssertionError(f"[{tag}] (c) r{o['rank']}: fit launches "
                                 f"{short} below {need}")
        if f["losses"] != h["losses"] or not f["compiled"] or \
                not h["compiled"] or f["fallbacks"]:
            raise AssertionError(f"[{tag}] (c) r{o['rank']}: fit "
                                 f"{f['losses']} != hand {h['losses']} (or "
                                 f"fell back: {f['fallbacks']})")
        if f["digest"] != h["digest"]:
            raise AssertionError(f"[{tag}] (c) r{o['rank']}: fit's "
                                 f"parameters differ from the hand lane's")
    by = {(o["dp_rank"], o["mp_rank"]): o for o in outs}
    for m in (0, 1):
        if by[(0, m)]["fit"]["digest"] != by[(1, m)]["fit"]["digest"]:
            raise AssertionError(f"[{tag}] (c) the dp replicas of mp rank "
                                 f"{m} differ after the steps")
    g = torch.Generator(device=dev).manual_seed(5)
    q, k, v = (torch.randn(8, 12, 1024, 64, device=dev, generator=g)
               .to(torch.bfloat16) for _ in range(3))
    whole, _ = fa.flash_attention_fwd(q, k, v, True, None, True,
                                      dropout=0.1, seed=1234)
    for (dp, mp), o in by.items():
        part = whole[4 * dp:4 * dp + 4, 6 * mp:6 * mp + 6]
        want = hashlib.sha256(part.float().cpu().numpy().tobytes()) \
            .hexdigest()[:16]
        if o["mask_part"] != want:
            raise AssertionError(f"[{tag}] (c) rank dp {dp} mp {mp}: its "
                                 f"flash part differs from the one-rank "
                                 f"call's (the dropout masks)")
    fit_ms = [float(np.median(o["fit"]["times"][warmup:])) for o in outs]
    hand_ms = [float(np.median(o["hand"]["times"][warmup:])) for o in outs]
    r0 = by[(0, 0)]
    log(f"[{tag}] (c) GPT-2 124M dp 2 x mp 2, dropout 0.1, bf16 O2: fit "
        f"losses {[round(x, 4) for x in r0['fit']['losses']]} equal the "
        f"hand lane's bit for bit on every rank, the dp replicas equal bit "
        f"for bit; step p50 fit {max(fit_ms):.2f} ms, hand "
        f"{max(hand_ms):.2f} ms (ranks {[round(m, 1) for m in fit_ms]}); "
        f"graphs r0 {r0['fit']['graphs']}; collectives of an eager step "
        f"{fmt_coll(r0['hand']['coll'])}")
    log(f"[{tag}] (c) the 4 ranks' flash parts (dropout 0.1, rows and heads "
        f"by the hash's offsets) equal the one-rank call's bit for bit")


def phase_train_hybrid(dev, zero=None, moe=False):
    """train-hybrid: (a) Llama-2 7B width, 8 layers, mp 2 (two ranks on
    the card), bf16 O2 training through fleet.init -> distributed_model ->
    CompiledTrainStep(mesh), both lanes; (b) mp 2 against one rank in
    fp32; (d) TP generate; (c) GPT-2 124M dp 2 x mp 2 with dropout through
    hapi fit and by hand.  No number here is a two-card one: the ranks
    time-slice one card.  ``zero`` (``{"root", "procs"}``): train-zero's
    ranks are started beside the gpt lane's, to import and wait for that
    phase's go.  With ``moe`` the gpt lane's ranks run train-moe's lane
    after their checks (`moe_lane`); its results are returned."""
    cards = torch.cuda.device_count()
    log(f"[train-hybrid] backend {HYBRID_BACKEND} ("
        + ("a card a rank" if cards >= 4 else "ranks sharing a card: "
           "NCCL's socket transport on lo, one host id a rank")
        + f"); {cards} card(s); worlds: llama 2 (dp 1 x mp 2), gpt 4 (dp 2"
        f" x mp 2)")
    root = tempfile.mkdtemp(prefix="train-hybrid-")
    if moe:
        open(os.path.join(root, "moe-too"), "w").close()
    llama = gpt = None
    try:
        llama = start_hybrid("llama", root)
        # the gpt lane's ranks start (import, process group, model) once
        # (a) is timed, beside (b) and (d), and train after them
        if wait_for_file(os.path.join(root, "a-done"), llama):
            gpt = start_hybrid("gpt", root)
            if zero is not None:
                zero["procs"] = start_hybrid("zero", zero["root"])
        outs = wait_hybrid("llama", root, llama)
        open(os.path.join(root, "llama-done"), "w").close()
        check_hybrid_llama(outs)
        if gpt is None:
            gpt = start_hybrid("gpt", root)
        outs = wait_hybrid("gpt", root, gpt)
        check_hybrid_gpt(outs, dev)
        return [o["moe"] for o in outs] if moe else None
    finally:
        for p, _ in (llama or []) + (gpt or []):
            if p.poll() is None:
                p.kill()
        shutil.rmtree(root, ignore_errors=True)


# ------------------------------------------------------------ train-zero
#: train-zero (a): GPT-3 1.3B width (hidden 2048, 16 heads, FFN 8192,
#: vocab 50304, S 2048), depth cut from 24 to ZERO_LAYERS layers; the
#: recipe's [8, 2048] batch; ZERO_STEPS eager steps (the first a warm-up)
ZERO_LAYERS = 4
ZERO_STEPS = 3
ZERO_BATCH = (8, 2048)
#: (b) and (c): 2 layers at the same width, fp32, ZERO_ROWS x ZERO_SEQ
#: tokens, ZERO_PARITY_STEPS AdamW steps (lr 1e-4, wd 0.01, clip 1.0)
ZERO_ROWS, ZERO_SEQ, ZERO_PARITY_STEPS, ZERO_LR = 4, 512, 2, 1e-4
#: (b)'s tolerances against the one rank: the losses (sums in other
#: orders over mp and the ZeRO averages) and each parameter within
#: 2 lr x steps (AdamW moves an element by at most ~lr a step, whatever
#: its gradient's size, so two runs part by at most twice that)
ZERO_LOSS_RTOL = 1e-4
ZERO_LEVELS = ("os", "os_g", "p_g_os")
#: the parameters JAX's rule splits Shard(0) over sharding in the
#: parallel GPT (dim 0 tiles and mp does not split dim 0), and those mp
#: splits on dim 1 (the rest of the mp-split ones on dim 0)
ZERO3_SHARDED = ("ln_1.weight", "ln_1.bias", "ln_2.weight", "ln_2.bias",
                 "qkv_proj.weight", "out_proj.bias", "fc_in.weight",
                 "fc_out.bias", "ln_f.weight", "ln_f.bias")
MP_DIM1 = ("qkv_proj.weight", "fc_in.weight")
MP_DIM0 = ("qkv_proj.bias", "fc_in.bias", "out_proj.weight",
           "fc_out.weight", "wte.weight", "wpe.weight")


def zero_rule(name):
    """JAX's placements of the parallel GPT's parameter ``name`` on the
    hybrid mesh (pp, dp, sharding, sep, mp) at stage 3."""
    pl = ["Replicate()"] * 5
    if name.endswith(ZERO3_SHARDED):
        pl[2] = "Shard(dim=0)"
    if name.endswith(MP_DIM1):
        pl[4] = "Shard(dim=1)"
    elif name.endswith(MP_DIM0):
        pl[4] = "Shard(dim=0)"
    return pl


def zero_strategy(stage3):
    from paddle_tpu_torch.distributed import fleet
    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": -1, "sharding_degree": 2,
                        "mp_degree": 2}
    if stage3:
        s.sharding = True
        s.sharding_configs = {"stage": 3}
    return s


def zero_batch(mesh, ids):
    """``ids`` placed as the recipe places it: Shard(0) on dp, replicated
    on the other axes."""
    import paddle_tpu_torch.distributed as dist
    return dist.shard_tensor(ids, mesh, [
        dist.Shard(0) if n == "dp" else dist.Replicate()
        for n in mesh.dim_names], stop_gradient=True)


def zero_recipe(dev):
    """(a) benchmarks/run.py config 3 call for call, at full width and
    bf16 O2: distributed_model(ParallelGPTForCausalLM), AdamW(1e-4),
    group_sharded_parallel(level="p_g_os"), distributed_optimizer,
    amp.decorate, the [8, 2048] batch by shard_tensor, eager steps."""
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.models import ParallelGPTForCausalLM
    cfg = gpt_config("gpt3-1.3b", max_seq_len=2048, num_layers=ZERO_LAYERS)
    torch.cuda.reset_peak_memory_stats(dev)
    model = fleet.distributed_model(ParallelGPTForCausalLM(
        cfg, device=dev, dtype=torch.float32, seed=0))
    opt = AdamW(1e-4, parameters=model.parameters())
    model, opt, _ = fleet.group_sharded_parallel(model, opt, level="p_g_os")
    opt = fleet.distributed_optimizer(opt)
    model, opt = amp.decorate(model, opt, level="O2", dtype=torch.bfloat16)
    b, s = ZERO_BATCH
    ids = zero_batch(dist.get_mesh(), torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (b, s))).to(dev))
    kernels.reset_launch_counts()
    before = collective_counts()
    losses, times, split = [], [], []
    for _ in range(ZERO_STEPS):
        marks = []

        def mark():
            torch.cuda.synchronize()
            marks.append(time.monotonic())
        mark()
        _, loss = model(ids, labels=ids)
        mark()
        loss.backward()
        mark()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.detach()))
        mark()
        times.append((marks[-1] - marks[0]) * 1e3)
        split.append([(b - a) * 1e3 for a, b in zip(marks, marks[1:])])
    counts = kernels.launch_counts()
    zero = opt._zero
    pbytes, sbytes = zero.resident_bytes(opt)
    full = [int(np.prod(zero.full_shape(p))) for p in opt._all_params()]
    return dict(
        losses=losses, times=times, rows=int(ids.shape[0]),
        split=np.median(split[1:], axis=0).tolist(),
        launches={k: v for k, v in counts.items() if v},
        scalar_adam=adam_update.scalar_launches,
        coll=per_step(collective_counts(), before, ZERO_STEPS),
        peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
        param_bytes=pbytes, state_bytes=sbytes,
        # the same rank at sharding 1: bf16 parameters, fp32 m1, m2, master
        param_bytes_1=2 * sum(full), state_bytes_1=12 * sum(full),
        n_params=model.num_params(non_embedding=False),
        placements={n: [repr(q) for q in p.placements]
                    for n, p in model.named_parameters()},
        kinds=sorted({zero.kind(p)[0] for p in opt._all_params()}))


def zero_moves(dev, mesh, rank):
    """The api.py moves on the card, bit for bit: Shard -> Replicate ->
    Shard(j) over both axes, an all-to-all on one axis, unshard_dtensor."""
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed.placement import local_slice
    S, R = dist.Shard, dist.Replicate
    g = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn(1024, 2048, device=dev, generator=g)
    first = [R(), R(), S(0), R(), S(1)]
    other = [R(), R(), S(1), R(), S(0)]
    t = dist.shard_tensor(x, mesh, first)
    whole = dist.reshard(t, mesh, [R()] * 5)
    t2 = dist.reshard(whole, mesh, other)
    a2a = dist.reshard(dist.shard_tensor(x, mesh, [R(), R(), S(0), R(), R()]),
                       mesh, [R(), R(), S(1), R(), R()])
    return dict(
        part=bool(torch.equal(t, local_slice(x, mesh, first))),
        whole=bool(torch.equal(whole, x)),
        part2=bool(torch.equal(t2, local_slice(x, mesh, other))),
        a2a=bool(torch.equal(a2a, local_slice(
            x, mesh, [R(), R(), S(1), R(), R()]))),
        unshard=bool(torch.equal(dist.unshard_dtensor(t2), x)))


def zero_parity(dev, rank, strategy, outdir):
    """(b) and (c): 2 layers at 1.3B width, fp32.  Rank 0 trains the
    one-rank GPTForCausalLM (seed 1) ZERO_PARITY_STEPS AdamW steps with
    the clip and takes its next batch's loss; then every level on the 4
    ranks from the same seed (ParallelGPTForCausalLM draws the one-rank
    model's weights, each rank keeping its parts), its gathered state to
    rank 0, which compares; after p_g_os, save_group_sharded_model, and
    rank 0 loads the file into a plain GPTForCausalLM."""
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.framework import io as pio
    from paddle_tpu_torch.models import ParallelGPTForCausalLM
    cfg = gpt_config("gpt3-1.3b", max_seq_len=2048, num_layers=2)
    rng = np.random.default_rng(3)
    batches = []
    for _ in range(ZERO_PARITY_STEPS + 1):
        ids = rng.integers(0, cfg.vocab_size, (ZERO_ROWS, ZERO_SEQ))
        labels = np.roll(ids, -1, axis=1)
        labels[:, -1] = -100
        batches.append((torch.from_numpy(ids).to(dev),
                        torch.from_numpy(labels).to(dev)))
    clock = [("start", time.monotonic())]
    out = {"moves": zero_moves(dev, dist.get_mesh(), rank)}
    clock.append(("moves", time.monotonic()))
    ref = None
    if rank == 0:
        one = GPTForCausalLM(cfg, device=dev, dtype=torch.float32, seed=1)
        opt = AdamW(ZERO_LR, parameters=one.parameters(), weight_decay=0.01,
                    grad_clip=ClipGradByGlobalNorm(1.0))
        losses = []
        for ids, labels in batches[:-1]:
            _, loss = one(ids, labels=labels)
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(float(loss.detach()))
        with torch.no_grad():
            nxt = float(one(*batches[-1][:1], labels=batches[-1][1])[1])
        ref = dict(losses=losses, next=nxt,
                   state={k: v.detach().clone() for k, v in
                          one.state_dict().items()})
        del one, opt
        torch.cuda.empty_cache()
    clock.append(("one rank", time.monotonic()))
    mesh = dist.get_mesh()
    path = os.path.join(outdir, "zero-c")
    for level in ZERO_LEVELS:
        strategy.sharding = level == "p_g_os"
        strategy.sharding_configs = {"stage": 3 if strategy.sharding else 1}
        model = fleet.distributed_model(ParallelGPTForCausalLM(
            cfg, device=dev, dtype=torch.float32, seed=1))
        opt = AdamW(ZERO_LR, parameters=model.parameters(),
                    weight_decay=0.01, grad_clip=ClipGradByGlobalNorm(1.0))
        model, opt, _ = fleet.group_sharded_parallel(model, opt, level=level)
        opt = fleet.distributed_optimizer(opt)
        before = collective_counts()
        losses = []
        for ids, labels in batches[:-1]:
            _, loss = model(zero_batch(mesh, ids),
                            labels=zero_batch(mesh, labels))
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(float(loss.detach()))
        coll = per_step(collective_counts(), before, ZERO_PARITY_STEPS)
        clock.append((f"{level} steps", time.monotonic()))
        with torch.no_grad():
            nxt = float(model(zero_batch(mesh, batches[-1][0]),
                              labels=zero_batch(mesh, batches[-1][1]))[1])
        state = convert.gather_paddle_tpu_state(model, dst=0)
        res = dict(losses=losses, next=nxt, coll=coll)
        if rank == 0:
            worst, name_worst = 0.0, None
            for name, want in ref["state"].items():
                err = float((torch.from_numpy(state[name]).to(dev)
                             - want).abs().max())
                if err > worst:
                    worst, name_worst = err, name
            res.update(ref_losses=ref["losses"], ref_next=ref["next"],
                       worst=worst, worst_name=name_worst,
                       bound=2 * ZERO_LR * ZERO_PARITY_STEPS)
        del state
        clock.append((f"{level} gather", time.monotonic()))
        if level == "p_g_os":
            out["saved"] = fleet.save_group_sharded_model(model, path)
            clock.append(("save", time.monotonic()))
        out[level] = res
        del model, opt
        gc.collect()
        torch.cuda.empty_cache()
    if rank == 0:
        plain = GPTForCausalLM(cfg, device=dev, dtype=torch.float32, seed=2)
        convert.load_paddle_tpu_state(plain, {
            k: v.cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
            for k, v in pio.load(out["saved"], map_location=dev).items()})
        with torch.no_grad():
            out["c_loss"] = float(plain(batches[-1][0],
                                        labels=batches[-1][1])[1])
        os.remove(out["saved"])
        clock.append(("load", time.monotonic()))
    out["clock"] = [(k, round(t - a, 1)) for (_, a), (k, t) in
                    zip(clock, clock[1:])]
    return out


def zero_lane(dev, rank, world, outdir):
    """The four ranks of train-zero: sharding 2 x mp 2 (dp -1: 1), the
    JAX recipe (a), then (b) and (c)."""
    from paddle_tpu_torch.distributed import env, fleet
    # started early (beside train-hybrid's gpt lane), the ranks wait here
    wait_for_file(os.path.join(outdir, "zero-go"), timeout=1200)
    marks = [time.monotonic()]
    env.init_parallel_env(
        backend=HYBRID_BACKEND, device=dev, world_size=world, rank=rank,
        init_method="file://" + os.path.join(outdir, "rdzv-zero"))
    strategy = zero_strategy(True)
    hcg = fleet.init(is_collective=True, strategy=strategy,
                     backend=HYBRID_BACKEND, device=dev)
    out = {"rank": rank, "sharding_rank": hcg.get_sharding_parallel_rank(),
           "mp_rank": hcg.get_model_parallel_rank(),
           "dp": hcg.get_data_parallel_world_size()}
    marks.append(time.monotonic())
    out["a"] = zero_recipe(dev)
    gc.collect()
    torch.cuda.empty_cache()
    marks.append(time.monotonic())
    out["b"] = zero_parity(dev, rank, strategy, outdir)
    marks.append(time.monotonic())
    out["seconds"] = [b - a for a, b in zip(marks, marks[1:])]
    if os.path.exists(os.path.join(outdir, "pipe-too")):
        # train-pipe on the same ranks: their imports and process group
        gc.collect()
        torch.cuda.empty_cache()
        out["pipe"] = pipe_lane(dev, rank)
    if os.path.exists(os.path.join(outdir, "sep-too")):
        # train-sep on the same ranks, after train-pipe's lane
        gc.collect()
        torch.cuda.empty_cache()
        out["sep"] = sep_lane(dev, rank)
    return out


HYBRID_LANES["zero"] = (zero_lane, 4)


def check_zero(outs):
    """(a), (b), (c) from the four ranks."""
    tag = "train-zero"
    b, s = ZERO_BATCH
    losses = [o["a"]["losses"] for o in outs]
    if any(x != losses[0] for x in losses) or \
            not all(np.isfinite(losses[0])):
        raise AssertionError(f"[{tag}] (a) losses not finite and equal on "
                             f"the 4 ranks: {losses}")
    for o in outs:
        a = o["a"]
        bad = {n: pl for n, pl in a["placements"].items()
               if pl != zero_rule(n)}
        if bad:
            raise AssertionError(f"[{tag}] (a) r{o['rank']}: placements "
                                 f"other than JAX's rule: {bad}")
        short = [k for k in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq",
                             "adam") if a["launches"].get(k, 0) <= 0]
        if short or a["scalar_adam"]:
            raise AssertionError(f"[{tag}] (a) r{o['rank']}: no launch of "
                                 f"{short} or {a['scalar_adam']} Adam "
                                 f"launches on the scalar path")
    steps = np.max([o["a"]["times"] for o in outs], axis=0)[1:]
    p50 = float(np.median(steps))
    a0 = outs[0]["a"]
    log(f"[{tag}] (a) GPT-3 1.3B width, {ZERO_LAYERS} of 24 layers, "
        f"sharding 2 x mp 2 (dp 1), level p_g_os, bf16 O2, AdamW(1e-4), "
        f"[{b}, {s}] by shard_tensor ({a0['rows']} rows a rank), "
        f"{a0['n_params'] / 1e6:.1f}M parameters: losses "
        f"{[round(x, 4) for x in losses[0]]} equal on the 4 ranks; step "
        f"p50 {p50:.1f} ms (the slowest rank's, {ZERO_STEPS - 1} steps "
        f"after the first; ranks "
        f"{[round(float(np.median(o['a']['times'][1:])), 1) for o in outs]}"
        f"), {b * s / p50 * 1e3:.0f} tokens/s; placements = JAX's rule on "
        f"every rank (kinds {a0['kinds']})")
    for o in outs:
        a = o["a"]
        per = {k: v / ZERO_STEPS for k, v in sorted(a["launches"].items())}
        log(f"[{tag}] (a) r{o['rank']} (sharding {o['sharding_rank']}, mp "
            f"{o['mp_rank']}): collectives a step {fmt_coll(a['coll'])}; "
            f"launches a step {per}, scalar-path Adam {a['scalar_adam']}; "
            f"resident parameters {a['param_bytes'] / 1e6:.1f} MB + "
            f"optimizer state {a['state_bytes'] / 1e6:.1f} MB against "
            f"{a['param_bytes_1'] / 1e6:.1f} + "
            f"{a['state_bytes_1'] / 1e6:.1f} MB at sharding 1 ("
            f"{(a['param_bytes'] + a['state_bytes']) / (a['param_bytes_1'] + a['state_bytes_1']):.3f}"
            f"); peak {a['peak_gb']:.2f} GB; a step's forward / backward / "
            f"step + clear_grad p50 "
            f"{' / '.join(f'{x:.1f}' for x in a['split'])} ms")
    for o in outs:
        mv = o["b"]["moves"]
        if not all(mv.values()):
            raise AssertionError(f"[{tag}] (b) r{o['rank']}: an api move "
                                 f"differs from the local slice: {mv}")
    r0 = outs[0]["b"]
    for level in ZERO_LEVELS:
        res = r0[level]
        rel = max(abs(x - y) / abs(y) for x, y in
                  zip(res["losses"] + [res["next"]],
                      res["ref_losses"] + [res["ref_next"]]))
        if rel > ZERO_LOSS_RTOL or res["worst"] > res["bound"]:
            raise AssertionError(
                f"[{tag}] (b) {level}: losses {res['losses']} vs one rank "
                f"{res['ref_losses']} (rel {rel:.2e} > {ZERO_LOSS_RTOL}) or "
                f"{res['worst_name']} off by {res['worst']:.3e} > "
                f"{res['bound']:.1e}")
        log(f"[{tag}] (b) {level}: fp32 2 layers at 1.3B width, sharding 2 "
            f"x mp 2 vs one rank, {ZERO_PARITY_STEPS} AdamW steps + clip "
            f"1.0: losses {[round(x, 5) for x in res['losses']]} vs "
            f"{[round(x, 5) for x in res['ref_losses']]} (worst rel "
            f"{rel:.2e}, next batch included), parameters within "
            f"{res['worst']:.2e} ({res['worst_name']}; bound "
            f"{res['bound']:.1e}); collectives a step "
            f"{fmt_coll(res['coll'])}")
    log(f"[{tag}] (b) api moves on the card bit for bit on every rank "
        f"(Shard -> Replicate -> Shard(j) over sharding and mp, an "
        f"all-to-all, unshard_dtensor)")
    c = r0["c_loss"]
    want = r0["p_g_os"]["next"]
    if abs(c - want) > ZERO_LOSS_RTOL * abs(want):
        raise AssertionError(f"[{tag}] (c) the saved model's loss {c} != "
                             f"the stage-3 run's next loss {want}")
    log(f"[{tag}] (c) save_group_sharded_model after p_g_os, loaded into "
        f"one rank's GPTForCausalLM: next-batch loss {c:.6f} vs the "
        f"stage-3 run's {want:.6f} (one rank's {r0['p_g_os']['ref_next']:.6f})")
    log(f"[{tag}] rank 0's seconds: the process group and topology "
        f"{outs[0]['seconds'][0]:.1f}, (a) {outs[0]['seconds'][1]:.1f}, (b) "
        f"and (c) {outs[0]['seconds'][2]:.1f} ({r0['clock']})")


def phase_train_zero(dev, early=None):
    """train-zero: ZeRO sharding and the semi-auto API on four ranks that
    share the card over NCCL's socket transport (the ranks are this
    script's ``--hybrid-child zero``): (a) the JAX recipe of
    benchmarks/run.py config 3 at GPT-3 1.3B width, (b) each level at 2
    layers in fp32 against one rank and the api moves, (c) the saved
    model into one rank.  No number here is a four-card one: the ranks
    time-slice one card.  ``early`` (``{"root", "procs", "pipe"}``):
    ranks that train-hybrid started, waiting for this phase's go; with
    ``pipe`` they run train-pipe's lane after their checks (`pipe_lane`),
    with ``sep`` train-sep's after it (`sep_lane`): this phase returns
    those lanes' results, ``{lane: [a rank's]}``."""
    # the ranks' ~50 GB must not meet this process's cached blocks of the
    # earlier phases
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    log(f"[train-zero] the card: {free / 1e9:.1f} of {total / 1e9:.1f} GB "
        f"free at the start (this process holds "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB)")
    own = early is None or not early["procs"]
    root = tempfile.mkdtemp(prefix="train-zero-") if early is None \
        else early["root"]
    procs = None if own else early["procs"]
    try:
        if own:
            procs = start_hybrid("zero", root)
        lanes = [lane for lane in ("pipe", "sep")
                 if early is not None and early[lane]]
        for lane in lanes:
            open(os.path.join(root, f"{lane}-too"), "w").close()
        open(os.path.join(root, "zero-go"), "w").close()
        outs = wait_hybrid("zero", root, procs, tag="train-zero")
        check_zero(outs)
        return {lane: [o[lane] for o in outs] for lane in lanes}
    finally:
        stop_ranks(procs or [])
        if early is None:
            shutil.rmtree(root, ignore_errors=True)


def stop_ranks(procs):
    for p, _ in procs:
        if p.poll() is None:
            p.kill()


# ------------------------------------------------------------ train-pipe
#: train-pipe (a): GPTForCausalLMPipe at GPT-3 1.3B width (hidden 2048,
#: 16 heads, FFN 8192, vocab 50304, S 2048), depth cut from 24 to
#: PIPE_LAYERS layers (2 a stage), pp 2 x mp 2, bf16 O2, AdamW(1e-4) with
#: the clip 1.0, the [8, 2048] batch in PIPE_ACCUM micro-batches of [2,
#: 2048], PIPE_STEPS train_batch calls (the first a warm-up)
PIPE_LAYERS, PIPE_STEPS, PIPE_ACCUM = 4, 4, 4
PIPE_BATCH = (8, 2048)
#: (b) 2 layers at the same width, (c) 4 layers in 2 virtual stages a
#: rank, small (hidden 1024, 8 heads of D 128, vocab 8192); fp32,
#: PIPE_ROWS rows of PIPE_SEQ tokens ((c) PIPE_SEQ_C), 2 micro-batches,
#: PIPE_PARITY_STEPS AdamW steps (lr ZERO_LR, wd 0.01, clip 1.0) against
#: one rank's GPTForCausalLMPipe at pp 1 on the same weights, within
#: train-zero (b)'s tolerances
PIPE_ROWS, PIPE_SEQ, PIPE_SEQ_C, PIPE_PARITY_STEPS = 4, 512, 256, 3


def pipe_parity_cfgs():
    """(b)'s and (c)'s model configs."""
    return (gpt_config("gpt3-1.3b", max_seq_len=2048, num_layers=2),
            gpt_config("gpt2-350m", num_layers=4, num_heads=8,
                       vocab_size=8192, max_seq_len=PIPE_SEQ_C))
#: the flash kernels' shape on the pipe's path: a micro-batch of B 2 x
#: S 2048, the rank's 8 of 16 heads, D 128, causal
PIPE_FLASH = dict(b=2, h=8, s=2048, d=128)


def pipe_strategy(accum):
    from paddle_tpu_torch.distributed import fleet
    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": 1, "mp_degree": 2, "pp_degree": 2}
    s.pipeline = True
    s.pipeline_configs = {"accumulate_steps": accum}
    return s


class one_rank_topology:
    """No topology in the body (a model built there holds the whole
    model and runs no collective); the rank's put back after."""

    def __enter__(self):
        from paddle_tpu_torch.distributed import mesh, topology
        self.hcg = topology.get_hybrid_communicate_group()
        topology.set_hybrid_communicate_group(None)
        self.scope = mesh.suspended()
        self.scope.__enter__()

    def __exit__(self, *exc):
        from paddle_tpu_torch.distributed import topology
        self.scope.__exit__(*exc)
        topology.set_hybrid_communicate_group(self.hcg)


def pipe_rows(vocab, b, s, seed):
    """(inputs, labels): ``b`` rows of ``s + 1`` random ids, shifted."""
    ids = torch.from_numpy(np.random.default_rng(seed).integers(
        0, vocab, (b, s + 1)))
    return ids[:, :-1], ids[:, 1:]


def pipe_recipe(dev, hcg):
    """(a) fleet.distributed_model(GPTForCausalLMPipe) -> train_batch at
    1.3B width, bf16 O2: losses, step ms, collectives a step, the tied
    weight's gradient bytes, launches, peak and resident bytes."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.models import GPTForCausalLMPipe
    cfg = gpt_config("gpt3-1.3b", max_seq_len=2048, num_layers=PIPE_LAYERS)
    torch.cuda.reset_peak_memory_stats(dev)
    model = GPTForCausalLMPipe(cfg, device=dev, dtype=torch.float32, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    pm = fleet.distributed_model(model)
    opt = AdamW(1e-4, parameters=pm.parameters(),
                grad_clip=ClipGradByGlobalNorm(1.0))
    pm, opt = amp.decorate(pm, opt, level="O2", dtype=torch.bfloat16)
    x, y = (t.to(dev) for t in pipe_rows(cfg.vocab_size, *PIPE_BATCH, 0))
    kernels.reset_launch_counts()
    scalar0 = adam_update.scalar_launches
    before = collective_counts()
    losses, times = [], []
    for _ in range(PIPE_STEPS):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        losses.append(float(pm.train_batch((x, y), opt)))
        torch.cuda.synchronize()
        times.append((time.monotonic() - t0) * 1e3)
    counts = kernels.launch_counts()
    coll = per_step(collective_counts(), before, PIPE_STEPS)
    state = sum(t.numel() * t.element_size()
                for t in opt.state_dict().values() if torch.is_tensor(t))
    return dict(
        losses=losses, times=times, coll=coll,
        launches={k: v for k, v in counts.items() if v},
        scalar_adam=adam_update.scalar_launches - scalar0,
        tie_mb=sum(p.numel() * p.element_size()
                   for _, ps in pm._ties for p in ps) / 1e6,
        peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
        n_params=n_params, n_tensors=len(list(pm.parameters())),
        param_bytes=sum(p.numel() * p.element_size()
                        for p in pm.parameters()), state_bytes=state,
        order=[(op, m) for _, op, m in pm._runner.last_schedule])


def pipe_kernel_checks(dev, n_adam):
    """The flash kernels at the pipe's shape and Adam at its largest
    parameter (bf16 with an fp32 master), each against its plain
    version (the phase's own launches, after the path's were read)."""
    gen = torch.Generator(device=dev).manual_seed(23)
    f = PIPE_FLASH
    errs, _ = flash_case(dev, f["b"], f["h"], f["h"], f["s"], f["d"], True,
                         torch.bfloat16, gen)
    errs["adam"], _ = adam_case(dev, n_adam, torch.bfloat16, True, True,
                                0.01, gen)
    return errs


def pipe_parity(dev, strategy, cfg, chunks, seq):
    """(b) / (c): ``cfg`` in fp32, ``chunks`` virtual stages a rank,
    against one rank's GPTForCausalLMPipe at pp 1 built from the same
    seed in this process (every rank runs it: no transfer of the whole
    model): the losses of PIPE_PARITY_STEPS steps and the worst
    difference of this rank's parameters from the one rank's parts."""
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.distributed import fleet, topology
    from paddle_tpu_torch.distributed.fleet.mp_layers import shard_of
    from paddle_tpu_torch.models import GPTForCausalLMPipe
    batches = [tuple(t.to(dev) for t in pipe_rows(cfg.vocab_size, PIPE_ROWS,
                                                  seq, 3 + i))
               for i in range(PIPE_PARITY_STEPS)]

    def adamw(ps):
        return AdamW(ZERO_LR, parameters=ps, weight_decay=0.01,
                     grad_clip=ClipGradByGlobalNorm(1.0))
    t0 = time.monotonic()
    with one_rank_topology():
        one = GPTForCausalLMPipe(cfg, device=dev, dtype=torch.float32,
                                 seed=1)
        opt = adamw(one.parameters())
        ref = []
        for x, y in batches:
            loss = one._loss_fn(one(x), y)
            loss.backward()
            opt.step()
            opt.clear_grad()
            ref.append(float(loss.detach()))
        want = {k: v.detach() for k, v in one.state_dict().items()}
        del one, opt
    t1 = time.monotonic()
    strategy.pipeline_configs["accumulate_steps"] = 2
    model = GPTForCausalLMPipe(cfg, num_virtual_pipeline_stages=chunks,
                               device=dev, dtype=torch.float32, seed=1)
    pm = fleet.distributed_model(model)
    opt = adamw(pm.parameters())
    losses = [float(pm.train_batch(b, opt)) for b in batches]
    splits = convert._splits(model)
    g = topology.mp_group()
    worst, worst_name = 0.0, None
    for name, p in model.state_dict().items():
        w = want[name]
        if name in splits:
            dim, ch = splits[name]
            w = shard_of(w, dim, g.nranks, g.rank, ch)
        err = float((p - w).abs().max())
        if err > worst:
            worst, worst_name = err, name
    res = dict(losses=losses, ref=ref, worst=worst, worst_name=worst_name,
               bound=2 * ZERO_LR * PIPE_PARITY_STEPS,
               kind=type(pm).__name__,
               order=list(pm._runner.last_schedule),
               seconds=(t1 - t0, time.monotonic() - t1))
    del model, pm, opt, want
    gc.collect()
    torch.cuda.empty_cache()
    return res


def pipe_lane(dev, rank):
    """train-pipe on the world's four ranks (their process group joined):
    pp 2 x mp 2; the fp32 lanes (b) and (c) first (the groups' NCCL
    communicators are made there), then (a), then the kernels at its
    shapes (rank 0)."""
    from paddle_tpu_torch.distributed import fleet
    marks = [time.monotonic()]
    strategy = pipe_strategy(PIPE_ACCUM)
    hcg = fleet.init(is_collective=True, strategy=strategy,
                     backend=HYBRID_BACKEND, device=dev)
    out = {"rank": rank, "stage": hcg.get_pipe_parallel_rank(),
           "mp_rank": hcg.get_model_parallel_rank()}
    marks.append(time.monotonic())
    cfg_b, cfg_c = pipe_parity_cfgs()
    out["b"] = pipe_parity(dev, strategy, cfg_b, 1, PIPE_SEQ)
    marks.append(time.monotonic())
    out["c"] = pipe_parity(dev, strategy, cfg_c, 2, PIPE_SEQ_C)
    marks.append(time.monotonic())
    strategy.pipeline_configs["accumulate_steps"] = PIPE_ACCUM
    out["a"] = pipe_recipe(dev, hcg)
    marks.append(time.monotonic())
    if rank == 0:
        out["kernels"] = pipe_kernel_checks(dev, 25152 * 2048)
    marks.append(time.monotonic())
    out["seconds"] = [b - a for a, b in zip(marks, marks[1:])]
    return out


def pipe_ranks(dev, rank, world, outdir):
    """train-pipe's own four ranks (without train-zero in the run)."""
    from paddle_tpu_torch.distributed import env
    env.init_parallel_env(
        backend=HYBRID_BACKEND, device=dev, world_size=world, rank=rank,
        init_method="file://" + os.path.join(outdir, "rdzv-pipe"))
    return pipe_lane(dev, rank)


HYBRID_LANES["pipe"] = (pipe_ranks, 4)

#: (a)'s launches a rank a step: flash fwd, dK/dV and dQ once a layer a
#: micro-batch on the rank's 2 layers; Adam once a parameter (stage 0:
#: wte, wpe and 12 a block; stage 1: 12 a block, the final norm's 2 and
#: the tied copy's wte and wpe)
PIPE_ADAM = {0: 2 + 12 * PIPE_LAYERS // 2, 1: 12 * PIPE_LAYERS // 2 + 4}


def check_pipe(outs, seconds=None):
    """(a), the kernels, (b) and (c) from the four ranks."""
    tag = "train-pipe"
    card = smi_card()
    losses = [o["a"]["losses"] for o in outs]
    if any(x != losses[0] for x in losses) or \
            not all(np.isfinite(losses[0])):
        raise AssertionError(f"[{tag}] (a) losses not finite and equal on "
                             f"the 4 ranks: {losses}")
    flash_per = PIPE_ACCUM * PIPE_LAYERS // 2
    for o in outs:
        a = o["a"]
        per = {k: v / PIPE_STEPS for k, v in a["launches"].items()}
        want = dict({k: flash_per for k in FLASH}, adam=PIPE_ADAM[o["stage"]])
        bad = {k: (per.get(k, 0), n) for k, n in want.items()
               if per.get(k, 0) != n}
        if bad or a["scalar_adam"]:
            raise AssertionError(f"[{tag}] (a) r{o['rank']}: launches a "
                                 f"step (got, want) {bad}, scalar-path Adam "
                                 f"{a['scalar_adam']}")
        plan = pipe_plan(2, PIPE_ACCUM)[o["stage"]]
        if [tuple(x) for x in a["order"]] != plan:
            raise AssertionError(f"[{tag}] (a) r{o['rank']}: order "
                                 f"{a['order']} is not the 1F1B plan {plan}")
    steps = np.max([o["a"]["times"] for o in outs], axis=0)[1:]
    p50 = float(np.median(steps))
    b, s = PIPE_BATCH
    log(f"[{tag}] {card}; (a) GPTForCausalLMPipe at GPT-3 1.3B width, "
        f"{PIPE_LAYERS} of 24 layers (2 a stage), pp 2 x mp 2 on four ranks "
        f"sharing the card over NCCL's socket, bf16 O2, AdamW(1e-4) + clip "
        f"1.0, [{b}, {s}] in {PIPE_ACCUM} micro-batches, 1F1B on each rank: "
        f"losses {[round(x, 4) for x in losses[0]]} equal on the 4 ranks; "
        f"step p50 {p50:.1f} ms (the slowest rank's, {PIPE_STEPS - 1} steps "
        f"after the first; ranks "
        f"{[round(float(np.median(o['a']['times'][1:])), 1) for o in outs]}"
        f"), {b * s / p50 * 1e3:.0f} tokens/s")
    for o in outs:
        a = o["a"]
        per = {k: v / PIPE_STEPS for k, v in sorted(a["launches"].items())}
        log(f"[{tag}] (a) r{o['rank']} (stage {o['stage']}, mp "
            f"{o['mp_rank']}): {a['n_params'] / 1e6:.1f}M parameters in "
            f"{a['n_tensors']} tensors, resident {a['param_bytes'] / 1e9:.3f}"
            f" GB + optimizer state {a['state_bytes'] / 1e9:.3f} GB; "
            f"collectives a step {fmt_coll(a['coll'])}; the tied weight's "
            f"gradient all-reduce {a['tie_mb']:.1f} MB; launches a step "
            f"{per}, scalar-path Adam {a['scalar_adam']}; peak "
            f"{a['peak_gb']:.2f} GB; step ms {[round(t, 1) for t in a['times']]}")
    errs = outs[0]["kernels"]
    f = PIPE_FLASH
    log(f"[{tag}] kernels at the path's shapes against their plain versions "
        f"(rank 0): flash B{f['b']} H{f['h']} S{f['s']} D{f['d']} causal "
        f"bf16: fwd {errs['flash_fwd']:.3e}, dK/dV {errs['flash_bwd_dkv']:.3e}"
        f", dQ {errs['flash_bwd_dq']:.3e} (max abs err, rows within "
        f"ROW_TOL); Adam on {25152 * 2048} elements (bf16 + fp32 master) bit "
        f"for bit")
    for lane, want_kind in (("b", "PipelineParallel"),
                            ("c", "PipelineParallelWithInterleave")):
        for o in outs:
            r = o[lane]
            rel = max(abs(x - y) / abs(y) for x, y in zip(r["losses"],
                                                           r["ref"]))
            if r["kind"] != want_kind or rel > ZERO_LOSS_RTOL or \
                    r["worst"] > r["bound"]:
                raise AssertionError(
                    f"[{tag}] ({lane}) r{o['rank']} {r['kind']}: losses "
                    f"{r['losses']} vs one rank {r['ref']} (rel {rel:.2e} > "
                    f"{ZERO_LOSS_RTOL}) or {r['worst_name']} off by "
                    f"{r['worst']:.3e} > {r['bound']:.1e}")
        r0 = outs[0][lane]
        rels = [max(abs(x - y) / abs(y) for x, y in
                    zip(o[lane]["losses"], o[lane]["ref"])) for o in outs]
        log(f"[{tag}] ({lane}) fp32 "
            + ("2 layers at 1.3B width" if lane == "b" else
               "4 layers at hidden 1024, 8 heads, vocab 8192")
            + ", pp 2 x mp 2"
            + (", 2 virtual stages a rank (all forwards chunk by chunk, "
               "then the backwards in reverse)" if lane == "c" else "")
            + f", [{PIPE_ROWS}, {PIPE_SEQ if lane == 'b' else PIPE_SEQ_C}] "
            f"in 2 micro-batches vs one rank's pipe at pp 1, "
            f"{PIPE_PARITY_STEPS} AdamW steps + clip 1.0: losses "
            f"{[round(x, 5) for x in r0['losses']]} vs "
            f"{[round(x, 5) for x in r0['ref']]} (worst rel {max(rels):.2e}"
            f"), parameters within "
            f"{max(o[lane]['worst'] for o in outs):.2e} (bound "
            f"{r0['bound']:.1e}); seconds one rank / pipe "
            f"{r0['seconds'][0]:.1f} / {r0['seconds'][1]:.1f}")
    sec = outs[0]["seconds"]
    log(f"[{tag}] rank 0's seconds: the topology {sec[0]:.1f}, (b) "
        f"{sec[1]:.1f}, (c) {sec[2]:.1f}, (a) {sec[3]:.1f}, kernels "
        f"{sec[4]:.1f}")


def pipe_plan(stages, micro):
    """Each stage's JAX 1F1B action list (`Host1F1B._plan`)."""
    from paddle_tpu_torch.distributed.fleet.meta_parallel.\
        pipeline_parallel import Host1F1B

    class _Stages:
        _num_chunks = 1

        def get_num_stages(self):
            return stages
    return Host1F1B(_Stages(), micro, None)._plan()


def phase_train_pipe(dev, outs=None):
    """train-pipe: pipeline parallelism on four ranks that share the card
    (pp 2 x mp 2, the ranks' NCCL over its socket transport).  ``outs``:
    the results train-zero's ranks brought back (they run this lane
    after their checks); else this phase starts its own ranks (this
    script's ``--hybrid-child pipe``)."""
    if outs is None:
        gc.collect()
        torch.cuda.empty_cache()
        root = tempfile.mkdtemp(prefix="train-pipe-")
        procs = None
        try:
            procs = start_hybrid("pipe", root)
            outs = wait_hybrid("pipe", root, procs, tag="train-pipe")
        finally:
            stop_ranks(procs or [])
            shutil.rmtree(root, ignore_errors=True)
    check_pipe(outs)


# ------------------------------------------------------------ train-sep
#: train-sep (a): ParallelGPTForCausalLM(use_ring_attention=True) at GPT-3
#: 1.3B width (hidden 2048, 16 heads, FFN 8192, vocab 50304, S 2048), depth
#: cut from 24 to SEP_LAYERS layers, sep 2 x mp 2 (dp 1) on four ranks
#: sharing the card, bf16 O2, AdamW(1e-4) + clip 1.0, SEP_STEPS steps (the
#: first a warm-up) on the global [4, 2048] batch (a rank's chunk [4,
#: 1024]): B cut from 8, where the four ranks' peaks came to 64.2 GB (16.05
#: GB a rank: the ring's fp32 scores, 268 MB a tensor at B 8)
SEP_LAYERS, SEP_STEPS = 4, 3
SEP_BATCH = (4, 2048)
#: (b): 2 layers at the same width in fp32, [SEP_ROWS, SEP_SEQ], with ring
#: and the gathered lane, PARITY_STEPS AdamW steps (lr ZERO_LR, wd 0.01,
#: clip 1.0) against one rank's model at sep 1 on the same weights: the
#: losses within PARITY_LOSS_RTOL, each parameter within PARITY_BOUND:
#: set from the sound runs (1.32e-05 to 1.66e-05 on an H100, ring,
#: gathered and MoE) at about 6 times the largest, below the 2 lr x 2
#: steps = 4e-4 that any two runs of 2 AdamW steps stay within (AdamW
#: moves an element by at most ~lr a step whatever its gradient's size),
#: so that the second update, which no loss sees, is checked
SEP_ROWS, SEP_SEQ, PARITY_STEPS = 2, 512, 2
PARITY_LOSS_RTOL, PARITY_BOUND = 1e-6, 1.0e-4
#: (c): ring and Ulysses at B2 S2048 (1024 a rank) H8 D128 bf16, forward
#: and input gradients, against the flash kernel on the whole sequence
#: (`check_close`'s bf16 tolerance: rtol 1e-2, atol 2e-2)
SEP_OPS = dict(b=2, h=8, s=2048, d=128)


def sep_strategy():
    from paddle_tpu_torch.distributed import fleet
    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": 1, "mp_degree": 2, "sep_degree": 2}
    return s


class count_by_group:
    """Tallies `collective.all_reduce` calls and bytes in the body by the
    group's name in ``groups`` ({name: Group}): the registry counts by
    op only."""

    def __init__(self, groups):
        self.names = {tuple(g.ranks): n for n, g in groups.items()
                      if g is not None}
        self.tally = {}

    def __enter__(self):
        from paddle_tpu_torch.distributed import collective
        self.mod, self.orig = collective, collective.all_reduce

        def counted(tensor, *args, **kwargs):
            group = kwargs.get("group", args[1] if len(args) > 1 else None)
            name = "world" if group is None else self.names.get(
                tuple(group.ranks), str(group.ranks))
            c, b = self.tally.get(name, (0, 0))
            self.tally[name] = (c + 1,
                                b + tensor.numel() * tensor.element_size())
            return self.orig(tensor, *args, **kwargs)
        collective.all_reduce = counted
        return self

    def __exit__(self, *exc):
        self.mod.all_reduce = self.orig


def rank_steps(model, opt, x, y, n, update=None):
    """``n`` eager steps (forward, backward, ``update`` or ``opt.step``,
    clear): the rank's losses and each step's ms."""
    losses, times = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        _, loss = model(x, labels=y)
        loss.backward()
        (update or opt.step)()
        opt.clear_grad()
        losses.append(float(loss.detach()))
        torch.cuda.synchronize()
        times.append((time.monotonic() - t0) * 1e3)
    return losses, times


def sep_recipe(dev, hcg):
    """(a): fleet.distributed_model(ParallelGPTForCausalLM(cfg,
    use_ring_attention=True)) at 1.3B width, bf16 O2: the rank's losses,
    step ms, all-reduce calls and bytes a step by group, the ring's p2p,
    launches, peak."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.models import ParallelGPTForCausalLM
    cfg = gpt_config("gpt3-1.3b", max_seq_len=2048, num_layers=SEP_LAYERS)
    torch.cuda.reset_peak_memory_stats(dev)
    model = fleet.distributed_model(ParallelGPTForCausalLM(
        cfg, use_ring_attention=True, device=dev, dtype=torch.float32,
        seed=0))
    opt = AdamW(1e-4, parameters=model.parameters(),
                grad_clip=ClipGradByGlobalNorm(1.0))
    model, opt = amp.decorate(model, opt, level="O2", dtype=torch.bfloat16)
    x, y = (t.to(dev) for t in pipe_rows(cfg.vocab_size, *SEP_BATCH, 0))
    kernels.reset_launch_counts()
    scalar0 = adam_update.scalar_launches
    before = collective_counts()
    with count_by_group({"mp": hcg.get_model_parallel_group(),
                         "sep": hcg.get_sep_parallel_group()}) as groups:
        losses, times = rank_steps(model, opt, x, y, SEP_STEPS)
    return dict(
        losses=losses, times=times, kind=type(model).__name__,
        coll=per_step(collective_counts(), before, SEP_STEPS),
        groups={k: (c / SEP_STEPS, b / SEP_STEPS)
                for k, (c, b) in groups.tally.items()},
        launches={k: v for k, v in kernels.launch_counts().items() if v},
        scalar_adam=adam_update.scalar_launches - scalar0,
        peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
        n_tensors=len(list(model.parameters())),
        param_bytes=sum(p.numel() * p.element_size()
                        for p in model.parameters()))


def worst_part(model, want):
    """The largest difference of this rank's parameters from the one-rank
    model's ``want`` (its mp part of each split one): (err, name)."""
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.distributed import topology
    from paddle_tpu_torch.distributed.fleet.mp_layers import shard_of
    splits = convert._splits(model)
    g = topology.mp_group()
    worst, worst_name = 0.0, None
    for name, p in model.state_dict().items():
        w = want[name]
        if name in splits:
            dim, ch = splits[name]
            w = shard_of(w, dim, g.nranks, g.rank, ch)
        err = float((p.float() - w.float()).abs().max())
        if err > worst:
            worst, worst_name = err, name
    return worst, worst_name


def parity_adamw(ps):
    return AdamW(ZERO_LR, parameters=ps, weight_decay=0.01,
                 grad_clip=ClipGradByGlobalNorm(1.0))


def one_rank_run(build, batches):
    """The one-rank reference (no topology): losses and state."""
    with one_rank_topology():
        one = build()
        opt = parity_adamw(one.parameters())
        ref = [rank_steps(one, opt, x, y, 1)[0][0] for x, y in batches]
        want = {k: v.detach() for k, v in one.state_dict().items()}
        del one, opt
    return ref, want


def sep_parity(dev, hcg):
    """(b): fp32 2 layers at 1.3B width, ring and gathered, against one
    rank's model at sep 1 (every rank builds it: no transfer): the losses
    (a rank's chunk losses averaged over sep: the chunks hold equal
    labelled counts) and the worst parameter difference."""
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.models import ParallelGPTForCausalLM
    cfg = gpt_config("gpt3-1.3b", max_seq_len=2048, num_layers=2)
    batches = [tuple(t.to(dev) for t in pipe_rows(cfg.vocab_size, SEP_ROWS,
                                                  SEP_SEQ, 3 + i))
               for i in range(PARITY_STEPS)]
    t0 = time.monotonic()
    ref, want = one_rank_run(lambda: ParallelGPTForCausalLM(
        cfg, device=dev, dtype=torch.float32, seed=1), batches)
    res = {"ref": ref, "seconds": [time.monotonic() - t0]}
    for ring in (True, False):
        t0 = time.monotonic()
        model = fleet.distributed_model(ParallelGPTForCausalLM(
            cfg, use_ring_attention=ring, device=dev, dtype=torch.float32,
            seed=1))
        opt = parity_adamw(model.parameters())
        kernels.reset_launch_counts()
        local = [rank_steps(model, opt, x, y, 1)[0][0] for x, y in batches]
        flash = kernels.launch_counts().get("flash_fwd", 0)
        lt = torch.tensor(local, device=dev)
        C.all_reduce(lt, op=C.ReduceOp.AVG,
                     group=hcg.get_sep_parallel_group())
        worst, name = worst_part(model, want)
        res["ring" if ring else "gathered"] = dict(
            losses=lt.tolist(), worst=worst, worst_name=name,
            flash_fwd=flash)
        res["seconds"].append(time.monotonic() - t0)
        del model, opt
    del want
    gc.collect()
    torch.cuda.empty_cache()
    return res


def sep_ops(dev, hcg):
    """(c): ring and Ulysses on this rank's chunk, forward and input
    gradients, against the flash kernel on the whole sequence (the same
    inputs on every rank from one seed): max abs errors."""
    from paddle_tpu_torch.distributed import context_parallel as CP
    f = SEP_OPS
    g = torch.Generator(device=dev).manual_seed(29)
    q, k, v, do = (torch.randn(f["b"], f["s"], f["h"], f["d"], device=dev,
                               generator=g).to(torch.bfloat16)
                   for _ in range(4))
    ref = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = F.flash_attention(*ref, causal=True)
    out.backward(do)
    r, c = hcg.get_sep_parallel_rank(), f["s"] // 2

    def chunk(t):
        return t[:, r * c:(r + 1) * c]
    errs = {}
    for name, fn in (("ring", CP.ring_flash_attention),
                     ("ulysses", CP.ulysses_attention)):
        ins = [chunk(t).detach().clone().requires_grad_(True)
               for t in (q, k, v)]
        y = fn(*ins, causal=True)
        y.backward(chunk(do))
        for label, got, want in (("out", y, chunk(out)),
                                 ("dq", ins[0].grad, chunk(ref[0].grad)),
                                 ("dk", ins[1].grad, chunk(ref[1].grad)),
                                 ("dv", ins[2].grad, chunk(ref[2].grad))):
            check_close(f"[train-sep] (c) {name} {label}", got.detach(),
                        want.detach(), torch.bfloat16)
            errs[f"{name} {label}"] = max_err(got, want)
    return errs


def sep_lane(dev, rank):
    """train-sep on the world's four ranks (their process group joined):
    sep 2 x mp 2; (b) first (the groups' communicators are made there),
    then (a), then (c) and, on rank 0, Adam at (a)'s largest parameter."""
    from paddle_tpu_torch.distributed import fleet
    marks = [time.monotonic()]
    hcg = fleet.init(is_collective=True, strategy=sep_strategy(),
                     backend=HYBRID_BACKEND, device=dev)
    out = {"rank": rank, "sep_rank": hcg.get_sep_parallel_rank(),
           "mp_rank": hcg.get_model_parallel_rank()}
    marks.append(time.monotonic())
    out["b"] = sep_parity(dev, hcg)
    marks.append(time.monotonic())
    out["a"] = sep_recipe(dev, hcg)
    gc.collect()
    torch.cuda.empty_cache()
    marks.append(time.monotonic())
    out["c"] = sep_ops(dev, hcg)
    if rank == 0:
        gen = torch.Generator(device=dev).manual_seed(31)
        out["adam"], _ = adam_case(dev, 25152 * 2048, torch.bfloat16, True,
                                   True, 0.0, gen)
    marks.append(time.monotonic())
    out["seconds"] = [b - a for a, b in zip(marks, marks[1:])]
    return out


def sep_ranks(dev, rank, world, outdir):
    """train-sep's own four ranks (without train-zero in the run)."""
    from paddle_tpu_torch.distributed import env
    env.init_parallel_env(
        backend=HYBRID_BACKEND, device=dev, world_size=world, rank=rank,
        init_method="file://" + os.path.join(outdir, "rdzv-sep"))
    return sep_lane(dev, rank)


HYBRID_LANES["sep"] = (sep_ranks, 4)

#: (a)'s Adam launches a rank a step: one a parameter (wte, wpe, 12 a
#: block, the final norm's 2)
SEP_ADAM = 2 + 12 * SEP_LAYERS + 2


def fmt_by_group(groups):
    return ", ".join(f"{k} {c:g} calls {b / 1e6:.1f} MB"
                     for k, (c, b) in sorted(groups.items()))


def check_sep(outs):
    """(a), (b), (c) from the four ranks."""
    tag = "train-sep"
    card = smi_card()
    by = {(o["sep_rank"], o["mp_rank"]): o for o in outs}
    for s in (0, 1):
        la, lb = by[(s, 0)]["a"]["losses"], by[(s, 1)]["a"]["losses"]
        if la != lb or not all(np.isfinite(la)):
            raise AssertionError(f"[{tag}] (a) sep rank {s}: the mp ranks' "
                                 f"chunk losses not finite and equal: {la} "
                                 f"{lb}")
    glob = np.mean([by[(s, 0)]["a"]["losses"] for s in (0, 1)], axis=0)
    for o in outs:
        a = o["a"]
        per = {k: v / SEP_STEPS for k, v in a["launches"].items()}
        if a["kind"] != "SegmentParallel" or per.get("adam") != SEP_ADAM \
                or a["scalar_adam"] or per.get("flash_fwd", 0):
            raise AssertionError(
                f"[{tag}] (a) r{o['rank']}: {a['kind']}, launches a step "
                f"{per} (Adam {SEP_ADAM} a step, no flash: the ring runs "
                f"in plain torch), scalar-path Adam {a['scalar_adam']}")
    steps = np.max([o["a"]["times"] for o in outs], axis=0)[1:]
    p50 = float(np.median(steps))
    b, s = SEP_BATCH
    log(f"[{tag}] {card}; (a) ParallelGPTForCausalLM(use_ring_attention="
        f"True) at GPT-3 1.3B width, {SEP_LAYERS} of 24 layers, sep 2 x mp "
        f"2 on four ranks sharing the card over NCCL's socket, bf16 O2, "
        f"AdamW(1e-4) + clip 1.0, [{b}, {s}] ([{b}, {s // 2}] a rank): "
        f"losses (mean of the chunks) {[round(float(x), 4) for x in glob]}; step "
        f"p50 {p50:.1f} ms (the slowest rank's, {SEP_STEPS - 1} steps after "
        f"the first; ranks "
        f"{[round(float(np.median(o['a']['times'][1:])), 1) for o in outs]}"
        f"), {b * s / p50 * 1e3:.0f} tokens/s")
    for o in outs:
        a = o["a"]
        per = {k: v / SEP_STEPS for k, v in sorted(a["launches"].items())}
        log(f"[{tag}] (a) r{o['rank']} (sep {o['sep_rank']}, mp "
            f"{o['mp_rank']}): {a['n_tensors']} tensors, resident "
            f"{a['param_bytes'] / 1e9:.3f} GB; all-reduces a step by group "
            f"{fmt_by_group(a['groups'])}; collectives a step "
            f"{fmt_coll(a['coll'])}; launches a step {per}, scalar-path "
            f"Adam {a['scalar_adam']}; peak {a['peak_gb']:.2f} GB; step ms "
            f"{[round(t, 1) for t in a['times']]}")
    for o in outs:
        r = o["b"]
        for lane in ("ring", "gathered"):
            x = r[lane]
            rel = max(abs(g - w) / abs(w) for g, w in zip(x["losses"],
                                                          r["ref"]))
            want_flash = 0 if lane == "ring" else 2 * PARITY_STEPS
            if rel > PARITY_LOSS_RTOL or x["worst"] > PARITY_BOUND or \
                    x["flash_fwd"] != want_flash:
                raise AssertionError(
                    f"[{tag}] (b) {lane} r{o['rank']}: losses {x['losses']} "
                    f"vs one rank {r['ref']} (rel {rel:.2e} > "
                    f"{PARITY_LOSS_RTOL}), {x['worst_name']} off by "
                    f"{x['worst']:.3e} (> {PARITY_BOUND:.1e}?), flash "
                    f"forwards {x['flash_fwd']} (want {want_flash})")
    r0 = outs[0]["b"]
    for lane in ("ring", "gathered"):
        rels = [max(abs(g - w) / abs(w) for g, w in
                    zip(o["b"][lane]["losses"], o["b"]["ref"]))
                for o in outs]
        log(f"[{tag}] (b) fp32 2 layers at 1.3B width, sep 2 x mp 2, "
            f"{lane}, [{SEP_ROWS}, {SEP_SEQ}], {PARITY_STEPS} AdamW steps + "
            f"clip 1.0 vs one rank's model at sep 1: losses "
            f"{[round(x, 6) for x in r0[lane]['losses']]} vs "
            f"{[round(x, 6) for x in r0['ref']]} (worst rel {max(rels):.2e}"
            f" <= {PARITY_LOSS_RTOL}), parameters within "
            f"{max(o['b'][lane]['worst'] for o in outs):.2e} (bound "
            f"{PARITY_BOUND:.1e}); flash forwards "
            f"{r0[lane]['flash_fwd']}")
    f = SEP_OPS
    errs = outs[0]["c"]
    log(f"[{tag}] (c) ring and Ulysses at B{f['b']} S{f['s']} ({f['s'] // 2}"
        f" a rank) H{f['h']} D{f['d']} bf16 vs the flash kernel on the whole "
        f"sequence (check_close: rtol 1e-2, atol 2e-2), max abs err (rank "
        f"0): " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    log(f"[{tag}] Adam on {25152 * 2048} elements (bf16 + fp32 master, "
        f"(a)'s largest parameter) bit for bit: max abs err "
        f"{outs[0]['adam']:.3e}")
    sec = outs[0]["seconds"]
    log(f"[{tag}] rank 0's seconds: the topology {sec[0]:.1f}, (b) "
        f"{sec[1]:.1f} (one rank / ring / gathered "
        f"{', '.join(f'{t:.1f}' for t in r0['seconds'])}), (a) {sec[2]:.1f}, "
        f"(c) + Adam {sec[3]:.1f}")


def phase_train_sep(dev, outs=None):
    """train-sep: context parallelism on four ranks that share the card
    (sep 2 x mp 2).  ``outs``: the results train-zero's ranks brought
    back (they run this lane after their checks); else this phase starts
    its own ranks (this script's ``--hybrid-child sep``)."""
    if outs is None:
        gc.collect()
        torch.cuda.empty_cache()
        root = tempfile.mkdtemp(prefix="train-sep-")
        procs = None
        try:
            procs = start_hybrid("sep", root)
            outs = wait_hybrid("sep", root, procs, tag="train-sep")
        finally:
            stop_ranks(procs or [])
            shutil.rmtree(root, ignore_errors=True)
    check_sep(outs)


# ------------------------------------------------------------ train-moe
#: train-moe: benchmarks/run.py config 5 (`moe`) at full width, nothing
#: cut: ParallelGPTForCausalLM(gpt_config("gpt2-124m", max_seq_len=1024),
#: moe_every=2, num_experts=4) (6 MoE layers), dp 2 x mp 2 on four ranks
#: sharing the card, AdamW(1e-4), the global [16, 1024] batch (a dp rank
#: [8, 1024]), MOE_STEPS eager steps (the first a warm-up); bf16 O2 added
MOE_STEPS = 3
MOE_BATCH = (16, 1024)
#: (b): 2 layers (one MoE) at GPT-2 width in fp32, [MOE_ROWS, MOE_SEQ],
#: moe_capacity (0.5, 1.0) so that tokens drop, PARITY_STEPS AdamW steps
#: against one rank's model at dp 1 x mp 1 (train-sep (b)'s bounds)
MOE_ROWS, MOE_SEQ = 4, 256
#: the flash kernels at the recipe's shape: a dp rank's B8 x S1024, the
#: rank's 6 of 12 heads, D 64, causal
MOE_FLASH = dict(b=8, h=6, s=1024, d=64)


def moe_model(dev, cfg, seed, capacity=None):
    from paddle_tpu_torch.models import ParallelGPTForCausalLM
    return ParallelGPTForCausalLM(cfg, moe_every=2, num_experts=4,
                                  moe_capacity=capacity, device=dev,
                                  dtype=torch.float32, seed=seed)


def moe_update(opt, hcg, dev):
    """The eager dp x mp step tail (`parallel.mesh_update`)."""
    from paddle_tpu_torch.distributed import parallel
    return lambda: parallel.mesh_update(
        opt, None, hcg.get_data_parallel_group(),
        hcg.get_model_parallel_group(), dev)


def dp_rows(t, hcg):
    per = t.shape[0] // hcg.get_data_parallel_world_size()
    r = hcg.get_data_parallel_rank()
    return t[r * per:(r + 1) * per]


def moe_recipe(dev, hcg):
    """(a): the recipe at full width, bf16 O2: losses, step ms,
    all-reduce calls and bytes a step by group, the tokens each MoE
    layer's experts dropped, launches, peak."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.framework import prng
    cfg = gpt_config("gpt2-124m", max_seq_len=1024)
    torch.cuda.reset_peak_memory_stats(dev)
    model = fleet.distributed_model(moe_model(dev, cfg, 0))
    opt = AdamW(1e-4, parameters=model.parameters())
    model, opt = amp.decorate(model, opt, level="O2", dtype=torch.bfloat16)
    x, y = (dp_rows(t, hcg).to(dev)
            for t in pipe_rows(cfg.vocab_size, *MOE_BATCH, 0))
    prng.seed(0)
    kernels.reset_launch_counts()
    scalar0 = adam_update.scalar_launches
    before = collective_counts()
    with count_by_group({"mp": hcg.get_model_parallel_group(),
                         "dp": hcg.get_data_parallel_group()}) as groups:
        losses, times = rank_steps(model, opt, x, y, MOE_STEPS,
                                   moe_update(opt, hcg, dev))
    moe = [blk.mlp for blk in model.gpt.h if hasattr(blk.mlp, "gate")]
    return dict(
        losses=losses, times=times,
        coll=per_step(collective_counts(), before, MOE_STEPS),
        groups={k: (c / MOE_STEPS, b / MOE_STEPS)
                for k, (c, b) in groups.tally.items()},
        dropped=[m.last_dropped.tolist() for m in moe],
        capacity=int(max(1, 1.2 * MOE_BATCH[0] * MOE_BATCH[1] / 4 * 2)),
        launches={k: v for k, v in kernels.launch_counts().items() if v},
        scalar_adam=adam_update.scalar_launches - scalar0,
        peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
        n_tensors=len(list(model.parameters())),
        expert_shape=list(moe[0]._stacked.w1.shape))


def moe_parity(dev, hcg):
    """(b): fp32 2 layers, tokens dropped by the capacity, against one
    rank's model at dp 1 x mp 1 on the global batch (the random routing's
    keys from the same stream): the global losses and the worst
    parameter difference."""
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.framework import prng
    cfg = gpt_config("gpt2-124m", max_seq_len=1024, num_layers=2)
    batches = [tuple(t.to(dev) for t in pipe_rows(cfg.vocab_size, MOE_ROWS,
                                                  MOE_SEQ, 5 + i))
               for i in range(PARITY_STEPS)]
    cap = (0.5, 1.0)
    t0 = time.monotonic()
    prng.seed(0)
    ref, want = one_rank_run(lambda: moe_model(dev, cfg, 1, cap), batches)
    one_s = time.monotonic() - t0
    prng.seed(0)
    model = fleet.distributed_model(moe_model(dev, cfg, 1, cap))
    opt = parity_adamw(model.parameters())
    update = moe_update(opt, hcg, dev)
    local = [rank_steps(model, opt, dp_rows(x, hcg), dp_rows(y, hcg), 1,
                        update)[0][0] for x, y in batches]
    dropped = model.gpt.h[1].mlp.last_dropped.tolist()
    lt = torch.tensor(local, device=dev)
    C.all_reduce(lt, op=C.ReduceOp.AVG, group=hcg.get_data_parallel_group())
    worst, name = worst_part(model, want)
    del model, opt, want
    gc.collect()
    torch.cuda.empty_cache()
    return dict(losses=lt.tolist(), ref=ref, worst=worst, worst_name=name,
                dropped=dropped,
                seconds=(one_s, time.monotonic() - t0 - one_s))


def moe_lane(dev, rank, hcg):
    """train-moe in train-hybrid (c)'s four ranks (dp 2 x mp 2, their
    topology): (a), then (b), then the kernels at (a)'s shapes (rank
    0)."""
    marks = [time.monotonic()]
    out = {"rank": rank, "dp_rank": hcg.get_data_parallel_rank(),
           "mp_rank": hcg.get_model_parallel_rank()}
    out["a"] = moe_recipe(dev, hcg)
    gc.collect()
    torch.cuda.empty_cache()
    marks.append(time.monotonic())
    out["b"] = moe_parity(dev, hcg)
    marks.append(time.monotonic())
    if rank == 0:
        gen = torch.Generator(device=dev).manual_seed(37)
        f = MOE_FLASH
        out["kernels"], _ = flash_case(dev, f["b"], f["h"], f["h"], f["s"],
                                       f["d"], True, torch.bfloat16, gen)
        out["kernels"]["adam"], _ = adam_case(dev, 25152 * 768,
                                              torch.bfloat16, True, True,
                                              0.0, gen)
    marks.append(time.monotonic())
    out["seconds"] = [b - a for a, b in zip(marks, marks[1:])]
    return out


def moe_ranks(dev, rank, world, outdir):
    """train-moe's own four ranks (without train-hybrid in the run)."""
    return moe_lane(dev, rank, hybrid_init(dev, world, 2, 2, outdir, "moe"))


HYBRID_LANES["moe"] = (moe_ranks, 4)

#: (a)'s launches a rank a step: flash fwd, dK/dV and dQ once a layer;
#: Adam once a parameter (wte, wpe, 12 a dense block, 14 a MoE block: the
#: attention's 6, the norms' 4, its 4 expert stacks and the gate's 2; the
#: final norm's 2)
MOE_ADAM = 2 + 12 * 6 + 14 * 6 + 2


def check_moe(outs):
    """(a), (b) and the kernels from the four ranks."""
    tag = "train-moe"
    card = smi_card()
    by = {(o["dp_rank"], o["mp_rank"]): o for o in outs}
    for d in (0, 1):
        la, lb = by[(d, 0)]["a"]["losses"], by[(d, 1)]["a"]["losses"]
        if la != lb or not all(np.isfinite(la)):
            raise AssertionError(f"[{tag}] (a) dp rank {d}: the mp ranks' "
                                 f"losses not finite and equal: {la} {lb}")
    glob = np.mean([by[(d, 0)]["a"]["losses"] for d in (0, 1)], axis=0)
    for o in outs:
        a = o["a"]
        per = {k: v / MOE_STEPS for k, v in a["launches"].items()}
        want = dict({k: 12 for k in FLASH}, adam=MOE_ADAM)
        bad = {k: (per.get(k, 0), n) for k, n in want.items()
               if per.get(k, 0) != n}
        if bad or a["scalar_adam"] or a["expert_shape"] != [2, 768, 3072]:
            raise AssertionError(
                f"[{tag}] (a) r{o['rank']}: launches a step (got, want) "
                f"{bad}, scalar-path Adam {a['scalar_adam']}, expert stack "
                f"{a['expert_shape']} (want [2, 768, 3072])")
        if a["dropped"] != outs[0]["a"]["dropped"]:
            raise AssertionError(f"[{tag}] (a) the ranks' routing differs: "
                                 f"{a['dropped']} {outs[0]['a']['dropped']}")
    steps = np.max([o["a"]["times"] for o in outs], axis=0)[1:]
    p50 = float(np.median(steps))
    b, s = MOE_BATCH
    a0 = outs[0]["a"]
    log(f"[{tag}] {card}; (a) benchmarks/run.py config 5: "
        f"ParallelGPTForCausalLM(gpt2-124m, max_seq_len 1024, moe_every=2, "
        f"num_experts=4) at full width (6 MoE layers, 2 experts a rank), dp 2"
        f" x mp 2 on four ranks sharing the card over NCCL's socket, bf16 "
        f"O2 (the recipe is fp32), AdamW(1e-4), [{b}, {s}] ([{b // 2}, {s}] "
        f"a rank): losses (mean of the dp ranks) "
        f"{[round(float(x), 4) for x in glob]}; step p50 {p50:.1f} ms (the slowest "
        f"rank's, {MOE_STEPS - 1} steps after the first; ranks "
        f"{[round(float(np.median(o['a']['times'][1:])), 1) for o in outs]}"
        f"), {b * s / p50 * 1e3:.0f} tokens/s; the last step's choices "
        f"dropped by each MoE layer's capacity ({a0['capacity']} places an "
        f"expert), by expert: {a0['dropped']}")
    for o in outs:
        a = o["a"]
        per = {k: v / MOE_STEPS for k, v in sorted(a["launches"].items())}
        log(f"[{tag}] (a) r{o['rank']} (dp {o['dp_rank']}, mp "
            f"{o['mp_rank']}): {a['n_tensors']} tensors; all-reduces a step "
            f"by group {fmt_by_group(a['groups'])}; collectives a step "
            f"{fmt_coll(a['coll'])}; launches a step {per}, scalar-path "
            f"Adam {a['scalar_adam']}; peak {a['peak_gb']:.2f} GB; step ms "
            f"{[round(t, 1) for t in a['times']]}")
    for o in outs:
        r = o["b"]
        rel = max(abs(g - w) / abs(w) for g, w in zip(r["losses"], r["ref"]))
        if rel > PARITY_LOSS_RTOL or r["worst"] > PARITY_BOUND or \
                not sum(r["dropped"]):
            raise AssertionError(
                f"[{tag}] (b) r{o['rank']}: losses {r['losses']} vs one rank"
                f" {r['ref']} (rel {rel:.2e} > {PARITY_LOSS_RTOL}), "
                f"{r['worst_name']} off by {r['worst']:.3e} (> "
                f"{PARITY_BOUND:.1e}?), dropped {r['dropped']} (want some)")
    r0 = outs[0]["b"]
    rels = [max(abs(g - w) / abs(w) for g, w in zip(o["b"]["losses"],
                                                     o["b"]["ref"]))
            for o in outs]
    log(f"[{tag}] (b) fp32 2 layers (one MoE) at GPT-2 width, dp 2 x mp 2, "
        f"moe_capacity (0.5, 1.0), [{MOE_ROWS}, {MOE_SEQ}], {PARITY_STEPS} "
        f"AdamW steps + clip 1.0 vs one rank's model at dp 1 x mp 1: losses "
        f"{[round(x, 6) for x in r0['losses']]} vs "
        f"{[round(x, 6) for x in r0['ref']]} (worst rel {max(rels):.2e} <= "
        f"{PARITY_LOSS_RTOL}), parameters within "
        f"{max(o['b']['worst'] for o in outs):.2e} (bound "
        f"{PARITY_BOUND:.1e}); the last step dropped {r0['dropped']} by "
        f"expert; seconds one rank / dp x mp {r0['seconds'][0]:.1f} / "
        f"{r0['seconds'][1]:.1f}")
    errs = outs[0]["kernels"]
    f = MOE_FLASH
    log(f"[{tag}] kernels at the path's shapes against their plain versions "
        f"(rank 0): flash B{f['b']} H{f['h']} S{f['s']} D{f['d']} causal "
        f"bf16: fwd {errs['flash_fwd']:.3e}, dK/dV {errs['flash_bwd_dkv']:.3e}"
        f", dQ {errs['flash_bwd_dq']:.3e} (max abs err, rows within "
        f"ROW_TOL); Adam on {25152 * 768} elements (bf16 + fp32 master) "
        f"{errs['adam']:.3e}")
    sec = outs[0]["seconds"]
    log(f"[{tag}] rank 0's seconds: (a) {sec[0]:.1f}, (b) {sec[1]:.1f}, "
        f"kernels {sec[2]:.1f}")


def phase_train_moe(dev, outs=None):
    """train-moe: the expert-parallel MoE recipe on four ranks that share
    the card (dp 2 x mp 2).  ``outs``: the results train-hybrid (c)'s
    ranks brought back (they run this lane after their checks); else this
    phase starts its own ranks (this script's ``--hybrid-child moe``)."""
    if outs is None:
        gc.collect()
        torch.cuda.empty_cache()
        root = tempfile.mkdtemp(prefix="train-moe-")
        procs = None
        try:
            procs = start_hybrid("moe", root)
            outs = wait_hybrid("moe", root, procs, tag="train-moe")
        finally:
            stop_ranks(procs or [])
            shutil.rmtree(root, ignore_errors=True)
    check_moe(outs)


# ----------------------------------------------------------- train-guard
#: train-guard's workload: GPT-2 124M at full width, depth cut from 12
#: to GUARD_LAYERS blocks (the card script's time), dp 2 (two ranks on
#: the card), the eager lane, 6 steps of GUARD_ROWS rows a rank (train-
#: gpt2's B 8 over the two ranks); (b) and (e) through fit, an epoch of
#: GUARD_SAVE_EVERY steps, a sharded checkpoint each epoch and a hot-spare
#: snapshot every GUARD_SPARE_EVERY updates
GUARD_LAYERS = 6
GUARD_STEPS = 6
GUARD_ROWS = 4
GUARD_SAVE_EVERY = 2
GUARD_SPARE_EVERY = 2
#: (a)'s lanes by turns after its first step (armed): the guardian off,
#: armed, armed with a hot-spare snapshot (a capture) after the step
GUARD_LANES = ("off", "armed", "spare")
GUARD_TURNS = 2
#: (c)'s collective timeout, seconds, and the controller's graces
GUARD_TIMEOUT_S = 3.0
GUARD_PEER_GRACE_S = 5.0
GUARD_TERM_GRACE_S = 5.0


def guard_batch(step, rank, dev):
    """The rows of ``rank`` at ``step``: a numpy seed keyed on both, so a
    resumed incarnation replays the same batch."""
    rows = np.random.default_rng(1000 * step + rank).integers(
        0, 50304, (GUARD_ROWS, 1025))
    return (torch.from_numpy(rows[:, :-1]).to(dev),
            torch.from_numpy(rows[:, 1:]).to(dev))


def guard_reseed(model, step, rank):
    """Seed every generator the forward draws from (the flash seeds', the
    dropout masks') from (step, rank): a step's randomness depends on no
    earlier step, so a resumed run draws what an uninterrupted one did."""
    from paddle_tpu_torch.hapi.model import _generators
    for i, g in enumerate(_generators(model.network)):
        g.manual_seed(1_000_003 * step + 1009 * rank + i)


def guard_steps(model, start, rank, dev, log_path, mgr=None,
                stop=GUARD_STEPS, before=None, after=None):
    """Steps ``start`` .. ``stop`` - 1 of the eager dp lane (``before(step)``
    first, when given, ``after(step)`` inside the step's timing once its
    loss is read): each step's loss (this rank's, read back), host ms
    to the read and wall time go to ``log_path`` (a JSON line a step);
    rank 0 saves every GUARD_SAVE_EVERY steps (not after the last); a
    barrier closes each step.  Returns (losses, ms, the watchdog's (seq
    at the step's start, seq at its end) of its dp all-reduces' group,
    which the fault points' at_seq counts)."""
    from paddle_tpu_torch.distributed import collective, watchdog

    def dp_seq():
        wd = watchdog._WATCHDOG
        return wd._seq.get(model._dp_group.id, 0) if wd else None

    losses, times, seqs = [], [], []
    opt = model._optimizer
    for step in range(start, stop):
        if before is not None:
            before(step)
        seq0 = dp_seq()
        guard_reseed(model, step, rank)
        x, y = guard_batch(step, rank, dev)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        loss = float(model._train_batch_device(x, y).detach())
        if after is not None:
            after(step)
        times.append((time.monotonic() - t0) * 1e3)
        losses.append(loss)
        seqs.append((seq0, dp_seq()))
        with open(log_path, "a") as f:
            f.write(json.dumps({"step": step, "loss": loss, "t": time.time(),
                                "start": start}) + "\n")
        if mgr is not None and rank == 0 and \
                (step + 1) % GUARD_SAVE_EVERY == 0 and step + 1 < stop:
            mgr.save({"model": model.network.state_dict(),
                      "optimizer": opt.state_dict(), "step": step},
                     step=step)
            mgr.wait()
        collective.barrier()
    return losses, times, seqs


def guard_switch(armed, timeout, writes):
    """Arm the guardian (the launcher's trap store, ``timeout``; its store
    writes counted into ``writes[0]``) or turn it off (no trap, no
    timeout: ``begin`` returns None)."""
    from paddle_tpu_torch.distributed import watchdog
    port_flags.set_flags({"FLAGS_collective_timeout_s":
                          timeout if armed else 0.0})
    if not armed:
        watchdog.configure(store=None)
        return
    watchdog.reset()
    store = watchdog.get_watchdog().trap.store    # the env's, anew
    store_set = store.set

    def counted(key, value):
        writes[0] += 1
        return store_set(key, value)

    store.set = counted


def guard_call_us(n=100):
    """Host microseconds of one guarded call's begin, preflight and end
    (its arrival record, the peer check; no collective) on a probe group
    (``tokens``: whether ``begin`` returned one)."""
    from paddle_tpu_torch.distributed import watchdog

    class Probe:
        id, ranks, nranks = "probe", [0, 1], 2

    t0 = time.perf_counter()
    for _ in range(n):
        tok = watchdog.begin("all_reduce", Probe)
        watchdog.preflight(tok)
        watchdog.end(tok)
    return (time.perf_counter() - t0) / n * 1e6, tok is not None


def guard_drain():
    """The armed watchdog's entries after a sync and its next poll (they
    stay in flight until the poll sees their events complete)."""
    from paddle_tpu_torch.distributed import watchdog
    wd = watchdog.get_watchdog()
    torch.cuda.synchronize()
    deadline = time.monotonic() + 3 * wd._interval()
    while wd.in_flight() and time.monotonic() < deadline:
        time.sleep(0.05)
    return wd.in_flight()


def guard_train(mode, outdir, rank, dev):
    """(a) ``clean``: GUARD_TURNS turns of GUARD_LANES after a first step
    with the guardian armed (the process's warm-up), the lanes sharing
    the process's drift; a ``spare`` step is an armed step followed, in
    its timing, by the hot-spare agent's snapshot (the capture at the
    step boundary; the stream to the buddy runs on its thread).  The
    pinned host buffers are filled once before the first turn, and the
    stream of the snapshot before is waited out ahead of each spare step
    (both outside the timing), so every spare step times a warm capture,
    never a skipped cadence; then a guarded call's host cost.  (c) ``drill``: the guardian armed
    throughout, rank 0 checkpointing, resumed from its newest
    checkpoint."""
    model = fit_gpt2_model(dev, dropout=0.1, layers=GUARD_LAYERS)
    timeout = port_flags.flag("FLAGS_collective_timeout_s")
    writes = [0]
    if mode == "clean":
        from paddle_tpu_torch.distributed import collective
        from paddle_tpu_torch.framework import hot_spare
        labels = ["armed"] + list(GUARD_LANES) * GUARD_TURNS
        agent = hot_spare.arm(rank=rank, world=2, every=1)

        def before(step):
            guard_switch(labels[step] != "off", timeout, writes)
            if step == 1:
                agent.capture(model._hot_spare_state())   # the buffers
            if labels[step] == "spare":
                agent.wait()

        def snapshot(step):
            if labels[step] == "spare":
                agent.maybe_snapshot(step + 1, model._hot_spare_state,
                                     {"it": step + 1, "epoch": 0,
                                      "next_step": step + 1})
        kernels.reset_launch_counts()
        losses, times, seqs = guard_steps(
            model, 0, rank, dev, os.path.join(outdir, f"steps.{rank}.jsonl"),
            stop=len(labels), before=before, after=snapshot)
        launches = {k: v for k, v in kernels.launch_counts().items() if v}
        in_flight = guard_drain()
        agent.wait(60)
        collective.barrier()        # the buddy's stream to this rank ended
        spare = dict(agent.stats)
        agent.close(park=False)
        call_us = {}
        for lane in ("off", "armed"):
            guard_switch(lane == "armed", timeout, [0])
            call_us[lane] = guard_call_us()
        return dict(losses=losses, times=times, labels=labels,
                    seqs=[b - a for (a, b), k in zip(seqs, labels)
                          if k == "armed"],
                    writes=writes[0] / (len(labels) - labels.count("off")),
                    in_flight=in_flight, launches=launches, call_us=call_us,
                    spare=spare)
    guard_switch(True, timeout, writes)
    mgr = CheckpointManager(os.path.join(outdir, "ckpt"), max_to_keep=2,
                            map_location=dev)
    start = 0
    restored = mgr.restore_latest()
    if restored is not None:
        state, _ = restored
        model.network.load_state_dict(state["model"])
        model._optimizer.set_state_dict(state["optimizer"])
        start = int(state["step"]) + 1
    with open(os.path.join(outdir, f"incarnations.{rank}.log"), "a") as f:
        f.write(f"{start}\n")
    losses, times, seqs = guard_steps(
        model, start, rank, dev, os.path.join(outdir, f"steps.{rank}.jsonl"),
        mgr)
    return dict(losses=losses, times=times, in_flight=guard_drain())


class GuardRows:
    """fit's dataset of ``rank``'s rows: item ``i`` is row ``i %
    GUARD_ROWS`` of step ``i // GUARD_ROWS`` (guard_batch's rows)."""

    def __init__(self, rank):
        self.rank = rank
        self._step = self._rows = None

    def __len__(self):
        return 4 * GUARD_STEPS * GUARD_ROWS

    def __getitem__(self, i):
        step, row = divmod(int(i), GUARD_ROWS)
        if step != self._step:
            self._step, self._rows = step, np.random.default_rng(
                1000 * step + self.rank).integers(0, 50304,
                                                  (GUARD_ROWS, 1025))
        return self._rows[row, :-1], self._rows[row, 1:]


class GuardEpochs:
    """fit's batch sampler: epoch ``e`` is steps ``(e + first) *
    GUARD_SAVE_EVERY`` .. + GUARD_SAVE_EVERY - 1 (fit sets the epoch)."""

    def __init__(self, first=0):
        self.first, self.epoch = first, 0

    def set_epoch(self, epoch):
        self.epoch = int(epoch)

    def __len__(self):
        return GUARD_SAVE_EVERY

    def __iter__(self):
        for k in range(GUARD_SAVE_EVERY):
            step = (self.epoch + self.first) * GUARD_SAVE_EVERY + k
            yield [step * GUARD_ROWS + j for j in range(GUARD_ROWS)]


def guard_loader(rank, first=0):
    return DataLoader(GuardRows(rank), batch_sampler=GuardEpochs(first))


class GuardFitLog(Callback):
    """A guard job's fit: every generator reseeded from (step,
    ``seed_rank``) before each step (guard_reseed), each step's loss and
    host ms to its read logged to ``steps.<rank>.jsonl`` (guard_steps'
    lines), the incarnation's first step and where it resumed from
    appended to ``incarnations.<rank>.log``; ``check(model)`` runs at the
    start of training (after the resume).  The armed hot-spare agent's
    stats go to ``spare.<rank>.json`` at the end of training and on the
    guardian's exits.  With ``GUARD_SETTLE_AT`` (the environment) the
    agent's transfer in flight is waited out before that step, and the
    stats dumped: a replica then stands at the buddy when the step
    starts."""

    def __init__(self, outdir, rank, seed_rank=None, first=0, check=None):
        super().__init__()
        self.outdir, self.rank, self.first = outdir, rank, first
        self.settle_at = int(os.environ.get("GUARD_SETTLE_AT", "-1"))
        self.seed_rank = rank if seed_rank is None else seed_rank
        self.check, self.checked = check, None
        self.losses, self.times = [], []
        self.epoch, self.start, self.agent = 0, None, None

    def on_train_begin(self, logs=None):
        from paddle_tpu_torch.distributed import watchdog
        from paddle_tpu_torch.framework import hot_spare
        self.agent = hot_spare.current_agent()
        if self.agent is not None:
            watchdog.add_exit_hook(self.dump_spare)
        if self.check is not None:
            self.checked = self.check(self.model)

    def dump_spare(self):
        if self.agent is not None:
            path = os.path.join(self.outdir,
                                f"spare.{self.rank}.{self.start}.json")
            with open(path + ".tmp", "w") as f:
                json.dump(self.agent.stats, f)
            os.replace(path + ".tmp", path)

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch

    def on_train_batch_begin(self, step, logs=None):
        g = (self.epoch + self.first) * GUARD_SAVE_EVERY + step
        if self.start is None:
            self.start = g
            src = (self.model.last_resume or {}).get("source") or "none"
            with open(os.path.join(self.outdir,
                                   f"incarnations.{self.rank}.log"),
                      "a") as f:
                f.write(f"{g} {src}\n")
        if g == self.settle_at and self.agent is not None:
            self.agent.wait()
            self.dump_spare()
        guard_reseed(self.model, g, self.seed_rank)
        self.g = g
        torch.cuda.synchronize()
        self.t0 = time.monotonic()

    def on_train_batch_end(self, step, logs=None):
        self.times.append((time.monotonic() - self.t0) * 1e3)
        self.losses.append(logs["loss"])
        with open(os.path.join(self.outdir, f"steps.{self.rank}.jsonl"),
                  "a") as f:
            f.write(json.dumps({"step": self.g, "loss": logs["loss"],
                                "t": time.time(), "start": self.start})
                    + "\n")
        self.dump_spare()          # a crash ends this rank without hooks

    def on_train_end(self, logs=None):
        self.dump_spare()

    def result(self):
        r = self.model.last_resume or {}
        return dict(losses=self.losses, times=self.times, start=self.start,
                    launches={k: v for k, v in
                              kernels.launch_counts().items() if v},
                    source=r.get("source"), it=r.get("it"),
                    restore_s=r.get("seconds"),
                    arrays_resharded=(r.get("report") or {}).get(
                        "arrays_resharded"),
                    checked=self.checked)


def guard_fit(outdir, rank, dev):
    """(b), (e): ``GUARD_EPOCHS`` (the environment) epochs of
    GUARD_SAVE_EVERY steps through fit under the guardian (armed
    throughout), with a sharded
    ModelCheckpoint (a shard file a rank) at each epoch's end, the
    hot-spare agent under the environment's FLAGS_hot_spare; a relaunch
    resumes through the ladder."""
    model = fit_gpt2_model(dev, dropout=0.1, layers=GUARD_LAYERS)
    guard_switch(True, port_flags.flag("FLAGS_collective_timeout_s"), [0])
    cb = GuardFitLog(outdir, rank)
    kernels.reset_launch_counts()
    model.fit(guard_loader(rank), epochs=int(os.environ["GUARD_EPOCHS"]),
              verbose=0, log_freq=1, save_dir=os.path.join(outdir, "ckpt"),
              max_to_keep=1, resume=True, callbacks=[cb])
    return dict(cb.result(), in_flight=guard_drain())


def restored_against_shard(path):
    """A check for GuardFitLog: the model's restored parameters and
    optimizer state equal rank 0's shard file of the checkpoint at
    ``path`` (read on its own), bit for bit; returns how many tensors."""
    from paddle_tpu_torch.distributed.reshard import (_host_tensor,
                                                      _load_shard,
                                                      read_layout)

    def check(model):
        layout = read_layout(path)
        shard = _load_shard(os.path.join(
            path, layout["rank_files"]["0"]))
        saved = {k: _host_tensor(v)
                 for k, v in shard["arrays"].items()}
        live = {f"model.{k}": v for k, v in
                model.network.state_dict().items()}
        live.update({f"optimizer.{k}": v for k, v in
                     model._optimizer.state_dict().items()
                     if torch.is_tensor(v)})
        bad = [k for k, v in live.items() if k not in saved or
               not torch.equal(v.detach().cpu(), saved[k])]
        if bad or len(live) != len(saved):
            raise AssertionError(f"restored state differs from {path}'s "
                                 f"shard file: {bad[:5]}, {len(live)} "
                                 f"tensors against {len(saved)}")
        return len(live)
    return check


def guard_resize(outdir, rank, dev):
    """(d)'s relaunch on one worker (PADDLE_ELASTIC_RESIZED): resumes (b)'s
    dp 2 sharded checkpoint (GUARD_RESUME_DIR) resharded onto a world of
    one, its restored state checked against the saved one bit for bit,
    and trains the next epoch to the end."""
    from paddle_tpu_torch.framework.checkpoint_manager import scan_steps
    root = os.environ["GUARD_RESUME_DIR"]
    model = fit_gpt2_model(dev, dropout=0.1, layers=GUARD_LAYERS)
    cb = GuardFitLog(outdir, rank, check=restored_against_shard(
        scan_steps(root)[0][1]))
    kernels.reset_launch_counts()
    model.fit(guard_loader(rank),
              epochs=GUARD_STEPS // GUARD_SAVE_EVERY + 1, verbose=0,
              log_freq=1, resume=root, callbacks=[cb])
    return dict(cb.result(), world=int(os.environ["PADDLE_TRAINERS_NUM"]),
                resized=os.environ["PADDLE_ELASTIC_RESIZED"])


def world1_gpt_model(dev):
    """hybrid_gpt_model's model in a world of one: the same parameters,
    names and loss, nothing split."""
    from paddle_tpu_torch.models import ParallelGPTForCausalLM
    cfg = gpt_config("gpt2-124m", max_seq_len=1024, attn_dropout=0.1,
                     dropout=0.1, num_layers=GUARD_LAYERS)
    lm = ParallelGPTForCausalLM(cfg, device=dev, dtype=torch.float32, seed=0)
    net = LocalLogits(lm)
    opt = AdamW(learning_rate=1e-4, parameters=net.parameters(),
                weight_decay=0.01)
    return Model(net).prepare(opt, LocalLMLoss(lm), amp_configs="O2")


def guard_mp2(outdir, rank, dev):
    """(f): GPT-2 124M at dp 1 x mp 2 (train-hybrid (c)'s model) through
    fit, one epoch of GUARD_SAVE_EVERY steps on dp rank 0's rows, a
    sharded ModelCheckpoint at its end (each rank its parts, "mp" their
    partition); rank 0 then writes the global state gathered over mp
    (`convert.gather_paddle_tpu_state` and its optimizer twin) for the
    world-one job."""
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.distributed import collective, fleet
    from paddle_tpu_torch.framework import io as fio
    fleet.init(is_collective=True, strategy=hybrid_strategy(1, 2),
               backend=HYBRID_BACKEND, device=dev)
    model = hybrid_gpt_model(dev, layers=GUARD_LAYERS)
    cb = GuardFitLog(outdir, rank, seed_rank=0)
    kernels.reset_launch_counts()
    model.fit(guard_loader(0), epochs=1, verbose=0, log_freq=1,
              save_dir=os.path.join(outdir, "ckpt"), callbacks=[cb])
    out = cb.result()
    params = convert.gather_paddle_tpu_state(model.network, dst=0)
    moments = convert.gather_paddle_tpu_optimizer_state(
        model.network, model._optimizer, dst=0)
    if rank == 0:
        fio.save({"model": params, "optimizer": moments},
                 os.path.join(outdir, "gathered.pkl"))
    collective.barrier()
    return out


def guard_mp2_resume(outdir, dev):
    """(f)'s world-one job: (A) resumes the mp 2 checkpoint (the restored
    parameters and moments checked against the gathered state bit for
    bit) and trains the next epoch; (B) a world-one model started from
    the gathered state trains the same epoch; their losses must be
    equal bit for bit."""
    from paddle_tpu_torch.framework import io as fio
    gathered = fio.load(os.path.join(outdir, "gathered.pkl"),
                        map_location="cpu")

    def against_gathered(model):
        bad, n = [], 0
        for k, v in model.network.state_dict().items():
            n += 1
            want = torch.as_tensor(np.asarray(gathered["model"][k]))
            if not torch.equal(v.detach().float().cpu(), want.float()):
                bad.append(k)
        for k, v in model._optimizer.state_dict().items():
            if torch.is_tensor(v):
                n += 1
                want = torch.as_tensor(np.asarray(gathered["optimizer"][k]))
                if not torch.equal(v.detach().cpu(), want.to(v.dtype)):
                    bad.append(k)
        if bad:
            raise AssertionError(f"(f) restored tensors differ from the "
                                 f"gathered state: {bad[:5]}")
        return n

    model = world1_gpt_model(dev)
    a = GuardFitLog(outdir, 0, seed_rank=0, check=against_gathered)
    kernels.reset_launch_counts()
    model.fit(guard_loader(0), epochs=2, verbose=0, log_freq=1,
              resume=os.path.join(outdir, "ckpt"), callbacks=[a])
    res_a = a.result()
    del model, a
    gc.collect()
    torch.cuda.empty_cache()
    model = world1_gpt_model(dev)
    with torch.no_grad():
        for k, v in model.network.state_dict().items():
            v.copy_(torch.as_tensor(np.asarray(gathered["model"][k])))
    model._optimizer.set_state_dict(gathered["optimizer"])
    b = GuardFitLog(os.path.join(outdir, "b"), 0, seed_rank=0, first=1)
    os.makedirs(b.outdir, exist_ok=True)
    kernels.reset_launch_counts()
    model.fit(guard_loader(0, first=1), epochs=1, verbose=0, log_freq=1,
              callbacks=[b])
    return dict(a=res_a, b=b.result())


def guard_flaky(outdir, rank, dev):
    """(d): fit under the sentinel (the environment's flags) while
    grad_bitflip corrupts rank 1's gradients; its escalation leaves the
    process (`SentinelError`)."""
    model = fit_gpt2_model(dev, dropout=0.1, layers=GUARD_LAYERS)
    rows = TokenRows(2 * GUARD_ROWS * GUARD_STEPS, 50304, 1024)
    model.fit(rows, batch_size=GUARD_ROWS, epochs=1, shuffle=False,
              verbose=0)
    return {"completed": True}


GUARD_MODES = {"flaky": guard_flaky, "fit": guard_fit, "mp2": guard_mp2,
               "resize": guard_resize}


def guard_child(mode, outdir):
    """A rank of train-guard, started by the port's launcher (its
    ``PADDLE_TRAINER_*`` contract, ``FLAGS_selected_gpus`` on this card):
    ``clean`` / ``drill`` (guard_train), ``fit``, ``flaky``, ``mp2``, and
    ``resize`` for a quarantine relaunch; ``mp2-resume`` runs alone (a
    world of one, no launcher).  Writes ``<mode>.<rank>.json``; an
    exception goes through ``sys.excepthook`` (the guardian's trap: the
    record for the peers, exit 101 for a peer's failure), and the rank
    exits without a process-group teardown (see HYBRID_BACKEND)."""
    rank = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
    if os.environ.get("PADDLE_ELASTIC_RESIZED"):
        mode = "resize"           # the quarantine relaunch: one worker
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from paddle_tpu_torch.distributed import env
    try:
        if mode == "mp2-resume":
            dev = torch.device("cuda", 0)
            res = guard_mp2_resume(outdir, dev)
        else:
            env.init_parallel_env()
            dev = env.current_device()
            fn = GUARD_MODES.get(mode)
            res = fn(outdir, rank, dev) if fn is not None else \
                guard_train(mode, outdir, rank, dev)
        with open(os.path.join(outdir, f"{mode}.{rank}.json"), "w") as f:
            json.dump(res, f)
    except BaseException as e:  # noqa: BLE001 — the guardian's hooks
        sys.stdout.flush()
        sys.excepthook(type(e), e, e.__traceback__)
        sys.stderr.flush()
        os._exit(1)
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


def guard_controller(tag, mode, outdir, max_restart, extra_env):
    """The port's CollectiveController over this script's ``--guard-child
    MODE DIR`` ranks (two on this card), keeping each incarnation's exit
    codes and trapped records (time stamps included: the controller
    clears them at a relaunch) and the blame it quarantined on; its
    graces are the environment's (``PADDLE_GUARDIAN_PEER_GRACE_S``, one
    value for the jobs that run at once)."""
    from paddle_tpu_torch.distributed.launch.context import (Context,
                                                             parse_args)
    from paddle_tpu_torch.distributed.launch.controller import \
        CollectiveController
    from paddle_tpu_torch.framework.sentinel import read_blame

    class GuardController(CollectiveController):
        def __init__(self, ctx):
            super().__init__(ctx)
            self._extra_env = dict(extra_env)
            self.codes, self.records, self.blames = [], [], []

        def _watch(self):
            codes = super()._watch()
            self.codes.append(list(codes))
            return codes

        def _guardian_blame(self):
            errs = super()._guardian_blame()
            self.records.append(errs)
            return errs

        def _apply_quarantine(self):
            self.blames.append(read_blame(self._trap.store, self._trap.job))
            super()._apply_quarantine()

    os.makedirs(outdir, exist_ok=True)
    args = parse_args(["--nproc_per_node", "2", "--max_restart",
                       str(max_restart), "--job_id", tag, "--log_dir",
                       os.path.join(outdir, "logs"), os.path.abspath(__file__),
                       "--guard-child", mode, outdir])
    ctl = GuardController(Context(args=args))
    t0 = time.time()
    code = ctl.run()
    return code, ctl, t0, time.time()


def guard_logs(outdir, rank):
    with open(os.path.join(outdir, "logs", f"worker.{rank}.log"),
              errors="replace") as f:
        return f.read()


def guard_results(outdir, mode):
    outs = []
    for r in range(2):
        path = os.path.join(outdir, f"{mode}.{r}.json")
        if not os.path.exists(path):
            raise AssertionError(f"[train-guard] {mode}: rank {r} wrote no "
                                 f"result; its log:\n"
                                 f"{guard_logs(outdir, r)[-3000:]}")
        outs.append(json.load(open(path)))
    return outs


def guard_step_losses(outdir, rank):
    """{step: [losses]} of ``rank`` over every incarnation, and the wall
    time of each incarnation's first step: {start: t}."""
    by, first = {}, {}
    with open(os.path.join(outdir, f"steps.{rank}.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            by.setdefault(rec["step"], []).append(rec["loss"])
            first.setdefault(rec["start"], rec["t"])
    return by, first


def guard_stall(root, base, at, tag="train-guard"):
    """(c): rank 1 stalls (collective_delay) in the all_reduce at seq
    ``at``; rank 0's stall dump, the job's end."""
    c_dir = os.path.join(root, "c")
    code, ctl, t0, t1 = guard_controller(
        "c", "drill", c_dir, 0, dict(
            base, FLAGS_collective_timeout_s=str(GUARD_TIMEOUT_S),
            FLAGS_stall_dump_path=os.path.join(c_dir, "stall.json"),
            FLAGS_fault_inject=f"collective_delay:op=all_reduce,"
            f"at_seq={at},delay_s=120,rank=1"))
    dump = os.path.join(c_dir, "stall.rank0.json")
    if code == 0 or not os.path.exists(dump):
        raise AssertionError(f"[{tag}] (c) exit {code} {ctl.codes}, "
                             f"dump {os.path.exists(dump)}; rank 0:\n"
                             f"{guard_logs(c_dir, 0)[-3000:]}")
    run_check_telemetry(f"{tag} (c)", "--stall-dump", dump)
    stall = json.load(open(dump))
    st = stall["stall"]
    began = stall["ts"] - st["waited_s"]
    limit = GUARD_TIMEOUT_S + GUARD_PEER_GRACE_S + GUARD_TERM_GRACE_S
    if (st["op"], st["seq"], st["missing_ranks"]) != \
            ("all_reduce", at, [1]) or \
            not st["waited_s"] < 2 * GUARD_TIMEOUT_S or \
            not t1 - began <= limit:
        raise AssertionError(f"[{tag}] (c) dump op {st['op']} seq "
                             f"{st['seq']} missing {st['missing_ranks']}"
                             f" waited {st['waited_s']} s; the job ended "
                             f"{t1 - began:.1f} s after the stall began "
                             f"(limit {limit:g})")
    log(f"[{tag}] (c) rank 1 stalled in all_reduce seq {at}: rank 0's "
        f"stall dump passes check_stall_dump (op {st['op']}, seq "
        f"{st['seq']}, missing_ranks {st['missing_ranks']}, waited_s "
        f"{st['waited_s']} < 2 x {GUARD_TIMEOUT_S:g}); codes {ctl.codes}"
        f", the job ended {t1 - began:.1f} s after the stall began "
        f"(timeout + both graces {limit:g} s)")


def guard_flaky_drill(root, base, resume_dir, tag="train-guard"):
    """(d): grad_bitflip on rank 1 twice under the sentinel; the blame,
    SentinelError and the quarantine relaunch on one worker, which resumes
    (b)'s dp 2 sharded checkpoint (``resume_dir``) resharded onto a world
    of one and trains the next epoch."""
    d_dir = os.path.join(root, "d")
    code, ctl, t0, t1 = guard_controller(
        "d", "flaky", d_dir, 1, dict(
            base, FLAGS_collective_timeout_s="60", FLAGS_sentinel="1",
            FLAGS_sentinel_check_every="1", FLAGS_sentinel_max_skips="2",
            FLAGS_sentinel_dump_path=os.path.join(d_dir, "sentinel.json"),
            FLAGS_fault_inject="grad_bitflip:rank=1,count=2",
            GUARD_RESUME_DIR=resume_dir))
    dumps = {}
    for r in range(2):
        p = os.path.join(d_dir, f"sentinel.rank{r}.json")
        if os.path.exists(p):
            run_check_telemetry(f"{tag} (d)", "--sentinel-dump", p)
            dumps[r] = json.load(open(p))["sentinel"]
    types = sorted({e.get("type") for e in ctl.records[0]}) \
        if ctl.records else []
    relaunch = os.path.join(d_dir, "resize.0.json")
    blamed = [b.get("rank") for b in ctl.blames if b]
    res = json.load(open(relaunch)) if os.path.exists(relaunch) else {}
    n = len(res.get("losses", []))
    if code != 0 or blamed != [1] or "SentinelError" not in types or \
            (res.get("world"), res.get("resized")) != (1, "2:1") \
            or os.path.exists(os.path.join(d_dir, "resize.1.json")) \
            or sorted(dumps) != [0, 1] or \
            any(d["quarantined"] != [0, 1] for d in dumps.values()) or \
            1 not in {d["blamed_rank"] for d in dumps.values()} or \
            res.get("source") != "disk" or not res.get("checked") or \
            not res.get("arrays_resharded") or \
            n != GUARD_SAVE_EVERY or not all(np.isfinite(res["losses"])):
        raise AssertionError(f"[{tag}] (d) exit {code}, codes "
                             f"{ctl.codes}, blame {ctl.blames}, records "
                             f"{types}, dumps {dumps}, relaunch {res}; "
                             f"rank 1:\n{guard_logs(d_dir, 1)[-3000:]}\n"
                             f"relaunch:\n{guard_logs(d_dir, 0)[-3000:]}")
    check_launches(dict.fromkeys(DROPOUT_KERNELS + ("adam",), 0) |
                   res["launches"],
                   gpt2_launches(GUARD_LAYERS, n))
    log(f"[{tag}] (d) grad_bitflip on rank 1 at iterations 0 and 1: both "
        f"ranks skipped them (quarantined {dumps[0]['quarantined']}); "
        f"blame on rank {blamed[0]} (the dumps' blamed_rank "
        f"{[dumps[r]['blamed_rank'] for r in (0, 1)]}), the trapped "
        f"errors {types}, codes {ctl.codes}; relaunched on one worker "
        f"with PADDLE_ELASTIC_RESIZED=2:1: it resumed (b)'s dp 2 sharded "
        f"checkpoint resharded onto a world of one "
        f"({res['arrays_resharded']} arrays resharded, restore "
        f"{res['restore_s']:.2f} s; its {res['checked']} parameter and "
        f"optimizer tensors equal rank 0's shard file bit for bit) and "
        f"trained steps {res['start']}-{res['start'] + n - 1}: losses "
        f"{res['losses']}; launches {res['launches']}; job "
        f"{t1 - t0:.1f} s")


def guard_incarnations(outdir, rank):
    """[(first step, restored from)] of ``rank``'s incarnations."""
    with open(os.path.join(outdir, f"incarnations.{rank}.log")) as f:
        return [(int(a), b) for a, b in (ln.split() for ln in f)]


def guard_spare_drill(root, base, at, want, sub, buddy_crash, steps,
                      settle_at=None, tag="train-guard"):
    """(b) / (e): fit under the guardian with a sharded ModelCheckpoint
    each epoch and FLAGS_hot_spare (a snapshot every GUARD_SPARE_EVERY
    updates); rank_crash on rank 1 at the all-reduce ``at`` -> rank 0
    exits 101 (PeerFailureError), parking its own snapshot and rank 1's
    replica -> the relaunch climbs the ladder: (b) rank 1 from its
    buddy's memory, rank 0 from its own parked copy; (e) ``buddy_crash``
    on rank 1: a PeerRestoreWarning and both ranks from the sharded
    checkpoint although the replica stood (``settle_at``: the step
    before which each rank waits out its transfer, so rank 1's is
    committed at the crash).  ``steps`` (a whole number of epochs) are
    trained; every step's losses must equal (a)'s.  Returns the drill's
    numbers and its timeline (the first step, the crash, the resumed
    first step, the last step and the job's end, seconds from the job's
    start)."""
    d = os.path.join(root, sub)
    fault = (f"rank_crash:op=all_reduce,at_seq={at},rank=1,"
             f"once_file={os.path.join(d, 'crashed')}")
    if buddy_crash:
        fault += ";buddy_crash:rank=1"
    env = dict(base, FLAGS_collective_timeout_s="60", FLAGS_hot_spare="1",
               FLAGS_hot_spare_every=str(GUARD_SPARE_EVERY),
               FLAGS_fault_inject=fault,
               GUARD_EPOCHS=str(steps // GUARD_SAVE_EVERY))
    if settle_at is not None:
        env["GUARD_SETTLE_AT"] = str(settle_at)
    code, ctl, t0, t1 = guard_controller(sub, "fit", d, 1, env)
    log0 = guard_logs(d, 0)
    if code != 0 or len(ctl.codes) != 2 or \
            ctl.codes[0][0] != ELASTIC_EXIT_CODE or \
            "PeerFailureError" not in log0 or "InjectedFault" not in log0:
        raise AssertionError(f"[{tag}] ({sub}) exit {code}, incarnations' "
                             f"codes {ctl.codes}; rank 0's log:\n"
                             f"{log0[-3000:]}\nrank 1's log:\n"
                             f"{guard_logs(d, 1)[-3000:]}")
    crash = [e for e in ctl.records[0] if e.get("type") == "InjectedFault"]
    if len(crash) != 1:
        raise AssertionError(f"[{tag}] ({sub}) trapped records "
                             f"{ctl.records}")
    incs, resumed_at, last = {}, {}, 0.0
    for r in range(2):
        incs[r] = guard_incarnations(d, r)
        by, first = guard_step_losses(d, r)
        with open(os.path.join(d, f"steps.{r}.jsonl")) as f:
            last = max([last] + [json.loads(ln)["t"] for ln in f])
        got = [by[s][-1] for s in range(steps)]
        twice = {s: v for s, v in by.items() if len(set(v)) > 1}
        if [a for a, _ in incs[r]][:1] != [0] or len(incs[r]) != 2 or \
                incs[r][1][0] < 1 or got != want[r][:steps] or twice:
            raise AssertionError(f"[{tag}] ({sub}) r{r}: incarnations "
                                 f"{incs[r]}, losses {got} vs (a) "
                                 f"{want[r]} (steps run twice and parted: "
                                 f"{twice})")
        resumed_at[r] = first[incs[r][1][0]]
    sources = {r: incs[r][1][1] for r in range(2)}
    want_src = {0: "disk", 1: "disk"} if buddy_crash else \
        {0: "self", 1: "peer"}
    warned = "PeerRestoreWarning" in guard_logs(d, 1)
    if sources != want_src or warned != buddy_crash or \
            incs[0][1][0] != incs[1][1][0]:
        raise AssertionError(f"[{tag}] ({sub}) restored from {sources} "
                             f"(want {want_src}) at steps "
                             f"{[incs[r][1][0] for r in range(2)]}; "
                             f"PeerRestoreWarning in rank 1's log: "
                             f"{warned}\n{guard_logs(d, 1)[-3000:]}")
    res = guard_results(d, "fit")          # the relaunch's
    start = incs[0][1][0]
    n = steps - start
    for o in res:
        check_launches(dict.fromkeys(DROPOUT_KERNELS + ("adam",), 0) |
                       o["launches"],
                       gpt2_launches(GUARD_LAYERS, n))
    spare = {}
    for r in range(2):
        path = os.path.join(d, f"spare.{r}.0.json")
        spare[r] = json.load(open(path)) if os.path.exists(path) else {}
    if settle_at is not None and not spare[1].get("transfer_ms"):
        raise AssertionError(f"[{tag}] ({sub}) rank 1 committed no "
                             f"transfer to its buddy before the crash: "
                             f"{spare[1]}")
    firsts = guard_step_losses(d, 0)[1]
    timeline = [round(x - t0, 1) for x in (
        firsts[0], crash[0]["ts"], min(resumed_at.values()), last, t1)]
    return dict(back_s=min(resumed_at.values()) - crash[0]["ts"],
                job_s=t1 - t0, codes=ctl.codes, start=start,
                sources=sources, spare=spare, relaunch=res,
                seq=crash[0].get("seq"), timeline=timeline)


def guard_mp2_drill(root, base, tag="train-guard"):
    """(f): GPT-2 124M at dp 1 x mp 2 through fit saves a sharded
    checkpoint (each rank its parts); a world-one job resumes it: the
    restored parameters and moments equal the gathered shards bit for
    bit, and its next epoch's losses equal a world-one run started from
    that gathered state bit for bit."""
    from paddle_tpu_torch.distributed.reshard import read_layout
    from paddle_tpu_torch.framework.checkpoint_manager import scan_steps
    f_dir = os.path.join(root, "f")
    code, ctl, t0, t1 = guard_controller(
        "f", "mp2", f_dir, 0, dict(base, FLAGS_collective_timeout_s="60"))
    if code != 0:
        raise AssertionError(f"[{tag}] (f) mp 2 job exit {code} {ctl.codes}"
                             f"; rank 0:\n{guard_logs(f_dir, 0)[-3000:]}")
    mp2 = guard_results(f_dir, "mp2")
    n = GUARD_SAVE_EVERY
    for o in mp2:
        check_launches(dict.fromkeys(DROPOUT_KERNELS + ("adam",), 0) |
                       o["launches"],
                       gpt2_launches(GUARD_LAYERS, n))
    layout = read_layout(scan_steps(os.path.join(f_dir, "ckpt"))[0][1])
    split = sorted(k for k, m in layout["arrays"].items()
                   if "mp" in m["partition"])
    t2 = time.time()
    p = subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--guard-child", "mp2-resume", f_dir],
                       env=dict(os.environ, **base), capture_output=True,
                       text=True, timeout=600)
    out = os.path.join(f_dir, "mp2-resume.0.json")
    if p.returncode != 0 or not os.path.exists(out):
        raise AssertionError(f"[{tag}] (f) world-one job exit "
                             f"{p.returncode}:\n{p.stdout[-3000:]}\n"
                             f"{p.stderr[-3000:]}")
    res = json.load(open(out))
    a, b = res["a"], res["b"]
    if not a["checked"] or not a["arrays_resharded"] or \
            a["losses"] != b["losses"] or len(a["losses"]) != n or \
            not all(np.isfinite(a["losses"])) or a["source"] != "disk":
        raise AssertionError(f"[{tag}] (f) world one: resumed {a}, from the "
                             f"gathered state {b}")
    for o in (a, b):
        check_launches(dict.fromkeys(DROPOUT_KERNELS + ("adam",), 0) |
                       o["launches"],
                       gpt2_launches(GUARD_LAYERS, n))
    log(f"[{tag}] (f) GPT-2 124M width ({GUARD_LAYERS} layers) dp 1 x mp 2 (train-hybrid (c)'s model), "
        f"bf16 O2, dropout 0.1: fit's {n} steps (losses "
        f"{[round(x, 4) for x in mp2[0]['losses']]}) saved a sharded "
        f"checkpoint over {layout['mesh']}: {len(split)} of "
        f"{len(layout['arrays'])} arrays split \"mp\" (each rank its part;"
        f" the fused q/k/v projections whole); job {t1 - t0:.1f} s.  A "
        f"world-one job resumed it ({a['arrays_resharded']} arrays "
        f"resharded, restore {a['restore_s']:.2f} s): its {a['checked']} "
        f"parameter and optimizer tensors equal the gathered shards bit for "
        f"bit, and its next {n} steps' losses {a['losses']} equal a "
        f"world-one run started from the gathered state bit for bit; "
        f"launches {a['launches']}; {time.time() - t2:.1f} s")


def side_by_side(*jobs):
    """Run each ``(key, fn)`` on a thread of its own (each a job of its
    own on the card) and wait for all; raises the first failure."""
    errors = {}

    def run(key, fn):
        try:
            fn()
        except BaseException as e:  # noqa: BLE001 — raised below
            errors[key] = e
    threads = [threading.Thread(target=run, args=job,
                                name=f"train-guard-{job[0]}")
               for job in jobs]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    for key, _ in jobs:
        if key in errors:
            raise errors[key]


def phase_train_guard(dev):
    """train-guard: GPT-2 124M dp 2 (two ranks on the card, NCCL) under the
    hang and failure guardian, launched by the port's launcher: (a) the
    guardian off, armed and armed with hot-spare snapshots by turns; (b)
    through fit with sharded checkpoints and the hot spare, rank 1
    crashes inside step 4 -> relaunch, rank 1 restored from its buddy's
    memory; (c) a stalled all_reduce -> stall dump, abort; (d) a flaky
    rank -> skip, blame, SentinelError, the quarantine relaunch on one
    worker resuming (b)'s checkpoint resharded; (e) (b) with buddy_crash
    -> the disk; (f) an mp 2 checkpoint restored at world one."""
    tag = "train-guard"
    gc.collect()
    torch.cuda.empty_cache()
    # the jobs' checkpoints, parked snapshots and logs
    root = tempfile.mkdtemp(prefix="train-guard-")
    saved = {k: os.environ.get(k) for k in (
        "PADDLE_GUARDIAN_PEER_GRACE_S", "PADDLE_GUARDIAN_TERM_GRACE_S",
        "PADDLE_ELASTIC_FAULT_TOLERANC_LEVEL")}
    base = {"FLAGS_compiled_train_step": "0", "PYTHONUNBUFFERED": "1",
            "FLAGS_flight_recorder_path": os.path.join(root, "fr.json")}
    try:
        log(f"[{tag}] the jobs' files under {os.path.dirname(root)} "
            f"({shutil.disk_usage(root).free / 1e9:.1f} GB free)")
        os.environ["PADDLE_GUARDIAN_TERM_GRACE_S"] = str(GUARD_TERM_GRACE_S)
        # any failure relaunches (up to each job's max_restart)
        os.environ["PADDLE_ELASTIC_FAULT_TOLERANC_LEVEL"] = "1"
        # (a) clean: the guardian (a timeout set, the trap store on) off,
        # armed, and armed with a hot-spare snapshot by turns, in each rank
        a_dir = os.path.join(root, "a")
        code, ctl, t0, t1 = guard_controller(
            "a", "clean", a_dir, 0,
            dict(base, FLAGS_collective_timeout_s="60"))
        if code != 0:
            raise AssertionError(f"[{tag}] (a) exit {code} {ctl.codes}; "
                                 f"{guard_logs(a_dir, 0)[-3000:]}")
        clean = guard_results(a_dir, "clean")
        n = len(clean[0]["losses"])
        per_step = clean[0]["seqs"]
        for r, o in enumerate(clean):
            sp = o["spare"]
            if [o["call_us"][k][1] for k in ("armed", "off")] != \
                    [True, False] or not all(np.isfinite(o["losses"])) or \
                    o["in_flight"] or len(set(o["seqs"])) != 1 or \
                    sp["skipped"] or sp["failures"] or \
                    len(sp["capture_ms"]) != GUARD_TURNS:
                raise AssertionError(
                    f"[{tag}] (a) r{r}: losses {o['losses']}, tokens "
                    f"{o['call_us']}, in flight after a sync and a poll "
                    f"{o['in_flight']}, dp collectives a step {o['seqs']}, "
                    f"hot spare {sp}")
        if clean[0]["losses"] == clean[1]["losses"]:
            raise AssertionError(f"[{tag}] (a) the ranks' losses are equal: "
                                 "their rows are not their own")
        need = gpt2_launches(GUARD_LAYERS, n)
        for o in clean:
            check_launches(dict.fromkeys(need, 0) | o["launches"], need)
        labels = clean[0]["labels"]
        p50 = {lane: [float(np.median([t for t, k in zip(
            o["times"][1:], labels[1:]) if k == lane])) for o in clean]
            for lane in GUARD_LANES}
        call_us = [{k: v[0] for k, v in o["call_us"].items()} for o in clean]
        log(f"[{tag}] (a) GPT-2 124M width ({GUARD_LAYERS} of 12 layers) "
            f"dp 2 (two ranks on one card, NCCL "
            f"socket), dropout 0.1, bf16 O2, AdamW, B{GUARD_ROWS} x S1024 a "
            f"rank, the eager lane: {n} steps, the guardian armed at step "
            f"0, then {GUARD_TURNS} turns of {'/'.join(GUARD_LANES)}; job "
            f"{t1 - t0:.1f} s")
        for r, o in enumerate(clean):
            log(f"[{tag}] (a) r{r} losses {o['losses']}; launches "
                f"{o['launches']}")
        fmt_ms = {k: [round(m, 2) for m in v] for k, v in p50.items()}
        calls = per_step[0] + 1               # and the step's barrier
        cap = [float(np.median(o["spare"]["capture_ms"])) for o in clean]
        log(f"[{tag}] (a) step p50 (steps 2-{n}, host ms to the loss read; "
            f"a spare step's includes its snapshot's warm capture) by rank: "
            f"off {fmt_ms['off']}, armed {fmt_ms['armed']}, spare "
            f"{fmt_ms['spare']}: the guardian's cost "
            f"{max(p50['armed']) - max(p50['off']):+.2f} ms a step, a "
            f"snapshot step's over an armed one "
            f"{max(p50['spare']) - max(p50['armed']):+.2f} ms (slowest "
            f"rank; the capture alone p50 {[round(c, 1) for c in cap]} ms "
            f"by rank; the stream ran under the off and armed steps after "
            f"it and was waited out before the next spare step, outside "
            f"the timing); a guarded call's host time "
            f"(begin, preflight, end; no collective) "
            f"{[round(c['armed'], 1) for c in call_us]} us armed, "
            f"{[round(c['off'], 2) for c in call_us]} us off, x {calls} "
            f"calls a step = "
            f"{max(c['armed'] for c in call_us) * calls / 1e3:.2f} ms; dp "
            f"collectives a step {per_step[0]} and a barrier; store writes "
            f"{[round(o['writes'], 2) for o in clean]} an armed step by "
            f"rank; every entry retired after a sync and one poll")
        for r, o in enumerate(clean):
            sp = o["spare"]
            log(f"[{tag}] (a) r{r} hot spare: {sp['snapshots']} snapshots "
                f"of {sp['bytes'] / 1e9:.3f} GB over {GUARD_TURNS} spare "
                f"steps (the pinned buffers filled before the first), "
                f"capture {[round(x, 1) for x in sp['capture_ms']]} ms, "
                f"transfer to the buddy "
                f"{[round(x, 1) for x in sp['transfer_ms']]} ms, "
                f"{sp['failures']} failed")
        want = {r: clean[r]["losses"][:GUARD_STEPS] for r in range(2)}
        seqs = [k * per_step[0] for k in range(GUARD_STEPS)]
        at = seqs[4] + (seqs[5] - seqs[4]) // 2   # step 4's middle one

        # (b) through fit: sharded checkpoints, the hot spare; rank 1
        # crashes at a collective inside step 4 (once); beside it (e), the
        # same with buddy_crash over 4 steps, rank 1 crashing inside step 2
        # (the disk rung against the peer's, under the same load), and (f)
        # mp 2 -> world one
        def drill_b():
            b = guard_spare_drill(root, base, at, want, "b", False,
                                  GUARD_STEPS)
            sp = b["spare"]
            tms = [t for r in sp for t in sp[r].get("transfer_ms", [])]
            rel = {r: o for r, o in enumerate(b["relaunch"])}
            log(f"[{tag}] (b) fit, a sharded ModelCheckpoint every "
                f"{GUARD_SAVE_EVERY} steps, FLAGS_hot_spare_every "
                f"{GUARD_SPARE_EVERY}: rank 1 crashed at collective seq "
                f"{b['seq']} (inside step 4): rank 0 exit "
                f"{b['codes'][0][0]} with PeerFailureError carrying the "
                f"InjectedFault, codes {b['codes']}; the relaunch restored "
                f"rank 1 from its buddy's memory (restored_from="
                f"{b['sources'][1]}) and rank 0 from its own parked copy "
                f"({b['sources'][0]}) at iteration {rel[1]['it']}, resuming "
                f"at step {b['start']}; both ranks' losses equal (a)'s bit "
                f"for bit; crash -> the resumed first step "
                f"{b['back_s']:.1f} s (from disk before the hot spare: "
                f"13.9-22.1 s, PERF.md); job "
                f"{b['job_s']:.1f} s (the first step ended, the crash, the "
                f"resumed first step ended, the last step ended, the job "
                f"ended at {b['timeline']} s)")
            log(f"[{tag}] (b) hot spare before the crash: snapshots "
                f"{[sp[r].get('snapshots') for r in (0, 1)]} of "
                f"{[round(sp[r].get('bytes', 0) / 1e9, 3) for r in (0, 1)]}"
                f" GB, cadences skipped "
                f"{[sp[r].get('skipped') for r in (0, 1)]}, capture ms "
                f"{[[round(x, 1) for x in sp[r].get('capture_ms', [])] for r in (0, 1)]}"
                f", ckpt.peer.transfer_ms p50 "
                f"{float(np.median(tms)) if tms else float('nan'):.1f} (all "
                f"{[round(x, 1) for x in tms]}); rank 0's park "
                f"{sp[0].get('park_ms') or float('nan'):.1f} ms, "
                f"{sp[0].get('park_bytes', 0) / 1e9:.3f} GB; the peer "
                f"restore {[round(rel[r]['restore_s'], 2) for r in (0, 1)]}"
                f" s by rank; step p50 with the agent on (the relaunch, "
                f"fit) "
                f"{[round(float(np.median(rel[r]['times'])), 1) for r in (0, 1)]}"
                f" ms")
            shutil.rmtree(os.path.join(root, "b", "logs", "guardian"),
                          ignore_errors=True)

        def drill_e():
            # rank 1's snapshot of iteration 2 committed at its buddy
            # before step 2, which it crashes inside: the fall-through is
            # buddy_crash's, not a missing replica's
            at_e = seqs[2] + (seqs[3] - seqs[2]) // 2
            e = guard_spare_drill(root, base, at_e, want, "e", True, 4,
                                  settle_at=2)
            sp1 = e["spare"][1]
            log(f"[{tag}] (e) buddy_crash on rank 1's relaunch: its "
                f"replica stood at the buddy ({len(sp1['transfer_ms'])} "
                f"committed transfer(s) before the crash, "
                f"{[round(x, 1) for x in sp1['transfer_ms']]} ms), yet a "
                f"PeerRestoreWarning in its log, every rank fell back to the "
                f"sharded checkpoint (restored_from {e['sources']}, "
                f"{[o['arrays_resharded'] for o in e['relaunch']]} arrays "
                f"resharded: the same dp 2 layout, the fast path; restore "
                f"{[round(o['restore_s'], 2) for o in e['relaunch']]} s by "
                f"rank), rank 1 crashed at seq {e['seq']} (inside step 2), "
                f"resuming at step {e['start']}; both ranks' losses equal "
                f"(a)'s bit for bit; crash -> the resumed first step "
                f"{e['back_s']:.1f} s; job {e['job_s']:.1f} s (timeline "
                f"{e['timeline']} s)")
            shutil.rmtree(os.path.join(root, "e"), ignore_errors=True)
        # (f) never fails: the grace is (b)'s and (e)'s
        os.environ["PADDLE_GUARDIAN_PEER_GRACE_S"] = "20"
        side_by_side(("b", drill_b), ("e", drill_e),
                     ("f", lambda: guard_mp2_drill(root, base)))
        shutil.rmtree(os.path.join(root, "f"), ignore_errors=True)

        # (c) rank 1 stalls at step 1's first all_reduce, beside (d)
        # grad_bitflip on rank 1 twice under the sentinel and its
        # quarantine relaunch on (b)'s last checkpoint (three jobs at once
        # is what the card's memory holds)
        os.environ["PADDLE_GUARDIAN_PEER_GRACE_S"] = str(GUARD_PEER_GRACE_S)
        side_by_side(
            ("c", lambda: guard_stall(root, base, seqs[1])),
            ("d", lambda: guard_flaky_drill(
                root, base, os.path.join(root, "b", "ckpt"))))
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(root, ignore_errors=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    ap.add_argument("--fit-child", nargs=2, metavar=("MODE", "DIR"),
                    help=argparse.SUPPRESS)   # fit-gpt2 (b)'s children
    ap.add_argument("--serve-child", metavar="DIR",
                    help=argparse.SUPPRESS)   # serve-resilience (2)'s child
    ap.add_argument("--hybrid-child", nargs=2, metavar=("LANE", "DIR"),
                    help=argparse.SUPPRESS)   # train-hybrid's ranks
    ap.add_argument("--guard-child", nargs=2, metavar=("MODE", "DIR"),
                    help=argparse.SUPPRESS)   # train-guard's ranks
    args = ap.parse_args(argv)
    if args.hybrid_child:
        hybrid_child(*args.hybrid_child)
        return
    if args.guard_child:
        guard_child(*args.guard_child)
        return
    SERVE_RECORD.install()
    if args.fit_child:
        fit_child(*args.fit_child)
        return
    if args.serve_child:
        serve_child(args.serve_child)
        return
    phases = args.phases.split(",")
    start = time.monotonic()
    name, card = phase_device()
    dev = torch.device("cuda", 0)

    def run(label, fn, *a):
        t0 = time.monotonic()
        out = fn(*a)
        log(f"[time] {label}: {time.monotonic() - t0:.1f} s (ends "
            f"{time.monotonic() - start:.1f} s into the run)")
        return out
    if "build" in phases:
        run("build", phase_build)
    errs, timed = {}, {}
    if "kernels" in phases:
        errs, timed = run("kernels", phase_kernels, dev)
    counts = lora_counts = fp8_counts = None
    fleet_ref = None
    if {"serve", "serve-lora-int8", "serve-tick", "serve-spec",
            "serve-resilience", "serve-telemetry", "serve-fleet"} & set(phases):
        model = build_7b(dev)
        float_st = serve_outs = None
        if "serve" in phases:
            counts, float_st, serve_outs = run("serve", phase_serve, dev,
                                               model)
        if "serve-lora-int8" in phases:
            lora_counts, fp8_counts = run("serve-lora-int8", phase_serve_lora,
                                          dev, model, float_st)
        if "serve-tick" in phases:
            run("serve-tick", phase_serve_tick, dev, model)
        spec_plain = spec_margins = None
        if "serve-spec" in phases:
            spec_plain, spec_margins = run("serve-spec", phase_serve_spec,
                                           dev, model)
        if "serve-resilience" in phases:
            run("serve-resilience", phase_serve_resilience, dev, model,
                spec_plain, spec_margins)
        if "serve-telemetry" in phases:
            run("serve-telemetry", phase_serve_telemetry, dev, model,
                serve_outs, float_st, spec_margins)
        if "serve-fleet" in phases:
            fleet_ref = run("serve-fleet reference", fleet_reference, dev,
                            model, serve_outs)
        del model
        torch.cuda.empty_cache()
    if "serve-fleet" in phases:
        run("serve-fleet", phase_serve_fleet, dev, fleet_ref)
    if {"serve-gpt", "generate-gpt"} & set(phases):
        model = build_gpt_6_7b(dev)
        if "serve-gpt" in phases:
            run("serve-gpt", phase_serve_gpt, dev, model)
        if "generate-gpt" in phases:
            run("generate-gpt", phase_generate_gpt, dev, model)
        del model
        torch.cuda.empty_cache()
    if "parity" in phases:
        run("parity", phase_parity, dev)
    if "gpt-parity" in phases:
        run("gpt-parity", phase_gpt_parity, dev)
    train_counts = None
    if "train" in phases:
        train_counts = run("train", phase_train, dev)
    cpu_losses = None
    if "train-parity" in phases:
        cpu_losses = run("train-parity", phase_train_parity, dev)
    if "train-compiled-parity" in phases:
        run("train-compiled-parity", phase_train_compiled_parity, dev,
            cpu_losses)
    gpt2_counts = gpt2_lanes = ops_counts = None
    if "train-gpt2" in phases:
        gpt2_counts, gpt2_lanes = run("train-gpt2", phase_train_gpt2, dev)
    if "train-gpt2-recompute" in phases:
        run("train-gpt2-recompute", phase_train_gpt2_recompute, dev,
            gpt2_lanes)
    if "gpt2-parity" in phases:
        run("gpt2-parity", phase_gpt2_parity, dev)
    if "attn-ops" in phases:
        ops_counts = run("attn-ops", phase_attn_ops, dev)
    if "train-optimizers" in phases:
        run("train-optimizers", phase_train_optimizers, dev)
    if "fit-gpt2" in phases:
        run("fit-gpt2", phase_fit_gpt2, dev)
    if "fit-llama" in phases:
        run("fit-llama", phase_fit_llama, dev)
    if "sentinel-gpt2" in phases:
        run("sentinel-gpt2", phase_sentinel_gpt2, dev)
    if "lora-llama" in phases:
        run("lora-llama", phase_lora_llama, dev)
    early = moe_outs = None
    lanes = {}
    if "train-zero" in phases:
        # train-zero's ranks start beside train-hybrid's gpt lane and wait
        # for their phase; with train-pipe and train-sep they run those
        # lanes after theirs
        early = {"root": tempfile.mkdtemp(prefix="train-zero-"), "procs": [],
                 "pipe": "train-pipe" in phases,
                 "sep": "train-sep" in phases}
    try:
        if "train-hybrid" in phases:
            # with train-moe its gpt lane's ranks run that lane after theirs
            moe_outs = run("train-hybrid", phase_train_hybrid, dev, early,
                           "train-moe" in phases)
        if "train-zero" in phases:
            lanes = run("train-zero", phase_train_zero, dev, early)
        if "train-pipe" in phases:
            run("train-pipe", phase_train_pipe, dev, lanes.get("pipe"))
        if "train-sep" in phases:
            run("train-sep", phase_train_sep, dev, lanes.get("sep"))
        if "train-moe" in phases:
            run("train-moe", phase_train_moe, dev, moe_outs)
    finally:
        if early is not None:
            stop_ranks(early["procs"])
            shutil.rmtree(early["root"], ignore_errors=True)
    if "train-guard" in phases:
        run("train-guard", phase_train_guard, dev)
    if timed and None not in (counts, lora_counts, train_counts, gpt2_counts,
                              ops_counts):
        # launches: the serving run's for its two kernels, the training
        # run's for the six of the training path (its compiled lane, the
        # default: call 1 eager, then replays), the int8 + LoRA run's
        # and the fp8 run's for the quantized decode and the delta
        launches = dict(counts)
        launches.update({k: train_counts[k] for k in TRAIN_KERNELS
                         if k != "rms_norm"})
        launches.update(paged_decode_int8=lora_counts["paged_decode_int8"],
                        lora_delta=lora_counts["lora_delta"],
                        paged_decode_fp8=fp8_counts["paged_decode_fp8"])
        # the dropout variants: GPT-2's training run; the masked ones: the
        # public attention entry points
        launches.update({k: gpt2_counts[k] for k in DROPOUT_KERNELS})
        launches.update({k: ops_counts[k] for k in MASKED_KERNELS})
        summary = [dict(name=k, route="cuda",
                        source="paddle_tpu_torch/" + KERNEL_META[k][0],
                        replaces=KERNEL_META[k][1], launches=launches[k],
                        max_abs_err=errs[k], **timed[k])
                   for k in KERNEL_META]
        log(json.dumps({"kernels": summary}))
    log(f"[time] the run: {time.monotonic() - start:.1f} s")
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
