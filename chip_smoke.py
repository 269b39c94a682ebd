#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. the card: ``nvidia-smi`` name and power limit, ``torch.cuda`` name;
2. build: ``nvcc`` compiles the kernels in ``src/repro_torch/kernels/csrc``
   (``conv2d.cu``, ``gemm.cu``, ``skinny_gemm.cu``, ``wino_gemm.cu``; one
   ``nvcc`` each, all started together) for ``sm_90a`` (into the git-ignored
   ``kernels/build``);
3. kernel vs plain: each hand-written kernel against its plain PyTorch
   version on the card at every shape the CNN's forward and train step
   give it (the direct conv at the forward, dIn and dKer shapes, the
   tiled GEMM at the head's three products, Winograd's batched tile GEMM
   at the forward, dIn and dv/du shapes), with its time, the plain
   version's time, one PyTorch library call's time (TF32 off), the
   least time the card could take (f32 operations over the H100's
   67 TFLOP/s non-tensor peak -- for Winograd's tile GEMM, which runs f32
   as 3xTF32, three TF32 products per f32 product over 495 TFLOP/s, the
   FFMA bound beside it -- or bytes over 3.35 TB/s, whichever is larger)
   and the share of that bound the kernel reaches; the kernel
   and the library call are also timed queued behind a spin of the card
   (device only) and on the host alone (the launch path); the conv's
   sums are also given per direction (fwd, dIn, dKer); then, the same
   way, each kernel at the shapes ResNet-50's layer table
   (``core.problem.resnet50_layers(batch=64)``, forward, SAME) gives it:
   the direct conv at the 1x1 and 3x3 layers, Winograd's tile GEMM at
   the 3x3 layers, the tiled GEMM at ``conv1``'s im2col product
   ``[802816,147]@[147,64]``; and one bfloat16 row each for the conv and
   Winograd's tile GEMM at the 64 -> 64 layer (the conv's wrapper widens
   bf16 operands to f32 and narrows the result once, the widening's own
   time printed as ``widen_ms``; the tile GEMM loads bf16 natively),
   held to ``BF16_KERNEL_RTOL``.  Every row (and every row of phase 8)
   prints the paper's Eq. 4 block plan at the card's budget
   (``kernels.tiling.plan_blocks``, ``SMEM_PER_BLOCK`` of f32, 64-wide
   tiles) beside the launch the kernel took (``kernels._plan``'s tile
   and splits): printed, not used;
4. inference at full width: the repro CNN at ResNet-50's 3x3 stage
   widths (channels 64..512, 3 input channels, 1000 classes, batch 64,
   56x56) answers batches of images through ``forward_cnn(dist_mesh=...)``
   on a one-rank (1,1,1,1,1) grid, and one through the dense path, with
   the static plan (tuner off); the kernels' launch counts show the path
   went through them, and the logits agree with the same forward on the
   CPU (plain versions);
5. training at full width: the same CNN trains through
   ``make_grid_train_step`` (AdamW, lr 1e-3) on the one-rank grid for 3
   steps in three dispatch modes -- ``static`` (tuner off: the direct
   conv and the tiled GEMM, forward and backward), ``winograd`` (a plan
   table seeded with ``winograd`` for every 3x3 conv and the kernel for
   every tile GEMM the step reaches, the static choice elsewhere) and
   ``tuned`` (the tuner free, each key's winner printed with its times).
   Launch counts are read after a warm-up step.  The modes must agree
   with each other at batch 64 and with the same step on the CPU (plain
   versions, full widths, batch 4) in the step-1 loss and the step-1
   gradients, taken on the static mode's ReLU / max-pool branch
   (``_pinned_branch``).  Each of the 3 timed steps of every mode is
   held against a plain float64 AdamW on the CPU
   (``_update_errs``): its loss against a separate pass at the same
   parameters, and its new parameters and moments against that AdamW
   applied to the card's state before the step and that pass's
   gradients.  Then the static mode once more with ``save_gathered=True``
   (``static_sg``: native differentiation on the saved gathers), held
   to the same gates against the static mode, with the same launches
   but the dKer of the C = 3 layer (cuDNN's backward of its library
   forward).  Every mode prints its peak of
   ``torch.cuda.max_memory_allocated`` over the timed steps beside
   ``cnn_train_mem_elems(...)["peak"] * 4``;
5b. resilient training at full width, the same CNN and batch, static
   plan, on the grid ``grid="auto"`` picks for one card: run C,
   ``dist.train.make_resilient_train_loop`` in process for 8 steps
   without a fault, its launches equal to phase 5's static count per
   step; the train state's checkpoint (bytes, a synchronous save, an
   async save's time in the caller and to its commit, a restore onto the
   card, bit-equal); run A, ``python -m repro_torch.launch.train --mesh
   dist-grid`` as a subprocess for the same 8 steps, ``--ckpt-every 2``,
   a ``wedge`` at step 3 (the watchdog fires and saves) and a ``sigterm``
   at step 5 (it must print ``preempted at step 5``); then
   ``fault.inject.corrupt_chunk`` on the newest checkpoint; run B, the
   CLI again: it logs ``corrupt_ckpt``, restores an earlier step and
   prints ``done at step 8``; the losses of A and B, stitched, within
   ``RESILIENT_RTOL`` of run C's at every step.  Then, on a one-rank
   nccl mesh: ``compressed_psum_tree`` (``wire="s8"``, a real int8
   all-gather) of the card CNN's gradients, equal to the same call on
   the CPU, and a one-stage ``pipelined_apply``, forward and gradients,
   equal to the stage run plainly.  Run C's step p50 is printed beside
   phase 5's static p50;
6. warm: ``kernels.autotune.warm(batch=64, refresh=True)`` against a
   plan table in a temporary directory; each layer's winner and every
   candidate's ms, every hand-written candidate timed, the winners
   persisted, and all three kernels launched;
7. synthesis, on the host, printed only: the grid, model cost and wire
   ``core.sharding_synthesis.synthesize_cnn_grid`` picks for the smoke
   CNN over 1, 2, 4 and 8 devices (``allgather``, ``ring2``; without and
   with a memory cap that excludes the uncapped winner), and the grid
   ``synthesize_dist_grid`` picks for each ResNet-50 layer at 4 devices;
8. serving, with the tuner off (the static plan: every product whose
   extents are multiples of 8 takes the GEMM, on the route
   ``_plan.skinny_route`` gives it: the skinny GEMM for every bf16
   product and the f32 ones of at most ``SKINNY_M`` rows, the tile core
   for the rest): the GEMM against its plain version at every distinct
   shape that tiles of one decode step (8 slots) and one prefill (bucket
   64) of llama3.2-1b and of granite-moe-1b-a400m
   (``dist.lm.lm_step_products``: the projections, the 128256-wide head,
   the expert products), in f32 and in bf16, each against
   ``torch.matmul`` at the same dtype, with kernel, device-only, bound
   and library ms, the device-only ms again with the weight cold (taken
   in turn from copies that exceed the 50 MB L2, as in a decode step:
   ``cold_device_ms``), and the sums over one decode step per dtype
   against the weights' byte bound (and the tile core at llama's f32 decode shapes,
   their route before the skinny GEMM); then llama3.2-1b at its
   published widths, random weights from a seed, served through
   ``launch.serve.run`` on a one-rank (1,1,1) grid (8 slots, 16 requests
   of 48-64 prompt tokens, bucket 64, 32 new tokens each) twice: in its
   own dtype, bf16 (this slice's main path), and in f32.  Each run
   prints served tokens/s (every token over the serve window) and the
   rate over decode time alone, p50/p99 decode ms, the decode step's
   bound (its weights' bytes over 3.35 TB/s) and the share reached,
   device-busy ms and the top kernels of one profiled decode step, and
   peak allocated bytes; it gates the GEMM's launches, and the skinny
   GEMM's among them, against the counts the static plan gives the
   steps' shapes, and serves the same weights and prompts dense
   (``torch.matmul``) with both runs teacher-forced on the dense run's
   tokens, logits within ``TF_BF16_RTOL`` (bf16) or ``TF_RTOL`` (f32)
   of max|logit| at the prefill and every decode step (free-running
   token agreement printed, not gated); the smoke config's tokens on the
   card equal to the CPU's, in both dtypes; granite-moe-1b-a400m at full
   width in f32 on the same grid (4 requests, 8 new tokens), its
   launches gated and its logits teacher-forced against its dense path
   (the experts as einsums) the same way, and the host's share of a
   decode step printed;
9. perf, the calibrated cost model on the card's own measurements: the
   bench records of ``perf/bench.py`` -- ``kernel/<layer>`` for the
   reference's ``FULL_LAYERS`` at batch 64 through
   ``kernels.ops.local_conv2d`` (the static dispatch, then the tuner in
   a temporary plan table), ``train/cnn/2D-DP`` from phase 5's static
   steps (the whole CNN step on the one-rank grid) and ``serve/`` from
   phase 8's llama3.2-1b decode steps in bf16 and f32 -- fitted by
   ``perf.fit_collectives`` into a table written to
   the git-ignored ``perf_out/`` (with the records and the error
   report), gated: every constant finite and >= 0, the provenance naming
   the card, the compute rate other than the checked-in CPU table's.
   Granite-moe's decode step (f32) is held out of the fit: its
   projection count differs from llama's, so it tests the split of
   ``dispatch/decode`` and ``dispatch/matmul`` that the llama records
   alone leave to the ridge.  Printed, not gated: predicted vs measured
   for every fitted record and their median (``prediction_error_report``,
   in sample), the held-out record's error apart, the dispatch keys and
   the median of a second fit that takes granite-moe in,
   ``predict_cnn_train_ms`` of phase 5's CNN beside its measured static
   steps and device-busy ms and phase 5b's run C (the same step, timed
   apart), ``synthesize_cnn_grid`` by time under the
   card's table over 1, 2, 4 and 8 devices beside its picks by wire,
   ``synthesize_dist_grid(schedule="auto", minimize="time")`` per
   ResNet-50 layer at 4 devices, each key's ``n_obs`` (the collectives
   one card cannot fit read the nominal default entry, marked so), and
   the rows where the Eq. 4 plan differs from the launch's tile.  Then
   ``python -m repro_torch.launch.train --mesh dist-grid --minimize
   time`` for 2 steps with ``REPRO_CALIB`` at the card's table: it must
   print the table's provenance and the grid the synthesizer picks.
10. the zoo, through the port's static ``launch.serve.Engine`` (no
   hand-written kernel: the reference's zoo runs none; their launches
   over the phase are printed under the ``zoo`` path, not gated):
   zamba2-7b at its published widths and full depth (81 Mamba2 layers,
   d = 3584, 13 shared-attention applications) in bf16, random weights
   drawn on the card, 8 prompts of 64 tokens and 32 new tokens each
   (prefill ms, decode p50/p99 from CUDA events between the steps,
   served tokens/s, weight and peak allocated bytes, device-busy ms and
   the top kernels of one profiled decode step, the host's share, and
   the share of the step's byte bound: every weight read once, the
   recurrent states read and written once, the valid K/V rows read),
   gated: every logit finite, and prefill(63 tokens) then one decode
   step within ``TF_BF16_RTOL`` of max|logit| of prefill(64 tokens);
   zamba2-7b cut to 6 layers (one shared application) and xlstm-350m at
   full depth, f32, card against the CPU on the same weights, 2 prompts
   of 32 tokens and 4 teacher-forced decode steps, within ``TF_RTOL``;
   whisper-tiny in f32 the same way through ``prefill_encdec`` /
   ``decode_step_encdec`` with 1500 encoder frames and a 4-token prompt;
   xlstm-350m and whisper-tiny then served in bf16 like zamba2-7b; the
   three smoke configs' greedy tokens on the card equal to the CPU's in
   f32;
11. LM training (``lm_train``), the tuner off: (a) llama3.2-1b at its
   published widths and full depth in f32 (random weights drawn on the
   card), batch 8 x 64 from the ported ``data.pipeline.SyntheticTokens``,
   ``LM_TRAIN_STEPS`` AdamW steps of ``loss_lm`` on the one-rank
   (1,1,1) grid (every projection through the GEMM, forward, recomputed
   under ``remat`` and backward; the head ``torch.matmul``) and the same
   steps dense (``torch.matmul``, TF32 off) from the same weights: each
   step's loss within ``LOSS_RTOL``, the step-1 gradients per tensor
   within ``GRAD_RTOL`` of max|g|, the GEMM's launches in every grid step
   (and in the gradient pass, and a profiled step) equal to the count the
   code gives (``lm_train_products``: 448) and no other kernel launched,
   none dense; step p50 and tokens/s, device-busy ms and the top kernels
   of one profiled step, the GEMM's share and that of the copies inside
   its backward (the operand transposes), both read from that step's
   trace, the same two timed alone beside them as microbenchmarks, peak
   allocated bytes; (b) the GEMM against its plain version and
   ``torch.matmul`` at each distinct product of that step (forward, dX,
   dW of the four projection shapes), with the FFMA bound and the sums
   over a step; (c) the flash-attention ``autograd.Function`` at llama's
   heads (32 q, 8 kv, head_dim 64), batch 1, S = 4096, f32: output, dq,
   dk, dv against autograd through the plain ``attention_scores`` path
   within ``KERNEL_RTOL``, both timed; (d) every family's smoke config
   (llama, granite-moe, qwen2-vl, xlstm-350m at 8 tokens, zamba2-7b,
   whisper-tiny) in f32, the loss and gradients on the card against the
   CPU within ``LOSS_RTOL`` / ``GRAD_RTOL``; (e) ``python -m
   repro_torch.launch.train --mesh host --arch llama3.2-1b --steps 4
   --batch 8 --seq 64`` in a subprocess (full width, its own bf16,
   dense), run beside (d): exit 0 and four finite losses;
12. the schedule verifier (``repro_torch.analysis``): the AST lint and
   the doc lint on the tree (no jax needed), zero findings; then
   ``analysis.verify.run_specs`` on one rank (nccl, world 1), the static
   plan, at full width: every distinct conv of the CNN above (batch 64,
   SAME, the C = 3 first layer included) on ``(1,1,1,1,1)`` and the
   head's product ``[64,512]@[512,1000]`` on ``(1,1,1)``, each in the
   three schedules x {fwd, train, train with ``save_gathered=True``}.
   One ``{"phase": "verify", ...}`` line prints each cell's recorded
   and analytic wire (zero on one rank) and ratio, the allocator's peak
   over the cell (``live``) beside the paper's per-op Eq. 11 count
   (``*_mem_elems``) and their ratio, the band and ``ok``; every cell's
   lints gate, the memory band included, and the phase's launches of
   all four kernels, read whole, must be the count the cells give.

The last lines are the card line, one JSON line of per-kernel results
and ``{"ok": true, "device": {...}}``.  Without a CUDA device it exits
with code 2 and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

F32_PEAK_FLOPS = 67e12      # H100 SXM, float32 outside the tensor cores
# H100 SXM, TF32 on the tensor cores, dense: Winograd's tile GEMM runs
# float32 as 3xTF32, three TF32 products per f32 product
TF32_PEAK_FLOPS = 495e12
BF16_PEAK_FLOPS = 989e12    # H100 SXM, bfloat16 on the tensor cores, dense
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
KERNEL_RTOL = 1e-4   # max|kernel - plain| / max|plain|, f32 sums reordered
# the same in bfloat16: both sum in f32 in their own orders and round once
# to bfloat16, whose ulp is 2^-8 ~ 3.9e-3: two ulps
BF16_KERNEL_RTOL = 8e-3
LOGITS_RTOL = 1e-3   # 8 conv layers + head, card vs CPU, f32 throughout
SEED = 0
CHANNELS = [64, 64, 128, 128, 256, 256, 512, 512]
IN_CHANNELS, N_CLASSES, BATCH, HW, POOL_EVERY = 3, 1000, 64, 56, 2
REQUESTS = 5
TRAIN_STEPS, TRAIN_LR = 3, 1e-3
CPU_BATCH = 4        # the CPU step's batch: full widths, time-limited
LOSS_RTOL = 1e-4     # loss vs loss, relative
GRAD_RTOL = 1e-3     # max|grad - grad'| / max|grad'|, per tensor
# the timed steps against a plain AdamW: a parameter's error in units of
# lr, over the elements whose clipped gradient is above UPDATE_MASK of
# its tensor's max (below that the first update, lr * g / |g|, turns on
# the sign of a gradient rounding can flip); a moment's error over its
# tensor's max.  Sound runs on an H100 read 3.0e-5 lr and 5.4e-7 in every
# mode; a weight decay left out is off by lr * 0.1 * |p|, ~1e-2 lr for
# the larger weights
UPDATE_MASK = 1e-3
PARAM_LR_TOL = 1e-3
MOMENT_RTOL = 1e-5
MODES = ("static", "winograd", "tuned")
SG_MODE = "static_sg"   # mode static with save_gathered=True
# phase 5b: the resilient loop, through the loop and through the CLI
RESILIENT_STEPS, RESILIENT_CKPT_EVERY = 8, 2
RESILIENT_WATCHDOG_S, RESILIENT_WEDGE_S = 0.5, 1.5
RESILIENT_WEDGE_AT, RESILIENT_SIGTERM_AT = 3, 5
RESILIENT_RTOL = 5e-4   # stitched losses vs uninterrupted, the reference's
COMPRESS_RTOL = 1e-6    # s8 compression, card vs CPU: the same IEEE ops
PIPE_RTOL = 1e-5        # one-stage pipeline vs the stage, the reference's
# phase 8: LM serving at the published widths, f32, on the (1,1,1) grid
SERVE_ARCH, MOE_ARCH = "llama3.2-1b", "granite-moe-1b-a400m"
SERVE_SLOTS, SERVE_REQUESTS, SERVE_GEN = 8, 16, 32
SERVE_PROMPT_LENS = (48, 64)   # prompt lengths drawn in this range
SERVE_BUCKET, SERVE_MAX_SEQ = 64, 256
MOE_REQUESTS, MOE_GEN = 4, 8
TF_RTOL = 1e-3   # teacher-forced logits, grid vs dense, of max|logit|
# the same for llama3.2-1b served in its own dtype, bfloat16.  The CPU
# test (tests/test_torch_bf16.py) puts two valid bf16 roundings of the
# smoke llama (2 layers) 1.33e-2 of max|logit| apart (port vs reference,
# 3 seeds), while the same model with its f32 sums merely reordered moves
# by 9.3e-6.  Grid vs dense on the card differ in the sums' order only
# (the skinny GEMM vs cuBLAS, both f32 sums); the full model has 8x the
# layers, sqrt(8) x 1.33e-2 = 3.8e-2 if its rounding noise grew like a
# full re-rounding's: the gate is the 5e-2 cap
TF_BF16_RTOL = 5e-2
# phase 10: the zoo through the static Engine, at published widths
ZOO_HYBRID, ZOO_SSM, ZOO_ENCDEC = "zamba2-7b", "xlstm-350m", "whisper-tiny"
ZOO_SLOTS, ZOO_PROMPT, ZOO_GEN = 8, 64, 32
ZOO_TF_SLOTS, ZOO_TF_PROMPT, ZOO_TF_STEPS = 2, 32, 4
ZOO_CUT_LAYERS = 6   # zamba2-7b f32 against the CPU: one shared application
WHISPER_FRAMES, WHISPER_PROMPT = 1500, 4   # 30 s of audio at 50 frames/s
# xlstm-350m's random sLSTM recurrence is chaotic (one ulp more in the
# embedding moves its logits at 32 prompt tokens by O(1), printed beside):
# card against CPU at 2 prompt tokens + 4 steps
XLSTM_TF_PROMPT = 2
# phase 11: LM training, llama3.2-1b at full width and depth in float32
LM_TRAIN_ARCH = "llama3.2-1b"
LM_TRAIN_BATCH, LM_TRAIN_SEQ, LM_TRAIN_STEPS = 8, 64, 3
LM_TRAIN_LR = 1e-3
FLASH_SEQ = 4096   # above the flash threshold: S * S > 2048 ** 2
# phase 12: the schedule verifier, each cell in every schedule
VERIFY_SCHEDULES = ("allgather", "ring", "ring2")


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"FAIL: {msg}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 50, warmup: int = 5, repeats: int = 5) -> float:
    """Device time of ``fn()`` per call, back to back (CUDA events): the
    median over ``repeats`` runs of ``iters // repeats`` calls, so that
    one stall of the shared host does not set the mean of all.  Where
    the host launches slower than the device runs, this is the host's
    time per call."""
    for _ in range(warmup):
        fn()
    per_call = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters // repeats):
            fn()
        end.record()
        torch.cuda.synchronize()
        per_call.append(start.elapsed_time(end) / (iters // repeats))
    return statistics.median(per_call)


def device_ms(fn, iters: int = 10) -> float:
    """Mean device time of ``fn()`` with the host out of the way: the
    calls are queued behind a ~3 ms spin of the device, so they run back
    to back however long the host takes to launch them (``time_ms``
    includes the host's time wherever the host is the slower)."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(5_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cold_device_ms(fn, x, w, budget: int = 256 << 20) -> float:
    """Device time of ``fn(x, w')`` per call, queued behind a spin of the
    device as in :func:`device_ms`, with ``w'`` taken in turn from copies
    of ``w`` that together exceed the card's 50 MB L2: every call finds
    its weight in device memory, as a decode step does (it streams a
    model's weights once), where back-to-back calls on one weight under
    50 MB read it from the L2."""
    n = max(2, -(-budget // (w.numel() * w.element_size())))
    copies = [w] + [w.clone() for _ in range(n - 1)]
    iters = min(n, 100)
    fn(x, w)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(5_000_000)
    start.record()
    for i in range(iters):
        fn(x, copies[i])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean host time of ``fn()`` over ``iters`` calls: the launch path
    (wrapper, allocation, launch), without waiting for the device."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / iters * 1e3


def bound(flops: float, nbytes: float, peak: float = F32_PEAK_FLOPS):
    """(least ms, what bounds it) on an H100 at full power: ``flops`` at
    ``peak`` FLOP/s (f32 FFMA, or bf16 tensor cores) or ``nbytes`` over
    HBM, whichever is larger."""
    ops_ms, bytes_ms = flops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), \
        ("operations" if ops_ms >= bytes_ms else "bytes")


def eq4_beside_launch(prob, route: str, t: int, m: int, n: int, r: int,
                      dtype=torch.float32) -> dict:
    """The paper's Eq. 4 block plan of ``prob`` at the card's budget
    (``kernels.tiling.plan_blocks`` with ``SMEM_PER_BLOCK`` of float32 and
    64-wide tiles) beside the launch the kernel takes for the
    ``[t, m, r] @ [t, r, n]`` GEMM on ``route`` (``tile``: ``gemm_plan``;
    ``skinny``: ``skinny_plan``; ``wino``: ``wino_plan``).  Printed, not
    used: the launches come from ``kernels._plan``."""
    from repro_torch.kernels import _plan, tiling

    plan = tiling.plan_blocks(prob, vmem_elems=_plan.SMEM_PER_BLOCK // 4,
                              mxu=64)
    sms = _plan.sm_count(torch.cuda.current_device())
    if route == "wino":
        launch = _plan.wino_plan(t, m, n, r, dtype, sms)
        tile = launch.tile
    elif route == "skinny":
        launch = _plan.skinny_plan(m, n, r, dtype, sms)
        tile = (launch.rows, launch.strip)
    else:
        launch = _plan.gemm_plan(t, m, n, r, sms)
        tile = launch.tile
    return {"eq4_plan": {"block_bhw": plan.block_bhw,
                         "block_k": plan.block_k, "block_c": plan.block_c,
                         "footprint_elems": plan.vmem_elems,
                         "traffic_elems": plan.hbm_traffic},
            "launch_plan": {"route": route, "tile": list(tile),
                            "splits": launch.splits, "chunk": launch.chunk},
            "eq4_differs": [plan.block_bhw, plan.block_k] != list(tile)}


def conv_layers():
    """(C, K, H) of every conv of the CNN, in order."""
    out, cin, h = [], IN_CHANNELS, HW
    for i, cout in enumerate(CHANNELS):
        out.append((cin, cout, h))
        cin = cout
        if (i + 1) % POOL_EVERY == 0:
            h //= 2
    return out


def _dtype_terms(*tensors):
    """(tolerance, peak FLOP/s, dtype name) of operands: bfloat16 work is
    held to BF16_KERNEL_RTOL and bounded by the tensor cores' rate."""
    if any(t.dtype == torch.bfloat16 for t in tensors):
        return BF16_KERNEL_RTOL, BF16_PEAK_FLOPS, "bfloat16"
    return KERNEL_RTOL, F32_PEAK_FLOPS, "float32"


def compare_kernel(name, kernel, plain, library, args, flops, nbytes,
                   direction=None, extra=None, peak=None):
    """``peak``: the FLOP/s that bound ``flops``, if not the dtype's."""
    out = kernel(*args)
    ref = plain(*args)
    torch.cuda.synchronize()
    rtol, dtype_peak, dtype = _dtype_terms(*args)
    peak = peak or dtype_peak
    check(out.shape == ref.shape and out.dtype == ref.dtype
          and bool(torch.isfinite(out).all()),
          f"{name}: shape {tuple(out.shape)}, dtype {out.dtype} or "
          f"non-finite values")
    abs_err = float((out.float() - ref.float()).abs().max())
    rel = abs_err / float(ref.float().abs().max())
    check(rel <= rtol, f"{name}: max|d|/max|ref| {rel:.3e} > {rtol}")
    lib = library(*args)
    torch.cuda.synchronize()
    check(float((lib.float() - ref.float()).abs().max())
          / float(ref.float().abs().max()) <= rtol,
          f"{name}: the library call disagrees")
    bms, by = bound(flops, nbytes, peak)
    row = {"shape": name, "dtype": dtype, "max_abs_err": abs_err,
           "rel_err": rel, "rtol": rtol,
           "kernel_ms": time_ms(lambda: kernel(*args)),
           "plain_ms": time_ms(lambda: plain(*args), iters=3, warmup=1,
                               repeats=1),
           "library_ms": time_ms(lambda: library(*args)),
           "bound_ms": bms, "bound_by": by}
    row["bound_share"] = bms / row["kernel_ms"]
    row["kernel_device_ms"] = device_ms(lambda: kernel(*args))
    row["library_device_ms"] = device_ms(lambda: library(*args))
    row["kernel_host_ms"] = host_ms(lambda: kernel(*args))
    row["library_host_ms"] = host_ms(lambda: library(*args))
    if direction is not None:
        row["direction"] = direction
    row.update(extra or {})
    print(json.dumps(row), flush=True)
    return row


def conv_row(name, x, w, direction):
    """Kernel vs plain vs ``F.conv2d`` for one stride-1 VALID conv."""
    from repro_torch.kernels.conv2d import conv2d, conv2d_plain

    from repro_torch.core.problem import ConvProblem

    n, c, h, wd = x.shape
    k, _, kh, kw = w.shape
    ho, wo = h - kh + 1, wd - kw + 1
    plans = eq4_beside_launch(
        ConvProblem(Nb=n, Nk=k, Nc=c, Nh=ho, Nw=wo, Nr=kh, Ns=kw), "tile",
        1, n * ho * wo, k, c * kh * kw)
    return compare_kernel(
        name, lambda a, b: conv2d(a, b, padding="VALID"),
        lambda a, b: conv2d_plain(a, b, padding="VALID"), F.conv2d, (x, w),
        2.0 * n * k * c * ho * wo * kh * kw,
        x.element_size() * (x.numel() + w.numel() + n * k * ho * wo),
        direction, extra=dict(_widen_ms(x, w, (n, k, ho, wo)), **plans))


def _widen_ms(a, b, out_shape):
    """For bfloat16 operands of a kernel that computes in float32 (the
    conv): the time of the wrapper's widening of both operands and its
    narrowing of the float32 output, alone."""
    if a.dtype != torch.bfloat16:
        return {}
    out = torch.empty(out_shape, device=a.device)
    return {"widen_ms": time_ms(lambda: (a.float(), b.float(),
                                         out.to(torch.bfloat16)))}


def gemm_row(name, kernel, plain, library, a, b, extra=None, route="tile"):
    """Kernel vs plain vs library for one (batched) GEMM, at the
    operands' dtype; ``route`` names the launch plan the kernel takes
    (see :func:`eq4_beside_launch`)."""
    from repro_torch.core.problem import ConvProblem

    t = a.shape[0] if a.dim() == 3 else 1
    m, kk = a.shape[-2:]
    n = b.shape[-1]
    plans = eq4_beside_launch(ConvProblem.from_matmul(t * m, n, kk), route,
                              t, m, n, kk, a.dtype)
    return compare_kernel(name, kernel, plain, library, (a, b),
                          2.0 * t * m * kk * n,
                          a.element_size() * t * (m * kk + kk * n + m * n),
                          extra=dict(extra or {}, **plans))


def wino_row(name, v, u):
    """Winograd's tile GEMM (``csrc/wino_gemm.cu``) against its plain
    version and ``torch.bmm``.  float32 runs as 3xTF32 on the tensor
    cores: its bound counts three TF32 products per f32 product at
    ``TF32_PEAK_FLOPS``, the FFMA bound beside it (``ffma_bound_ms``);
    bfloat16 is one product at the bf16 peak."""
    from repro_torch.kernels.winograd import (wino_gemm, wino_gemm_einsum,
                                              wino_gemm_plain)

    from repro_torch.core.problem import ConvProblem

    if v.dtype != torch.float32:
        return gemm_row(name, wino_gemm, wino_gemm_plain, wino_gemm_einsum,
                        v, u, route="wino")
    t, m, r = v.shape
    flops = 2.0 * t * m * r * u.shape[2]
    nbytes = 4.0 * t * (m * r + r * u.shape[2] + m * u.shape[2])
    plans = eq4_beside_launch(ConvProblem.from_matmul(t * m, u.shape[2], r),
                              "wino", t, m, u.shape[2], r)
    return compare_kernel(name, wino_gemm, wino_gemm_plain,
                          wino_gemm_einsum, (v, u), 3 * flops, nbytes,
                          extra={"ffma_bound_ms": bound(flops, nbytes)[0],
                                 **plans},
                          peak=TF32_PEAK_FLOPS)


def kernel_phase(device):
    """Every kernel at every shape of the CNN; returns, per kernel, all
    rows and the rows of one train step on its mode's path (``static``
    for the conv and the GEMM, ``winograd`` for the tile GEMM), and the
    conv rows of one dist-path forward."""
    from repro_torch.kernels.conv2d import conv2d, conv2d_plain
    from repro_torch.kernels.matmul import matmul, matmul_plain

    gen = torch.Generator().manual_seed(SEED)

    def rand(*shape):
        return torch.randn(*shape, generator=gen).to(device)

    rows = {"conv2d": [], "matmul": [], "wino_gemm": []}
    path = {"conv2d": [], "matmul": [], "wino_gemm": []}
    conv_infer = []
    for c, k, h in conv_layers():
        # dense path: SAME on the plane (layer 0 included); dist path:
        # VALID on the window with one halo row each side (C % 8 == 0)
        x, w = rand(BATCH, c, h, h), rand(k, c, 3, 3)
        rows["conv2d"].append(compare_kernel(
            f"conv SAME N={BATCH} C={c} K={k} H=W={h}",
            lambda a, b: conv2d(a, b, padding="SAME"),
            lambda a, b: conv2d_plain(a, b, padding="SAME"),
            lambda a, b: F.conv2d(a, b, padding=1), (x, w),
            2.0 * BATCH * k * c * h * h * 9,
            4.0 * (x.numel() + w.numel() + BATCH * k * h * h)))
        xw = rand(BATCH, c, h + 2, h + 2)
        g = rand(BATCH, k, h, h)
        if c % 8 == 0:
            row = conv_row(f"conv fwd VALID N={BATCH} C={c} K={k} "
                           f"H=W={h + 2}", xw, w, "fwd")
            conv_infer.append(row)
            # dIn: the cotangent padded by 2 against the flipped,
            # O/I-swapped kernel
            gp = F.pad(g, (2, 2, 2, 2))
            wt = w.flip(2, 3).transpose(0, 1).contiguous()
            din = conv_row(f"conv dIn N={BATCH} C={k} K={c} H=W={h + 4}",
                           gp, wt, "dIn")
            path["conv2d"] += [row, din]
        # dKer: the N/C-transposed VALID conv, the cotangent as kernel
        dker = conv_row(f"conv dKer N={c} C={BATCH} K={k} H=W={h + 2} "
                        f"kernel {h}x{h}", xw.transpose(0, 1).contiguous(),
                        g.transpose(0, 1).contiguous(), "dKer")
        path["conv2d"].append(dker)
        del x, w, xw, g

    for c, k, h in conv_layers():
        if c % 8:  # the C = 3 layer's tile GEMM takes the library backend
            continue
        p, pin = BATCH * (-(-h // 2)) ** 2, BATCH * (-(-(h + 2) // 2)) ** 2
        for what, tpc, tck, on_path in [
                ("fwd", (16, p, c), (16, c, k), True),
                ("dIn fwd", (16, pin, k), (16, k, c), True),
                ("dv", (16, p, k), (16, k, c), False),
                ("du", (16, c, p), (16, p, k), False)]:
            row = wino_row(f"wino_gemm {what} [16,{tpc[1]},{tpc[2]}]@"
                           f"[16,{tck[1]},{tck[2]}] (C={c} K={k} H={h})",
                           rand(*tpc), rand(*tck))
            rows["wino_gemm"].append(row)
            if on_path:
                path["wino_gemm"].append(row)

    cin = CHANNELS[-1]
    for what, (m, kk, n), on_path in [
            ("head fwd", (BATCH, cin, N_CLASSES), True),
            ("head dX", (BATCH, N_CLASSES, cin), True),
            ("head dW", (cin, BATCH, N_CLASSES), True),
            ("ragged", (65, 520, 1000), False),
            # the im2col candidate's dKer product of the 56x56 layer
            ("im2col dKer", (CHANNELS[0] * 9, BATCH * HW * HW, CHANNELS[1]),
             False)]:
        row = gemm_row(f"matmul {what} [{m},{kk}]@[{kk},{n}]", matmul,
                       matmul_plain, torch.matmul, rand(m, kk), rand(kk, n))
        rows["matmul"].append(row)
        if on_path:
            path["matmul"].append(row)
    rows["conv2d"] += path["conv2d"]

    # bfloat16, one row each at the 64 -> 64 layer at 56x56: the conv
    # widens bf16 operands to f32 in the wrapper and narrows the result
    # once (the reference's arithmetic); Winograd's tile GEMM loads bf16
    # natively
    c, k, h = conv_layers()[1]
    bf = torch.bfloat16
    bf16 = {"conv2d": conv_row(
        f"conv fwd VALID bf16 N={BATCH} C={c} K={k} H=W={h + 2}",
        rand(BATCH, c, h + 2, h + 2).to(bf), rand(k, c, 3, 3).to(bf), "fwd")}
    p = BATCH * (h // 2) ** 2
    v, u = rand(16, p, c).to(bf), rand(16, c, k).to(bf)
    bf16["wino_gemm"] = wino_row(
        f"wino_gemm fwd bf16 [16,{p},{c}]@[16,{c},{k}] (C={c} K={k} H={h})",
        v, u)
    return rows, path, conv_infer, bf16


def resnet50_phase(device):
    """Each kernel at the shapes ResNet-50's layer table
    (``core.problem.resnet50_layers(batch=64)``, forward, SAME) gives it:
    the direct conv at the stride-1 layers (1x1 and 3x3), Winograd's tile
    GEMM at the 3x3 layers, and the tiled GEMM at ``conv1``'s im2col
    product (7x7/2, C = 3).  Returns the rows per kernel."""
    from repro_torch.core.problem import resnet50_layers
    from repro_torch.kernels.conv2d import conv2d, conv2d_plain
    from repro_torch.kernels.matmul import matmul, matmul_plain

    gen = torch.Generator().manual_seed(SEED + 3)

    def rand(*shape):
        return torch.randn(*shape, generator=gen).to(device)

    rows = {"conv2d": [], "matmul": [], "wino_gemm": []}
    for name, p in resnet50_layers(batch=BATCH).items():
        n, c, k, h, w, r = p.Nb, p.Nc, p.Nk, p.Nh, p.Nw, p.Nr
        if p.sh == 1:
            x, wt = rand(n, c, h, w), rand(k, c, r, r)
            rows["conv2d"].append(compare_kernel(
                f"resnet50 {name} conv SAME N={n} C={c} K={k} H=W={h} "
                f"{r}x{r}",
                lambda a, b: conv2d(a, b, padding="SAME"),
                lambda a, b: conv2d_plain(a, b, padding="SAME"),
                lambda a, b, r=r: F.conv2d(a, b, padding=r // 2), (x, wt),
                float(p.flops()),
                4.0 * (x.numel() + wt.numel() + n * k * h * w),
                extra=eq4_beside_launch(p, "tile", 1, n * h * w, k,
                                        c * r * r)))
            del x, wt
        if r == 3 and p.sh == 1:
            tiles = n * (-(-h // 2)) * (-(-w // 2))
            rows["wino_gemm"].append(wino_row(
                f"resnet50 {name} wino_gemm [16,{tiles},{c}]@[16,{c},{k}]",
                rand(16, tiles, c), rand(16, c, k)))
        if p.sh > 1:   # conv1's im2col product: patches @ kernel rows
            m, kk = n * h * w, c * r * r
            rows["matmul"].append(gemm_row(
                f"resnet50 {name} im2col matmul [{m},{kk}]@[{kk},{k}]",
                matmul, matmul_plain, torch.matmul, rand(m, kk),
                rand(kk, k)))
    print(json.dumps({"phase": "resnet50", **{
        kind: {key: sum(r[key] for r in rs)
               for key in ("kernel_ms", "library_ms", "bound_ms")}
        for kind, rs in rows.items()}}), flush=True)
    return rows


@contextlib.contextmanager
def _temp_plan_table():
    """The tuner's plan table in a temporary directory for the scope;
    yields its path."""
    from repro_torch.kernels import autotune

    old = os.environ.get(autotune.CACHE_ENV)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "plans.json")
        os.environ[autotune.CACHE_ENV] = path
        autotune.plan_cache().reset()
        try:
            yield path
        finally:
            autotune.plan_cache().reset()
            if old is None:
                os.environ.pop(autotune.CACHE_ENV)
            else:
                os.environ[autotune.CACHE_ENV] = old


def warm_phase():
    """``autotune.warm(batch=64, refresh=True)`` against a plan table in a
    temporary directory: every layer's winner and every candidate's ms,
    and the kernels' launches during the pass.  A hand-written candidate
    that fails on the card propagates out of the tuner."""
    from repro_torch.core.problem import resnet50_layers
    from repro_torch.kernels import autotune, ops

    with _temp_plan_table() as path:
        _zero_counts()
        t0 = time.perf_counter()
        table = autotune.warm(batch=BATCH, refresh=True)
        seconds = time.perf_counter() - t0
        launches = _launch_counts()
        with open(path, encoding="utf-8") as f:
            persisted = json.load(f)["plans"]
    for name, p in resnet50_layers(batch=BATCH).items():
        ent = table[name]
        x_shape = (p.Nb, p.Nc, p.sh * p.Nh, p.sw * p.Nw)
        w_shape = (p.Nk, p.Nc, p.Nr, p.Ns)
        cands = ops.conv_candidates(x_shape, w_shape, (p.sh, p.sw), "SAME")
        check(set(ent["wall_ms"]) == set(cands)
              and all(math.isfinite(ent["wall_ms"][c]) for c in cands
                      if c not in autotune.LIBRARY),
              f"warm {name}: candidates {cands}, timed {ent['wall_ms']}")
        check(persisted[ops.conv_key(x_shape, w_shape, torch.float32,
                                     (p.sh, p.sw), "SAME")]["impl"]
              == ent["impl"], f"warm {name}: winner not persisted")
    for name, ent in table.items():
        print(json.dumps({"phase": "warm", "layer": name,
                          "winner": ent["impl"],
                          "wall_ms": ent["wall_ms"]}), flush=True)
    for name in ("conv2d", "matmul", "wino_gemm"):
        check(launches[name] > 0, f"warm: kernel {name} was not launched")
    print(json.dumps({"phase": "warm", "batch": BATCH, "seconds": seconds,
                      "keys_persisted": len(persisted),
                      "launches": launches}), flush=True)
    return launches


def _synth(fn, *args, **kw):
    """A synthesizer's pick, or the reason there is none."""
    try:
        c = fn(*args, **kw)
    except ValueError as err:
        return {"error": str(err)}
    out = {"grid": list(c.grid), "algo": c.algo,
           "model_cost": c.model_cost,
           "wire_elems": c.comm_elems["total"], "mem_elems": c.mem_elems}
    if c.predicted_ms is not None:   # ranked by time
        out.update(predicted_ms=c.predicted_ms, schedule=c.schedule)
    return out


def synthesis_phase():
    """What the planner picks, on the host: one grid for the smoke CNN
    over 1, 2, 4 and 8 devices (``allgather`` and ``ring2``; without a
    memory cap, then with a cap just below the uncapped winner's peak),
    and a grid per ResNet-50 layer at 4 devices.  Printed only; the CPU
    tests hold the planner equal to the JAX package's."""
    from repro_torch.core.problem import resnet50_layers
    from repro_torch.core.sharding_synthesis import (synthesize_cnn_grid,
                                                     synthesize_dist_grid)

    x_shape = (BATCH, IN_CHANNELS, HW, HW)
    for n in (1, 2, 4, 8):
        for sched in ("allgather", "ring2"):
            free = _synth(synthesize_cnn_grid, x_shape, CHANNELS, N_CLASSES,
                          n, schedule=sched)
            capped = None if "error" in free else _synth(
                synthesize_cnn_grid, x_shape, CHANNELS, N_CLASSES, n,
                schedule=sched, mem_cap_elems=free["mem_elems"] * (1 - 1e-9))
            print(json.dumps({"phase": "synthesis", "model": "smoke CNN",
                              "devices": n, "schedule": sched,
                              "uncapped": free, "capped": capped}),
                  flush=True)
    for name, p in resnet50_layers(batch=BATCH).items():
        print(json.dumps({"phase": "synthesis", "layer": name, "devices": 4,
                          **_synth(synthesize_dist_grid,
                                   (p.Nb, p.Nc, p.sh * p.Nh, p.sw * p.Nw),
                                   (p.Nk, p.Nc, p.Nr, p.Ns), 4,
                                   stride=(p.sh, p.sw))}), flush=True)


def _slice_rank(rank):
    """The full-width forward on a one-rank grid; returns what it saw."""
    from repro_torch.dist.conv2d import make_conv_mesh
    from repro_torch.kernels.conv2d import conv2d
    from repro_torch.kernels.matmul import matmul
    from repro_torch.models.cnn import forward_cnn, init_cnn

    mesh = make_conv_mesh((1, 1, 1, 1, 1))
    params = init_cnn(torch.Generator().manual_seed(SEED),
                      channels=CHANNELS, n_classes=N_CLASSES,
                      in_channels=IN_CHANNELS)
    gen = torch.Generator().manual_seed(SEED + 1)
    batches = [torch.randn(BATCH, IN_CHANNELS, HW, HW, generator=gen)
               for _ in range(REQUESTS)]
    on_card = [b.cuda() for b in batches]
    for images in on_card[:2]:  # warm-up
        forward_cnn(params, images, dist_mesh=mesh)
    torch.cuda.synchronize()

    conv2d.launches = matmul.launches = 0
    logits, batch_ms, device_ms = [], [], []
    for images in on_card:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = forward_cnn(params, images, dist_mesh=mesh)
        end.record()
        torch.cuda.synchronize()
        batch_ms.append((time.perf_counter() - t0) * 1e3)
        device_ms.append(start.elapsed_time(end))
        logits.append(out)
    dist_launches = {"conv2d": conv2d.launches, "matmul": matmul.launches}

    conv2d.launches = matmul.launches = 0
    dense = forward_cnn(params, on_card[0], use_pallas=True)
    torch.cuda.synchronize()
    dense_launches = {"conv2d": conv2d.launches, "matmul": matmul.launches}

    warm = iter(on_card[:2])
    profile = _profile(lambda: forward_cnn(params, next(warm),
                                           dist_mesh=mesh), 2, "batches")

    cpu_params = init_cnn(torch.Generator().manual_seed(SEED),
                          channels=CHANNELS, n_classes=N_CLASSES,
                          in_channels=IN_CHANNELS, device="cpu")
    cpu = forward_cnn(cpu_params, batches[0], use_pallas=True)
    return {"logits0": logits[0].cpu(), "dense0": dense.cpu(), "cpu0": cpu,
            "all_finite": all(bool(torch.isfinite(t).all())
                              for t in logits),
            "shapes": [tuple(t.shape) for t in logits],
            "batch_ms": batch_ms, "device_ms": device_ms,
            "dist_launches": dist_launches,
            "dense_launches": dense_launches, "profile": profile}


def _profile(run, count: int, label: str, extra=None):
    """Device time by kernel over ``count`` calls of ``run()``, and the
    share of the wall time the device was busy (``torch.profiler``);
    ``extra(prof, events)`` adds keys read from the same trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(count):
            run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only: an aten op's self device time repeats
    # that of the kernels it launched
    events = [(e.key, e.self_device_time_total / 1e3)
              for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and not e.is_user_annotation and e.self_device_time_total > 0]
    busy_ms = sum(ms for _, ms in events)
    check(busy_ms > 0, "the profiler saw no device time")
    top = sorted(events, key=lambda e: -e[1])[:8]
    out = {label: count, "wall_ms": wall_ms,
           "device_busy_ms": busy_ms, "device_busy_share": busy_ms / wall_ms,
           "top_device_ms": [[k[:60], ms] for k, ms in top]}
    if extra is not None:
        out.update(extra(prof, events))
    return out


def slice_phase():
    from repro_torch.dist.spawn import run_spmd
    from repro_torch.kernels.autotune import autotune_disabled

    with autotune_disabled():  # the static paper plan
        res = run_spmd(_slice_rank, 1)[0]
    check(res["all_finite"] and res["shapes"]
          == [(BATCH, N_CLASSES)] * REQUESTS, "logits shape or finiteness")
    n_direct = sum(1 for c, _, _ in conv_layers() if c % 8 == 0)
    want = {"conv2d": n_direct * REQUESTS, "matmul": REQUESTS}
    check(res["dist_launches"] == want,
          f"dist path launches {res['dist_launches']} != {want}")
    want_dense = {"conv2d": len(CHANNELS), "matmul": 0}
    check(res["dense_launches"] == want_dense,
          f"dense path launches {res['dense_launches']} != {want_dense}")
    ref = res["cpu0"]
    scale = float(ref.abs().max())
    err_dist = float((res["logits0"] - ref).abs().max()) / scale
    err_dense = float((res["dense0"] - ref).abs().max()) / scale
    check(err_dist <= LOGITS_RTOL and err_dense <= LOGITS_RTOL,
          f"logits vs CPU: dist {err_dist:.3e}, dense {err_dense:.3e} > "
          f"{LOGITS_RTOL}")
    p50 = statistics.median(res["batch_ms"])
    summary = {"phase": "slice", "plan": "static", "grid": [1, 1, 1, 1, 1],
               "channels": CHANNELS, "batch": BATCH, "hw": HW,
               "n_classes": N_CLASSES, "requests": REQUESTS,
               "batch_ms": res["batch_ms"], "p50_batch_ms": p50,
               "device_ms": res["device_ms"],
               "images_per_s": BATCH * REQUESTS / (sum(res["batch_ms"])
                                                    / 1e3),
               "dist_launches": res["dist_launches"],
               "dense_launches": res["dense_launches"],
               "logits_rel_err_vs_cpu": {"dist": err_dist,
                                         "dense": err_dense},
               "profile": res["profile"]}
    print(json.dumps(summary), flush=True)
    return res["dist_launches"]


# --------------------------------------------------------------------------
# Phase 5: the train step in three dispatch modes
# --------------------------------------------------------------------------

def _train_batch(batch: int, device) -> dict:
    gen = torch.Generator().manual_seed(SEED + 2)
    images = torch.randn(BATCH, IN_CHANNELS, HW, HW, generator=gen)
    labels = torch.randint(0, N_CLASSES, (BATCH,), generator=gen)
    return {"images": images[:batch].to(device),
            "labels": labels[:batch].to(device)}


@contextlib.contextmanager
def _pinned_branch(decisions: list, record: bool):
    """Pin the CNN's ReLU and max-pool decisions: with ``record`` the run
    appends them (ReLU masks, pool argmax indices) to ``decisions``,
    otherwise it takes those already there.  The loss is piecewise
    linear, and two f32 summation orders put a pre-activation within
    ~1e-7 of zero on opposite sides now and then: one such flip moves a
    layer's weight gradient by ~1e-2 of its max (measured between
    ``F.conv2d`` and the plain einsum version on the CPU).  Gradients
    are compared on one branch, so what is left is rounding."""
    from repro_torch.models import cnn

    saved = cnn._bias_relu, cnn._pool_local
    taken = iter(decisions)

    def bias_relu(y, b):
        z = y + b[None, :, None, None]
        if record:
            mask = z > 0
            decisions.append(mask.cpu())
        else:
            mask = next(taken).to(z.device)
        return z * mask

    def pool_local(y, ph, pw):
        if record:
            out, idx = F.max_pool2d(y, 2, 2, return_indices=True)
            decisions.append(idx.cpu())
            return out
        idx = next(taken).to(y.device)
        return y.flatten(2).gather(2, idx.flatten(2)).view(idx.shape)

    cnn._bias_relu, cnn._pool_local = bias_relu, pool_local
    try:
        yield
    finally:
        cnn._bias_relu, cnn._pool_local = saved


def _loss_and_grads(params, batch, mesh, decisions=None, record=False,
                    save_gathered=False):
    """The step's loss and its gradients (flattened leaves) on the grid,
    by the custom VJPs or natively (``save_gathered``); on the branch in
    ``decisions`` (see :func:`_pinned_branch`) when given."""
    from torch.utils import _pytree as pytree

    from repro_torch.models.cnn import loss_cnn

    leaves, spec = pytree.tree_flatten(params)
    leaves = [t.detach().requires_grad_(True) for t in leaves]
    with (_pinned_branch(decisions, record) if decisions is not None
          else contextlib.nullcontext()):
        loss = loss_cnn(pytree.tree_unflatten(leaves, spec), batch,
                        dist_mesh=mesh, dist_save_gathered=save_gathered)
        grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), [g.detach().cpu() for g in grads]


def _seed_winograd_plan(path, params, batches, mesh):
    """Write a plan table that picks ``winograd`` for every 3x3 conv key
    and the kernel for every tile-GEMM key the step reaches on
    ``batches`` (the static choice for every other key): the keys are
    read off one gradient pass with the tuner's choice replaced."""
    from repro_torch.kernels import autotune

    seeded = {}

    def choose(key, candidates, make_args, **_):
        names = [n for n, _ in candidates]
        if key.startswith("conv2d:") and ":3x3:" in key \
                and "winograd" in names:
            impl = "winograd"
        elif key.startswith("wino_gemm:") and "pallas" in names:
            impl = "pallas"
        else:
            impl = names[0]
        seeded[key] = impl
        return impl

    real = autotune.best_of
    autotune.best_of = choose
    try:
        for batch in batches:
            _loss_and_grads(params, batch, mesh)
    finally:
        autotune.best_of = real
    check(any(v == "winograd" for v in seeded.values())
          and any(k.startswith("wino_gemm:") for k in seeded),
          "the seeding pass reached no Winograd conv or tile GEMM")
    table = autotune.PlanCache(path)
    for key, impl in seeded.items():
        table.record(key, impl, {})
    return seeded


@contextlib.contextmanager
def _dispatch_mode(mode, cache_dir, params, batches, mesh):
    """The dispatch of one train mode; yields a dict the mode's plan
    table is written into when the mode ends."""
    from repro_torch.kernels import autotune

    info = {}
    if mode == "static":
        with autotune.autotune_disabled():
            yield info
        return
    path = os.path.join(cache_dir, f"{mode}_plan.json")
    if mode == "winograd":
        seeded = _seed_winograd_plan(path, params, batches, mesh)
    old = os.environ.get(autotune.CACHE_ENV)
    os.environ[autotune.CACHE_ENV] = path
    autotune.plan_cache().reset()
    try:
        yield info
    finally:
        autotune.plan_cache().reset()
        if old is None:
            os.environ.pop(autotune.CACHE_ENV)
        else:
            os.environ[autotune.CACHE_ENV] = old
    with open(path, encoding="utf-8") as f:
        info["plan"] = json.load(f)["plans"]
    if mode == "winograd":  # the seeded table covered every key
        check(set(info["plan"]) == set(seeded),
              f"the winograd mode reached unseeded keys "
              f"{sorted(set(info['plan']) - set(seeded))}")


def _launch_counts():
    """Each wrapper's launches; ``matmul`` counts both GEMM routes,
    ``skinny_gemm`` the skinny one among them."""
    from repro_torch.kernels.conv2d import conv2d
    from repro_torch.kernels.matmul import matmul
    from repro_torch.kernels.winograd import wino_gemm
    return {"conv2d": conv2d.launches, "matmul": matmul.launches,
            "skinny_gemm": matmul.skinny_launches,
            "wino_gemm": wino_gemm.launches}


def _zero_counts():
    from repro_torch.kernels.conv2d import conv2d
    from repro_torch.kernels.matmul import matmul
    from repro_torch.kernels.winograd import wino_gemm
    conv2d.launches = matmul.launches = wino_gemm.launches = 0
    matmul.skinny_launches = 0


def _train_mode(params, batch, small, mesh, step, opt, branches, record,
                save_gathered=False):
    from torch.utils import _pytree as pytree

    from repro_torch.dist.train import init_grid_train_state

    loss1, grads1 = _loss_and_grads(params, batch, mesh,
                                    branches["batch"], record, save_gathered)
    small_loss, small_grads = _loss_and_grads(
        params, small, mesh, branches["small"], record, save_gathered)
    step(init_grid_train_state(params, opt), batch)  # warm-up (and tuning)
    torch.cuda.synchronize()

    _zero_counts()
    states = [init_grid_train_state(params, opt)]
    base_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms, grad_norms = [], [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, metrics = step(states[-1], batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        states.append(state)  # the update is functional: states stay
        losses.append(float(metrics["loss"]))
        grad_norms.append(float(metrics["grad_norm"]))
    launches = _launch_counts()
    peak_bytes = torch.cuda.max_memory_allocated()
    check(all(bool(torch.isfinite(t).all())
              for t in pytree.tree_leaves(states[-1].params)),
          "non-finite parameters after the train steps")
    update = _update_errs(states, losses, batch, mesh, opt, save_gathered)
    start = init_grid_train_state(params, opt)
    profile = _profile(lambda: step(start, batch), 1, "steps")
    return {"loss1": loss1, "grads1": grads1, "small_loss": small_loss,
            "small_grads": small_grads, "losses": losses,
            "grad_norms": grad_norms, "step_ms": step_ms,
            "launches": launches, "update": update, "profile": profile,
            "memory": {"base_bytes": base_bytes, "peak_bytes": peak_bytes}}


def _adamw_plain(opt, step, p, m, v, g, gnorm):
    """One AdamW update of one tensor, written out in float64 (the
    update of ``repro_torch.train.optim.AdamW``, global-norm clipping
    included); returns (params, m, v, clipped gradient)."""
    g = g * min(1.0, opt.clip_norm / (gnorm + 1e-12))
    m = opt.b1 * m + (1 - opt.b1) * g
    v = opt.b2 * v + (1 - opt.b2) * g * g
    m_hat, v_hat = m / (1 - opt.b1 ** step), v / (1 - opt.b2 ** step)
    p = p - opt.lr * (m_hat / (v_hat.sqrt() + opt.eps)
                      + opt.weight_decay * p)
    return p, m, v, g


def _update_errs(states, losses, batch, mesh, opt, save_gathered=False):
    """Each timed step against :func:`_adamw_plain` on the CPU: step k's
    loss against a separate pass at the parameters it started from, and
    its new parameters and moments against the plain AdamW applied to
    the card's state before it and that pass's gradients (so each step's
    update and the state it hands on are checked, not the rounding of
    the gradients, which the step-1 checks bound).  Returns the worst
    errors over the steps and tensors."""
    from torch.utils import _pytree as pytree

    def cpu64(tree):
        return [t.detach().double().cpu() for t in pytree.tree_leaves(tree)]

    errs = {"loss": 0.0, "params_lr": 0.0, "moments": 0.0,
            "params_unmasked_lr": 0.0}
    for k in range(1, len(states)):
        prev, new = states[k - 1], states[k]
        check(new.opt.step == k, f"optimizer step {new.opt.step} after "
              f"{k} steps")
        loss, grads = _loss_and_grads(prev.params, batch, mesh,
                                      save_gathered=save_gathered)
        errs["loss"] = max(errs["loss"], abs(losses[k - 1] - loss)
                           / abs(loss))
        grads = [g.double() for g in grads]
        gnorm = math.sqrt(sum(float((g * g).sum()) for g in grads))
        for g, p, m, v, p2, m2, v2 in zip(
                grads, cpu64(prev.params), cpu64(prev.opt.m),
                cpu64(prev.opt.v), cpu64(new.params), cpu64(new.opt.m),
                cpu64(new.opt.v)):
            want_p, want_m, want_v, gc = _adamw_plain(opt, k, p, m, v, g,
                                                      gnorm)
            d = (p2 - want_p).abs() / opt.lr
            mask = gc.abs() > UPDATE_MASK * float(gc.abs().max())
            errs["params_lr"] = max(errs["params_lr"], float(d[mask].max()))
            errs["params_unmasked_lr"] = max(errs["params_unmasked_lr"],
                                             float(d.max()))
            for got, want in ((m2, want_m), (v2, want_v)):
                errs["moments"] = max(errs["moments"], float(
                    (got - want).abs().max()) / float(want.abs().max()))
    return errs


def _train_rank(rank, cache_dir, device="cuda"):
    from repro_torch.dist.conv2d import make_conv_mesh
    from repro_torch.dist.train import make_grid_train_step
    from repro_torch.kernels.autotune import autotune_disabled
    from repro_torch.models.cnn import init_cnn
    from repro_torch.train.optim import AdamW

    mesh = make_conv_mesh((1, 1, 1, 1, 1), device=device)
    params = init_cnn(torch.Generator().manual_seed(SEED),
                      channels=CHANNELS, n_classes=N_CLASSES,
                      in_channels=IN_CHANNELS, device=device)
    batch = _train_batch(BATCH, device)
    small = _train_batch(CPU_BATCH, device)
    opt = AdamW(lr=TRAIN_LR)
    step = make_grid_train_step(opt, mesh)
    # the static mode's ReLU / pool decisions, which the gradients of the
    # other modes and of the CPU are taken on
    branches = {"batch": [], "small": []}
    out = {}
    for mode in MODES:
        with _dispatch_mode(mode, cache_dir, params, [batch, small],
                            mesh) as info:
            out[mode] = _train_mode(params, batch, small, mesh, step, opt,
                                    branches, record=mode == "static")
        out[mode]["plan"] = info.get("plan")
    # the static plan once more, differentiated natively on its saved
    # gathers (save_gathered=True), on the static mode's branch
    sg_step = make_grid_train_step(opt, mesh, save_gathered=True)
    with autotune_disabled():
        out[SG_MODE] = _train_mode(params, batch, small, mesh, sg_step, opt,
                                   branches, record=False,
                                   save_gathered=True)
    out["small_branch"] = branches["small"]
    return out


def _cpu_train_rank(rank, decisions):
    """The static plan's loss and gradients on the CPU (plain versions),
    full widths, batch ``CPU_BATCH``, on the card's branch."""
    from repro_torch.dist.conv2d import make_conv_mesh
    from repro_torch.kernels.autotune import autotune_disabled
    from repro_torch.models.cnn import init_cnn

    mesh = make_conv_mesh((1, 1, 1, 1, 1), device="cpu")
    params = init_cnn(torch.Generator().manual_seed(SEED),
                      channels=CHANNELS, n_classes=N_CLASSES,
                      in_channels=IN_CHANNELS, device="cpu")
    with autotune_disabled():
        return _loss_and_grads(params, _train_batch(CPU_BATCH, "cpu"),
                               mesh, decisions)


def _grad_err(got, want):
    """Worst per-tensor max|got - want| / max|want|."""
    return max(float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
               for g, w in zip(got, want))


def train_phase(card):
    from repro_torch.dist.spawn import run_spmd
    from repro_torch.dist.train import cnn_train_mem_elems

    with tempfile.TemporaryDirectory() as cache_dir:
        res = run_spmd(_train_rank, 1, cache_dir)[0]
    t0 = time.perf_counter()
    cpu_loss, cpu_grads = run_spmd(_cpu_train_rank, 1, res["small_branch"],
                                   device="cpu")[0]
    cpu_s = time.perf_counter() - t0

    want = {"static": ("conv2d", "matmul"),
            "winograd": ("wino_gemm", "conv2d", "matmul"),
            SG_MODE: ("conv2d", "matmul")}
    ref = res["static"]
    # the native backward runs the custom one's contractions, except the
    # dKer of a layer whose forward took the library conv (C % 8 != 0):
    # there autograd differentiates F.conv2d by cuDNN's own backward
    lib_layers = sum(1 for c, _, _ in conv_layers() if c % 8)
    want_sg = dict(ref["launches"],
                   conv2d=ref["launches"]["conv2d"] - lib_layers * TRAIN_STEPS)
    check(res[SG_MODE]["launches"] == want_sg,
          f"save_gathered launches {res[SG_MODE]['launches']} != {want_sg}")
    for mode in MODES + (SG_MODE,):
        r = res[mode]
        for name in want.get(mode, ()):
            check(r["launches"][name] > 0,
                  f"train mode {mode}: kernel {name} was not launched")
        # the step's loss at the shared start, and on the pinned branch;
        # later steps are compared across modes only in the report:
        # AdamW's first update is lr * g / |g| per element, so rounding in
        # the tiny gradient entries flips whole 1e-3 steps (and the loss
        # jumps at step 3 at this lr on the CPU too); each mode's own
        # steps are held against a plain AdamW (_update_errs)
        loss_err = max(abs(r["losses"][0] - ref["losses"][0]),
                       abs(r["loss1"] - ref["loss1"])) / abs(ref["loss1"])
        later = [abs(a - b) / abs(b)
                 for a, b in zip(r["losses"][1:], ref["losses"][1:])]
        grad_err = _grad_err(r["grads1"], ref["grads1"])
        upd = r["update"]
        cpu_loss_err = abs(r["small_loss"] - cpu_loss) / abs(cpu_loss)
        cpu_grad_err = _grad_err(r["small_grads"], cpu_grads)
        p50 = statistics.median(r["step_ms"])
        summary = {"phase": "train", "mode": mode, "card": card,
                   "grid": [1, 1, 1, 1, 1], "channels": CHANNELS,
                   "batch": BATCH, "hw": HW, "n_classes": N_CLASSES,
                   "optimizer": f"AdamW lr={TRAIN_LR}",
                   "steps": TRAIN_STEPS, "losses": r["losses"],
                   "grad_norms": r["grad_norms"], "step_ms": r["step_ms"],
                   "p50_step_ms": p50, "images_per_s": BATCH / p50 * 1e3,
                   "device_busy_share": r["profile"]["device_busy_share"],
                   "device_busy_ms": r["profile"]["device_busy_ms"],
                   "save_gathered": mode == SG_MODE,
                   # the step's allocations on the card beside the dist
                   # ops' analytic per-layer peak; printed, not gated
                   "memory": dict(r["memory"], analytic_dist_peak_bytes=4 *
                                  cnn_train_mem_elems(
                                      (BATCH, IN_CHANNELS, HW, HW), CHANNELS,
                                      N_CLASSES, (1, 1, 1, 1, 1),
                                      save_gathered=mode == SG_MODE)["peak"]),
                   "launches": r["launches"],
                   "loss_rel_err_vs_static": loss_err,
                   "later_loss_rel_diff_vs_static": later,
                   "grad_rel_err_vs_static": grad_err,
                   "cpu_batch": CPU_BATCH, "cpu_step_s": cpu_s,
                   "loss_rel_err_vs_cpu": cpu_loss_err,
                   "grad_rel_err_vs_cpu": cpu_grad_err,
                   "update_vs_plain_adamw": upd,
                   "profile": r["profile"]}
        print(json.dumps(summary), flush=True)
        if mode == "tuned":
            for key, ent in sorted(r["plan"].items()):
                print(json.dumps({"phase": "train", "mode": mode,
                                  "key": key, "winner": ent["impl"],
                                  "wall_ms": ent["wall_ms"]}), flush=True)
        check(loss_err <= LOSS_RTOL and grad_err <= GRAD_RTOL,
              f"train mode {mode} vs static: loss {loss_err:.3e}, "
              f"grads {grad_err:.3e}")
        check(cpu_loss_err <= LOSS_RTOL and cpu_grad_err <= GRAD_RTOL,
              f"train mode {mode} vs the CPU at batch {CPU_BATCH}: loss "
              f"{cpu_loss_err:.3e}, grads {cpu_grad_err:.3e}")
        check(all(math.isfinite(v) for v in r["losses"]),
              f"train mode {mode}: loss not finite")
        check(upd["loss"] <= LOSS_RTOL and upd["params_lr"] <= PARAM_LR_TOL
              and upd["moments"] <= MOMENT_RTOL,
              f"train mode {mode}: the steps vs a plain AdamW: {upd}")
    static = res["static"]
    return ({mode: res[mode]["launches"] for mode in MODES + (SG_MODE,)},
            {"step_ms": static["step_ms"],
             "p50": statistics.median(static["step_ms"]),
             "device_busy_ms": static["profile"]["device_busy_ms"]})


# --------------------------------------------------------------------------
# Phase 5b: resilient training at full width
# --------------------------------------------------------------------------

def _resilient_inputs(device):
    """The CLI's parameters and batches: ``init_cnn`` from a generator
    seeded 0, ``make_synthetic_cnn_batches`` with seed 0."""
    from repro_torch.dist.train import make_synthetic_cnn_batches
    from repro_torch.models.cnn import init_cnn

    def init():
        return init_cnn(torch.Generator().manual_seed(0), channels=CHANNELS,
                        n_classes=N_CLASSES, in_channels=IN_CHANNELS,
                        device=device)
    return init, make_synthetic_cnn_batches(
        (BATCH, IN_CHANNELS, HW, HW), N_CLASSES, device=device)


def _resilient_rank(rank):
    """Run C: ``make_resilient_train_loop`` on the grid ``grid="auto"``
    picks for one card, static plan, no fault; the kernels' launches over
    its steps and the loop's report (the state stays on the card)."""
    from repro_torch.dist.train import (ResilienceConfig,
                                        make_resilient_train_loop)
    from repro_torch.kernels.autotune import autotune_disabled
    from repro_torch.train.optim import AdamW

    init, batches = _resilient_inputs("cuda")
    run = make_resilient_train_loop(AdamW(lr=TRAIN_LR), ResilienceConfig(),
                                    grid="auto", device="cuda")
    with autotune_disabled():
        _zero_counts()
        report = run(init, batches, RESILIENT_STEPS)
        torch.cuda.synchronize()
        report["launches"] = _launch_counts()
    return report


def _dir_bytes(path) -> int:
    return sum(f.stat().st_size for f in Path(path).iterdir())


def _ckpt_times(state, root):
    """Bytes of one checkpoint of the train state, a synchronous save, an
    async save's time in the caller and to its commit, and a restore onto
    the card, bit-equal."""
    from torch.utils import _pytree as pytree

    from repro_torch.ckpt.checkpointer import CheckpointManager, restore

    mgr = CheckpointManager(root, keep=2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mgr.save(state, 1)
    sync_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    mgr.save(state, 2, async_=True)
    async_caller_ms = (time.perf_counter() - t0) * 1e3
    mgr.wait()
    async_total_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    restored, step = restore(state, mgr._dir(2))
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t0) * 1e3
    check(step == 2, f"restored step {step}, saved 2")
    check(all(torch.equal(a, b) and a.device == b.device
              if isinstance(a, torch.Tensor) else a == b
              for a, b in zip(pytree.tree_leaves(restored),
                              pytree.tree_leaves(state))),
          "the restored train state differs from the saved one")
    return {"bytes": _dir_bytes(mgr._dir(2)), "sync_save_ms": sync_ms,
            "async_save_caller_ms": async_caller_ms,
            "async_save_commit_ms": async_total_ms,
            "restore_ms": restore_ms}


def _cli(args, ckpt_dir, plan=None, steps=RESILIENT_STEPS, env=None):
    """``python -m repro_torch.launch.train --mesh dist-grid`` on this
    card at the phase's widths (static plan), ``env`` added to the
    environment; its output, losses, fault events and wall s."""
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--mesh",
           "dist-grid", "--ranks", "1", "--steps", str(steps),
           "--batch", str(BATCH), "--channels", ",".join(map(str, CHANNELS)),
           "--in-channels", str(IN_CHANNELS), "--hw", str(HW), "--classes",
           str(N_CLASSES), "--lr", str(TRAIN_LR), "--ckpt-dir", ckpt_dir,
           "--ckpt-every", str(RESILIENT_CKPT_EVERY)] + args
    if plan is not None:
        cmd += ["--fault-plan", plan.to_json()]
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"),
               REPRO_TORCH_AUTOTUNE="0", **(env or {}))
    env.pop("REPRO_FAULT_PLAN", None)
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, env=env, cwd=root, capture_output=True,
                          text=True, timeout=300)
    wall_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"the trainer's CLI failed:\n{proc.stdout}"
          f"\n{proc.stderr[-4000:]}")
    losses = {int(m.group(1)): float(m.group(2)) for m in re.finditer(
        r"\[resilient\] step (\d+) loss ([0-9.]+)", proc.stdout)}
    events = re.findall(r"\[fault\] (\w+)@(\d+)", proc.stdout)
    return proc.stdout, losses, [(k, int(s)) for k, s in events], wall_s


def _card_grads(state, batches):
    """The card CNN's gradients at ``state``'s parameters on batch 0
    (dense path, static plan)."""
    from torch.utils import _pytree as pytree

    from repro_torch.kernels.autotune import autotune_disabled
    from repro_torch.models.cnn import loss_cnn

    leaves, spec = pytree.tree_flatten(state.params)
    leaves = [t.detach().requires_grad_(True) for t in leaves]
    with autotune_disabled():
        loss = loss_cnn(pytree.tree_unflatten(leaves, spec), batches(0))
        return [g.detach().cpu() for g in torch.autograd.grad(loss, leaves)]


def _compress_pipe_rank(rank, grads, device):
    """``compressed_psum_tree`` (s8) of ``grads`` and a one-stage
    ``pipelined_apply`` with its gradients, on a one-rank mesh on
    ``device`` (nccl on the card, gloo on the CPU)."""
    from repro_torch.dist.collectives import make_mesh, record_collectives
    from repro_torch.dist.compress import compressed_psum_tree
    from repro_torch.dist.pipeline import pipelined_apply

    mesh = make_mesh((1,), ("pod",), device=device)
    g = [t.to(device) for t in grads]
    with record_collectives() as notes:
        red, err = compressed_psum_tree(g, mesh, "pod", None, wire="s8")
    out = {"red": [t.cpu() for t in red], "err": [t.cpu() for t in err],
           "notes": [(n.kind, n.tag, n.itemsize) for n in notes]}
    if device == "cuda":
        gen = torch.Generator().manual_seed(SEED + 5)
        w = (torch.randn(1, 512, 512, generator=gen) * 512 ** -0.5).to(device)
        b = (torch.randn(1, 512, generator=gen) * 0.1).to(device)
        x = torch.randn(4, 64, 512, generator=gen).to(device)
        gy = torch.randn(4, 64, 512, generator=gen).to(device)

        def stage(p, h):
            return torch.tanh(h @ p["w"] + p["b"])

        params = {"w": w.requires_grad_(True), "b": b.requires_grad_(True)}
        xg = x.clone().requires_grad_(True)
        y = pipelined_apply(stage, params, xg, mesh, axis="pod")
        got = (y, *torch.autograd.grad((y * gy).sum(), (w, b, xg)))
        w2, b2, x2 = (t.detach().clone().requires_grad_(True)
                      for t in (w, b, x))
        y2 = torch.stack([stage({"w": w2[0], "b": b2[0]}, x2[m])
                          for m in range(x2.shape[0])])
        want = (y2, *torch.autograd.grad((y2 * gy).sum(), (w2, b2, x2)))
        out["pipe_err"] = max(_grad_err([a.detach().cpu()], [c.detach().cpu()])
                              for a, c in zip(got, want))
    return out


def resilient_phase(card, static_launches, static_p50):
    """Phase 5b: the resilient loop at the phase-5 CNN's widths."""
    from repro_torch.dist.spawn import run_spmd
    from repro_torch.fault.inject import FaultPlan, FaultSpec, corrupt_chunk

    t_phase = time.perf_counter()
    # run C, in process, uninterrupted
    rep = run_spmd(_resilient_rank, 1)[0]
    launches = rep["launches"]
    want = {k: v // TRAIN_STEPS * RESILIENT_STEPS
            for k, v in static_launches.items()}
    check(all(v % TRAIN_STEPS == 0 for v in static_launches.values())
          and launches == want,
          f"resilient loop launches {launches} != phase 5's static "
          f"{static_launches} per step x {RESILIENT_STEPS}")
    check(rep["grid"] == (1, 1, 1, 1, 1) and not rep["preempted"]
          and len(rep["losses"]) == RESILIENT_STEPS
          and all(math.isfinite(v) for v in rep["losses"]),
          f"run C: grid {rep['grid']}, {len(rep['losses'])} losses")
    loss_c = rep["losses"]
    step_ms = [s * 1e3 for s in rep["step_s"]]

    with tempfile.TemporaryDirectory() as tmp:
        ckpt = _ckpt_times(rep["state"], os.path.join(tmp, "timing"))
        # run A: the CLI, a wedge (the watchdog saves) and a SIGTERM
        root = os.path.join(tmp, "ckpt")
        plan = FaultPlan(faults=(
            FaultSpec(kind="wedge", step=RESILIENT_WEDGE_AT,
                      delay_s=RESILIENT_WEDGE_S),
            FaultSpec(kind="sigterm", step=RESILIENT_SIGTERM_AT)))
        out_a, loss_a, ev_a, wall_a = _cli(
            ["--watchdog-timeout", str(RESILIENT_WATCHDOG_S)], root, plan)
        check(f"preempted at step {RESILIENT_SIGTERM_AT}" in out_a
              and ("wedge", RESILIENT_WEDGE_AT) in ev_a
              and sorted(loss_a) == list(range(RESILIENT_SIGTERM_AT)),
              f"run A:\n{out_a}")
        # silent corruption of the newest checkpoint (the SIGTERM's)
        corrupted = corrupt_chunk(root)
        # run B: the CLI again, falls back past the corrupt step
        out_b, loss_b, ev_b, wall_b = _cli([], root)
        start_b = min(loss_b) if loss_b else None
        check(("corrupt_ckpt", RESILIENT_SIGTERM_AT) in ev_b
              and start_b is not None and start_b < RESILIENT_SIGTERM_AT
              and sorted(loss_b) == list(range(start_b, RESILIENT_STEPS))
              and f"done at step {RESILIENT_STEPS}" in out_b,
              f"run B:\n{out_b}")
    stitched = {**loss_a, **loss_b}
    diffs = [abs(stitched[s] - loss_c[s]) / abs(loss_c[s])
             for s in range(RESILIENT_STEPS)]
    # the CLI prints 6 decimals; B's overlap with A is held too
    overlap = [abs(loss_b[s] - loss_a[s]) / abs(loss_a[s])
               for s in loss_b if s in loss_a]

    # compression and the pipeline on a one-rank nccl mesh, vs the CPU
    grads = _card_grads(rep["state"], _resilient_inputs("cuda")[1])
    card_c = run_spmd(_compress_pipe_rank, 1, grads, "cuda")[0]
    cpu_c = run_spmd(_compress_pipe_rank, 1, grads, "cpu", device="cpu")[0]
    compress_err = max(_grad_err(card_c["red"], cpu_c["red"]),
                       _grad_err(card_c["err"], cpu_c["err"]))
    phase_s = time.perf_counter() - t_phase
    summary = {
        "phase": "resilient", "card": card, "grid": list(rep["grid"]),
        "channels": CHANNELS, "batch": BATCH, "hw": HW,
        "n_classes": N_CLASSES, "steps": RESILIENT_STEPS,
        "launches": launches,
        "launches_per_step": {k: v / RESILIENT_STEPS
                              for k, v in launches.items()},
        "step_ms": step_ms, "p50_step_ms": statistics.median(step_ms),
        "p50_step_ms_after_first": statistics.median(step_ms[1:]),
        "static_p50_step_ms_phase5": static_p50,
        "losses_c": loss_c, "losses_a": [loss_a[s] for s in sorted(loss_a)],
        "losses_b": [loss_b[s] for s in sorted(loss_b)],
        "b_restored_step": start_b,
        "events_a": ev_a, "events_b": ev_b,
        "corrupted": os.path.basename(corrupted),
        "max_stitched_rel_diff": max(diffs),
        "max_overlap_rel_diff": max(overlap, default=0.0),
        "cli_wall_s": {"a": wall_a, "b": wall_b},
        "checkpoint": ckpt,
        "compress_notes": {f"{k} {t} {n}-byte": card_c["notes"].count(
            (k, t, n)) for k, t, n in sorted(set(card_c["notes"]))},
        "compress_card_vs_cpu": compress_err,
        "pipeline_one_stage_err": card_c["pipe_err"],
        "phase_s": phase_s}
    print(json.dumps(summary), flush=True)
    check(max(diffs) <= RESILIENT_RTOL and max(overlap, default=0.0)
          <= RESILIENT_RTOL,
          f"stitched losses vs run C: {diffs}, overlap {overlap}")
    check(("all-gather", "compress_s8", 1) in card_c["notes"],
          f"no int8 all-gather on the card: {card_c['notes']}")
    check(compress_err <= COMPRESS_RTOL,
          f"s8 compression, card vs CPU: {compress_err:.3e}")
    check(card_c["pipe_err"] <= PIPE_RTOL,
          f"one-stage pipeline vs the stage: {card_c['pipe_err']:.3e}")
    return launches, step_ms


# --------------------------------------------------------------------------
# Phase 8: LM serving at full width
# --------------------------------------------------------------------------

def _serve_cfg(arch, smoke=False, dtype="float32"):
    """``arch``'s config at ``dtype``: float32 for the f32 runs (as in
    PR 15), ``None`` for the config's own dtype (bfloat16)."""
    from repro_torch.configs import get_config
    cfg = get_config(arch, smoke=smoke)
    return cfg if dtype is None else dataclasses.replace(cfg, dtype=dtype)


def _serve_requests(cfg, n, gen, seed=SEED):
    """``n`` requests with prompts of SERVE_PROMPT_LENS tokens (numpy
    draws from ``seed``) and ``gen`` new tokens each."""
    from repro_torch.launch.serve import Request

    rng = np.random.default_rng(seed)
    lo, hi = SERVE_PROMPT_LENS
    return [Request(rid=i, prompt=[int(t) for t in rng.integers(
        0, cfg.vocab, int(rng.integers(lo, hi + 1)))], max_new=gen)
            for i in range(n)]


def _kernel_products(cfg, rows: int, decode: bool):
    """(products the static plan gives the GEMM, those of them that take
    the skinny route) of one decode step or prefill of ``cfg`` at its
    dtype."""
    from repro_torch.dist.lm import lm_step_products
    from repro_torch.kernels._plan import skinny_route
    from repro_torch.kernels.ops import pallas_applicable_matmul

    kernel = [(m, c, n) for m, c, n in lm_step_products(cfg, rows, decode)
              if pallas_applicable_matmul(m, n, c)]
    return len(kernel), sum(skinny_route(m, n, c, cfg.torch_dtype)
                            for m, c, n in kernel)


STEP_KEYS = ("kernel_ms", "kernel_device_ms", "kernel_cold_device_ms",
             "plain_ms", "library_ms", "library_device_ms",
             "library_cold_device_ms", "bound_ms")


def serve_kernel_phase(device):
    """The GEMM at every distinct shape the served paths give it, in
    float32 and in bfloat16: one decode step at SERVE_SLOTS slots and one
    prefill (M = the bucket) of llama3.2-1b and of granite-moe, each shape
    the static plan tiles, named with its count per step, on the route the
    plan gives it (``skinny``: csrc/skinny_gemm.cu; ``tile``: the tile
    core in csrc/gemm.cu) against ``torch.matmul`` at the same dtype; and,
    for comparison in the same run, the tile core at llama's float32
    decode shapes (their route in PR 15).  Returns (rows by route, per
    arch and dtype the sums over one decode step's products)."""
    from collections import Counter

    from repro_torch.dist.lm import lm_step_products
    from repro_torch.kernels._plan import skinny_route
    from repro_torch.kernels.matmul import launch_gemm, matmul, matmul_plain
    from repro_torch.kernels.ops import pallas_applicable_matmul

    gen = torch.Generator(device=device).manual_seed(SEED + 4)

    def rand(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device=device).to(dtype)

    rows = {"skinny": [], "tile": [], "tile_pr15": []}
    steps = {}
    for arch in (SERVE_ARCH, MOE_ARCH):
        cfg = _serve_cfg(arch, dtype=None)
        for dtype in (torch.float32, torch.bfloat16):
            dt = str(dtype).replace("torch.", "")
            step = dict.fromkeys(STEP_KEYS, 0.0)
            for what, m_rows, decode in (("decode", SERVE_SLOTS, True),
                                         ("prefill", SERVE_BUCKET, False)):
                counts = Counter(
                    p for p in lm_step_products(cfg, m_rows, decode)
                    if pallas_applicable_matmul(p[0], p[2], p[1]))
                for (m, c, n), count in counts.items():
                    route = "skinny" if skinny_route(m, n, c, dtype) \
                        else "tile"
                    x, w = rand(m, c, dtype=dtype), rand(c, n, dtype=dtype)
                    row = gemm_row(
                        f"serve {arch} {what} {dt} x{count} "
                        f"[{m},{c}]@[{c},{n}]", matmul, matmul_plain,
                        torch.matmul, x, w, route=route,
                        extra={"route": route, "arch": arch, "step": what,
                               "count": count,
                               "kernel_cold_device_ms": cold_device_ms(
                                   matmul, x, w),
                               "library_cold_device_ms": cold_device_ms(
                                   torch.matmul, x, w)})
                    del x, w
                    rows[route].append(row)
                    if decode:
                        for key in step:
                            step[key] += count * row[key]
                    if decode and arch == SERVE_ARCH \
                            and dtype == torch.float32:
                        x, w = rand(m, c), rand(c, n)
                        rows["tile_pr15"].append(gemm_row(
                            f"serve {arch} decode float32 tile core x{count}"
                            f" [{m},{c}]@[{c},{n}]", launch_gemm,
                            matmul_plain, torch.matmul, x, w,
                            extra={"route": "tile_pr15", "count": count,
                                   "kernel_cold_device_ms": cold_device_ms(
                                       launch_gemm, x, w),
                                   "library_cold_device_ms": cold_device_ms(
                                       torch.matmul, x, w)}))
                        del x, w
            step["bound_share"] = step["bound_ms"] / step["kernel_ms"]
            step["device_bound_share"] = (step["bound_ms"]
                                          / step["kernel_device_ms"])
            step["cold_device_bound_share"] = (
                step["bound_ms"] / step["kernel_cold_device_ms"])
            step["library_bound_share"] = (step["bound_ms"]
                                           / step["library_ms"])
            steps[f"{arch} {dt}"] = step
    tile15 = {key: sum(r["count"] * r[key] for r in rows["tile_pr15"])
              for key in STEP_KEYS}
    steps[f"{SERVE_ARCH} float32 tile core (PR 15 route)"] = tile15
    print(json.dumps({"phase": "serve_kernels", "slots": SERVE_SLOTS,
                      "bucket": SERVE_BUCKET, "decode_step": steps}),
          flush=True)
    return rows, steps


def _weight_bytes(cfg) -> float:
    """Bytes of the weights one decode step reads at the config's dtype:
    every projection of every layer, the MoE experts the step's tokens
    reach at most (all of them) and the head."""
    from repro_torch.dist.lm import lm_decode_matmuls

    size = cfg.torch_dtype.itemsize
    total = 0.0
    for name, _, c, n in lm_decode_matmuls(cfg, SERVE_SLOTS):
        total += size * c * n * (1 if name == "lm_head" else cfg.n_layers)
    if cfg.is_moe:
        total += size * cfg.n_layers * cfg.n_experts * 3 * cfg.d_model \
            * cfg.d_ff
    return total


def _teacher_forced(params, cfg, prompts, forced, mesh, device):
    """Logits [slots, V] at the prefill and at every decode step, one
    slot per prompt (bucket-padded prefill scattered into the per-slot
    cache, as the engine does), every step fed the tokens ``forced``
    (the dense run's), so two runs see the same inputs throughout."""
    from repro_torch.models.lm import decode_step, init_cache, prefill

    with torch.inference_mode():
        cache = init_cache(cfg, len(prompts), SERVE_MAX_SEQ, per_slot=True,
                           device=device)
        first = []
        for slot, p in enumerate(prompts):
            stage = init_cache(cfg, 1, SERVE_MAX_SEQ, device=device)
            toks = torch.tensor([p + [0] * (SERVE_BUCKET - len(p))],
                                dtype=torch.int32, device=device)
            lg, stage = prefill(params, cfg, stage, toks,
                                last_pos=len(p) - 1, dist_mesh=mesh)
            cache["k"][:, slot] = stage["k"][:, 0]
            cache["v"][:, slot] = stage["v"][:, 0]
            cache["len"][slot] = len(p)
            first.append(lg[0, 0])
        out = [torch.stack(first)]
        for t in range(min(len(f) for f in forced) - 1):
            toks = torch.tensor([f[t] for f in forced], dtype=torch.int32,
                                device=device).view(-1, 1)
            lg, cache = decode_step(params, cfg, cache, toks,
                                    dist_mesh=mesh)
            out.append(lg[:, 0])
    return out


def _profiled_decode(params, cfg, mesh, slots, device):
    """One profiled decode step of ``slots`` slots at prompt length
    (``torch.profiler``)."""
    from repro_torch.models.lm import decode_step, init_cache

    with torch.inference_mode():
        cache = init_cache(cfg, slots, SERVE_MAX_SEQ, per_slot=True,
                           device=device)
        cache["len"].fill_(SERVE_PROMPT_LENS[1])
        toks = torch.zeros((slots, 1), dtype=torch.int32, device=device)
        decode_step(params, cfg, cache, toks, dist_mesh=mesh)   # warm
        return _profile(lambda: decode_step(params, cfg, cache, toks,
                                            dist_mesh=mesh), 1,
                        "decode_steps")


def _serve_full(cfg, params, reqs, device):
    """The engine on the (1,1,1) grid through ``launch.serve.run``,
    counted: a short warm-up run, then the counts zeroed, the run, the
    counts read.  Returns (stats, launches, peak allocated bytes)."""
    from repro_torch.launch.serve import Request, run

    kw = dict(grid=(1, 1, 1), params=params, slots=SERVE_SLOTS,
              max_seq=SERVE_MAX_SEQ, prefill_bucket=SERVE_BUCKET,
              device=device)
    run(cfg, request_set=[Request(rid=0, prompt=reqs[0].prompt, max_new=2)],
        **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    res = run(cfg, request_set=reqs, **kw)
    launches = _launch_counts()
    return res, launches, torch.cuda.max_memory_allocated()


def _launch_gate(cfg, res, launches, label):
    """The GEMM's launches in a serve run, and the skinny GEMM's among
    them, against the counts the static plan gives its steps' shapes at
    the config's dtype; returns (per decode step, per prefill), each a
    (GEMM, skinny) pair."""
    per_decode = _kernel_products(cfg, SERVE_SLOTS, True)
    per_prefill = _kernel_products(cfg, SERVE_BUCKET, False)
    admitted = sum(1 for s in res["statuses"].values() if s == "ok")
    for i, (name, what) in enumerate((("matmul", "GEMM"),
                                      ("skinny_gemm", "skinny GEMM"))):
        want = res["reps"] * per_decode[i] + admitted * per_prefill[i]
        check(launches[name] == want and (launches[name] > 0 or want == 0),
              f"{label}: {launches[name]} {what} launches, the static plan "
              f"gives {res['reps']} x {per_decode[i]} + {admitted} x "
              f"{per_prefill[i]} = {want}")
    check(launches["matmul"] > 0 and launches["conv2d"] == 0
          and launches["wino_gemm"] == 0,
          f"{label}: launches {launches}")
    return per_decode, per_prefill


def _against_dense(cfg, params, reqs, res, mesh, device):
    """The same weights and requests served dense (``grid=None``:
    ``torch.matmul``, the MoE's einsums), then the first SERVE_SLOTS
    requests teacher-forced on the dense run's tokens through the grid
    and through the dense path: max|grid - dense| / max|dense| of the
    logits at the prefill and at every decode step, and the free-running
    token agreement of ``res`` (the grid's run) with the dense run."""
    from repro_torch.launch.serve import run

    dense = run(cfg, grid=None, params=params, slots=SERVE_SLOTS,
                max_seq=SERVE_MAX_SEQ, prefill_bucket=SERVE_BUCKET,
                request_set=_serve_requests(cfg, len(reqs),
                                            reqs[0].max_new),
                device=device)
    prompts = [r.prompt for r in reqs[:SERVE_SLOTS]]
    forced = [dense["tokens"][r.rid] for r in reqs[:SERVE_SLOTS]]
    grid_lg = _teacher_forced(params, cfg, prompts, forced, mesh, device)
    dense_lg = _teacher_forced(params, cfg, prompts, forced, None, device)
    tf_errs = [float((g - d).abs().max()) / float(d.abs().max())
               for g, d in zip(grid_lg, dense_lg)]
    agree = sum(a == b for rid in dense["tokens"]
                for a, b in zip(res["tokens"][rid], dense["tokens"][rid]))
    return {"dense_tokens_per_s": dense["served_tokens_per_s"],
            "dense_p50_decode_ms": dense["p50_ms"],
            "teacher_forced_rel_err": tf_errs,
            "free_running_same_requests": sum(
                res["tokens"][rid] == dense["tokens"][rid]
                for rid in dense["tokens"]),
            "free_running_token_agreement": agree / max(
                sum(len(t) for t in dense["tokens"].values()), 1)}


def _serve_llama(cfg, gen, mesh, device, label):
    """llama3.2-1b at ``cfg``'s dtype, served on the (1,1,1) grid and
    dense, counted, gated and teacher-forced; what the summary prints."""
    from repro_torch.dist.lm import lm_serve_mem_elems
    from repro_torch.models.lm import init_lm

    t0 = time.perf_counter()
    params = init_lm(gen.manual_seed(SEED), cfg, device=device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    reqs = _serve_requests(cfg, SERVE_REQUESTS, SERVE_GEN)
    res, launches, peak = _serve_full(cfg, params, reqs, device)
    per_decode, per_prefill = _launch_gate(cfg, res, launches, label)
    mem = lm_serve_mem_elems(cfg, (1, 1, 1), slots=SERVE_SLOTS,
                             max_seq=SERVE_MAX_SEQ)
    out = {"stats": res, "launches": launches, "peak_bytes": peak,
           "per_decode": per_decode, "per_prefill": per_prefill,
           "init_s": init_s, "dtype": cfg.dtype,
           **_against_dense(cfg, params, reqs, res, mesh, device),
           "profile": _profiled_decode(params, cfg, mesh, SERVE_SLOTS,
                                       device),
           "analytic_peak_bytes": cfg.torch_dtype.itemsize * mem["peak"],
           "weight_bytes": _weight_bytes(cfg)}
    del params
    torch.cuda.empty_cache()
    return out


def _serve_rank(rank, device="cuda"):
    """Phase 8 on one card: llama3.2-1b in bfloat16 (its own dtype) and in
    float32, and granite-moe in float32, at full width served on the
    (1,1,1) grid and dense, teacher-forced against each other; llama's
    smoke config on the card in both dtypes (CPU-generator weights)."""
    from repro_torch.dist.matmul import make_matmul_mesh
    from repro_torch.kernels.autotune import autotune_disabled
    from repro_torch.launch.serve import run
    from repro_torch.models.lm import init_lm

    mesh = make_matmul_mesh((1, 1, 1), device=device)
    gen = torch.Generator(device=device)
    out = {}
    with autotune_disabled():   # the static paper plan
        # this slice's main path: llama3.2-1b served in bfloat16
        out["llama_bf16"] = _serve_llama(_serve_cfg(SERVE_ARCH, dtype=None),
                                         gen, mesh, device,
                                         "llama bf16 serve")
        out["llama"] = _serve_llama(_serve_cfg(SERVE_ARCH), gen, mesh,
                                    device, "llama serve")
        out["smoke_tokens"] = {
            dt: run(_serve_cfg(SERVE_ARCH, smoke=True, dtype=dt),
                    grid=(1, 1, 1), seed=SEED, device=device)["tokens"]
            for dt in ("float32", "bfloat16")}

        moe = _serve_cfg(MOE_ARCH)
        params = init_lm(gen.manual_seed(SEED), moe, device=device)
        mreqs = _serve_requests(moe, MOE_REQUESTS, MOE_GEN)
        res, launches, peak = _serve_full(moe, params, mreqs, device)
        per_decode, per_prefill = _launch_gate(moe, res, launches,
                                               "granite-moe serve")
        out["moe"] = {"stats": res, "launches": launches,
                      "peak_bytes": peak, "per_decode": per_decode,
                      "per_prefill": per_prefill, "dtype": moe.dtype,
                      **_against_dense(moe, params, mreqs, res, mesh,
                                       device),
                      "profile": _profiled_decode(params, moe, mesh,
                                                  SERVE_SLOTS, device),
                      "weight_bytes": _weight_bytes(moe)}
        del params
        torch.cuda.empty_cache()
    return out


def _cpu_smoke_rank(rank):
    """The smoke config served on the CPU (plain versions) in float32 and
    in bfloat16, the same CPU-generator weights and requests as on the
    card."""
    from repro_torch.kernels.autotune import autotune_disabled
    from repro_torch.launch.serve import run

    with autotune_disabled():
        return {dt: run(_serve_cfg(SERVE_ARCH, smoke=True, dtype=dt),
                        grid=(1, 1, 1), seed=SEED, device="cpu")["tokens"]
                for dt in ("float32", "bfloat16")}


def _serve_summary(card, arch, r, extra):
    st = r["stats"]
    bound_ms = r["weight_bytes"] / HBM_BYTES_PER_S * 1e3
    summary = {"phase": "serve", "arch": arch, "card": card,
               "grid": [1, 1, 1], "plan": "static", "dtype": r["dtype"],
               "slots": SERVE_SLOTS, "max_seq": SERVE_MAX_SEQ,
               "prefill_bucket": SERVE_BUCKET,
               "requests": st["n_requests"], "tokens": st["n_tokens"],
               "decode_steps": st["reps"], "wall_s": st["wall_s"],
               # every token over the whole serve window, prefills too
               "tokens_per_s": st["served_tokens_per_s"],
               "decode_tokens_per_s": st["tokens_per_s"],
               "p50_decode_ms": st["p50_ms"], "p99_decode_ms": st["p99_ms"],
               "mean_decode_ms": st["mean_ms"],
               "prefill_ms_p50": statistics.median(
                   st["prefill_ms"].values()),
               "decode_bound_ms": bound_ms,
               "decode_bound_share": bound_ms / st["p50_ms"],
               "weight_bytes_per_step": r["weight_bytes"],
               "device_busy_ms_per_step": r["profile"]["device_busy_ms"],
               "host_share_of_step": 1.0 - r["profile"]["device_busy_share"],
               "peak_allocated_bytes": r["peak_bytes"],
               "launches": r["launches"],
               "gemm_and_skinny_launches_per_decode_step": r["per_decode"],
               "gemm_and_skinny_launches_per_prefill": r["per_prefill"],
               "statuses_ok": sum(1 for s in st["statuses"].values()
                                  if s == "ok"),
               "dense_tokens_per_s": r["dense_tokens_per_s"],
               "dense_p50_decode_ms": r["dense_p50_decode_ms"],
               "teacher_forced_steps": len(r["teacher_forced_rel_err"]),
               "teacher_forced_worst_rel_err": max(
                   r["teacher_forced_rel_err"]),
               "free_running_same_requests": r["free_running_same_requests"],
               "free_running_token_agreement":
                   r["free_running_token_agreement"],
               "profile": r["profile"], **extra}
    print(json.dumps(summary), flush=True)
    return summary


def serve_phase(card):
    """Phase 8: LM serving through ``launch.serve.run`` (see the module
    docstring).  Returns the GEMM's and the skinny GEMM's launches per
    serve path, and each run's ``(arch, dtype, decode-step stats)``."""
    from repro_torch.dist.spawn import run_spmd

    t0 = time.perf_counter()
    res = run_spmd(_serve_rank, 1)[0]
    card_s = time.perf_counter() - t0
    cpu_tokens = run_spmd(_cpu_smoke_rank, 1, device="cpu")[0]
    bf, ll, moe = res["llama_bf16"], res["llama"], res["moe"]
    smoke_equal = {dt: res["smoke_tokens"][dt] == cpu_tokens[dt]
                   for dt in cpu_tokens}
    for r in (bf, ll):
        _serve_summary(card, SERVE_ARCH, r, {
            "init_s": r["init_s"], "phase_s": card_s,
            "analytic_peak_bytes": r["analytic_peak_bytes"],
            "smoke_tokens_equal_cpu": smoke_equal[r["dtype"]]})
    _serve_summary(card, MOE_ARCH, moe, {})
    for r in (bf, ll):
        check(r["stats"]["n_requests"] == SERVE_REQUESTS
              and r["stats"]["n_tokens"] == SERVE_REQUESTS * SERVE_GEN,
              f"llama {r['dtype']} serve: {r['stats']['n_tokens']} tokens "
              f"from {r['stats']['n_requests']} requests")
    check(moe["stats"]["n_tokens"] == MOE_REQUESTS * MOE_GEN,
          f"granite-moe serve: {moe['stats']['n_tokens']} tokens")
    for arch, r, tol in ((SERVE_ARCH, bf, TF_BF16_RTOL),
                         (SERVE_ARCH, ll, TF_RTOL), (MOE_ARCH, moe, TF_RTOL)):
        worst = max(r["teacher_forced_rel_err"])
        check(worst <= tol, f"{arch} {r['dtype']}: teacher-forced logits, "
              f"(1,1,1) grid vs dense: {worst:.3e} > {tol}")
    for dt, equal in smoke_equal.items():
        check(equal, f"smoke config in {dt}: the card's tokens differ from "
              f"the CPU's")
    paths = {"serve_bf16": bf, "serve": ll, "serve_moe": moe}
    return ({name: {path: r["launches"][name] for path, r in paths.items()}
             for name in ("matmul", "skinny_gemm")},
            [(arch, r["dtype"], r["stats"])
             for arch, r in ((SERVE_ARCH, bf), (SERVE_ARCH, ll),
                             (MOE_ARCH, moe))])


# --------------------------------------------------------------------------
# Phase 9: the card's calibration table and the time-ranked planner
# --------------------------------------------------------------------------

def _entry_json(table, key):
    """A key's constants in ``table``, or the nominal default entry
    ``lookup`` falls back to (``n_obs`` 0, marked ``default``)."""
    ent = table.lookup(key)
    out = {"alpha_ms": ent.alpha_ms, "beta_ms_per_elem": ent.beta_ms_per_elem,
           "n_obs": ent.n_obs}
    if key not in table.collectives and key.split("/")[0] \
            not in table.collectives:
        out["default"] = True
    return out


def perf_phase(card, rows, static, resilient_ms, serve_stats):
    """Phase 9 (see the module docstring).  Returns the kernels'
    launches of its kernel records."""
    from repro_torch.core.sharding_synthesis import (synthesize_cnn_grid,
                                                     synthesize_dist_grid)
    from repro_torch.core.problem import resnet50_layers
    from repro_torch.perf import (EVENT_KEYS, fit_collectives,
                                  predict_cnn_train_ms,
                                  prediction_error_report)
    from repro_torch.perf import bench
    from repro_torch.perf.calibrate import OUT_DIR, CalibTable, repo_root

    t_phase = time.perf_counter()
    x_shape = (BATCH, IN_CHANNELS, HW, HW)
    # the card's records: kernel/<layer> timed now (static dispatch, then
    # the tuner in a temporary plan table), comm/train from phase 5's
    # static steps, serve/ from phase 8's llama3.2-1b decode steps
    with _temp_plan_table():
        _zero_counts()
        kern = bench.kernel_records(batch=BATCH, device="cuda")
        torch.cuda.synchronize()
        launches = _launch_counts()
    check(launches["conv2d"] > 0,
          f"phase 9's kernel records launched no direct conv: {launches}")
    train = [bench.cnn_train_record(
        static["step_ms"], x_shape=x_shape, channels=CHANNELS,
        n_classes=N_CLASSES, k=3, pool_every=POOL_EVERY,
        grid=(1, 1, 1, 1, 1))]
    serve = [bench.serve_record(st, arch=arch, dtype=dt, slots=SERVE_SLOTS,
                                smoke=False, grid=(1, 1, 1))
             for arch, dt, st in serve_stats]
    # granite-moe's decode step is held out of the card's table: it is
    # priced by a table fitted without it, and a second fit with it
    # shows what it does to the dispatch split
    held = [r for r in serve if r["arch"] == MOE_ARCH]
    serve = [r for r in serve if r["arch"] != MOE_ARCH]
    source = {"source": "chip_smoke.py phase 9"}
    table = fit_collectives(train + serve, kernel_records=kern,
                            provenance=source)
    with_held = fit_collectives(train + serve + held, kernel_records=kern,
                                provenance=source)
    out = Path(repo_root()) / OUT_DIR
    out.mkdir(exist_ok=True)
    calib_path = out / "CALIB.json"
    table.save(str(calib_path))
    report = prediction_error_report(train + serve + kern, table)
    for fname, recs in (("BENCH_kernels.json", kern),
                        ("BENCH_comm.json", train),
                        ("BENCH_serve.json", serve + held),
                        ("CALIB_report.json", report)):
        (out / fname).write_text(json.dumps(recs, indent=1,
                                            sort_keys=True) + "\n")

    consts = [table.compute_flops_per_ms] + [
        v for e in table.collectives.values()
        for v in (e.alpha_ms, e.beta_ms_per_elem)]
    check(all(math.isfinite(v) and v >= 0 for v in consts),
          f"the card's table has a negative or non-finite constant: "
          f"{table.to_json()}")
    prov = table.provenance
    check(prov.get("platform") == "cuda"
          and prov.get("device") == torch.cuda.get_device_name(0)
          and prov.get("card") == card,
          f"the table's provenance does not name the card: {prov}")
    cpu = CalibTable.load(str(Path(repo_root()) / "CALIB.json"))
    check(table.compute_flops_per_ms != cpu.compute_flops_per_ms,
          "the card's compute rate equals the checked-in CPU table's")
    print(json.dumps({"phase": "perf", "table": table.to_json(),
                      "keys": {k: _entry_json(table, k)
                               for k in EVENT_KEYS},
                      "cpu_table_flops_per_ms": cpu.compute_flops_per_ms}),
          flush=True)
    print(json.dumps({"phase": "perf", "kernel_records": [
        [r["name"], r["schedule"], r["impl"], r["wall_ms"], r["std_ms"]]
        for r in kern]}), flush=True)
    for row in report["records"]:
        print(json.dumps({"phase": "perf", "record": row}), flush=True)
    print(json.dumps({"phase": "perf", "in_sample": True,
                      "error_summary": report["summary"]}), flush=True)
    dispatch = ("dispatch/conv", "dispatch/matmul", "dispatch/decode")
    print(json.dumps({"phase": "perf", "held_out": prediction_error_report(
        held, table)}), flush=True)
    print(json.dumps({"phase": "perf", "fitted_with_held_out": {
        "keys": {k: _entry_json(with_held, k) for k in dispatch},
        "error_summary": prediction_error_report(
            train + serve + held + kern, with_held)["summary"]}}),
        flush=True)

    # phase 5's CNN under the card's table: the record was fitted
    # (in sample); run C of phase 5b timed the same step apart
    pred = predict_cnn_train_ms(x_shape, CHANNELS, N_CLASSES,
                                (1, 1, 1, 1, 1), pool_every=POOL_EVERY,
                                calib=table)
    print(json.dumps({"phase": "perf", "cnn_step": {
        "grid": [1, 1, 1, 1, 1], "predicted_ms": pred,
        "static_p50_ms": static["p50"],
        "static_mean_ms": statistics.fmean(static["step_ms"]),
        "static_device_busy_ms": static["device_busy_ms"],
        "resilient_p50_ms": statistics.median(resilient_ms)}}),
        flush=True)

    # the planner ranking by time under the card's table, beside its
    # picks by wire (phase 7)
    picks = {}
    for n in (1, 2, 4, 8):
        for sched in ("allgather", "ring2"):
            picks[(n, sched)] = {
                mode: _synth(synthesize_cnn_grid, x_shape, CHANNELS,
                             N_CLASSES, n, schedule=sched, minimize=mode,
                             **({"calib": table} if mode == "time" else {}))
                for mode in ("comm", "time")}
            print(json.dumps({"phase": "perf", "model": "smoke CNN",
                              "devices": n, "schedule": sched,
                              **picks[(n, sched)]}), flush=True)
    for name, p in resnet50_layers(batch=BATCH).items():
        args = ((p.Nb, p.Nc, p.sh * p.Nh, p.sw * p.Nw),
                (p.Nk, p.Nc, p.Nr, p.Ns), 4)
        print(json.dumps({
            "phase": "perf", "layer": name, "devices": 4,
            "comm": _synth(synthesize_dist_grid, *args,
                           stride=(p.sh, p.sw)),
            "time_auto": _synth(synthesize_dist_grid, *args,
                                stride=(p.sh, p.sw), schedule="auto",
                                minimize="time", calib=table)}),
            flush=True)

    # the trainer's CLI ranking by time under the card's table
    stdout, losses, _, cli_s = _cli(["--minimize", "time"], "", steps=2,
                                    env={"REPRO_CALIB": str(calib_path)})
    want = tuple(picks[(1, "allgather")]["time"]["grid"])
    check(f"[calib] table={calib_path} source=chip_smoke.py phase 9 "
          f"platform=cuda" in stdout and f"card={card}" in stdout
          and f"[resilient] grid={want}" in stdout and sorted(losses)
          == [0, 1], f"the trainer's CLI with --minimize time:\n{stdout}")

    # the paper's Eq. 4 plan at the card's budget beside each phase-3
    # and phase-8 row's launch plan
    planned = [r for rs in rows.values() for r in rs if "eq4_plan" in r]
    differ = [[r["shape"], [r["eq4_plan"][k] for k in
                            ("block_bhw", "block_k", "block_c")],
               r["launch_plan"]["tile"], r["launch_plan"]["splits"]]
              for r in planned if r["eq4_differs"]]
    phase_s = time.perf_counter() - t_phase
    print(json.dumps({"phase": "perf", "eq4_rows": len(planned),
                      "eq4_differs": len(differ), "rows": differ}),
          flush=True)
    print(json.dumps({"phase": "perf", "card": card,
                      "kernel_record_launches": launches,
                      "cli_lines": [ln for ln in stdout.splitlines()
                                    if ln.startswith(("[calib]",
                                                      "[resilient] grid"))],
                      "cli_wall_s": cli_s, "table_path": str(calib_path),
                      "phase_s": phase_s}), flush=True)
    return launches


# --------------------------------------------------------------------------
# Phase 10: the model zoo served through the static Engine
# --------------------------------------------------------------------------

def _leaves(tree):
    """The tensors of nested dicts and lists (``None`` left out)."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, list):
        return [t for sub in tree for t in _leaves(sub)]
    return [] if tree is None else [tree]


def _to(tree, device):
    """Nested dicts and lists of tensors, copied to ``device``."""
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _zoo_cfg(arch, dtype=None, **cut):
    """``arch``'s published config at ``dtype`` (``None``: its own,
    bfloat16), with the fields in ``cut`` replaced."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    return dataclasses.replace(cfg, dtype=dtype or cfg.dtype, **cut)


def _zoo_step_bytes(cfg, params, cache) -> float:
    """The least bytes one decode step of ``ZOO_SLOTS`` slots moves at
    prompt length: every weight but the embedding table read once (and
    one table row per slot), the recurrent states (SSD, conv contexts,
    sLSTM cells) read and written once, and the K/V rows valid at that
    length read (the shared block's, the decoder's self and cross
    rows)."""
    tok = params["emb"]["tok"]
    weights = _nbytes(_leaves(params)) - _nbytes([tok]) \
        + ZOO_SLOTS * tok.shape[1] * tok.element_size()
    kv = [cache[k] for k in ("k", "v") if k in cache]
    kv_bytes = _nbytes(kv) * ZOO_PROMPT / cache["k"].shape[2] if kv else 0.0
    kv_bytes += _nbytes([cache[k] for k in ("xk", "xv") if k in cache])
    state = [t for k, v in cache.items()
             if k not in ("k", "v", "xk", "xv", "len")
             for t in _leaves(v)]
    return weights + kv_bytes + 2 * _nbytes(state)


def _zoo_engine(cfg, params, prompts):
    """``prompts`` through the port's static ``Engine`` (``ZOO_GEN`` new
    tokens each), after a two-token warm-up run on the same prompts:
    (tokens, prefill s, decode s, per-step decode ms, peak bytes)."""
    from repro_torch.launch.serve import Engine

    engine = Engine(cfg, params, slots=ZOO_SLOTS,
                    max_seq=ZOO_PROMPT + ZOO_GEN)
    engine.run(prompts, 2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    toks, t_pre, t_dec = engine.run(prompts, ZOO_GEN)
    return (toks, t_pre, t_dec, list(engine.decode_ms),
            torch.cuda.max_memory_allocated())


def _zoo_prefill(fns, cfg, params, cache, toks, frames=None):
    if cfg.family == "encdec":
        return fns.prefill(params, cfg, cache, frames, toks)
    return fns.prefill(params, cfg, cache, toks)


def _zoo_profiled_step(cfg, params, prompts, device):
    """One profiled decode step after a prefill of ``prompts``, and the
    cache it ran on: (profile, cache, the step's logits)."""
    from repro_torch.models.api import model_fns

    fns = model_fns(cfg)
    b, s = prompts.shape
    with torch.inference_mode():
        cache = fns.init_cache(cfg, b, s + ZOO_GEN, enc_len=s,
                               device=device)
        frames = torch.zeros((b, s, cfg.d_model), device=device)
        _, cache = _zoo_prefill(fns, cfg, params, cache, prompts, frames)
        tok = prompts[:, -1:]
        logits, _ = fns.decode_step(params, cfg, cache, tok)    # warm
        prof = _profile(lambda: fns.decode_step(params, cfg, cache, tok), 1,
                        "decode_steps")
    return prof, cache, logits


def _zoo_prefill_logits(cfg, params, prompts, device, max_seq):
    """(logits, cache) of one prefill of ``prompts`` into a fresh cache
    of ``max_seq`` positions."""
    from repro_torch.models.api import model_fns

    fns = model_fns(cfg)
    with torch.inference_mode():
        cache = fns.init_cache(cfg, prompts.shape[0], max_seq,
                               device=device)
        return fns.prefill(params, cfg, cache, prompts)


def _zoo_continuation(cfg, params, prompts, device) -> dict:
    """Prefill ``prompts[:, :-1]``, decode the last token, and hold its
    logits against one prefill of all of ``prompts`` (the reference's
    ``tests/test_archs.py`` check): max|step - prefill| / max|prefill|.
    Beside it, the same full prefill with the chunked recurrence at
    chunk 32 (the same math, its f32 sums in another order): the rounding
    noise the check cannot go below.  Every logit must be finite."""
    from repro_torch.models.api import model_fns

    s = prompts.shape[1]
    first, cache = _zoo_prefill_logits(cfg, params, prompts[:, :-1],
                                       device, s)
    with torch.inference_mode():
        step, _ = model_fns(cfg).decode_step(params, cfg, cache,
                                             prompts[:, -1:])
    del cache
    full, _ = _zoo_prefill_logits(cfg, params, prompts, device, s)
    chunk32, _ = _zoo_prefill_logits(
        dataclasses.replace(cfg, ssm_chunk=32), params, prompts, device, s)
    for name, lg in (("prefill", first), ("step", step), ("full", full),
                     ("chunk-32 prefill", chunk32)):
        check(bool(torch.isfinite(lg).all()),
              f"{cfg.arch_id} {cfg.dtype}: non-finite logits in the {name}")
    scale = float(full.abs().max())
    return {"continuation_rel_err": float((step - full).abs().max()) / scale,
            "chunk32_rel_diff": float((chunk32 - full).abs().max()) / scale}


def _zoo_serve(card, cfg, device, gen, label, extra=None):
    """``cfg`` at its published widths, random weights from ``gen`` on
    the card, served through ``Engine`` (``ZOO_SLOTS`` prompts of
    ``ZOO_PROMPT`` tokens, ``ZOO_GEN`` new); one decode step profiled;
    the summary printed and returned.  ``extra(params, prompts)`` gives
    more keys of the summary."""
    from repro_torch.models.api import model_fns

    t0 = time.perf_counter()
    params = model_fns(cfg).init(gen.manual_seed(SEED), cfg, device=device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab, (ZOO_SLOTS, ZOO_PROMPT))).to(device, torch.int32)
    toks, t_pre, t_dec, step_ms, peak = _zoo_engine(cfg, params, prompts)
    check(tuple(toks.shape) == (ZOO_SLOTS, ZOO_GEN),
          f"{label}: served {tuple(toks.shape)} tokens")
    prof, cache, logits = _zoo_profiled_step(cfg, params, prompts, device)
    check(bool(torch.isfinite(logits).all()),
          f"{label}: non-finite decode logits")
    step_bytes = _zoo_step_bytes(cfg, params, cache)
    del cache
    bound_ms = step_bytes / HBM_BYTES_PER_S * 1e3
    p50 = statistics.median(step_ms)
    n_tok = ZOO_SLOTS * ZOO_GEN
    summary = {
        "phase": "zoo", "arch": cfg.arch_id, "card": card,
        "dtype": cfg.dtype, "n_layers": cfg.n_layers,
        "d_model": cfg.d_model, "engine": "static", "slots": ZOO_SLOTS,
        "prompt_tokens": ZOO_PROMPT, "new_tokens": ZOO_GEN,
        "init_s": init_s, "prefill_ms": t_pre * 1e3,
        "decode_ms_total": t_dec * 1e3,
        "p50_decode_ms": p50,
        "p99_decode_ms": sorted(step_ms)[min(int(0.99 * len(step_ms)),
                                             len(step_ms) - 1)],
        "mean_decode_ms": statistics.mean(step_ms),
        # every token over the serve window, the prefill's first included
        "tokens_per_s": n_tok / (t_pre + t_dec),
        "decode_tokens_per_s": ZOO_SLOTS * (ZOO_GEN - 1) / t_dec,
        "weight_bytes": _nbytes(_leaves(params)),
        "decode_step_bound_bytes": step_bytes,
        "decode_bound_ms": bound_ms, "decode_bound_share": bound_ms / p50,
        "peak_allocated_bytes": peak,
        "device_busy_ms_per_step": prof["device_busy_ms"],
        "host_share_of_step": 1.0 - prof["device_busy_share"],
        "profile": prof}
    if extra is not None:
        summary.update(extra(params, prompts))
    print(json.dumps(summary), flush=True)
    del params
    torch.cuda.empty_cache()
    return summary


def _zoo_card_vs_cpu(cfg, device, gen, frames_len=None, prompt=ZOO_TF_PROMPT,
                    sensitivity=False):
    """``cfg`` in float32, weights drawn on the card and copied to the
    CPU; ``ZOO_TF_SLOTS`` prompts prefilled, then ``ZOO_TF_STEPS`` decode
    steps fed the same drawn tokens on both devices: max|card - cpu| /
    max|cpu| of the logits at the prefill and every step.  With
    ``sensitivity``, also the CPU against itself with the embedding table
    one float32 ulp larger (x (1 + 2^-23)): how far the model itself moves
    two runs that differ by rounding."""
    from repro_torch.models.api import model_fns

    fns = model_fns(cfg)
    params = fns.init(gen.manual_seed(SEED), cfg, device=device)
    cpu_params = _to(params, "cpu")
    rng = np.random.default_rng(SEED + 1)
    prompts = rng.integers(0, cfg.vocab, (ZOO_TF_SLOTS, prompt))
    forced = rng.integers(0, cfg.vocab, (ZOO_TF_STEPS, ZOO_TF_SLOTS, 1))
    frames = (rng.standard_normal((ZOO_TF_SLOTS, frames_len, cfg.d_model),
                                  dtype=np.float32)
              if frames_len else None)

    def run(p, dev):
        out = []
        with torch.inference_mode():
            cache = fns.init_cache(cfg, ZOO_TF_SLOTS, prompt + ZOO_TF_STEPS,
                                   enc_len=frames_len, device=dev)
            toks = torch.from_numpy(prompts).to(dev, torch.int32)
            fr = None if frames is None else torch.from_numpy(frames).to(dev)
            logits, cache = _zoo_prefill(fns, cfg, p, cache, toks, fr)
            out.append(logits.cpu())
            for t in forced:
                logits, cache = fns.decode_step(
                    p, cfg, cache, torch.from_numpy(t).to(dev, torch.int32))
                out.append(logits.cpu())
        return out

    def errs(got, want):
        return [float((a - b).abs().max() / b.abs().max())
                for a, b in zip(got, want)]

    card_lg = run(params, device)
    del params
    torch.cuda.empty_cache()
    cpu_lg = run(cpu_params, "cpu")
    if not sensitivity:
        return errs(card_lg, cpu_lg), None
    emb = cpu_params["emb"]
    nudged = dict(cpu_params, emb=dict(emb, tok=emb["tok"] * (1 + 2 ** -23)))
    return errs(card_lg, cpu_lg), errs(run(nudged, "cpu"), cpu_lg)


def _zoo_smoke_tokens(arch, device):
    """The smoke config in float32 through ``Engine`` with CPU-generator
    weights: (the card's greedy tokens, the CPU's)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import Engine
    from repro_torch.models.api import model_fns

    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    params = model_fns(cfg).init(torch.Generator().manual_seed(SEED), cfg,
                                 device="cpu")
    prompts = np.random.default_rng(SEED).integers(0, cfg.vocab, (4, 16))
    out = []
    for p in (_to(params, device), params):
        engine = Engine(cfg, p, slots=4, max_seq=16 + 8)
        out.append(engine.run(prompts, 8)[0].cpu().tolist())
    return out


def zoo_phase(card):
    """Phase 10: xlstm-350m, whisper-tiny and zamba2-7b through the port's
    static ``Engine`` (see the module docstring); the hand-written
    kernels' launches over the phase, printed, not gated."""
    import gc

    from repro_torch.models.api import model_fns

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    device = torch.device("cuda")
    gen = torch.Generator(device=device)
    _zero_counts()
    cfg_z = _zoo_cfg(ZOO_HYBRID)
    zamba = _zoo_serve(card, cfg_z, device, gen, "zamba2-7b bf16",
                       lambda params, prompts: _zoo_continuation(
                           cfg_z, params, prompts, device))
    # the continuation at the same widths and depth in float32, where the
    # rounding noise is far below the gate
    cfg_f = _zoo_cfg(ZOO_HYBRID, "float32")
    params = model_fns(cfg_f).init(gen.manual_seed(SEED), cfg_f,
                                   device=device)
    prompts = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg_f.vocab, (ZOO_SLOTS, ZOO_PROMPT))).to(device, torch.int32)
    cont_f32 = _zoo_continuation(cfg_f, params, prompts, device)
    del params
    torch.cuda.empty_cache()
    tf = {"zamba2-7b f32 6 layers": _zoo_card_vs_cpu(
        _zoo_cfg(ZOO_HYBRID, "float32", n_layers=ZOO_CUT_LAYERS), device,
        gen)[0]}
    xlstm_f32 = _zoo_cfg(ZOO_SSM, "float32")
    tf["xlstm-350m f32"] = _zoo_card_vs_cpu(xlstm_f32, device, gen,
                                            prompt=XLSTM_TF_PROMPT)[0]
    chaos = dict(zip(("card_vs_cpu", "cpu_vs_cpu_one_ulp"), _zoo_card_vs_cpu(
        xlstm_f32, device, gen, sensitivity=True)))
    xlstm = _zoo_serve(card, _zoo_cfg(ZOO_SSM), device, gen, "xlstm bf16")
    tf["whisper-tiny f32"] = _zoo_card_vs_cpu(
        _zoo_cfg(ZOO_ENCDEC, "float32"), device, gen,
        frames_len=WHISPER_FRAMES, prompt=WHISPER_PROMPT)[0]
    whisper = _zoo_serve(card, _zoo_cfg(ZOO_ENCDEC), device, gen,
                         "whisper bf16")
    smoke = {arch: _zoo_smoke_tokens(arch, device)
             for arch in (ZOO_SSM, ZOO_HYBRID, ZOO_ENCDEC)}
    launches = _launch_counts()
    phase_s = time.perf_counter() - t_phase
    print(json.dumps({
        "phase": "zoo", "card": card, "phase_s": phase_s,
        "teacher_forced_rel_err": tf,
        "zamba2_continuation": {
            "bfloat16": {k: zamba[k] for k in ("continuation_rel_err",
                                               "chunk32_rel_diff")},
            "float32": cont_f32},
        f"xlstm_f32_at_{ZOO_TF_PROMPT}_prompt_tokens": chaos,
        "smoke_tokens_equal_cpu": {a: c == h for a, (c, h) in smoke.items()},
        "kernel_launches": launches,
        "cut": f"zamba2-7b f32 against the CPU at {ZOO_CUT_LAYERS} of 81 "
               f"layers (one shared application): the CPU side of the "
               f"full depth would take minutes; xlstm-350m f32 against the "
               f"CPU at {XLSTM_TF_PROMPT}-token prompts: its random sLSTM "
               f"recurrence grows a one-ulp difference to O(1) within 32 "
               f"steps (printed beside)"}), flush=True)
    check(cont_f32["continuation_rel_err"] <= TF_RTOL,
          f"zamba2-7b f32: prefill-then-decode vs the longer prefill "
          f"{cont_f32['continuation_rel_err']:.3e} > {TF_RTOL}")
    for name, per_step in tf.items():
        check(max(per_step) <= TF_RTOL,
              f"{name}, card vs CPU: teacher-forced logits "
              f"{max(per_step):.3e} > {TF_RTOL}")
    for arch, (on_card, on_cpu) in smoke.items():
        check(on_card == on_cpu, f"{arch} smoke: the card's greedy tokens "
              f"differ from the CPU's")
    return launches, {"zamba2-7b": zamba, "xlstm-350m": xlstm,
                      "whisper-tiny": whisper}


# --------------------------------------------------------------------------
# Phase 11: LM training -- every family's loss, the flash and recurrence
# backward passes, llama3.2-1b trained on the (1,1,1) grid
# --------------------------------------------------------------------------

def _lm_batch(cfg, batch, seq, device, seed=SEED):
    """Step 0 of the ported synthetic pipeline, on ``device``."""
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens, \
        to_torch
    return to_torch(SyntheticTokens(DataConfig(
        global_batch=batch, seq_len=seq, vocab=cfg.vocab, seed=seed,
        frames=cfg.family == "encdec", d_model=cfg.d_model,
        positions3d=cfg.family == "vlm")).batch_at(0), device)


def _lm_value_and_grads(cfg, params, batch, mesh=None):
    """(loss, gradients as a flat list) of ``cfg``'s family loss."""
    from torch.utils import _pytree as pytree

    from repro_torch.models.api import model_fns
    from repro_torch.train.step import _value_and_grad

    kw = {} if mesh is None else {"dist_mesh": mesh}
    loss, grads = _value_and_grad(
        lambda p, b: model_fns(cfg).loss(p, cfg, b, **kw), params, batch)
    return float(loss), pytree.tree_leaves(grads)


def _grad_rel(got, want) -> float:
    """The worst per-tensor max|g - g'| / max|g'|."""
    return max(float((g.float() - w.float()).abs().max())
               / max(float(w.float().abs().max()), 1e-30)
               for g, w in zip(got, want))


def lm_train_products(cfg, rows: int):
    """``(M, C, N)`` of every local product one grid train step runs on
    the ``(1,1,1)`` grid, as the code gives them: each projection of each
    layer forward, again under ``cfg.remat`` (the backward recomputes the
    block), and its dX ``g @ W^T`` and dW ``X^T @ g``; the vocabulary
    head is ``torch.matmul`` and launches no GEMM."""
    from repro_torch.dist.lm import lm_decode_matmuls

    out = []
    for name, m, c, n in lm_decode_matmuls(cfg, rows):
        if name == "lm_head":
            continue
        out += [(m, c, n)] * (2 if cfg.remat else 1) + [(m, n, c), (c, m, n)]
    return out * cfg.n_layers


def _lm_train_steps(cfg, params, batch, mesh, steps):
    """``steps`` AdamW steps of ``make_train_step`` from ``params``
    (``mode="dist-grid"`` on the grid with ``mesh``, else ``"gspmd"``,
    dense): per step the loss, the host ms to the synchronised end and
    every kernel's launches; the state and the step function."""
    from repro_torch.models.lm import loss_lm
    from repro_torch.train.optim import AdamW
    from repro_torch.train.step import init_train_state, make_train_step

    opt = AdamW(lr=LM_TRAIN_LR)
    step = make_train_step(
        lambda p, b: loss_lm(p, cfg, b, dist_mesh=mesh), opt,
        mode="gspmd" if mesh is None else "dist-grid")
    state = init_train_state(params, opt)
    out = []
    for _ in range(steps):
        _zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        loss = float(metrics["loss"])
        out.append((loss, (time.perf_counter() - t0) * 1e3,
                    _launch_counts()))
    return state, step, out


# the autograd nodes of the GEMM's backward: the grid's and the local one
GEMM_BACKWARD_NODES = ("_MatmulDistributedBackward", "_MatmulKernelBackward")


def _lm_step_trace(prof, events):
    """Read from one profiled grid train step: the GEMM's kernels
    (``tile_gemm`` and its split-K ``sum_splits``) over the whole trace,
    and the copies made inside the GEMM's backward (the operand
    transposes ``w.t().contiguous()``, ``x.t().contiguous()``, and
    ``g.contiguous()`` where the cotangent is strided), found by their
    place in the op tree."""
    from torch.autograd import DeviceType

    copies_us = 0.0
    for e in prof.events():
        if e.device_type != DeviceType.CPU or not e.kernels:
            continue
        chain, node = [], e
        while node is not None:
            chain.append(node.name)
            node = node.cpu_parent
        if (any(n in GEMM_BACKWARD_NODES for n in chain)
                and any(n in ("aten::contiguous", "aten::clone",
                              "aten::copy_") for n in chain)):
            copies_us += sum(k.duration for k in e.kernels)
    return {"gemm_device_ms": sum(ms for key, ms in events
                                  if "tile_gemm" in key
                                  or "sum_splits" in key),
            "gemm_backward_copy_device_ms": copies_us / 1e3}


def _lm_train_rank(rank):
    """Phase 11 (a): llama3.2-1b at full width and depth in float32,
    trained ``LM_TRAIN_STEPS`` steps on the one-rank (1,1,1) grid (the
    static plan) and dense from the same weights; step-1 gradients of
    both; one more grid step profiled; the transposes of the backward
    also timed alone, as a microbenchmark beside the trace's."""
    from repro_torch.dist.lm import lm_decode_matmuls
    from repro_torch.dist.matmul import make_matmul_mesh
    from repro_torch.kernels.autotune import autotune_disabled
    from repro_torch.models.lm import init_lm

    device = torch.device("cuda")
    cfg = _zoo_cfg(LM_TRAIN_ARCH, "float32")
    mesh = make_matmul_mesh((1, 1, 1), device=device)
    params = init_lm(torch.Generator(device=device).manual_seed(SEED), cfg,
                     device=device)
    batch = _lm_batch(cfg, LM_TRAIN_BATCH, LM_TRAIN_SEQ, device)
    out = {"params": sum(p.numel() for p in _leaves(params))}
    with autotune_disabled():   # the static paper plan: the GEMM
        _zero_counts()
        loss_g, grads_g = _lm_value_and_grads(cfg, params, batch, mesh)
        out["grad_pass_launches"] = _launch_counts()
        loss_d, grads_d = _lm_value_and_grads(cfg, params, batch)
        out["step1_loss"] = {"grid": loss_g, "dense": loss_d}
        out["step1_grad_rel_err"] = _grad_rel(grads_g, grads_d)
        out["grad_tensors"] = len(grads_g)
        del grads_g, grads_d
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state, step, grid = _lm_train_steps(cfg, params, batch, mesh,
                                            LM_TRAIN_STEPS)
        out["grid_peak_allocated_bytes"] = torch.cuda.max_memory_allocated()
        _zero_counts()
        out["profile"] = _profile(lambda: step(state, batch), 1,
                                  "train_steps", extra=_lm_step_trace)
        out["profiled_launches"] = _launch_counts()
        del state, step
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _, _, dense = _lm_train_steps(cfg, params, batch, None,
                                      LM_TRAIN_STEPS)
        out["dense_peak_allocated_bytes"] = torch.cuda.max_memory_allocated()
    out["grid"], out["dense"] = grid, dense
    # microbenchmark: the backward's operand transposes
    # (``w.t().contiguous()``, ``x.t().contiguous()``) on random tensors,
    # each timed alone on the device
    gen = torch.Generator(device=device).manual_seed(SEED + 11)
    rows = LM_TRAIN_BATCH * LM_TRAIN_SEQ
    transpose_ms = 0.0
    for name, m, c, n in lm_decode_matmuls(cfg, rows):
        if name == "lm_head":
            continue
        w = torch.randn(c, n, generator=gen, device=device)
        x = torch.randn(m, c, generator=gen, device=device)
        transpose_ms += cfg.n_layers * (
            device_ms(lambda: w.t().contiguous())
            + device_ms(lambda: x.t().contiguous()))
        del w, x
    out["transposes_alone_device_ms"] = transpose_ms
    del params
    torch.cuda.empty_cache()
    return out


def _lm_train_kernel_rows(cfg, device):
    """Phase 11 (b): the GEMM against its plain version and
    ``torch.matmul`` at every distinct product of a grid train step
    (forward, dX, dW of each projection), each named with its count per
    step; and their sums over one step."""
    from collections import Counter

    from repro_torch.kernels.matmul import matmul, matmul_plain

    gen = torch.Generator(device=device).manual_seed(SEED + 12)
    counts = Counter(lm_train_products(cfg, LM_TRAIN_BATCH * LM_TRAIN_SEQ))
    rows, step = [], dict.fromkeys(("kernel_ms", "kernel_device_ms",
                                    "plain_ms", "library_ms",
                                    "library_device_ms", "bound_ms"), 0.0)
    for (m, c, n), count in sorted(counts.items()):
        x = torch.randn(m, c, generator=gen, device=device)
        w = torch.randn(c, n, generator=gen, device=device)
        row = gemm_row(f"train_lm {LM_TRAIN_ARCH} float32 x{count} "
                       f"[{m},{c}]@[{c},{n}]", matmul, matmul_plain,
                       torch.matmul, x, w,
                       extra={"route": "tile", "count": count,
                              "path": "train_lm"})
        rows.append(row)
        for key in step:
            step[key] += count * row[key]
        del x, w
    step["bound_share"] = step["bound_ms"] / step["kernel_ms"]
    step["launches"] = sum(counts.values())
    return rows, step


def _flash_on_card(device):
    """Phase 11 (c): the flash ``autograd.Function`` at llama's heads,
    batch 1, S = FLASH_SEQ, float32, against autograd through the plain
    ``attention_scores`` path (k, v expanded, the [S,S] logits
    materialised): output and dq, dk, dv; both timed forward + backward."""
    from repro_torch.models import layers as L

    cfg = _zoo_cfg(LM_TRAIN_ARCH, "float32")
    s, hd = FLASH_SEQ, cfg.head_dim
    gen = torch.Generator(device=device).manual_seed(SEED + 13)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device=device)

    q, g = rand(1, s, cfg.n_heads, hd), rand(1, s, cfg.n_heads, hd)
    k, v = rand(1, s, cfg.n_kv_heads, hd), rand(1, s, cfg.n_kv_heads, hd)
    scale = hd ** -0.5
    rep = cfg.n_heads // cfg.n_kv_heads

    def flash(q, k, v):
        return L.flash_attention(q, k, v, 0, True, scale, 512, 1024)

    def plain(q, k, v):
        return L.attention_scores(
            q, L._repeat_kv(k, rep), L._repeat_kv(v, rep),
            mask=L.make_mask(s, s, causal=True, device=device), scale=scale)

    def fwd_bwd(fn):
        ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = fn(*ins)
        return [out.detach()] + list(torch.autograd.grad(out, ins, g))

    got, want = fwd_bwd(flash), fwd_bwd(plain)
    errs = {name: float((a - b).abs().max()) / float(b.abs().max())
            for name, a, b in zip(("out", "dq", "dk", "dv"), got, want)}
    del got, want
    out = {"seq": s, "heads": [cfg.n_heads, cfg.n_kv_heads, hd],
           "rel_err": errs,
           "flash_fwd_bwd_ms": time_ms(lambda: fwd_bwd(flash), iters=3,
                                       warmup=1, repeats=3),
           "plain_fwd_bwd_ms": time_ms(lambda: fwd_bwd(plain), iters=3,
                                       warmup=1, repeats=3)}
    torch.cuda.empty_cache()
    return out


LM_CARD_VS_CPU = (("llama3.2-1b", 16), ("granite-moe-1b-a400m", 16),
                  ("qwen2-vl-72b", 16), ("xlstm-350m", 8),
                  ("zamba2-7b", 32), ("whisper-tiny", 16))


def _lm_card_vs_cpu(device):
    """Phase 11 (d): every family's smoke config in float32, the loss and
    gradients on the card against the CPU (plain versions), the same
    CPU-generator weights and batch (xlstm-350m at 8 tokens: its random
    sLSTM is chaotic)."""
    from repro_torch.configs import get_config
    from repro_torch.models.api import model_fns

    out = {}
    for arch, seq in LM_CARD_VS_CPU:
        cfg = dataclasses.replace(get_config(arch, smoke=True),
                                  dtype="float32")
        params = model_fns(cfg).init(torch.Generator().manual_seed(SEED),
                                     cfg, device="cpu")
        batch = _lm_batch(cfg, 2, seq, "cpu")
        loss_c, grads_c = _lm_value_and_grads(cfg, params, batch)
        loss_g, grads_g = _lm_value_and_grads(
            cfg, _to(params, device), {k: v.to(device)
                                       for k, v in batch.items()})
        out[arch] = {"seq": seq, "loss_rel_err": abs(loss_g - loss_c)
                     / abs(loss_c),
                     "grad_rel_err": _grad_rel([g.cpu() for g in grads_g],
                                               grads_c),
                     "finite": bool(np.isfinite(loss_g))}
    return out


def _lm_cli_start():
    """Phase 11 (e): ``launch.train --mesh host`` on the card in a
    subprocess, started here and read by :func:`_lm_cli_finish`:
    llama3.2-1b at full width in its own dtype (bfloat16), dense, its
    output to a file."""
    args = ["--mesh", "host", "--arch", LM_TRAIN_ARCH, "--steps", "4",
            "--batch", str(LM_TRAIN_BATCH), "--seq", str(LM_TRAIN_SEQ),
            "--log-every", "1"]
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent
                                          / "src"))
    out = tempfile.TemporaryFile(mode="w+")
    proc = subprocess.Popen([sys.executable, "-m",
                             "repro_torch.launch.train", *args],
                            stdout=out, stderr=subprocess.STDOUT, text=True,
                            env=env)
    return proc, out, args, time.perf_counter()


def _lm_cli_finish(started):
    """Wait for the CLI run; its exit, wall time and per-step losses."""
    proc, out, args, t0 = started
    try:
        rc = proc.wait(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    wall = time.perf_counter() - t0
    out.seek(0)
    text = out.read()
    out.close()
    check(rc == 0, f"launch.train --mesh host exited {rc}:\n"
          f"{text[-3000:]}")
    losses = [float(x) for x in re.findall(r"^step +\d+ loss (\S+)", text,
                                           re.M)]
    return {"args": " ".join(args), "wall_s": wall, "losses": losses}


def lm_train_phase(card):
    """Phase 11 (see the module docstring).  Returns each kernel's
    launches over the grid's timed train steps, the training-product rows
    and their sums over one step."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    device = torch.device("cuda")
    from repro_torch.dist.spawn import run_spmd

    r = run_spmd(_lm_train_rank, 1)[0]
    cfg = _zoo_cfg(LM_TRAIN_ARCH, "float32")
    rows_per_step = len(lm_train_products(cfg, LM_TRAIN_BATCH
                                          * LM_TRAIN_SEQ))
    # the CLI's start-up and weights take ~20 s of mostly host time: it
    # runs beside the CPU-bound comparisons, before anything is timed
    cli = _lm_cli_start()
    try:
        card_cpu = _lm_card_vs_cpu(device)
    finally:
        cli = _lm_cli_finish(cli)
    flash = _flash_on_card(device)
    kernel_rows, kernel_step = _lm_train_kernel_rows(cfg, device)
    phase_s = time.perf_counter() - t_phase
    grid, dense = r["grid"], r["dense"]
    p50 = statistics.median(s[1] for s in grid)
    tokens = LM_TRAIN_BATCH * LM_TRAIN_SEQ
    prof = r["profile"]
    busy = prof["device_busy_ms"]
    print(json.dumps({
        "phase": "lm_train", "card": card, "arch": LM_TRAIN_ARCH,
        "dtype": "float32", "grid": [1, 1, 1], "plan": "static",
        "params": r["params"], "batch": [LM_TRAIN_BATCH, LM_TRAIN_SEQ],
        "remat": cfg.remat, "lr": LM_TRAIN_LR,
        "grid_losses": [s[0] for s in grid],
        "dense_losses": [s[0] for s in dense],
        "grid_step_ms": [s[1] for s in grid],
        "dense_step_ms": [s[1] for s in dense],
        "grid_p50_step_ms": p50,
        "dense_p50_step_ms": statistics.median(s[1] for s in dense),
        "tokens_per_s": tokens / p50 * 1e3,
        "launches_per_step": [s[2] for s in grid],
        "gemm_launches_derived": rows_per_step,
        "dense_launches_per_step": [s[2] for s in dense],
        "step1_loss": r["step1_loss"],
        "step1_grad_rel_err": r["step1_grad_rel_err"],
        "grad_tensors": r["grad_tensors"],
        "device_busy_ms_per_step": busy,
        "profiled_step_wall_ms": prof["wall_ms"],
        "top_device_ms": prof["top_device_ms"],
        "trace_gemm_device_ms": prof["gemm_device_ms"],
        "trace_gemm_share_of_device_busy": prof["gemm_device_ms"] / busy,
        "trace_gemm_backward_copy_device_ms":
            prof["gemm_backward_copy_device_ms"],
        "trace_gemm_backward_copy_share_of_device_busy":
            prof["gemm_backward_copy_device_ms"] / busy,
        "microbenchmark_gemm_rows_device_ms": kernel_step["kernel_device_ms"],
        "microbenchmark_transposes_alone_device_ms":
            r["transposes_alone_device_ms"],
        "gemm_step_sums": kernel_step,
        "grid_peak_allocated_bytes": r["grid_peak_allocated_bytes"],
        "dense_peak_allocated_bytes": r["dense_peak_allocated_bytes"],
        "flash_backward": flash, "card_vs_cpu": card_cpu, "cli": cli, "phase_s": phase_s}),
        flush=True)
    for i, ((lg, _, _), (ld, _, _)) in enumerate(zip(grid, dense)):
        check(abs(lg - ld) <= LOSS_RTOL * abs(ld),
              f"llama train step {i + 1}: grid loss {lg} vs dense {ld}")
    check(r["step1_grad_rel_err"] <= GRAD_RTOL,
          f"llama step-1 gradients, grid vs dense: "
          f"{r['step1_grad_rel_err']:.3e} > {GRAD_RTOL}")
    # every grid pass launches the tile GEMM as often as the code gives
    # and no other kernel; the dense steps launch none
    want = dict(dict.fromkeys(r["grad_pass_launches"], 0),
                matmul=rows_per_step)
    for name, launches in [("grad pass", r["grad_pass_launches"]),
                           ("profiled step", r["profiled_launches"])] + [
            (f"grid step {i + 1}", s[2]) for i, s in enumerate(grid)]:
        check(launches == want, f"llama train, {name}: launches "
              f"{launches}, the code gives {want}")
    check(all(not any(s[2].values()) for s in dense),
          f"the dense steps launched a kernel: {[s[2] for s in dense]}")
    check(prof["gemm_device_ms"] > 0,
          "the profiled grid step shows no tile GEMM on the device")
    for name, err in flash["rel_err"].items():
        check(err <= KERNEL_RTOL, f"flash attention at S = {FLASH_SEQ}: "
              f"{name} {err:.3e} > {KERNEL_RTOL}")
    for arch, e in card_cpu.items():
        check(e["finite"] and e["loss_rel_err"] <= LOSS_RTOL
              and e["grad_rel_err"] <= GRAD_RTOL,
              f"{arch} smoke loss, card vs CPU: {e}")
    check(len(cli["losses"]) == 4 and all(np.isfinite(cli["losses"])),
          f"launch.train --mesh host losses {cli['losses']}")
    return ({name: sum(s[2][name] for s in grid) for name in want},
            kernel_rows, kernel_step)


# --------------------------------------------------------------------------
# Phase 12: the schedule verifier at full width, memory against Eq. 11
# --------------------------------------------------------------------------

def _verify_specs():
    """Every distinct conv of the CNN and its head, on one rank, in the
    three schedules x {fwd + train, train with save_gathered}."""
    from repro_torch.analysis import verify

    specs, seen = [], set()
    for c, k, h in conv_layers():
        if (c, k, h) in seen:
            continue
        seen.add((c, k, h))
        for sched in VERIFY_SCHEDULES:
            kw = dict(x_shape=(BATCH, c, h, h), w_shape=(k, c, 3, 3))
            specs += [verify.conv_cell((1,) * 5, sched, **kw),
                      verify.conv_cell((1,) * 5, sched, save_gathered=True,
                                       include_fwd=False, **kw)]
    mcn = (BATCH, CHANNELS[-1], N_CLASSES)
    for sched in VERIFY_SCHEDULES:
        specs += [verify.matmul_cell((1, 1, 1), sched, mcn=mcn),
                  verify.matmul_cell((1, 1, 1), sched, mcn=mcn,
                                     save_gathered=True, include_fwd=False)]
    return specs


def _verify_launches():
    """The phase's launches as the code gives them, per schedule: a conv
    whose C tiles runs the direct conv forward and, in either backward,
    at dIn and dKer (3 a train variant); the C = 3 layer runs cuDNN
    forward and at dIn (K = 3 there), the direct conv at the custom
    backward's dKer only (cuDNN's own backward under save_gathered).
    The head runs the tile GEMM forward, at dX and at dW."""
    tiling = {(c, k, h) for c, k, h in conv_layers() if c % 8 == 0}
    first = {(c, k, h) for c, k, h in conv_layers()} - tiling
    n = len(VERIFY_SCHEDULES)
    return {"conv2d": n * (7 * len(tiling) + len(first)),
            "matmul": n * 7, "skinny_gemm": 0, "wino_gemm": 0}


def verify_phase(card):
    """Phase 12 (see the module docstring).  Returns the phase's launches
    of each kernel."""
    import gc

    from repro_torch.analysis import astlint, doclint, verify

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    ast_found = astlint.lint_tree(astlint.default_root())
    doc_found = doclint.lint_tree(doclint.default_root())
    check(not ast_found, "astlint: " + "; ".join(map(str, ast_found)))
    check(not doc_found, "doclint: " + "; ".join(map(str, doc_found)))
    specs = _verify_specs()
    _zero_counts()
    reports = verify.run_specs(specs)   # one rank on the card, nccl
    torch.cuda.synchronize()
    launches = _launch_counts()
    phase_s = time.perf_counter() - t_phase
    cells = [{"cell": r.name, "wire_bytes": r.wire_bytes,
              "analytic_wire_bytes": r.analytic_wire_bytes,
              "wire_ratio": r.wire_ratio, "live_bytes": r.live_bytes,
              "analytic_bytes": r.analytic_mem_bytes,
              "mem_ratio": r.mem_ratio, "band": r.mem_band, "ok": r.ok,
              "findings": [str(f) for f in r.findings]} for r in reports]
    print(json.dumps({"phase": "verify", "card": card,
                      "grids": [[1] * 5, [1, 1, 1]], "batch": BATCH,
                      "cells": cells, "n_cells": len(cells),
                      "astlint_findings": len(ast_found),
                      "doclint_findings": len(doc_found),
                      "launches": launches, "seconds": phase_s}),
          flush=True)
    failed = [c for c in cells if not c["ok"]]
    check(not failed, f"verify: {len(failed)} cells failed: "
          + "; ".join(f"{c['cell']}: {c['findings']}" for c in failed))
    check(all(r.live_bytes is not None and r.mem_ratio is not None
              for r in reports), "verify: a cell's memory was not read")
    want = _verify_launches()
    check(launches == want, f"verify launches {launches} != {want}")
    return launches


def kernel_entry(name, source, replaces, jax_function, rows, path_rows,
                 launches, by_path):
    """One kernel's line: errors over every shape checked, times summed
    over the shapes one train step gives it on its mode's path."""
    bound_ops = sum(r["bound_ms"] for r in path_rows
                    if r["bound_by"] == "operations")
    bound_bytes = sum(r["bound_ms"] for r in path_rows
                      if r["bound_by"] == "bytes")
    kernel_ms = sum(r["kernel_ms"] for r in path_rows)
    by_direction = {}
    for r in path_rows:
        if "direction" in r:
            d = by_direction.setdefault(r["direction"], {
                "kernel_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0})
            for key in d:
                d[key] += r[key]
    extra = {"ms_by_direction": by_direction} if by_direction else {}
    if all("ffma_bound_ms" in r for r in path_rows):
        extra["ffma_bound_ms"] = sum(r["ffma_bound_ms"] for r in path_rows)
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "jax_function": jax_function,
            "launches": launches, "launches_by_path": by_path,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "max_rel_err": max(r["rel_err"] for r in rows),
            "ms": kernel_ms, "kernel_ms": kernel_ms,
            "plain_ms": sum(r["plain_ms"] for r in path_rows),
            "bound_ms": bound_ops + bound_bytes,
            "bound_by": "operations" if bound_ops >= bound_bytes
            else "bytes",
            "library_ms": sum(r["library_ms"] for r in path_rows),
            "bound_share": (bound_ops + bound_bytes) / kernel_ms,
            **{key: sum(r[key] for r in path_rows)
               for key in ("kernel_device_ms", "library_device_ms",
                           "kernel_host_ms", "library_host_ms")},
            **extra}


def skinny_entry(rows, step, launches, by_path):
    """The skinny GEMM's line: errors over every serving shape checked in
    both dtypes, times summed over one bfloat16 decode step of
    llama3.2-1b (each product times its count: this slice's main path),
    the float32 step beside them."""
    bf = [r for r in rows if r["dtype"] == "bfloat16"]
    f32 = [r for r in rows if r["dtype"] == "float32"]
    main_step = step[f"{SERVE_ARCH} bfloat16"]
    return {"name": "skinny_gemm", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/skinny_gemm.cu",
            "replaces": "src/repro/kernels/matmul.py:43",
            "jax_function": "matmul_pallas",
            "launches": launches, "launches_by_path": by_path,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "max_rel_err_bfloat16": max(r["rel_err"] for r in bf),
            "max_rel_err_float32": max(r["rel_err"] for r in f32),
            "ms": main_step["kernel_ms"],
            "device_ms": main_step["kernel_device_ms"],
            "plain_ms": main_step["plain_ms"],
            "bound_ms": main_step["bound_ms"], "bound_by": "bytes",
            "library_ms": main_step["library_ms"],
            "library_device_ms": main_step["library_device_ms"],
            "per": f"one decode step of {SERVE_ARCH} in bfloat16, "
                   f"{SERVE_SLOTS} slots",
            "decode_step": step}


_T_START = time.perf_counter()


def _clock(after: str) -> None:
    """The script's wall seconds so far, printed after each phase."""
    print(json.dumps({"phase": "clock", "after": after, "elapsed_s":
                      time.perf_counter() - _T_START}), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.device import resolve_device
    from repro_torch.kernels import _build

    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    device = resolve_device()  # pins TF32 off for the library timings

    t0 = time.perf_counter()
    _build.load()
    print(f"build: {time.perf_counter() - t0:.1f} s -> "
          f"{_build.library_path().name}", flush=True)
    for log in sorted(_build.BUILD_DIR.glob("*.log")):
        print(log.read_text(), flush=True)
    _clock("build")

    rows, path, conv_infer, bf16 = kernel_phase(device)
    print(json.dumps({"phase": "kernels", "conv2d_infer_ms": sum(
        r["kernel_ms"] for r in conv_infer)}), flush=True)
    for name, extra in resnet50_phase(device).items():
        rows[name] += extra
    _clock("kernels")
    infer = slice_phase()
    train, static = train_phase(card)
    _clock("train")
    resilient, resilient_ms = resilient_phase(card, train["static"],
                                              static["p50"])
    warm = warm_phase()
    synthesis_phase()
    _clock("resilient, warm, synthesis")
    serve_rows, serve_step = serve_kernel_phase(device)
    rows["matmul"] += serve_rows["tile"]
    serve, serve_stats = serve_phase(card)
    _clock("serve")
    perf = perf_phase(card, dict(rows, skinny=serve_rows["skinny"]),
                      static, resilient_ms, serve_stats)
    zoo, _ = zoo_phase(card)
    _clock("perf, zoo")
    train_lm, train_lm_rows, train_lm_step = lm_train_phase(card)
    rows["matmul"] += train_lm_rows
    _clock("lm_train")
    verified = verify_phase(card)
    _clock("verify")

    def by_path(name):
        counts = {"infer": infer.get(name, 0),
                  **{f"train_{m}": train[m][name]
                     for m in MODES + (SG_MODE,)},
                  "train_resilient": resilient[name],
                  "warm": warm[name], "perf": perf[name],
                  "zoo": zoo[name],
                  "train_lm": train_lm[name], "verify": verified[name]}
        counts.update(serve.get(name, dict.fromkeys(serve["matmul"], 0)))
        return counts

    skinny = by_path("skinny_gemm")
    tile = {p: n - skinny[p] for p, n in by_path("matmul").items()}

    kernels = [
        kernel_entry("conv2d_direct", "src/repro_torch/kernels/csrc/conv2d.cu",
                     "src/repro/kernels/conv2d.py:77", "conv2d_pallas",
                     rows["conv2d"], path["conv2d"],
                     train["static"]["conv2d"], by_path("conv2d")),
        dict(kernel_entry("matmul_tiled",
                          "src/repro_torch/kernels/csrc/gemm.cu",
                          "src/repro/kernels/matmul.py:43", "matmul_pallas",
                          rows["matmul"], path["matmul"],
                          train["static"]["matmul"], tile),
             serve_rows=[r["shape"] for r in serve_rows["tile"]],
             train_lm_rows=[r["shape"] for r in train_lm_rows],
             train_lm_step=train_lm_step),
        skinny_entry(serve_rows["skinny"], serve_step,
                     serve["skinny_gemm"]["serve_bf16"], skinny),
        kernel_entry("wino_gemm",
                     "src/repro_torch/kernels/csrc/wino_gemm.cu",
                     "src/repro/kernels/winograd.py:79", "wino_gemm_pallas",
                     rows["wino_gemm"], path["wino_gemm"],
                     train["winograd"]["wino_gemm"], by_path("wino_gemm")),
    ]
    for entry in kernels:   # the bf16 rows of the conv and the tile GEMM
        name = {"conv2d_direct": "conv2d"}.get(entry["name"], entry["name"])
        if name in bf16:
            entry["bfloat16"] = {key: bf16[name][key] for key in (
                "shape", "rel_err", "kernel_ms", "kernel_device_ms",
                "library_ms", "bound_ms", "widen_ms") if key in bf16[name]}
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
