#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. the card: ``nvidia-smi`` name and power limit, ``torch.cuda`` name;
2. build: ``nvcc`` compiles the kernels in ``src/repro_torch/kernels/csrc``
   for ``sm_90a`` (into the git-ignored ``kernels/build``);
3. kernel vs plain: each hand-written kernel against its plain PyTorch
   version on the card at every shape the CNN's forward and train step
   give it (the direct conv at the forward, dIn and dKer shapes, the
   tiled GEMM at the head's three products, Winograd's batched tile GEMM
   at the forward, dIn and dv/du shapes), with its time, the plain
   version's time, one PyTorch library call's time (TF32 off) and the
   least time the card could take (f32 operations over the H100's
   67 TFLOP/s non-tensor peak, or bytes over 3.35 TB/s, whichever is
   larger);
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
   gradients.

The last lines are the card line, one JSON line of per-kernel results
and ``{"ok": true, "device": {...}}``.  Without a CUDA device it exits
with code 2 and prints no result.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

F32_PEAK_FLOPS = 67e12      # H100 SXM, float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
KERNEL_RTOL = 1e-4   # max|kernel - plain| / max|plain|, f32 sums reordered
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


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"FAIL: {msg}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` over ``iters`` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops: float, nbytes: float):
    """(least ms, what bounds it) on an H100 at full power."""
    ops_ms, bytes_ms = flops / F32_PEAK_FLOPS * 1e3, \
        nbytes / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), \
        ("operations" if ops_ms >= bytes_ms else "bytes")


def conv_layers():
    """(C, K, H) of every conv of the CNN, in order."""
    out, cin, h = [], IN_CHANNELS, HW
    for i, cout in enumerate(CHANNELS):
        out.append((cin, cout, h))
        cin = cout
        if (i + 1) % POOL_EVERY == 0:
            h //= 2
    return out


def compare_kernel(name, kernel, plain, library, args, flops, nbytes):
    out = kernel(*args)
    ref = plain(*args)
    torch.cuda.synchronize()
    check(out.shape == ref.shape and bool(torch.isfinite(out).all()),
          f"{name}: shape {tuple(out.shape)} or non-finite values")
    abs_err = float((out - ref).abs().max())
    rel = abs_err / float(ref.abs().max())
    check(rel <= KERNEL_RTOL, f"{name}: max|d|/max|ref| {rel:.3e} > "
          f"{KERNEL_RTOL}")
    lib = library(*args)
    torch.cuda.synchronize()
    check(float((lib - ref).abs().max()) / float(ref.abs().max())
          <= KERNEL_RTOL, f"{name}: the library call disagrees")
    bms, by = bound(flops, nbytes)
    row = {"shape": name, "max_abs_err": abs_err, "rel_err": rel,
           "kernel_ms": time_ms(lambda: kernel(*args)),
           "plain_ms": time_ms(lambda: plain(*args), iters=3, warmup=1),
           "library_ms": time_ms(lambda: library(*args)),
           "bound_ms": bms, "bound_by": by}
    print(json.dumps(row), flush=True)
    return row


def conv_row(name, x, w):
    """Kernel vs plain vs ``F.conv2d`` for one stride-1 VALID conv."""
    from repro_torch.kernels.conv2d import conv2d, conv2d_plain

    n, c, h, wd = x.shape
    k, _, kh, kw = w.shape
    ho, wo = h - kh + 1, wd - kw + 1
    return compare_kernel(
        name, lambda a, b: conv2d(a, b, padding="VALID"),
        lambda a, b: conv2d_plain(a, b, padding="VALID"), F.conv2d, (x, w),
        2.0 * n * k * c * ho * wo * kh * kw,
        4.0 * (x.numel() + w.numel() + n * k * ho * wo))


def gemm_row(name, kernel, plain, library, a, b):
    """Kernel vs plain vs library for one (batched) GEMM."""
    t = a.shape[0] if a.dim() == 3 else 1
    m, kk = a.shape[-2:]
    n = b.shape[-1]
    return compare_kernel(name, kernel, plain, library, (a, b),
                          2.0 * t * m * kk * n,
                          4.0 * t * (m * kk + kk * n + m * n))


def kernel_phase(device):
    """Every kernel at every shape of the CNN; returns, per kernel, all
    rows and the rows of one train step on its mode's path (``static``
    for the conv and the GEMM, ``winograd`` for the tile GEMM), and the
    conv rows of one dist-path forward."""
    from repro_torch.kernels.conv2d import conv2d, conv2d_plain
    from repro_torch.kernels.matmul import matmul, matmul_plain
    from repro_torch.kernels.winograd import (wino_gemm, wino_gemm_einsum,
                                              wino_gemm_plain)

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
                           f"H=W={h + 2}", xw, w)
            conv_infer.append(row)
            # dIn: the cotangent padded by 2 against the flipped,
            # O/I-swapped kernel
            gp = F.pad(g, (2, 2, 2, 2))
            wt = w.flip(2, 3).transpose(0, 1).contiguous()
            din = conv_row(f"conv dIn N={BATCH} C={k} K={c} H=W={h + 4}",
                           gp, wt)
            path["conv2d"] += [row, din]
        # dKer: the N/C-transposed VALID conv, the cotangent as kernel
        dker = conv_row(f"conv dKer N={c} C={BATCH} K={k} H=W={h + 2} "
                        f"kernel {h}x{h}", xw.transpose(0, 1).contiguous(),
                        g.transpose(0, 1).contiguous())
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
            row = gemm_row(f"wino_gemm {what} [16,{tpc[1]},{tpc[2]}]@"
                           f"[16,{tck[1]},{tck[2]}] (C={c} K={k} H={h})",
                           wino_gemm, wino_gemm_plain, wino_gemm_einsum,
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
    return rows, path, conv_infer


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


def _profile(run, count: int, label: str):
    """Device time by kernel over ``count`` calls of ``run()``, and the
    share of the wall time the device was busy (``torch.profiler``)."""
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
    return {label: count, "wall_ms": wall_ms,
            "device_busy_ms": busy_ms, "device_busy_share": busy_ms / wall_ms,
            "top_device_ms": [[k[:60], ms] for k, ms in top]}


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


def _loss_and_grads(params, batch, mesh, decisions=None, record=False):
    """The step's loss and its gradients (flattened leaves) on the grid;
    on the branch in ``decisions`` (see :func:`_pinned_branch`) when
    given."""
    from torch.utils import _pytree as pytree

    from repro_torch.models.cnn import loss_cnn

    leaves, spec = pytree.tree_flatten(params)
    leaves = [t.detach().requires_grad_(True) for t in leaves]
    with (_pinned_branch(decisions, record) if decisions is not None
          else contextlib.nullcontext()):
        loss = loss_cnn(pytree.tree_unflatten(leaves, spec), batch,
                        dist_mesh=mesh)
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
    from repro_torch.kernels.conv2d import conv2d
    from repro_torch.kernels.matmul import matmul
    from repro_torch.kernels.winograd import wino_gemm
    return {"conv2d": conv2d.launches, "matmul": matmul.launches,
            "wino_gemm": wino_gemm.launches}


def _zero_counts():
    from repro_torch.kernels.conv2d import conv2d
    from repro_torch.kernels.matmul import matmul
    from repro_torch.kernels.winograd import wino_gemm
    conv2d.launches = matmul.launches = wino_gemm.launches = 0


def _train_mode(params, batch, small, mesh, step, opt, branches, record):
    from torch.utils import _pytree as pytree

    from repro_torch.dist.train import init_grid_train_state

    loss1, grads1 = _loss_and_grads(params, batch, mesh,
                                    branches["batch"], record)
    small_loss, small_grads = _loss_and_grads(params, small, mesh,
                                              branches["small"], record)
    step(init_grid_train_state(params, opt), batch)  # warm-up (and tuning)
    torch.cuda.synchronize()

    _zero_counts()
    states = [init_grid_train_state(params, opt)]
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
    check(all(bool(torch.isfinite(t).all())
              for t in pytree.tree_leaves(states[-1].params)),
          "non-finite parameters after the train steps")
    update = _update_errs(states, losses, batch, mesh, opt)
    start = init_grid_train_state(params, opt)
    profile = _profile(lambda: step(start, batch), 1, "steps")
    return {"loss1": loss1, "grads1": grads1, "small_loss": small_loss,
            "small_grads": small_grads, "losses": losses,
            "grad_norms": grad_norms, "step_ms": step_ms,
            "launches": launches, "update": update, "profile": profile}


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


def _update_errs(states, losses, batch, mesh, opt):
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
        loss, grads = _loss_and_grads(prev.params, batch, mesh)
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

    with tempfile.TemporaryDirectory() as cache_dir:
        res = run_spmd(_train_rank, 1, cache_dir)[0]
    t0 = time.perf_counter()
    cpu_loss, cpu_grads = run_spmd(_cpu_train_rank, 1, res["small_branch"],
                                   device="cpu")[0]
    cpu_s = time.perf_counter() - t0

    want = {"static": ("conv2d", "matmul"),
            "winograd": ("wino_gemm", "conv2d", "matmul")}
    ref = res["static"]
    for mode in MODES:
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
    return {mode: res[mode]["launches"] for mode in MODES}


def kernel_entry(name, source, replaces, jax_function, rows, path_rows,
                 launches, by_path):
    """One kernel's line: errors over every shape checked, times summed
    over the shapes one train step gives it on its mode's path."""
    bound_ops = sum(r["bound_ms"] for r in path_rows
                    if r["bound_by"] == "operations")
    bound_bytes = sum(r["bound_ms"] for r in path_rows
                      if r["bound_by"] == "bytes")
    kernel_ms = sum(r["kernel_ms"] for r in path_rows)
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
            "library_ms": sum(r["library_ms"] for r in path_rows)}


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

    rows, path, conv_infer = kernel_phase(device)
    print(json.dumps({"phase": "kernels", "conv2d_infer_ms": sum(
        r["kernel_ms"] for r in conv_infer)}), flush=True)
    infer = slice_phase()
    train = train_phase(card)

    def by_path(name):
        return {"infer": infer.get(name, 0),
                **{f"train_{m}": train[m][name] for m in MODES}}

    kernels = [
        kernel_entry("conv2d_direct", "src/repro_torch/kernels/csrc/conv2d.cu",
                     "src/repro/kernels/conv2d.py:77", "conv2d_pallas",
                     rows["conv2d"], path["conv2d"],
                     train["static"]["conv2d"], by_path("conv2d")),
        kernel_entry("matmul_tiled", "src/repro_torch/kernels/csrc/gemm.cu",
                     "src/repro/kernels/matmul.py:43", "matmul_pallas",
                     rows["matmul"], path["matmul"],
                     train["static"]["matmul"], by_path("matmul")),
        kernel_entry("wino_gemm", "src/repro_torch/kernels/csrc/gemm.cu",
                     "src/repro/kernels/winograd.py:79", "wino_gemm_pallas",
                     rows["wino_gemm"], path["wino_gemm"],
                     train["winograd"]["wino_gemm"], by_path("wino_gemm")),
    ]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
