#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. the card: ``nvidia-smi`` name and power limit, ``torch.cuda`` name;
2. build: ``nvcc`` compiles the kernels in ``src/repro_torch/kernels/csrc``
   for ``sm_90a`` (into the git-ignored ``kernels/build``);
3. kernel vs plain: each hand-written kernel against its plain PyTorch
   version on the card at every shape the CNN gives it, with its time,
   the plain version's time, one PyTorch library call's time (TF32 off)
   and the least time the card could take (f32 operations over the
   H100's 67 TFLOP/s non-tensor peak, or bytes over 3.35 TB/s, whichever
   is larger);
4. the slice at full width: the repro CNN at ResNet-50's 3x3 stage widths
   (channels 64..512, 3 input channels, 1000 classes, batch 64, 56x56)
   answers batches of images through ``forward_cnn(dist_mesh=...)`` on a
   one-rank (1,1,1,1,1) grid, and one through the dense path; the
   kernels' launch counts show the path went through them, and the
   logits agree with the same forward on the CPU (plain versions).

The last lines are the card line, one JSON line of per-kernel results
and ``{"ok": true, "device": {...}}``.  Without a CUDA device it exits
with code 2 and prints no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
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


def kernel_phase(device):
    from repro_torch.kernels.conv2d import conv2d, conv2d_plain
    from repro_torch.kernels.matmul import matmul, matmul_plain

    gen = torch.Generator().manual_seed(SEED)

    def rand(*shape):
        return torch.randn(*shape, generator=gen).to(device)

    conv_rows, conv_path = [], []
    for i, (c, k, h) in enumerate(conv_layers()):
        # dense path: SAME on the plane (layer 0 included); dist path:
        # VALID on the window with one halo row each side (C % 8 == 0)
        cases = [("SAME", h)] + ([("VALID", h + 2)] if c % 8 == 0 else [])
        for padding, hin in cases:
            x, w = rand(BATCH, c, hin, hin), rand(k, c, 3, 3)
            ho = h
            row = compare_kernel(
                f"conv {padding} N={BATCH} C={c} K={k} H=W={hin}",
                lambda a, b, p=padding: conv2d(a, b, padding=p),
                lambda a, b, p=padding: conv2d_plain(a, b, padding=p),
                lambda a, b, p=padding: F.conv2d(
                    a, b, padding=1 if p == "SAME" else 0),
                (x, w), 2.0 * BATCH * k * c * ho * ho * 9,
                4.0 * (x.numel() + w.numel() + BATCH * k * ho * ho))
            conv_rows.append(row)
            if padding == "VALID":
                conv_path.append(row)
            del x, w
    mm_rows = []
    for m, kk, n in [(BATCH, CHANNELS[-1], N_CLASSES), (65, 520, 1000)]:
        x, w = rand(m, kk), rand(kk, n)
        mm_rows.append(compare_kernel(
            f"matmul [{m},{kk}]@[{kk},{n}]", matmul, matmul_plain,
            torch.matmul, (x, w), 2.0 * m * kk * n,
            4.0 * (m * kk + kk * n + m * n)))
    return conv_rows, conv_path, mm_rows, mm_rows[:1]


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

    profile = _profile_batches(params, on_card[:2], mesh)

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


def _profile_batches(params, batches, mesh):
    """Device time by kernel over a few dist-path batches, and the share
    of the wall time the device was busy (``torch.profiler``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models.cnn import forward_cnn

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for images in batches:
            forward_cnn(params, images, dist_mesh=mesh)
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
    return {"batches": len(batches), "wall_ms": wall_ms,
            "device_busy_ms": busy_ms, "device_busy_share": busy_ms / wall_ms,
            "top_device_ms": [[k[:60], ms] for k, ms in top]}


def slice_phase():
    from repro_torch.dist.spawn import run_spmd

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
    summary = {"phase": "slice", "grid": [1, 1, 1, 1, 1],
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


def kernel_entry(name, source, replaces, jax_function, rows, path_rows,
                 launches):
    """One kernel's line: errors over every shape checked, times summed
    over the shapes of one forward on the main path."""
    bound_ops = sum(r["bound_ms"] for r in path_rows
                    if r["bound_by"] == "operations")
    bound_bytes = sum(r["bound_ms"] for r in path_rows
                      if r["bound_by"] == "bytes")
    kernel_ms = sum(r["kernel_ms"] for r in path_rows)
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "jax_function": jax_function,
            "launches": launches,
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

    conv_rows, conv_path, mm_rows, mm_path = kernel_phase(device)
    launches = slice_phase()

    kernels = [
        kernel_entry("conv2d_direct", "src/repro_torch/kernels/csrc/conv2d.cu",
                     "src/repro/kernels/conv2d.py:77", "conv2d_pallas",
                     conv_rows, conv_path, launches["conv2d"]),
        kernel_entry("matmul_tiled", "src/repro_torch/kernels/csrc/matmul.cu",
                     "src/repro/kernels/matmul.py:43", "matmul_pallas",
                     mm_rows, mm_path, launches["matmul"]),
    ]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
