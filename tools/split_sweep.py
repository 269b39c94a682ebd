#!/usr/bin/env python3
"""Sweep the split rule of the tile GEMM's launch plan on one card.

    python3 tools/split_sweep.py [--out FILE]

For each pair of ``kernels._plan.MIN_SLABS`` (the shortest chunk, in
slabs) and ``BLOCKS_PER_SM`` (the block count the split aims at), times
the hand-written GEMM and direct conv (CUDA events, warm, mean of 20
launches, back to back and queued behind a spin of the device) at the
shapes of the CNN's train step whose plan the rule can change: the
head's three products, the im2col dKer product, Winograd's dU product
and the direct conv's dKer at four layers.  Prints one JSON
line per (rule, shape) and, last, the card and the per-rule sums.  The
shapes and the CNN are those of ``chip_smoke.py`` (batch 64, 56x56).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

MIN_SLABS = (1, 2, 3, 4, 6, 8, 16)
BLOCKS_PER_SM = (2, 4, 8)
BATCH = 64


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
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


def device_ms(fn, iters: int = 20) -> float:
    """As ``time_ms``, with the calls queued behind a ~3 ms spin of the
    device so that the host's launch time drops out."""
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


def shapes(device):
    """(name, plan args (t, m, n, r), call) for every shape swept."""
    from repro_torch.kernels.conv2d import conv2d
    from repro_torch.kernels.matmul import matmul
    from repro_torch.kernels.winograd import wino_gemm

    gen = torch.Generator().manual_seed(0)

    def rand(*shape):
        return torch.randn(*shape, generator=gen).to(device)

    out = []
    for name, (m, k, n) in [("head fwd", (BATCH, 512, 1000)),
                            ("head dX", (BATCH, 1000, 512)),
                            ("head dW", (512, BATCH, 1000)),
                            ("im2col dKer", (576, BATCH * 56 * 56, 64))]:
        a, b = rand(m, k), rand(k, n)
        out.append((name, (1, m, n, k), lambda a=a, b=b: matmul(a, b)))
    v, u = rand(16, 64, BATCH * 28 * 28), rand(16, BATCH * 28 * 28, 64)
    out.append(("wino du 64->64", (16, 64, 64, BATCH * 28 * 28),
                lambda: wino_gemm(v, u)))
    for c, k, h in [(3, 64, 56), (64, 64, 56), (256, 256, 14),
                    (512, 512, 7)]:
        x = rand(c, BATCH, h + 2, h + 2)
        g = rand(k, BATCH, h, h)
        out.append((f"conv dKer {c}->{k} H={h}", (1, c * 9, k,
                                                   BATCH * h * h),
                    lambda x=x, g=g: conv2d(x, g, padding="VALID")))
    return out


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", help="also write the lines here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("split_sweep: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.device import resolve_device
    from repro_torch.kernels import _plan

    device = resolve_device()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    cases = shapes(device)
    sms = _plan.sm_count(torch.cuda.current_device())
    lines, sums = [], {}
    saved = _plan.MIN_SLABS, _plan.BLOCKS_PER_SM
    try:
        for bps in BLOCKS_PER_SM:
            for ms in MIN_SLABS:
                _plan.MIN_SLABS, _plan.BLOCKS_PER_SM = ms, bps
                _plan.gemm_plan.cache_clear()
                for name, plan_args, call in cases:
                    plan = _plan.gemm_plan(*plan_args, sms=sms)
                    row = {"blocks_per_sm": bps, "min_slabs": ms,
                           "shape": name, "tile": plan.tile,
                           "splits": plan.splits, "ms": time_ms(call),
                           "device_ms": device_ms(call)}
                    lines.append(row)
                    sums[f"{bps}/{ms}"] = sums.get(f"{bps}/{ms}", 0.0) \
                        + row["ms"]
                    print(json.dumps(row), flush=True)
    finally:
        _plan.MIN_SLABS, _plan.BLOCKS_PER_SM = saved
        _plan.gemm_plan.cache_clear()
    summary = {"card": card, "sum_ms_by_blocks_per_sm_and_min_slabs": sums}
    print(json.dumps(summary), flush=True)
    if args.out:
        Path(args.out).write_text(
            "\n".join(json.dumps(r) for r in lines + [summary]) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
