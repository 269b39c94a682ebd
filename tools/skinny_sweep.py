#!/usr/bin/env python3
"""Sweep the launch plan of the skinny GEMM (``csrc/skinny_gemm.cu``) on
one card.

    python3 tools/skinny_sweep.py [--out FILE]

Two sweeps, at the products of one decode step (8 slots) of
llama3.2-1b and granite-moe-1b-a400m that the static plan gives the
kernel (``dist.lm.lm_step_products``):

1. the split rule: for each pair of ``kernels._plan.SKINNY_BLOCKS_PER_SM``
   (the block count the split aims at) and ``SKINNY_MIN_SLABS`` (the
   shortest chunk, in slabs), each distinct shape in bfloat16 and float32
   timed on the device alone (CUDA events, the calls queued behind a spin
   of the device, so the host's launch time drops out) and back to back;
   one JSON line per (rule, dtype, shape), and the decode step's sums per
   rule (each shape times its count);
2. the float32 route: at M = 8, 16, 32 and 64 rows, llama's four
   projection widths on the skinny GEMM and on the tile core
   (``matmul.launch_gemm``), device only; ``_plan.SKINNY_M`` is the
   largest M at which the skinny GEMM wins every width.

The last line is the card (``nvidia-smi`` name and power limit) with the
sums.  Exits 2 without a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from collections import Counter
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

BLOCKS_PER_SM = (1, 2, 4)
MIN_SLABS = (1, 2, 4)
ARCHS = ("llama3.2-1b", "granite-moe-1b-a400m")
SLOTS = 8


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


def decode_shapes():
    """{(M, C, N): count per decode step} over both archs."""
    from repro_torch.configs import get_config
    from repro_torch.dist.lm import lm_step_products
    from repro_torch.kernels.ops import pallas_applicable_matmul

    counts = Counter()
    for arch in ARCHS:
        counts.update(p for p in lm_step_products(get_config(arch), SLOTS,
                                                  True)
                      if pallas_applicable_matmul(p[0], p[2], p[1]))
    return counts


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", help="also write the lines here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("skinny_sweep: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.device import resolve_device
    from repro_torch.kernels import _plan
    from repro_torch.kernels.matmul import launch_gemm, launch_skinny

    device = resolve_device()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    sms = _plan.sm_count(torch.cuda.current_device())
    gen = torch.Generator(device=device).manual_seed(0)
    counts = decode_shapes()
    operands = {}
    for dtype in (torch.bfloat16, torch.float32):
        for m, c, n in counts:
            operands[dtype, m, c, n] = (
                torch.randn(m, c, generator=gen, device=device).to(dtype),
                torch.randn(c, n, generator=gen, device=device).to(dtype))
    lines, sums = [], {}
    saved = _plan.SKINNY_BLOCKS_PER_SM, _plan.SKINNY_MIN_SLABS
    try:
        for bps in BLOCKS_PER_SM:
            for ms in MIN_SLABS:
                _plan.SKINNY_BLOCKS_PER_SM, _plan.SKINNY_MIN_SLABS = bps, ms
                _plan.skinny_plan.cache_clear()
                for (dtype, m, c, n), (x, w) in operands.items():
                    plan = _plan.skinny_plan(m, n, c, dtype, sms)
                    row = {"blocks_per_sm": bps, "min_slabs": ms,
                           "dtype": str(dtype).replace("torch.", ""),
                           "shape": [m, c, n], "count": counts[m, c, n],
                           "splits": plan.splits,
                           "device_ms": device_ms(
                               lambda: launch_skinny(x, w)),
                           "ms": time_ms(lambda: launch_skinny(x, w))}
                    lines.append(row)
                    key = f"{bps}/{ms}/{row['dtype']}"
                    sums[key] = sums.get(key, 0.0) \
                        + row["count"] * row["device_ms"]
                    print(json.dumps(row), flush=True)
    finally:
        _plan.SKINNY_BLOCKS_PER_SM, _plan.SKINNY_MIN_SLABS = saved
        _plan.skinny_plan.cache_clear()
    for m in (8, 16, 32, 64):
        for c, n in ((2048, 2048), (2048, 512), (2048, 8192), (8192, 2048)):
            x = torch.randn(m, c, generator=gen, device=device)
            w = torch.randn(c, n, generator=gen, device=device)
            row = {"route": "f32", "shape": [m, c, n],
                   "skinny_device_ms": device_ms(lambda: launch_skinny(x, w)),
                   "core_device_ms": device_ms(lambda: launch_gemm(x, w))}
            lines.append(row)
            print(json.dumps(row), flush=True)
    summary = {"card": card,
               "decode_step_device_ms_by_blocks_per_sm_min_slabs_dtype":
                   sums}
    print(json.dumps(summary), flush=True)
    if args.out:
        Path(args.out).write_text(
            "\n".join(json.dumps(r) for r in lines + [summary]) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
