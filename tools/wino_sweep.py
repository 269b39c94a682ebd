#!/usr/bin/env python3
"""Sweep the launch plan of Winograd's tile GEMM (``csrc/wino_gemm.cu``)
on one card, and time variants of its split.

    python3 tools/wino_sweep.py [--out FILE]

At the shapes the CNN's train step gives the kernel (batch 64, the seven
Winograd layers of ``chip_smoke.py``: fwd ``[16,P,C]@[16,C,K]``, dIn fwd
``[16,P',K]@[16,K,C]``, autograd's dv and du), in float32 and bfloat16:

1. every shape with the repository's plan, timed back to back (CUDA
   events) and on the device alone (queued behind a spin of the
   device); the step's sums (fwd and dIn fwd, the 14 products of one
   train step) per dtype;
2. the split rule at the du shapes (the only ones that split): each pair
   of ``WINO_BLOCKS_PER_SM`` x ``WINO_MIN_SLABS``;
3. variants of the source, each built in a copy of ``src/`` in a scratch
   directory and run in a process of its own, the repository's own
   source first and last (the spread): ``cvt``, hi rounded by
   ``cvt.rna.tf32.f32`` instead of the integer add and mask;
   ``lo_rounded``, lo rounded to TF32 too (else the tensor core truncates
   it); ``one_level``, the products summed straight into the running
   accumulators (no per-slab sums); ``stages4``, a 4-slab ring;
   ``warp64x32`` and ``warp32x64``, four warps of 64 x 32 or 32 x 64
   outputs in place of eight of 32 x 32; the step's sums each, in both
   dtypes;
4. T = 1: the kernel against the tile core (``csrc/gemm.cu``, the f32
   matmul's route 1) at ``chip_smoke.py``'s matmul shapes, device only.

The last line is the card (``nvidia-smi`` name and power limit) with the
sums.  Exits 2 without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

BATCH = 64
LAYERS = [(64, 64, 56), (64, 128, 28), (128, 128, 28), (128, 256, 14),
          (256, 256, 14), (256, 512, 7), (512, 512, 7)]
BLOCKS_PER_SM = (1, 2, 4)
MIN_SLABS = (2, 4, 8)
MATMUL_SHAPES = [(64, 512, 1000), (64, 1000, 512), (512, 64, 1000),
                 (65, 520, 1000), (576, 200704, 64)]
# variant name -> the (text in csrc/wino_gemm.cu, its replacement) edits
CVT = [("  return (x + 0x1000u) & 0xffffe000u;",
        '  uint32_t r;\n  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(r) : '
        '"f"(__uint_as_float(x)));\n  return r;')]
LO_ROUNDED = [("  lo = __float_as_uint(__uint_as_float(x) - __uint_as_float(hi));",
               "  lo = to_tf32(__float_as_uint(__uint_as_float(x) - "
               "__uint_as_float(hi)));")]
ONE_LEVEL = [("  float s[C::MF][C::NF][4];",
              "  float (&s)[C::MF][C::NF][4] = acc;"),
             ("      for (int e = 0; e < 4; ++e) s[i][j][e] = 0.f;",
              "      for (int e = 0; e < 4; ++e) (void)e;"),
             ("      for (int e = 0; e < 4; ++e) acc[i][j][e] += s[i][j][e];",
              "      for (int e = 0; e < 4; ++e) (void)e;")]
STAGES4 = [("using Tile = Cfg<T, 128, 64, 3, kVec>;",
            "using Tile = Cfg<T, 128, 64, 4, kVec>;")]
WARP64X32 = [("  static constexpr int WM = 32, WN = 32;",
              "  static constexpr int WM = 64, WN = 32;")]
WARP32X64 = [("  static constexpr int WM = 32, WN = 32;",
              "  static constexpr int WM = 32, WN = 64;")]
VARIANTS = {"repo": [], "cvt": CVT, "lo_rounded": LO_ROUNDED,
            "one_level": ONE_LEVEL, "stages4": STAGES4,
            "warp64x32": WARP64X32, "warp32x64": WARP32X64,
            "repo_again": []}

VARIANT_RUN = r'''
import json, sys
sys.path.insert(0, "tools")
import wino_sweep
print(json.dumps(wino_sweep.step_sums((wino_sweep.torch.float32,
                                        wino_sweep.torch.bfloat16))))
'''


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


def step_shapes():
    """(direction, (C, K, H), (t, m, r, n)) of every product, batch 64."""
    out = []
    for c, k, h in LAYERS:
        p = BATCH * (-(-h // 2)) ** 2
        pin = BATCH * (-(-(h + 2) // 2)) ** 2
        out += [("fwd", (c, k, h), (16, p, c, k)),
                ("dIn fwd", (c, k, h), (16, pin, k, c)),
                ("dv", (c, k, h), (16, p, k, c)),
                ("du", (c, k, h), (16, c, p, k))]
    return out


def _operands(dtype, device, gen):
    return {shape: (torch.randn(shape[:3], generator=gen, device=device
                                ).to(dtype),
                    torch.randn(shape[0], shape[2], shape[3], generator=gen,
                                device=device).to(dtype))
            for _, _, shape in step_shapes()}


def step_sums(dtypes=(torch.float32,)) -> dict:
    """The repository plan's time of one train step's 14 products per
    dtype (back to back and device only), and of all 28 directions."""
    from repro_torch.device import resolve_device
    from repro_torch.kernels.winograd import launch_wino_gemm

    device = resolve_device()
    gen = torch.Generator(device=device).manual_seed(0)
    sums = {}
    for dtype in dtypes:
        ops = _operands(dtype, device, gen)
        name = str(dtype).replace("torch.", "")
        for what, _, shape in step_shapes():
            v, u = ops[shape]
            ms = time_ms(lambda: launch_wino_gemm(v, u))
            dms = device_ms(lambda: launch_wino_gemm(v, u))
            keys = [f"{name} all"] + ([f"{name} step"]
                                      if what in ("fwd", "dIn fwd") else [])
            for key in keys:
                sums[key] = sums.get(key, 0.0) + ms
                sums[key + " device"] = sums.get(key + " device", 0.0) + dms
        del ops
    return sums


def run_variant(name, edit):
    """The step's sums with ``edit`` applied to a copy of the source."""
    with tempfile.TemporaryDirectory() as tmp:
        shutil.copytree(ROOT / "src", Path(tmp) / "src",
                        ignore=shutil.ignore_patterns("build", "__pycache__"))
        shutil.copytree(ROOT / "tools", Path(tmp) / "tools")
        src = Path(tmp) / "src/repro_torch/kernels/csrc/wino_gemm.cu"
        text = src.read_text()
        for old, new in edit:
            if text.count(old) != 1:
                raise SystemExit(f"variant {name}: edit does not apply")
            text = text.replace(old, new)
        src.write_text(text)
        env = dict(os.environ, PYTHONPATH=str(Path(tmp) / "src"))
        proc = subprocess.run([sys.executable, "-c", VARIANT_RUN], cwd=tmp,
                              env=env, capture_output=True, text=True)
        if proc.returncode:
            raise SystemExit(f"variant {name} failed:\n{proc.stdout}"
                             f"{proc.stderr}")
        return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", help="also write the lines here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("wino_sweep: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.device import resolve_device
    from repro_torch.kernels import _plan
    from repro_torch.kernels.matmul import launch_gemm
    from repro_torch.kernels.winograd import launch_wino_gemm

    device = resolve_device()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    sms = _plan.sm_count(torch.cuda.current_device())
    gen = torch.Generator(device=device).manual_seed(0)
    lines, sums = [], {}

    def emit(row):
        lines.append(row)
        print(json.dumps(row), flush=True)

    saved = _plan.WINO_BLOCKS_PER_SM, _plan.WINO_MIN_SLABS

    def set_rule(bps, ms):
        _plan.WINO_BLOCKS_PER_SM, _plan.WINO_MIN_SLABS = bps, ms
        _plan.wino_plan.cache_clear()

    try:
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).replace("torch.", "")
            ops = _operands(dtype, device, gen)
            for what, layer, shape in step_shapes():
                plan = _plan.wino_plan(*shape[:2], shape[3], shape[2],
                                       dtype, sms)
                v, u = ops[shape]
                row = {"sweep": "shape", "dtype": name, "direction": what,
                       "layer": list(layer), "shape": list(shape),
                       "splits": plan.splits,
                       "ms": time_ms(lambda: launch_wino_gemm(v, u)),
                       "device_ms": device_ms(
                           lambda: launch_wino_gemm(v, u))}
                emit(row)
                if what in ("fwd", "dIn fwd"):
                    key = f"step {name}"
                    sums[key] = sums.get(key, 0.0) + row["ms"]
            for bps in BLOCKS_PER_SM:
                for ms_ in MIN_SLABS:
                    set_rule(bps, ms_)
                    for what, layer, shape in step_shapes():
                        if what != "du":
                            continue
                        plan = _plan.wino_plan(*shape[:2], shape[3],
                                               shape[2], dtype, sms)
                        v, u = ops[shape]
                        dms = device_ms(lambda: launch_wino_gemm(v, u))
                        emit({"sweep": "split", "blocks_per_sm": bps,
                              "min_slabs": ms_, "dtype": name,
                              "layer": list(layer), "shape": list(shape),
                              "splits": plan.splits, "device_ms": dms})
                        key = f"du {name} {bps}/{ms_}"
                        sums[key] = sums.get(key, 0.0) + dms
            del ops
    finally:
        set_rule(*saved)
    for m, k, n in MATMUL_SHAPES:
        a = torch.randn(m, k, generator=gen, device=device)
        b = torch.randn(k, n, generator=gen, device=device)
        emit({"sweep": "t1", "shape": [m, k, n],
              "wino_device_ms": device_ms(
                  lambda: launch_wino_gemm(a[None], b[None])),
              "gemm_device_ms": device_ms(lambda: launch_gemm(a, b))})
    for name, edit in VARIANTS.items():
        row = {"sweep": "variant", "variant": name,
               **run_variant(name, edit)}
        emit(row)
    summary = {"card": card, "sums": sums}
    print(json.dumps(summary), flush=True)
    if args.out:
        Path(args.out).write_text(
            "\n".join(json.dumps(r) for r in lines + [summary]) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
