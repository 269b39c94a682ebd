#!/usr/bin/env python3
"""Time variants of the tile core's two configurations on one card.

    python3 tools/tile_variants.py [--out FILE]

Each variant is a copy of ``src/`` (and of ``chip_smoke.py``) in a
scratch directory with the ``Big`` / ``Small`` lines of
``csrc/tile_gemm.cuh`` rewritten -- ring depth (stages) and slab depth
(BK) -- and the launch plan's slab table to match.  Every variant builds
its own library and runs ``chip_smoke.kernel_phase`` (every kernel at
every shape of the CNN's train step, against its plain version), in a
process of its own; the repository's own configuration runs first and
last, as the spread.  Prints one JSON line per variant: the conv's sums
per direction, the tile GEMM's and the head's sums (back to back and
device-only), the registers ``ptxas`` gave each kernel, and the card.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
BIG = "using Big = Cfg<128, 128, 8, 8, 8, 4>;"
SMALL = "using Small = Cfg<64, 64, 16, 4, 4, 4>;"
SLABS = "TILES = {(128, 128): 8, (64, 64): 16}"
# name -> (Big's BK, Big's stages, Small's stages)
VARIANTS = {"repo": (8, 4, 4), "stages3": (8, 3, 3), "stages5": (8, 5, 5),
            "big_bk16": (16, 4, 4), "repo_again": (8, 4, 4)}

RUN = r'''
import contextlib, glob, io, json, sys
sys.path.insert(0, ".")
import chip_smoke
from repro_torch.device import resolve_device
from repro_torch.kernels import _build

device = resolve_device()
_build.load()
regs = [line.split("Used")[1].split(",")[0].strip()
        for log in sorted(glob.glob("src/repro_torch/kernels/build/*.log"))
        for line in open(log) if "registers" in line]
with contextlib.redirect_stdout(io.StringIO()):
    rows, path, _ = chip_smoke.kernel_phase(device)
out = {"registers": regs}
for r in path["conv2d"]:
    key = "conv " + r["direction"]
    out[key] = out.get(key, 0.0) + r["kernel_ms"]
out["wino_gemm path"] = sum(r["kernel_ms"] for r in path["wino_gemm"])
out["wino_gemm all shapes"] = sum(r["kernel_ms"] for r in rows["wino_gemm"])
for key, col in (("head", "kernel_ms"), ("head device", "kernel_device_ms"),
                 ("head torch.matmul", "library_ms"),
                 ("head torch.matmul device", "library_device_ms")):
    out[key] = sum(r[col] for r in path["matmul"])
print(json.dumps(out))
'''


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", help="also write the lines to this file")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("tile_variants: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    lines = []
    with tempfile.TemporaryDirectory() as tmp:
        for name, (big_bk, big_stages, small_stages) in VARIANTS.items():
            work = Path(tmp) / name
            shutil.copytree(ROOT / "src", work / "src",
                            ignore=shutil.ignore_patterns("build",
                                                          "__pycache__"))
            shutil.copy(ROOT / "chip_smoke.py", work)
            kernels = work / "src" / "repro_torch" / "kernels"
            for path, old, new in [
                    (kernels / "csrc" / "tile_gemm.cuh", BIG,
                     f"using Big = Cfg<128, 128, {big_bk}, 8, 8, "
                     f"{big_stages}>;"),
                    (kernels / "csrc" / "tile_gemm.cuh", SMALL,
                     f"using Small = Cfg<64, 64, 16, 4, 4, {small_stages}>;"),
                    (kernels / "_plan.py", SLABS,
                     f"TILES = {{(128, 128): {big_bk}, (64, 64): 16}}")]:
                text = path.read_text()
                if old not in text:
                    raise RuntimeError(f"{path.name} no longer has {old!r}")
                path.write_text(text.replace(old, new))
            proc = subprocess.run([sys.executable, "-c", RUN], cwd=work,
                                  capture_output=True, text=True)
            if proc.returncode:
                print(proc.stdout[-2000:], proc.stderr[-4000:],
                      file=sys.stderr)
                return 1
            row = {"variant": name, "big_bk": big_bk,
                   "big_stages": big_stages, "small_stages": small_stages,
                   **json.loads(proc.stdout.strip().splitlines()[-1]),
                   "card": card}
            lines.append(row)
            print(json.dumps(row), flush=True)
    if args.out:
        Path(args.out).write_text("\n".join(map(json.dumps, lines)) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
