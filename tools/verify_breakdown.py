#!/usr/bin/env python3
"""Where the distributed conv's custom backward holds its peak, on one card.

    python3 tools/verify_breakdown.py [--c 3] [--k 64] [--hw 56]

Runs the verifier's train cell (``analysis/verify.py``, one rank,
``allgather``, the static plan) for one 3x3 conv of the CNN in
``chip_smoke.py`` (batch 64), with the allocator read around dIn
(``dist/conv2d.py::_dx_local``) and dKer (``_dw_local``): for each, the
MB allocated before, the peak during (the peak is reset on entry) and
the MB left after.  Prints one JSON line with that breakdown, the
cell's live and Eq. 11 bytes and its ``mem_ratio``, then the card's
name and power limit.  Since the peak is reset on entry to each step,
the cell's ``live`` is the peak of the last step that ran.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

BATCH = 64


def _wrap(module, name: str, marks: list) -> None:
    inner = getattr(module, name)

    def read(*args, **kwargs):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = inner(*args, **kwargs)
        torch.cuda.synchronize()
        marks.append({"step": name, "before_mb": before / 1e6,
                      "peak_mb": torch.cuda.max_memory_allocated() / 1e6,
                      "after_mb": torch.cuda.memory_allocated() / 1e6,
                      "out_mb": out.numel() * out.element_size() / 1e6})
        return out
    setattr(module, name, read)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--c", type=int, default=3, help="input channels")
    ap.add_argument("--k", type=int, default=64, help="output channels")
    ap.add_argument("--hw", type=int, default=56, help="image extent")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("verify_breakdown: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.analysis import verify
    from repro_torch.device import resolve_device
    from repro_torch.dist import conv2d as dconv

    resolve_device()
    marks: list = []
    for name in ("_dx_local", "_dw_local"):
        _wrap(dconv, name, marks)
    spec = verify.conv_cell((1,) * 5, "allgather",
                            x_shape=(BATCH, args.c, args.hw, args.hw),
                            w_shape=(args.k, args.c, 3, 3),
                            include_fwd=False)
    report = verify.run_specs([spec])[0]
    print(json.dumps({"cell": report.name, "x": list(spec.x_shape),
                      "w": list(spec.w_shape), "steps": marks,
                      "live_mb": report.live_bytes / 1e6,
                      "analytic_mb": report.analytic_mem_bytes / 1e6,
                      "mem_ratio": report.mem_ratio,
                      "findings": [str(f) for f in report.findings]}),
          flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
