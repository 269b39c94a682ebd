"""Aggregate the dry run's records (``dryrun_out/*.json``) into roofline
tables -- the port of ``repro/launch/report.py``.

  PYTHONPATH=src python -m repro_torch.launch.report [--dir dryrun_out]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List

from repro_torch.launch.dryrun import OUT_DIR, PEAK_FLOPS

ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
ARCHS = ["llama3.2-1b", "smollm-360m", "gemma3-12b", "gemma3-4b",
         "zamba2-7b", "xlstm-350m", "whisper-tiny", "granite-moe-1b-a400m",
         "qwen3-moe-235b-a22b", "qwen2-vl-72b"]
MESHES = ["16x16", "2x16x16"]


def load(dir_: str) -> Dict:
    out = {}
    for path in glob.glob(os.path.join(dir_, "*.json")):
        with open(path) as f:
            r = json.load(f)
        out[(r["arch"], r["shape"], r["mesh"])] = r
    return out


def fmt_s(x) -> str:
    if x is None:
        return "-"
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x*1e3:.1f}ms"
    return f"{x*1e6:.0f}us"


def roofline_table(recs: Dict, mesh: str) -> List[str]:
    """The three roofline terms on one H100, the dominant one, the useful
    share of the step's FLOPs and the roofline fraction: the useful FLOPs'
    time at the card's peak for the config's dtype over the largest
    term."""
    lines = [
        "| arch | shape | compute | memory | collective | dominant | "
        "useful/counted | roofline frac |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for arch in ARCHS:
        for shape in ORDER:
            r = recs.get((arch, shape, mesh))
            if r is None:
                continue
            if r["status"] == "skipped":
                lines.append(f"| {arch} | {shape} | — | — | — | "
                             f"SKIP (sub-quadratic rule) | — | — |")
                continue
            if r["status"] != "ok":
                lines.append(f"| {arch} | {shape} | ERROR | | | | | |")
                continue
            tc = r["roofline_compute_s"]
            tm = r["roofline_memory_s"]
            tl = r["roofline_collective_s"]
            dom = r["dominant"].replace("_s", "")
            bound = max(tc, tm, tl)
            model_t = r["model_flops_per_device"] / PEAK_FLOPS[r["dtype"]]
            frac = model_t / bound if bound else 0.0
            ratio = r.get("useful_flops_ratio")
            lines.append(
                f"| {arch} | {shape} | {fmt_s(tc)} | {fmt_s(tm)} | "
                f"{fmt_s(tl)} | {dom} | "
                f"{ratio:.2f} | {frac*100:.1f}% |")
    return lines


def dryrun_table(recs: Dict, mesh: str) -> List[str]:
    """Per cell: the trace's seconds, the counted GFLOPs, memory traffic,
    peak memory (arguments + temporaries) and wire per device, and the
    collectives by kind."""
    lines = [
        "| arch | shape | status | trace | GFLOPs/dev | HBM GB/dev | "
        "peak GB/dev | wire GB/dev | collectives (AR/AG/RS/A2A/CP) |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for arch in ARCHS:
        for shape in ORDER:
            r = recs.get((arch, shape, mesh))
            if r is None:
                continue
            if r["status"] == "skipped":
                lines.append(f"| {arch} | {shape} | SKIP | | | | | | |")
                continue
            if r["status"] != "ok":
                lines.append(f"| {arch} | {shape} | ERROR | | | | | | |")
                continue
            c = r["collectives"]["counts"]
            cs = "/".join(str(int(c.get(k, 0))) for k in
                          ("all-reduce", "all-gather", "reduce-scatter",
                           "all-to-all", "collective-permute"))
            lines.append(
                f"| {arch} | {shape} | ok | "
                f"{r['place_s'] + r['trace_s']:.1f}s | "
                f"{r['flops_per_device']/1e9:.0f} | "
                f"{r['bytes_per_device']/1e9:.1f} | "
                f"{r['peak_bytes_per_device']/1e9:.2f} | "
                f"{r['collectives']['total_wire_bytes']/1e9:.2f} | {cs} |")
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=OUT_DIR)
    args = ap.parse_args(argv)
    recs = load(args.dir)
    for mesh in MESHES:
        n = {s: sum(1 for k, v in recs.items()
                    if k[2] == mesh and v["status"] == s)
             for s in ("ok", "skipped", "error")}
        if not any(n.values()):
            continue
        print(f"\n## mesh {mesh}: {n['ok']} ok / {n['skipped']} skipped / "
              f"{n['error']} error\n")
        print("\n".join(dryrun_table(recs, mesh)))
        print()
        print("\n".join(roofline_table(recs, mesh)))


if __name__ == "__main__":
    main()
