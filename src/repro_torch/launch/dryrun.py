"""Multi-pod dry run -- the port of ``repro/launch/dryrun.py``: build every
(arch x shape) cell's step on the production mesh (16x16 single-pod /
2x16x16 multi-pod), run it once on placed ``meta`` state, and price it on
one H100 from what each device holds, computes and sends.

The reference lowers and compiles each cell for 512 CPU placeholder
devices and reads the compiled HLO.  Here the mesh stands on a fake
process group of 256 or 512 ranks in this process, seen from rank 0
(``launch.mesh``); the state is placed on it as DTensors whose blocks are
``meta`` tensors (``train.step.place_gspmd`` for a train step,
``train.step.place_serve`` for prefill and decode), so a full-width
qwen3-moe-235b-a22b needs no memory; the step runs eagerly under
``launch.op_analysis.OpCounter``, which counts this device's blocks.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k
  python -m repro_torch.launch.dryrun --arch all --shape all [--multi-pod]
  ... each cell writes dryrun_out/<arch>_<shape>_<mesh>.json

Entry points run on the card unless asked for the CPU (``--device
cpu``); the device names the mesh's device type, nothing is computed on
it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
from typing import Any, Dict, NamedTuple

# ---------------------------------------------------------------- roofline
#: H100 SXM data sheet, dense: bfloat16 on the tensor cores, float32
#: outside them (taken by the config's dtype)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BW = 3.35e12          # B/s per card, H100 SXM HBM3
#: B/s per card: the 400 Gb/s network port each card has in a DGX H100.
#: Both axes of a 16x16 mesh span more than one 8-card NVLink node, so
#: that port bounds a collective over either axis.
LINK_BW = 50e9
HBM_BYTES = 80e9          # the H100 80GB's memory: param_specs' budget
OUT_DIR = "dryrun_out"
DOTS_LEFT_SHOWN = 4   # records of dots left to DTensor kept per cell


def budget() -> Dict[str, float]:
    """The memory budget ``param_specs`` is given: the H100 80GB's, its
    bytes counted in bf16 elements for the tile choice (the rule of
    ``parallel.sharding.device_budget`` on a card)."""
    return {"hbm_bytes": HBM_BYTES, "mem_elems": int(HBM_BYTES) // 2}


class Built(NamedTuple):
    """A cell's step, the placed arguments it runs on, and the sharding
    decisions."""
    step: Any
    args: tuple
    decisions: Dict[str, str]


def train_on(cfg, mesh, batch: Dict, *, hbm_bytes: float,
             mem_elems: int) -> Built:
    """The reference's ``build_train`` on ``mesh``: meta parameters, AdamW
    state, both placed by ``place_gspmd`` at the batch's tokens per step,
    and the ``mode="gspmd"`` train step."""
    from repro_torch.models.api import model_fns
    from repro_torch.parallel.sharding import param_shapes
    from repro_torch.train.optim import AdamW
    from repro_torch.train.step import (init_train_state, make_train_step,
                                        place_gspmd)
    fns = model_fns(cfg)
    opt = AdamW(lr=3e-4)
    pl = place_gspmd(cfg, mesh, init_train_state(param_shapes(cfg), opt),
                     batch, hbm_bytes=hbm_bytes, mem_elems=mem_elems)
    step = make_train_step(lambda p, b: fns.loss(p, cfg, b), opt)
    return Built(step, (pl.state, pl.place_batch(batch)), pl.decisions)


def serve_on(cfg, mesh, kind: str, inputs: Dict, cache, *,
             tokens_per_step: int, hbm_bytes: float,
             mem_elems: int) -> Built:
    """The reference's ``build_prefill`` / ``build_decode`` on ``mesh``:
    meta parameters, the cache and the inputs placed by ``place_serve``,
    and the family's prefill or decode step."""
    from repro_torch.parallel.sharding import param_shapes
    from repro_torch.train.step import place_serve, serve_step
    pl = place_serve(cfg, mesh, param_shapes(cfg), cache, inputs,
                     tokens_per_step=tokens_per_step, hbm_bytes=hbm_bytes,
                     mem_elems=mem_elems)
    return Built(serve_step(cfg, kind), (pl.params, pl.cache, pl.inputs),
                 pl.decisions)


def build_train(cfg, mesh, shape_name: str, **budget_kw) -> Built:
    from repro_torch.launch.shapes import input_specs
    return train_on(cfg, mesh, input_specs(cfg, shape_name),
                    **(budget_kw or budget()))


def build_decode(cfg, mesh, shape_name: str, **budget_kw) -> Built:
    from repro_torch.launch.shapes import SHAPES, cache_struct, input_specs
    sp = SHAPES[shape_name]
    return serve_on(cfg, mesh, "decode", input_specs(cfg, shape_name),
                    cache_struct(cfg, shape_name),
                    tokens_per_step=sp.global_batch,
                    **(budget_kw or budget()))


def build_prefill(cfg, mesh, shape_name: str, **budget_kw) -> Built:
    from repro_torch.launch.shapes import SHAPES, cache_struct, input_specs
    sp = SHAPES[shape_name]
    return serve_on(cfg, mesh, "prefill", input_specs(cfg, shape_name),
                    cache_struct(cfg, shape_name),
                    tokens_per_step=sp.global_batch * sp.seq_len,
                    **(budget_kw or budget()))


def price(stats: Dict[str, Any], *, dtype: str) -> Dict[str, Any]:
    """The roofline terms of one step's per-device counts on one H100 and
    the dominant one."""
    terms = {"compute_s": stats["flops"] / PEAK_FLOPS[dtype],
             "memory_s": stats["hbm_bytes"] / HBM_BW,
             "collective_s": stats["total_wire_bytes"] / LINK_BW}
    return {**{f"roofline_{k}": v for k, v in terms.items()},
            "dominant": max(terms, key=terms.get)}


def model_flops(cfg, kind: str, tokens: int, n_dev: int) -> float:
    """Useful FLOPs per device of a step over ``tokens`` tokens: 6 per
    active parameter and token to train, 2 to serve (the reference's)."""
    mult = 6 if kind == "train" else 2
    return mult * cfg.active_param_count() * tokens / n_dev


def analyze_built(built: Built, *, sites: bool = False) -> Dict[str, Any]:
    """Run a built step once under the op counter (``op_analysis``);
    ``sites`` adds its dot FLOPs by site."""
    from repro_torch.launch.op_analysis import analyze
    return analyze(built.step, built.args, sites=sites)


# ------------------------------------------------------------------ runner

def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             out_dir: str = OUT_DIR, device=None,
             memory: Dict[str, float] = None,
             sites: bool = False) -> Dict[str, Any]:
    """One cell's record (also written to ``out_dir``): the reference's
    keys, with the step's place and trace seconds where it has its lower
    and compile seconds.  ``memory`` is the budget given to
    ``param_specs`` (``hbm_bytes``, ``mem_elems``; :func:`budget`, the
    H100's, by default).  ``sites`` adds ``dot_flops_by_site``: the
    per-device dot FLOPs by where the port ran each dot (two torch
    versions' records then name the products whose placements differ)."""
    from repro_torch.configs import get_config
    from repro_torch.device import resolve_device
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.shapes import SHAPES, cell_supported
    from repro_torch.models import layers as L

    cfg = get_config(arch)
    ok, why = cell_supported(cfg, shape_name)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    rec: Dict[str, Any] = {"arch": arch, "shape": shape_name,
                           "mesh": mesh_name}
    if not ok:
        rec["status"] = "skipped"
        rec["reason"] = why
        return _write(rec, out_dir)

    device = resolve_device(device)
    mesh = make_production_mesh(multi_pod=multi_pod, device=device)
    sp = SHAPES[shape_name]
    builder = {"train": build_train, "prefill": build_prefill,
               "decode": build_decode}[sp.kind]
    memory = memory or budget()
    t0 = time.time()
    try:
        built = builder(cfg, mesh, shape_name, **memory)
        t_place = time.time() - t0
        stats = analyze_built(built, sites=sites)
    finally:
        L.set_attention_mesh(None)
    t_trace = time.time() - t0 - t_place

    n_dev = mesh.size()
    tokens = sp.global_batch * (sp.seq_len if sp.kind != "decode" else 1)
    model_flops_dev = model_flops(cfg, sp.kind, tokens, n_dev)
    flops_dev = float(stats["flops"])
    mem = {k: stats[k] for k in ("argument_size_in_bytes",
                                 "output_size_in_bytes",
                                 "temp_size_in_bytes")}
    rec.update({
        "status": "ok",
        "place_s": round(t_place, 1), "trace_s": round(t_trace, 1),
        "dtype": cfg.dtype,
        "flops_per_device": flops_dev,
        "dot_flops_per_device": float(stats["dot_flops"]),
        "bytes_per_device": float(stats["hbm_bytes"]),
        "collectives": {"wire_bytes": stats["wire_bytes"],
                        "counts": stats["coll_counts"],
                        "total_wire_bytes": stats["total_wire_bytes"]},
        "memory_analysis": mem,
        "peak_bytes_per_device": mem["argument_size_in_bytes"]
        + mem["temp_size_in_bytes"],
        **price(stats, dtype=cfg.dtype),
        "model_flops_per_device": model_flops_dev,
        "useful_flops_ratio": (model_flops_dev / flops_dev
                               if flops_dev else None),
        "tp_decisions": built.decisions,
        "hbm_budget_bytes": memory["hbm_bytes"],
        **({"dot_flops_by_site": stats["dot_sites"]} if sites else {}),
        # products whose split DTensor's propagation chose (none: every
        # product runs on each rank's blocks), the first few named
        "dots_left_to_dtensor": len(stats["dots_left"]),
        "dots_left_first": stats["dots_left"][:DOTS_LEFT_SHOWN],
    })
    return _write(rec, out_dir)


def _write(rec, out_dir):
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(
        out_dir, f"{rec['arch']}_{rec['shape']}_{rec['mesh']}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1, default=str)
    status = rec.get("status")
    print(f"[dryrun] {rec['arch']} {rec['shape']} {rec['mesh']}: {status} "
          + (f"(dominant={rec.get('dominant')}, trace "
             f"{rec.get('trace_s')} s)" if status == "ok" else
             rec.get("reason", rec.get("error", ""))[-200:]), flush=True)
    return rec


def _cell_job(task) -> int:
    """One cell in a process of its own (``--jobs``): 1 if it failed."""
    import torch

    from repro_torch.dist.spawn import end_world
    arch, shape, multi_pod, out_dir, device, sites = task
    torch.set_num_threads(1)
    try:
        run_cell(arch, shape, multi_pod=multi_pod, out_dir=out_dir,
                 device=device, sites=sites)
        return 0
    except Exception:
        _write({"arch": arch, "shape": shape,
                "mesh": "2x16x16" if multi_pod else "16x16",
                "status": "error", "error": traceback.format_exc()},
               out_dir)
        return 1
    finally:
        end_world()


def main(argv=None):
    import multiprocessing

    from repro_torch.configs import ALIASES
    from repro_torch.launch.shapes import SHAPES

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True,
                    help="arch id or 'all'")
    ap.add_argument("--shape", default="all",
                    choices=list(SHAPES) + ["all"])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--device", default=None,
                    help="the mesh's device type: cuda (default) or cpu")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells run at once, each in a process of its own")
    ap.add_argument("--dot-sites", action="store_true",
                    help="add each cell's dot FLOPs by site to its record")
    args = ap.parse_args(argv)

    archs = list(ALIASES) if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    # the prefill cells first: they take the longest (the flash loop runs
    # unrolled)
    tasks = sorted(((a, s, mp, args.out, args.device, args.dot_sites)
                    for a in archs for s in shapes for mp in meshes),
                   key=lambda t: SHAPES[t[1]].kind != "prefill")
    t0 = time.time()
    if args.jobs > 1:
        ctx = multiprocessing.get_context("spawn")
        with ctx.Pool(args.jobs, maxtasksperchild=1) as pool:
            failures = sum(pool.imap_unordered(_cell_job, tasks))
    else:
        failures = sum(_cell_job(t) for t in tasks)
    print(f"[dryrun] {len(tasks)} cells, {failures} failed, "
          f"{time.time() - t0:.1f} s", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
