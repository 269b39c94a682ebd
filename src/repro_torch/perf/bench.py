"""Bench records from the port -- the counterpart of
``benchmarks/bench_kernels.py`` and of the serve records of
``benchmarks/bench_serve.py``, with the reference's keys, plus a record
of a whole CNN train step of the port's own.

Three kinds of record, each read by ``perf.predict.record_dag`` and
``perf.calibrate.fit_collectives``:

* ``kernel/<layer>`` (:func:`kernel_records`): a pair per ResNet-50
  layer of ``FULL_LAYERS``, benched as the stride-1 SAME slab
  contraction the distributed schedules run at the layer's output
  extents, through ``kernels.ops.local_conv2d``.  ``schedule`` is
  ``paper-plan`` (the static dispatch, tuner off: the direct conv where
  it tiles, the library conv elsewhere) or ``autotuned`` (the tuner's
  winner in the active plan table), with the ``impl`` that ran, ``grid``
  (the Eq. 4 blocks of ``kernels.tiling.plan_blocks`` at the reference's
  budget), ``wire_bytes`` (the plan's modeled traffic x 4),
  ``peak_elems``, ``min_tile_traffic_ratio``, ``flops``, ``wall_ms``,
  ``std_ms`` and ``reps``;
* ``serve/<arch>/<grid>`` (:func:`serve_record`): a serve run's decode
  step (``wall_ms`` its mean, as the reference's bench) with ``slots``,
  ``dtype``, ``smoke``, ``p50_ms``, ``p99_ms``, ``tokens_per_s`` and
  ``wire_bytes_per_tok``;
* ``train/cnn/<algo>`` (:func:`cnn_train_record`): a whole CNN train
  step on a conv grid with ``x_shape`` (the images), ``channels``,
  ``n_classes``, ``k``, ``pool_every`` and ``grid`` (``record_dag``
  replays ``cnn_train_dag``; the reference has no such record and skips
  it).

On a card every time comes from CUDA events; on the CPU from
``time.perf_counter``.  The CLI writes the kernel records as
``BENCH_kernels.json`` into the git-ignored ``perf_out/``, never at the
repo root; ``python -m repro_torch.perf.calibrate --root perf_out``
reads them (``chip_smoke.py`` phase 9 adds the serve and train records
of its own runs)::

    python -m repro_torch.perf.bench --batch 64            # on the card
    python -m repro_torch.perf.bench --batch 2 --device cpu
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import sys
import time
from typing import Callable, Dict, List, Sequence, Tuple

FULL_LAYERS = ("conv1", "res2a_2b", "res3a_2b", "res4a_2b", "res5a_2b")


def time_calls(fn: Callable, *args, reps: int = 5
               ) -> Tuple[float, float, int]:
    """``(mean_ms, std_ms, reps)`` of ``fn(*args)``: one warm call
    discarded, then each rep timed alone (CUDA events on a card, the
    host's clock on the CPU), so a record carries its noise."""
    import torch

    on_card = any(isinstance(a, torch.Tensor) and a.is_cuda for a in args)
    with torch.no_grad():
        fn(*args)
        times = []
        for _ in range(reps):
            if on_card:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn(*args)
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
            else:
                t0 = time.perf_counter()
                fn(*args)
                times.append((time.perf_counter() - t0) * 1e3)
    mean = sum(times) / reps
    std = (sum((t - mean) ** 2 for t in times) / reps) ** 0.5
    return mean, std, reps


def kernel_records(*, batch: int = 64, layers: Sequence[str] = FULL_LAYERS,
                   device=None, reps: int = 5) -> List[Dict]:
    """The ``kernel/<layer>`` record pair of every layer in ``layers``
    (see the module doc).  The autotuned record times against the plan
    table the tuner reads (``REPRO_TORCH_AUTOTUNE_CACHE``)."""
    import torch

    from repro_torch.core.problem import resnet50_layers
    from repro_torch.device import resolve_device
    from repro_torch.kernels import autotune, tiling
    from repro_torch.kernels import ops as kops

    device = resolve_device(device)
    gen = torch.Generator().manual_seed(0)
    table = resnet50_layers(batch=batch)
    recs = []
    for name in layers:
        p = table[name]
        x = torch.randn(p.Nb, p.Nc, p.Nh, p.Nw, generator=gen).to(device)
        w = torch.randn(p.Nk, p.Nc, p.Nr, p.Ns, generator=gen).to(device)
        plan = tiling.plan_blocks(p)
        naive = tiling.plan_blocks(p, vmem_elems=2 * 128 * 128)
        common = {
            "grid": [plan.block_bhw, plan.block_k, plan.block_c],
            "wire_bytes": plan.hbm_traffic * 4,
            "peak_elems": plan.vmem_elems,
            "min_tile_traffic_ratio": naive.hbm_traffic / plan.hbm_traffic,
            "stencil": [p.Nr, p.Ns],
            "stride": [1, 1],
            "flops": p.flops(),
            "batch": batch,
        }

        def conv(a, b):
            return kops.local_conv2d(a, b, stride=(1, 1), padding="SAME")

        for schedule in ("paper-plan", "autotuned"):
            scope = (autotune.autotune_disabled() if schedule == "paper-plan"
                     else contextlib.nullcontext())
            with scope:
                impl = kops.select_conv_impl(x.shape, w.shape, (1, 1),
                                             "SAME", dtype=x.dtype,
                                             device=x.device)
                mean, std, n = time_calls(conv, x, w, reps=reps)
            recs.append({"name": f"kernel/{name}", "schedule": schedule,
                         "impl": impl, "wall_ms": mean, "std_ms": std,
                         "reps": n, **common})
        del x, w
    return recs


def serve_record(res: Dict, *, arch: str, dtype: str, slots: int,
                 smoke: bool, grid=None,
                 schedule: str = "allgather") -> Dict:
    """The ``serve/<arch>/<grid>`` record of one ``launch.serve.run``
    result ``res`` (its decode-step stats)."""
    gstr = "dense" if grid is None else "x".join(str(g) for g in grid)
    wire = res.get("wire_bytes_per_tok", 0.0)
    return {"name": f"serve/{arch}/{gstr}", "arch": arch, "smoke": smoke,
            "dtype": dtype, "slots": slots,
            "grid": list(grid) if grid is not None else None,
            "schedule": schedule,
            "tokens_per_s": res["tokens_per_s"],
            "p50_ms": res["p50_ms"], "p99_ms": res["p99_ms"],
            "wire_bytes_per_tok": wire, "wire_bytes": wire,
            "wall_ms": res["mean_ms"], "std_ms": res["std_ms"],
            "reps": res["reps"]}


def cnn_train_record(step_ms: Sequence[float], *, x_shape, channels,
                     n_classes: int, k: int, pool_every: int,
                     grid) -> Dict:
    """The ``train/cnn/<algo>`` record of measured train steps
    ``step_ms`` of a whole CNN (``x_shape`` the images, ``k`` x ``k``
    convs) on ``grid``."""
    from repro_torch.core.sharding_synthesis import _algo_family

    return {"name": f"train/cnn/{_algo_family(tuple(grid))}",
            "grid": list(grid), "schedule": "allgather",
            "x_shape": list(x_shape), "channels": list(channels),
            "n_classes": int(n_classes), "k": int(k),
            "pool_every": int(pool_every),
            "wall_ms": statistics.fmean(step_ms),
            "std_ms": statistics.pstdev(step_ms), "reps": len(step_ms),
            "p50_ms": statistics.median(step_ms)}


def main(argv=None) -> int:
    from repro_torch.perf.calibrate import OUT_DIR, repo_root

    ap = argparse.ArgumentParser(
        description="bench records of the port, with the reference's keys")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--out", default=os.path.join(repo_root(), OUT_DIR),
                    help=f"directory for the records (default: {OUT_DIR}/)")
    args = ap.parse_args(argv)
    if os.path.abspath(args.out) == repo_root():
        raise SystemExit("[bench] refusing to write BENCH_*.json at the "
                         "repo root")
    os.makedirs(args.out, exist_ok=True)
    kern = kernel_records(batch=args.batch, device=args.device)
    path = os.path.join(args.out, "BENCH_kernels.json")
    with open(path, "w") as f:
        json.dump(kern, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"[bench] {len(kern)} records -> {path}")
    for r in kern:
        print(f"  {r['name']}/{r['schedule']} ({r['impl']}): "
              f"{r['wall_ms']:.3f} ms +- {r['std_ms']:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
