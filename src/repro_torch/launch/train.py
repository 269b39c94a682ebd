"""The fault-tolerant CNN trainer -- the port of ``repro/launch/train.py``.

``--mesh dist-grid`` trains the CNN on the explicit ``(Pb,Ph,Pw,Pk,Pc)``
grid through ``dist/train.py::make_resilient_train_loop``: the grid is
re-synthesized over the ranks on every (re)start, restore walks back past
corrupt checkpoints, a watchdog saves on wedged steps, SIGTERM saves and
stops every rank at the same step, and ``--fault-plan`` (or the
``REPRO_FAULT_PLAN`` environment variable the reference reads too)
injects deterministic failures (``fault/inject.py``).  ``--ranks N``
starts N ranks through ``dist.spawn.run_spmd`` (gloo on the CPU, one card
each under nccl); a world of one runs in this process, so a SIGTERM sent
to it reaches the loop.  The ``[resilient]`` and ``[fault]`` lines are the
reference's, letter for letter, so one regex reads either package's
output.

``--mesh host``, the dense LM trainer, needs ``loss_lm`` and waits for
the LM-training slice of the port.

CPU-scale run (8 gloo ranks, preempted at step 12)::

  PYTHONPATH=src python -m repro_torch.launch.train --mesh dist-grid \\
      --ranks 8 --device cpu --steps 20 --batch 8 --ckpt-dir /tmp/ckpt \\
      --fault-plan '{"faults": [{"kind": "sigterm", "step": 12}]}'

On a card: ``--ranks 1`` (the default there is one rank per card).
"""

from __future__ import annotations

import argparse
from typing import Dict

import torch

LM_LATER = ("--mesh host (the dense LM trainer) needs loss_lm, which "
            "waits for the LM-training slice of the port")


def _load_fault_plan(spec: str):
    """``--fault-plan`` accepts inline JSON or ``@path/to/plan.json``;
    without the flag, ``REPRO_FAULT_PLAN`` is read."""
    from repro_torch.fault.inject import FaultPlan
    if not spec:
        return FaultPlan.from_env()
    if spec.startswith("@"):
        with open(spec[1:], encoding="utf-8") as f:
            spec = f.read()
    return FaultPlan.from_json(spec)


def _train_rank(rank: int, args: Dict, plan) -> Dict:
    """One rank of the resilient trainer; its report without the state
    (which stays on the rank's device)."""
    from repro_torch.dist.train import (ResilienceConfig,
                                        make_resilient_train_loop,
                                        make_synthetic_cnn_batches)
    from repro_torch.fault.inject import FaultInjector
    from repro_torch.models.cnn import init_cnn
    from repro_torch.train.optim import AdamW

    device = args["device"]
    x_shape = args["x_shape"]
    rcfg = ResilienceConfig(
        ckpt_dir=args["ckpt_dir"], ckpt_every=args["ckpt_every"],
        watchdog_timeout_s=args["watchdog_timeout"] or None,
        schedule=args["schedule"], minimize=args["minimize"],
        fault_log_path=args["fault_log"] or None)
    run = make_resilient_train_loop(
        AdamW(lr=args["lr"]), rcfg, grid="auto",
        injector=FaultInjector(plan) if plan is not None else None,
        device=device)
    report = run(lambda: init_cnn(torch.Generator().manual_seed(0),
                                  channels=args["channels"],
                                  n_classes=args["classes"],
                                  in_channels=x_shape[1], device=device),
                 make_synthetic_cnn_batches(x_shape, args["classes"],
                                            device=device),
                 args["steps"])
    report.pop("state")
    return report


def _main_dist_grid(args) -> Dict:
    """The resilient CNN trainer on the explicit conv grid."""
    from repro_torch.device import resolve_device
    from repro_torch.dist.spawn import run_spmd

    device = resolve_device(args.device)
    ranks = args.ranks or (torch.cuda.device_count()
                           if device.type == "cuda" else 1)
    channels = [int(c) for c in args.channels.split(",")]
    x_shape = (args.batch, args.in_channels, args.hw, args.hw)
    plan = _load_fault_plan(args.fault_plan)
    cfg = dict(vars(args), device=device.type, channels=channels,
               x_shape=x_shape)
    print(f"[resilient] devices={ranks} steps={args.steps} "
          f"x={x_shape} channels={channels}", flush=True)
    report = run_spmd(_train_rank, ranks, cfg, plan, device=device.type)[0]
    print(f"[resilient] grid={report['grid']}", flush=True)
    for i, loss in enumerate(report["losses"]):
        print(f"[resilient] step {report['start_step'] + i} "
              f"loss {loss:.6f}", flush=True)
    for ev in report["events"]:
        print(f"[fault] {ev.kind}@{ev.step}: {ev.detail}", flush=True)
    if report["preempted"]:
        print(f"[resilient] preempted at step {report['end_step']} "
              f"(emergency checkpoint committed)", flush=True)
    else:
        print(f"[resilient] done at step {report['end_step']}",
              flush=True)
    return report


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="host",
                    choices=("host", "dist-grid"),
                    help="host: the dense LM trainer (not ported yet); "
                         "dist-grid: the resilient CNN on the conv grid")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--channels", default="8,8",
                    help="CNN channel widths, comma-separated")
    ap.add_argument("--in-channels", type=int, default=4)
    ap.add_argument("--hw", type=int, default=8,
                    help="input spatial extent")
    ap.add_argument("--classes", type=int, default=10)
    ap.add_argument("--schedule", default="allgather",
                    choices=("allgather", "ring", "ring2"))
    ap.add_argument("--minimize", default="comm", choices=("comm", "time"),
                    help="grid objective: analytic wire volume, or the "
                         "calibrated time model (not ported yet)")
    ap.add_argument("--watchdog-timeout", type=float, default=0.0,
                    help="wedged-step watchdog (seconds; 0 disables)")
    ap.add_argument("--fault-plan", default="",
                    help="JSON FaultPlan or @file (fault/inject.py)")
    ap.add_argument("--fault-log", default="",
                    help="JSON-lines FaultEvent log path (rank 0)")
    ap.add_argument("--ranks", type=int, default=0,
                    help="ranks to start (default: one per card, or 1 on "
                         "the CPU)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (gloo ranks)")
    args, rest = ap.parse_known_args(argv)
    if args.mesh == "host":
        raise NotImplementedError(LM_LATER)
    if rest:
        ap.error(f"unrecognized arguments: {' '.join(rest)}")
    return _main_dist_grid(args)


if __name__ == "__main__":
    main()
