"""The trainer -- the port of ``repro/launch/train.py``.  Two drivers
behind ``--mesh``:

* ``--mesh host`` (default): the dense LM trainer, for every family
  ``--arch`` names (the encdec's batches carry frames) -- the synthetic data
  pipeline (``data/pipeline.py``, prefetched on a thread), the train step
  (``train/step.py``, ``mode="gspmd"``, AdamW under a cosine schedule),
  checkpoints every ``--ckpt-every`` steps, the straggler monitor, and a
  SIGTERM save.  On one rank the reference's host mesh is the identity
  and the state stays plain.  ``--ranks N`` starts N ranks through
  ``dist.spawn.run_spmd`` on the reference's host mesh ``(N, 1)`` over
  ``("data", "model")``: the state is placed by the GSPMD rules
  (``parallel/sharding.py``, ``train.step.place_gspmd``), each rank feeds
  its block of the pipeline's global batch, and checkpoints hold whole
  tensors, so any rank count resumes them.  A model axis above 1 is
  reached through the Python API, as the reference's.  Two deliberate
  differences from the reference: a periodic checkpoint is labelled with
  the steps it has taken (the reference labels it with the loop index of
  its last step, so a resume from it repeats that step), and a SIGTERM
  ends the run after the emergency save at the next step boundary (the
  reference's handler returns and training goes on).
  ``--fault-plan`` fires its ``sigterm`` faults at the ``step`` point.
* ``--mesh dist-grid``: the CNN on the explicit ``(Pb,Ph,Pw,Pk,Pc)`` grid
  through ``dist/train.py::make_resilient_train_loop``: the grid is
  re-synthesized over the ranks on every (re)start, restore walks back
  past corrupt checkpoints, a watchdog saves on wedged steps, SIGTERM
  saves and stops every rank at the same step, and ``--fault-plan`` (or
  the ``REPRO_FAULT_PLAN`` environment variable the reference reads too)
  injects deterministic failures (``fault/inject.py``).  ``--minimize
  time`` ranks the grids by the calibrated replay (``repro_torch.perf``,
  the table ``load_calib`` resolves: ``REPRO_CALIB``, else the
  checked-in ``CALIB.json``) and prints one ``[calib]`` line with that
  table's provenance.  ``--ranks N`` starts N ranks through
  ``dist.spawn.run_spmd`` (gloo on the CPU, one card each under nccl); a
  world of one runs in this process, so a SIGTERM sent to it reaches the
  loop.  The ``[resilient]`` and ``[fault]`` lines are the reference's,
  letter for letter, so one regex reads either package's output.

CPU-scale runs::

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
      --smoke --device cpu --steps 20 --batch 8 --seq 64 --ckpt-dir /tmp/lm

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
      --smoke --device cpu --ranks 2 --steps 20 --batch 8 --seq 64

  PYTHONPATH=src python -m repro_torch.launch.train --mesh dist-grid \\
      --ranks 8 --device cpu --steps 20 --batch 8 --ckpt-dir /tmp/ckpt \\
      --fault-plan '{"faults": [{"kind": "sigterm", "step": 12}]}'

On a card: drop ``--device cpu`` (``--ranks 1`` for the grid; its
default there is one rank per card).
"""

from __future__ import annotations

import argparse
import time
from typing import Dict

import torch
from torch.utils import _pytree as pytree


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
    if args.minimize == "time":
        from repro_torch.perf.calibrate import provenance_line
        print(provenance_line(), flush=True)
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


def _main_host(args) -> Dict:
    """The dense LM trainer: in this process on one rank, else on
    ``--ranks`` ranks started by ``dist.spawn.run_spmd``; rank 0's
    report."""
    if args.ranks > 1:
        from repro_torch.device import resolve_device
        from repro_torch.dist.spawn import run_spmd
        device = resolve_device(args.device)
        return run_spmd(_host_rank, args.ranks, vars(args),
                        device=device.type)[0]
    return _host_loop(args)


def _host_rank(rank: int, args: Dict) -> Dict:
    return _host_loop(argparse.Namespace(**args))


def _host_loop(args) -> Dict:
    """The dense LM trainer on this rank; returns the report: each step's
    loss, the first and the end step, and whether a SIGTERM ended it.

    On more than one rank the state is placed on the reference's host
    mesh ``(ranks, 1)`` over ``("data", "model")`` by
    ``train.step.place_gspmd`` and each rank feeds its block of the
    pipeline's global batch.  Checkpoints hold whole tensors (gathered on
    every rank, written by rank 0), so a resume does not depend on the
    writer's rank count.  The SIGTERM handler only raises a flag there;
    a one-int vote (``collectives.any_rank``) stops every rank at the
    same step, as a straggler's checkpoint is voted."""
    from repro_torch.ckpt.checkpointer import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import (DataConfig, Prefetcher,
                                           SyntheticTokens, to_torch)
    from repro_torch.device import resolve_device
    from repro_torch.dist import collectives as C
    from repro_torch.fault.inject import FaultInjector
    from repro_torch.fault.monitor import EmergencySaver, StragglerMonitor
    from repro_torch.models.api import model_fns
    from repro_torch.models.layers import set_attention_mesh
    from repro_torch.train.optim import AdamW, cosine_schedule
    from repro_torch.train.step import (init_train_state, make_train_step,
                                        place_gspmd)

    device = resolve_device(args.device)
    ranks, rank = C.world_size(), C.world_rank()
    say = print if rank == 0 else (lambda *a, **k: None)
    cfg = get_config(args.arch, smoke=args.smoke)
    fns = model_fns(cfg)
    say(f"[train] {cfg.arch_id} ({'smoke' if args.smoke else 'full'}) "
        f"ranks={ranks} device={device.type} dtype={cfg.dtype}", flush=True)

    params = fns.init(torch.Generator(device=device).manual_seed(0), cfg,
                      device=device)
    n_params = sum(p.numel() for p in pytree.tree_leaves(params))
    say(f"[train] {n_params / 1e6:.2f}M params", flush=True)

    opt = AdamW(lr=cosine_schedule(args.lr, warmup=20, total=args.steps))
    state = init_train_state(params, opt)
    step_fn = make_train_step(lambda p, b: fns.loss(p, cfg, b), opt,
                              n_microbatches=args.microbatches,
                              mode="gspmd")

    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    start = 0
    if mgr and args.resume:
        restored, step = mgr.restore_latest(state, device=device)
        if restored is not None:
            state, start = restored, step
            say(f"[train] resumed from step {step}", flush=True)

    data_cfg = DataConfig(global_batch=args.batch, seq_len=args.seq,
                          vocab=cfg.vocab,
                          frames=cfg.family == "encdec",
                          d_model=cfg.d_model,
                          positions3d=cfg.family == "vlm")
    placement = None
    if ranks > 1:
        mesh = C.make_mesh((ranks, 1), ("data", "model"), device=device)
        placement = place_gspmd(
            cfg, mesh, state,
            to_torch(SyntheticTokens(data_cfg).batch_at(start), device))
        state = placement.state
        say(f"[train] mesh={{'data': {ranks}, 'model': 1}}", flush=True)

    def whole(st):
        return pytree.tree_map(C.full_tensor, st) if placement else st

    def save(step: int, async_: bool = False) -> None:
        full = whole(state)          # a collective: every rank gathers
        if rank == 0:
            mgr.save(full, step, async_=async_)

    saver = None
    if mgr:
        saver = EmergencySaver(
            (lambda: None) if placement else
            (lambda: (mgr.wait(), mgr.save(state, int(state.opt.step))))
        ).install()
    plan = _load_fault_plan(args.fault_plan)
    injector = FaultInjector(plan) if plan is not None else None

    pf = Prefetcher(SyntheticTokens(data_cfg), start_step=start)
    monitor = StragglerMonitor()
    losses, preempted, end = [], False, start
    try:
        t_last = time.time()
        for step in range(start, args.steps):
            if injector is not None:
                injector.fire("step", step, {"ckpt_root": args.ckpt_dir,
                                             "rank": rank})
            stop = saver is not None and saver.triggered
            if placement is not None and saver is not None:
                stop = C.any_rank(stop, device=device)
                if stop:
                    if rank == 0:
                        mgr.wait()
                    save(int(state.opt.step))
            if stop:
                preempted = True
                say(f"[train] preempted at step {step} (emergency "
                    f"checkpoint committed)", flush=True)
                break
            batch = to_torch(pf.next(), device)
            if placement is not None:
                batch = placement.place_batch(batch)
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])
            losses.append(loss)
            end = step + 1
            dt = time.time() - t_last
            t_last = time.time()
            straggling = monitor.observe(step, dt)
            if placement is not None:
                straggling = C.any_rank(straggling, device=device,
                                        tag="straggler_vote")
            if straggling:
                say(f"[fault] persistent straggling at step {step} "
                    f"(ema {monitor.stats.ema:.3f}s) — checkpointing",
                    flush=True)
                if mgr:
                    save(int(state.opt.step), async_=True)
                monitor.consecutive = 0
            if step % args.log_every == 0:
                say(f"step {step:5d} loss {loss:.4f} "
                    f"gnorm {float(metrics['grad_norm']):.3f} "
                    f"dt {dt*1e3:.0f}ms", flush=True)
            if mgr and step and step % args.ckpt_every == 0:
                save(int(state.opt.step), async_=True)
        if mgr and not preempted:
            if rank == 0:
                mgr.wait()
            save(args.steps)
            say(f"[train] final checkpoint at {args.steps}", flush=True)
    finally:
        pf.close()
        if mgr:
            mgr.wait()
        if saver:
            saver.uninstall()
        if placement is not None:
            set_attention_mesh(None)
    if losses:
        say(f"[train] done: final loss {losses[-1]:.4f}", flush=True)
    return {"losses": losses, "start_step": start, "end_step": end,
            "preempted": preempted}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--mesh", default="host",
                    choices=("host", "dist-grid"),
                    help="host: the dense LM trainer; dist-grid: the "
                         "resilient CNN on the conv grid")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--channels", default="8,8",
                    help="dist-grid CNN channel widths, comma-separated")
    ap.add_argument("--in-channels", type=int, default=4)
    ap.add_argument("--hw", type=int, default=8,
                    help="dist-grid input spatial extent")
    ap.add_argument("--classes", type=int, default=10)
    ap.add_argument("--schedule", default="allgather",
                    choices=("allgather", "ring", "ring2"))
    ap.add_argument("--minimize", default="comm",
                    choices=("comm", "time"),
                    help="grid='auto' objective: analytic wire volume "
                         "or calibrated replay time (CALIB.json)")
    ap.add_argument("--watchdog-timeout", type=float, default=0.0,
                    help="wedged-step watchdog (seconds; 0 disables)")
    ap.add_argument("--fault-plan", default="",
                    help="JSON FaultPlan or @file (fault/inject.py)")
    ap.add_argument("--fault-log", default="",
                    help="JSON-lines FaultEvent log path (rank 0)")
    ap.add_argument("--ranks", type=int, default=0,
                    help="ranks to start (host: default 1, N ranks on the "
                         "(N, 1) data x model mesh; dist-grid: default one "
                         "per card, or 1 on the CPU)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (gloo ranks)")
    args = ap.parse_args(argv)
    if args.mesh == "host":
        return _main_host(args)
    return _main_dist_grid(args)


if __name__ == "__main__":
    main()
