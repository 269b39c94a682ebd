"""Grid-parallel CNN training -- the port of ``repro/dist/train.py``: the
train step, its analytic accounting, and the fault-tolerant loop around
it (:func:`make_resilient_train_loop`).

The step built here runs the loss, its gradients and the AdamW update
with every conv and the classifier head on the explicit-grid ``dist``
ops, whose backward passes transpose the forward schedule on the same
``(Pb, Ph, Pw, Pk, Pc)`` grid.  It is per-rank code: every rank passes
the same global batch and full parameters, and every rank ends the step
with the same updated parameters.

``cnn_train_comm_elems`` walks the layer structure of
``models.cnn.forward_cnn`` and sums the analytic per-rank fwd+bwd wire of
the dist *ops*; the inter-layer reshards (tag ``"reshard"``) come on
top.

The resilient loop is SPMD, where the reference's is one controller over
many devices: every rank runs it, and three things follow.  The ranks
stop at the same step: at the top of each step they agree whether any of
them was signalled (``collectives.any_rank``, tag ``stop_vote``, outside
every analytic count).  Rank 0 alone writes checkpoints, since the
parameters are full and equal on every rank, and the faults that touch
files act there only.  Every rank restores the same committed step, so a
restart on another grid just loads the full tree.
"""

from __future__ import annotations

import dataclasses
import functools
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.ckpt.checkpointer import CheckpointManager
from repro_torch.device import resolve_device
from repro_torch.dist.collectives import any_rank, world_rank, world_size
from repro_torch.dist.conv2d import (conv_grid_divides,
                                     conv_train_comm_elems,
                                     conv_train_mem_elems, make_conv_mesh)
from repro_torch.dist.matmul import (matmul_grid_divides,
                                     matmul_train_comm_elems,
                                     matmul_train_mem_elems)
from repro_torch.fault.monitor import EmergencySaver, StragglerMonitor
from repro_torch.fault.watchdog import FaultEvent, FaultLog, StepWatchdog
from repro_torch.models.cnn import loss_cnn
from repro_torch.train.optim import AdamW
from repro_torch.train.step import TrainState, init_train_state, \
    make_train_step


def make_grid_train_step(optimizer: AdamW, mesh: DeviceMesh, *,
                         schedule: str = "allgather",
                         save_gathered: bool = False,
                         pool_every: int = 2,
                         n_microbatches: int = 1,
                         loss_fn: Optional[Callable] = None) -> Callable:
    """Train step (``(state, batch) -> (state, metrics)``) for the CNN on
    a 5-axis conv mesh, per rank.

    ``schedule`` picks the dist-op schedule (``allgather`` / ``ring`` /
    ``ring2``); ``save_gathered=True`` trades backward memory for zero
    gather-replay wire.  ``loss_fn(params, batch, dist_mesh=...,
    dist_schedule=..., dist_save_gathered=...)`` may be supplied to train
    a different model through the dist ops; it defaults to
    ``models.cnn.loss_cnn``."""
    base = loss_fn if loss_fn is not None else functools.partial(
        loss_cnn, pool_every=pool_every)
    loss = functools.partial(base, dist_mesh=mesh, dist_schedule=schedule,
                             dist_save_gathered=save_gathered)
    return make_train_step(loss, optimizer, n_microbatches=n_microbatches,
                           mode="dist-grid")


def init_grid_train_state(params, optimizer: AdamW) -> TrainState:
    """Train state for the grid-parallel step."""
    return init_train_state(params, optimizer)


def _cnn_layer_shapes(x_shape, channels: List[int], *, k: int,
                      pool_every: int) -> List[Tuple[tuple, tuple]]:
    """(x_shape, w_shape) per conv layer, mirroring ``forward_cnn``."""
    N, C, H, W = x_shape
    out = []
    cin = C
    for i, cout in enumerate(channels):
        out.append(((N, cin, H, W), (cout, cin, k, k)))
        cin = cout
        if (i + 1) % pool_every == 0:
            H, W = H // 2, W // 2
    return out


def cnn_train_comm_elems(x_shape, channels: List[int], n_classes: int,
                         grid, *, k: int = 3, pool_every: int = 2,
                         schedule: str = "allgather",
                         save_gathered: bool = False) -> Dict:
    """Analytic per-rank fwd+bwd wire (elements) of the dist ops in one
    CNN train step on ``grid = (Pb, Ph, Pw, Pk, Pc)``: one entry per conv
    layer plus the head matmul (0 when its shapes don't divide the
    matmul view and it runs dense)."""
    if len(grid) != 5:
        raise ValueError(f"conv grid must be (Pb,Ph,Pw,Pk,Pc), got {grid}")
    layers = [conv_train_comm_elems(xs, ws, grid, schedule=schedule,
                                    save_gathered=save_gathered)
              for xs, ws in _cnn_layer_shapes(x_shape, channels, k=k,
                                              pool_every=pool_every)]
    pb, ph, pw, pk, pc = grid
    mm_grid = (pb * ph * pw, pk, pc)
    N, cin = x_shape[0], channels[-1]
    if matmul_grid_divides(N, cin, n_classes, mm_grid):
        head = matmul_train_comm_elems(N, cin, n_classes, mm_grid,
                                       save_gathered=save_gathered)
    else:
        head = {"fwd": {"total": 0.0}, "bwd": {"total": 0.0}, "total": 0.0}
    total = sum(l["total"] for l in layers) + head["total"]
    return {"layers": layers, "head": head, "total": total,
            "fwd_total": sum(l["fwd"]["total"] for l in layers)
            + head["fwd"]["total"],
            "bwd_total": sum(l["bwd"]["total"] for l in layers)
            + head["bwd"]["total"]}


def cnn_train_mem_elems(x_shape, channels: List[int], n_classes: int,
                        grid, *, k: int = 3, pool_every: int = 2,
                        schedule: str = "allgather",
                        save_gathered: bool = False) -> Dict:
    """Analytic per-rank peak live memory (elements) of the dist ops in
    one CNN train step: the per-layer peaks and their max (layers run one
    after another)."""
    if len(grid) != 5:
        raise ValueError(f"conv grid must be (Pb,Ph,Pw,Pk,Pc), got {grid}")
    layers = [conv_train_mem_elems(xs, ws, grid, schedule=schedule,
                                   save_gathered=save_gathered)
              for xs, ws in _cnn_layer_shapes(x_shape, channels, k=k,
                                              pool_every=pool_every)]
    pb, ph, pw, pk, pc = grid
    mm_grid = (pb * ph * pw, pk, pc)
    N, cin = x_shape[0], channels[-1]
    if matmul_grid_divides(N, cin, n_classes, mm_grid):
        head = matmul_train_mem_elems(N, cin, n_classes, mm_grid,
                                      schedule=schedule,
                                      save_gathered=save_gathered)
    else:
        head = {"peak": 0.0}
    peak = max([l["peak"] for l in layers] + [head["peak"]])
    return {"layers": layers, "head": head, "peak": peak}


def grid_divides_cnn(x_shape, channels: List[int], grid, *, k: int = 3,
                     pool_every: int = 2) -> bool:
    """True when every conv layer of the CNN satisfies the divisibility
    constraints of ``conv2d_distributed`` on ``grid``."""
    return all(conv_grid_divides(xs, ws, grid)
               for xs, ws in _cnn_layer_shapes(x_shape, channels, k=k,
                                               pool_every=pool_every))


# ===================================================== resilient loop ====
#
# The preemption-safe, elastic, watchdogged loop around the grid train
# step: CheckpointManager (crc32-verified, falls back past corrupt
# steps) + EmergencySaver (SIGTERM) + StepWatchdog (wedged steps) +
# StragglerMonitor + FaultInjector hooks, with the grid re-synthesized
# over whatever ranks a restart finds.


@dataclasses.dataclass
class ResilienceConfig:
    """Knobs of :func:`make_resilient_train_loop`.

    ``ckpt_dir=""`` disables checkpointing (then SIGTERM and wedges still
    log events, but nothing is saved); ``watchdog_timeout_s=None``
    disables the wedge watchdog.
    """

    ckpt_dir: str = ""
    ckpt_every: int = 5
    keep: int = 3
    watchdog_timeout_s: Optional[float] = None
    schedule: str = "allgather"
    save_gathered: bool = False
    pool_every: int = 2
    minimize: str = "comm"   # grid="auto" objective: "comm" | "time"
    straggler_z: float = 3.0
    straggler_patience: int = 3
    fault_log_path: Optional[str] = None


def make_synthetic_cnn_batches(x_shape, n_classes: int, *, seed: int = 0,
                               device=None) -> Callable[[int], Dict]:
    """Deterministic ``batch_fn(step)``: the same step always yields the
    same batch, in the first run and in every resumed one, so a restarted
    trajectory is comparable to an uninterrupted one.  The batch is drawn
    from a CPU generator seeded with ``seed * 1_000_003 + step`` and moved
    to ``device`` (``cuda`` by default), so a card and the CPU see the
    same batch."""
    device = resolve_device(device)

    def batch_fn(step: int) -> Dict:
        gen = torch.Generator().manual_seed(seed * 1_000_003 + step)
        images = torch.randn(tuple(x_shape), generator=gen)
        labels = torch.randint(0, n_classes, (x_shape[0],), generator=gen)
        return {"images": images.to(device), "labels": labels.to(device)}
    return batch_fn


def make_resilient_train_loop(optimizer: AdamW, rcfg: ResilienceConfig,
                              *, grid=None,
                              loss_fn: Optional[Callable] = None,
                              injector=None, device=None) -> Callable:
    """Build ``run(init_params_fn, batch_fn, steps) -> report``, the
    fault-tolerant CNN train loop on the explicit conv grid, run by every
    rank of the process group (or alone, without one).

    ``grid``: a ``(Pb,Ph,Pw,Pk,Pc)`` tuple, ``"auto"`` (synthesized over
    the process group's ranks by ``synthesize_cnn_grid``: the elastic
    path, where a restart on fewer ranks picks a new grid and loads the
    full checkpoint onto it), or ``None`` (the dense loop on ``device``,
    the same loop semantics without a grid).  ``device``: ``cuda`` by
    default; the parameters ``init_params_fn()`` returns must be there.

    ``batch_fn(step)`` must be deterministic in ``step``
    (:func:`make_synthetic_cnn_batches`): a resumed run re-reads exactly
    the batches the lost steps would have seen.

    The report dict: ``state``, ``losses`` (one per executed step),
    ``step_s`` (their wall seconds), ``start_step`` / ``end_step``,
    ``grid``, ``preempted`` (a SIGTERM on any rank stopped the loop after
    the emergency save) and ``events`` (this rank's :class:`FaultEvent`
    list).  Only rank 0 writes the event log's file.
    """
    def run(init_params_fn: Callable[[], Dict],
            batch_fn: Callable[[int], Dict], steps: int) -> Dict:
        dev = resolve_device(device)
        card = torch.cuda.current_device() if dev.type == "cuda" else None
        rank = world_rank()
        log = FaultLog(rcfg.fault_log_path if rank == 0 else None)
        if injector is not None:
            injector.log = log  # injected faults land in the report
        mgr = (CheckpointManager(rcfg.ckpt_dir, keep=rcfg.keep)
               if rcfg.ckpt_dir else None)
        writer = mgr if rank == 0 else None
        state = init_grid_train_state(init_params_fn(), optimizer)
        start = 0
        if mgr is not None:
            restored, meta_step = mgr.restore_latest(
                state, on_corrupt=lambda s, e: log.emit(FaultEvent(
                    kind="corrupt_ckpt", step=s, detail=str(e))))
            if restored is not None:
                state, start = restored, int(meta_step)

        # ---- grid resolution (the elastic re-synthesis point) -------
        if grid == "auto":
            if loss_fn is not None:
                raise ValueError(
                    "grid='auto' introspects the CNN params; pass an "
                    "explicit grid with a custom loss_fn")
            from repro_torch.core.sharding_synthesis import \
                synthesize_cnn_grid
            x_shape = tuple(batch_fn(start)["images"].shape)
            channels = [b["w"].shape[0] for b in state.params["convs"]]
            n_classes = state.params["head"].shape[1]
            n = world_size()
            choice = synthesize_cnn_grid(
                x_shape, channels, n_classes, n,
                pool_every=rcfg.pool_every, schedule=rcfg.schedule,
                minimize=rcfg.minimize)
            grid_t = choice.grid
            log.emit(FaultEvent(
                kind="elastic_plan", step=start,
                detail=f"grid {grid_t} over {n} devices ({choice.algo})"))
        else:
            grid_t = tuple(grid) if grid is not None else None

        if grid_t is not None:
            step_fn = make_grid_train_step(
                optimizer, make_conv_mesh(grid_t, device=dev),
                schedule=rcfg.schedule, save_gathered=rcfg.save_gathered,
                pool_every=rcfg.pool_every, loss_fn=loss_fn)
        else:
            base = loss_fn if loss_fn is not None else functools.partial(
                loss_cnn, pool_every=rcfg.pool_every)
            step_fn = make_train_step(base, optimizer)

        # ---- emergency save machinery -------------------------------
        # `last` is the last COMPLETED (state, step); the saver and the
        # watchdog thread read it while the main thread may be stuck in a
        # wedged step.  The update is functional, so that state is never
        # written again.  `save_lock` serializes every save path.
        holder = {"last": (state, start)}
        save_lock = threading.RLock()

        def emergency_save() -> None:
            if writer is None:
                return
            if card is not None:  # the watchdog thread's device
                torch.cuda.set_device(card)
            with save_lock:
                writer.wait()
                writer.save(*holder["last"])

        def on_sigterm(detail: str = "emergency checkpoint") -> None:
            done = holder["last"][1]
            log.emit(FaultEvent(kind="sigterm", step=done,
                                detail=f"{detail} at step {done}"))
            emergency_save()

        saver = EmergencySaver(on_sigterm).install()
        wd = (StepWatchdog(rcfg.watchdog_timeout_s,
                           on_wedge=lambda s, dt: emergency_save(), log=log)
              if rcfg.watchdog_timeout_s else None)
        monitor = StragglerMonitor(z=rcfg.straggler_z,
                                   patience=rcfg.straggler_patience)
        ctx = {"ckpt_root": rcfg.ckpt_dir, "log": log, "rank": rank}

        losses: List[float] = []
        step_s: List[float] = []
        preempted = False
        try:
            for step in range(start, steps):
                if wd is not None:
                    wd.arm(step)
                try:
                    if injector is not None:
                        injector.fire("step", step, ctx)
                    # every rank stops at the same step
                    if any_rank(saver.triggered, device=dev):
                        if not saver.triggered:
                            on_sigterm("a peer rank was signalled; "
                                       "emergency checkpoint")
                        preempted = True
                        break
                    batch = batch_fn(step)
                    t0 = time.monotonic()
                    state, metrics = step_fn(state, batch)
                    loss = float(metrics["loss"])  # waits for the step
                finally:
                    if wd is not None:
                        wd.disarm()
                dt = time.monotonic() - t0
                losses.append(loss)
                step_s.append(dt)
                holder["last"] = (state, step + 1)
                if monitor.observe(step, dt):
                    log.emit(FaultEvent(
                        kind="straggler", step=step,
                        detail=f"dt {dt:.3f}s vs ema "
                               f"{monitor.stats.ema:.3f}s — "
                               f"checkpointing"))
                    if writer is not None:
                        with save_lock:
                            writer.save(state, step + 1, async_=True)
                    monitor.consecutive = 0
                elif writer is not None and (step + 1) % rcfg.ckpt_every == 0:
                    with save_lock:
                        writer.save(state, step + 1, async_=True)
        finally:
            if wd is not None:
                wd.close()
            saver.uninstall()
            if writer is not None:
                with save_lock:
                    writer.wait()
        end = start + len(losses)
        if writer is not None and not preempted and end > start:
            with save_lock:
                writer.save(state, end)
        return {"state": state, "losses": losses, "step_s": step_s,
                "start_step": start, "end_step": end, "grid": grid_t,
                "preempted": preempted, "events": list(log.events)}

    return run
