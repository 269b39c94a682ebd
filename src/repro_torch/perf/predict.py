"""Trace-replay step-time prediction from calibrated collectives -- the
port of ``repro/perf/predict.py``.

The analytic accounting (``conv/matmul_comm_elems``) counts *elements*
under a uniform-bandwidth assumption, yet analytically equal schedules
can differ ~2x in measured time (ring vs ring2 on the train/2D-DP grid
of the reference's ``BENCH_comm.json``).  This module closes the gap the
way byteprofile-analysis replays a profiled op DAG: every distributed
step is lowered to a sequence of :class:`CommEvent`\\ s (one per
collective the schedule issues, with its per-device element volume and
invocation count) plus a compute term, and :func:`replay_ms` prices the
sequence with the machine's calibrated alpha-beta constants
(:class:`repro_torch.perf.calibrate.CalibTable`):

    t = max(compute, overlapped-comm bytes) + latencies + serial comm

Ring-pipelined gathers (``schedule="ring"``/``"ring2"``) are marked
``overlap=True``: their byte time hides under the slab compute (the
``max``), but their per-hop latency (``alpha * (g-1)``) never does --
which is exactly why two wire-equal schedules can differ in wall time.

Entry points:

* :func:`predict_step_ms` -- dispatch on a spec dict or a bench record
  (``BENCH_*.json`` or ``perf/bench.py``'s);
* ``predict_conv_step_ms`` / ``predict_matmul_step_ms`` /
  ``predict_cnn_train_ms`` / ``predict_decode_step_ms`` -- typed
  convenience wrappers;
* :func:`rank_conv_schedules` -- order schedules on one grid by
  predicted time (``minimize="time"``) or analytic wire
  (``minimize="comm"``, which ties ring vs ring2 by construction).

With the unit table (``CalibTable.unit()``: alpha=0, beta=1 ms/elem,
infinite compute rate) every prediction degenerates to the analytic
element count.

The DAGs are built from the port's own accounting (``repro_torch.dist``),
imported when a DAG is built: importing this module imports neither
torch nor numpy.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

#: Event keys the calibration table is indexed by.  ``ppermute`` is
#: split per schedule (a fori_loop ring hop and a ring2 zip hop have
#: different launch overheads) and ``dispatch/*`` are the per-op fixed
#: overheads (shard_map entry, cache bookkeeping) with no byte term.
EVENT_KEYS = (
    "all_gather", "reduce_scatter", "all_reduce", "psum",
    "ppermute/ring", "ppermute/ring2", "ppermute/halo",
    "dispatch/conv", "dispatch/matmul", "dispatch/decode",
)


@dataclasses.dataclass(frozen=True)
class CommEvent:
    """One collective of a step: ``steps`` invocations moving ``elems``
    per-device elements in total.  ``overlap=True`` marks ring-pipelined
    byte time that hides under the step's compute."""

    key: str
    elems: float
    steps: int = 1
    overlap: bool = False


@dataclasses.dataclass(frozen=True)
class StepDag:
    """The replayable op DAG of one step: collectives + compute flops."""

    events: Tuple[CommEvent, ...]
    flops: float
    name: str = ""


def replay_ms(dag: StepDag, calib) -> float:
    """Price a step DAG with the calibrated constants (see module doc)."""
    compute = dag.flops / calib.compute_flops_per_ms
    serial = 0.0
    overlapped = 0.0
    latency = 0.0
    for ev in dag.events:
        ent = calib.lookup(ev.key)
        t_bytes = ent.beta_ms_per_elem * ev.elems
        t_alpha = ent.alpha_ms * ev.steps
        if ev.overlap:
            overlapped += t_bytes
            latency += t_alpha
        else:
            serial += t_bytes + t_alpha
    return max(compute, overlapped) + latency + serial


def _default_calib(calib):
    if calib is None:
        from repro_torch.perf.calibrate import load_calib
        calib = load_calib()
    return calib


# --------------------------------------------------------------- conv ----

def _gather_event(schedule: str, ring: int, elems: float,
                  kind_serial: str) -> List[CommEvent]:
    """A gather (fwd) or its reduce-scatter transpose (bwd) over a ring
    of size ``ring``: one collective under ``allgather``, ``ring - 1``
    pipelined ppermute hops under the ring schedules."""
    if ring <= 1 or elems <= 0:
        return []
    if schedule in ("ring", "ring2"):
        return [CommEvent(f"ppermute/{schedule}", elems, steps=ring - 1,
                          overlap=True)]
    return [CommEvent(kind_serial, elems)]


def conv_step_dag(x_shape, w_shape, grid, *, stride=(1, 1),
                  padding="SAME", schedule: str = "allgather",
                  train: bool = False,
                  save_gathered: bool = False) -> StepDag:
    """The replayable DAG of one distributed conv fwd (or fwd+bwd) step
    on ``grid = (Pb, Ph, Pw, Pk, Pc)`` — built from the same analytic
    breakdown the HLO wire validation checks, so byte totals can never
    drift from ``conv_(train_)comm_elems``."""
    from repro_torch.core.problem import ConvProblem
    from repro_torch.dist.conv2d import (_conv_effective_schedule,
                                         conv_comm_elems,
                                         conv_train_comm_elems)
    from repro_torch.kernels.ops import pad_amounts as _pad_amounts

    if isinstance(stride, int):
        stride = (stride, stride)
    N, C, H, W = x_shape
    K, _, kh, kw = w_shape
    pb, ph, pw, pk, pc = grid
    schedule = _conv_effective_schedule(schedule, tuple(grid))
    pad_spec = (padding, padding) if isinstance(padding, str) else padding
    _, _, out_h = _pad_amounts(H, kh, stride[0], pad_spec[0])
    _, _, out_w = _pad_amounts(W, kw, stride[1], pad_spec[1])
    p = ConvProblem(Nb=N, Nk=K, Nc=C, Nh=out_h, Nw=out_w, Nr=kh, Ns=kw,
                    sh=stride[0], sw=stride[1])
    P_tot = pb * ph * pw * pk * pc
    fwd = conv_comm_elems(x_shape, w_shape, grid, stride=stride,
                          padding=padding)
    halo_steps = 2 * ((ph > 1) + (pw > 1))

    events: List[CommEvent] = [CommEvent("dispatch/conv", 0.0)]
    events += _gather_event(schedule, pk, fwd["gather_in"], "all_gather")
    events += _gather_event(schedule, pb, fwd["gather_ker"], "all_gather")
    if fwd["halo"] > 0:
        events.append(CommEvent("ppermute/halo", fwd["halo"],
                                steps=halo_steps))
    if fwd["reduce_out"] > 0:
        events.append(CommEvent("all_reduce", fwd["reduce_out"]))
    flops = p.flops() / P_tot
    if not train:
        return StepDag(tuple(events), flops, name="conv_fwd")

    bwd = conv_train_comm_elems(x_shape, w_shape, grid, stride=stride,
                                padding=padding, schedule=schedule,
                                save_gathered=save_gathered)["bwd"]
    events.append(CommEvent("dispatch/conv", 0.0))
    events += _gather_event(schedule, pk, bwd["gather_in_replay"],
                            "all_gather")
    events += _gather_event(schedule, pb, bwd["gather_ker_replay"],
                            "all_gather")
    if bwd["halo_replay"] > 0:
        events.append(CommEvent("ppermute/halo", bwd["halo_replay"],
                                steps=halo_steps))
    events += _gather_event(schedule, pk, bwd["rs_in"], "reduce_scatter")
    events += _gather_event(schedule, pb, bwd["rs_ker"], "reduce_scatter")
    if bwd["psum_ker_spatial"] > 0:
        events.append(CommEvent("psum", bwd["psum_ker_spatial"]))
    if bwd["psum_out_bwd"] > 0:
        events.append(CommEvent("all_reduce", bwd["psum_out_bwd"]))
    if bwd["halo_acc"] > 0:
        events.append(CommEvent("ppermute/halo", bwd["halo_acc"],
                                steps=halo_steps))
    # fwd GEMM + dIn GEMM + dKer GEMM
    return StepDag(tuple(events), 3.0 * flops, name="conv_train")


def predict_conv_step_ms(x_shape, w_shape, grid, *, stride=(1, 1),
                         padding="SAME", schedule: str = "allgather",
                         train: bool = False, save_gathered: bool = False,
                         calib=None) -> float:
    return replay_ms(conv_step_dag(x_shape, w_shape, grid, stride=stride,
                                   padding=padding, schedule=schedule,
                                   train=train,
                                   save_gathered=save_gathered),
                     _default_calib(calib))


# ------------------------------------------------------------- matmul ----

def matmul_step_dag(M: int, C: int, N: int, grid, *,
                    schedule: str = "allgather", train: bool = False,
                    save_gathered: bool = False) -> StepDag:
    """The replayable DAG of one ``matmul_distributed`` step on
    ``grid = (Pm, Pn, Pc)``."""
    from repro_torch.dist.matmul import (_matmul_effective_schedule,
                                         matmul_comm_elems,
                                         matmul_train_comm_elems)

    pm, pn, pc = grid
    schedule = _matmul_effective_schedule(schedule, tuple(grid))
    fwd = matmul_comm_elems(M, C, N, grid)
    events: List[CommEvent] = [CommEvent("dispatch/matmul", 0.0)]
    events += _gather_event(schedule, pn, fwd["gather_in"], "all_gather")
    events += _gather_event(schedule, pm, fwd["gather_ker"], "all_gather")
    if fwd["reduce_out"] > 0:
        events.append(CommEvent("all_reduce", fwd["reduce_out"]))
    flops = 2.0 * M * C * N / (pm * pn * pc)
    if not train:
        return StepDag(tuple(events), flops, name="matmul_fwd")

    bwd = matmul_train_comm_elems(M, C, N, grid,
                                  save_gathered=save_gathered)["bwd"]
    events.append(CommEvent("dispatch/matmul", 0.0))
    events += _gather_event(schedule, pn, bwd["gather_in_replay"],
                            "all_gather")
    events += _gather_event(schedule, pm, bwd["gather_ker_replay"],
                            "all_gather")
    events += _gather_event(schedule, pn, bwd["rs_in"], "reduce_scatter")
    events += _gather_event(schedule, pm, bwd["rs_ker"], "reduce_scatter")
    if bwd["psum_out_bwd"] > 0:
        events.append(CommEvent("all_reduce", bwd["psum_out_bwd"]))
    return StepDag(tuple(events), 3.0 * flops, name="matmul_train")


def predict_matmul_step_ms(M: int, C: int, N: int, grid, *,
                           schedule: str = "allgather",
                           train: bool = False,
                           save_gathered: bool = False,
                           calib=None) -> float:
    return replay_ms(matmul_step_dag(M, C, N, grid, schedule=schedule,
                                     train=train,
                                     save_gathered=save_gathered),
                     _default_calib(calib))


# ------------------------------------------------------- whole models ----

def cnn_train_dag(x_shape, channels, n_classes: int, grid, *, k: int = 3,
                  pool_every: int = 2, schedule: str = "allgather",
                  save_gathered: bool = False) -> StepDag:
    """Concatenated per-layer DAG of one CNN train step on the shared
    ``(Pb, Ph, Pw, Pk, Pc)`` grid (layers execute sequentially)."""
    from repro_torch.dist.matmul import matmul_grid_divides
    from repro_torch.dist.train import _cnn_layer_shapes

    events: List[CommEvent] = []
    flops = 0.0
    for xs, ws in _cnn_layer_shapes(x_shape, channels, k=k,
                                    pool_every=pool_every):
        dag = conv_step_dag(xs, ws, grid, schedule=schedule, train=True,
                            save_gathered=save_gathered)
        events.extend(dag.events)
        flops += dag.flops
    pb, ph, pw, pk, pc = grid
    mm_grid = (pb * ph * pw, pk, pc)
    N, cin = x_shape[0], channels[-1]
    if matmul_grid_divides(N, cin, n_classes, mm_grid):
        head = matmul_step_dag(N, cin, n_classes, mm_grid,
                               schedule=schedule, train=True,
                               save_gathered=save_gathered)
        events.extend(head.events)
        flops += head.flops
    else:
        flops += 3.0 * 2.0 * N * cin * n_classes   # replicated dense head
    return StepDag(tuple(events), flops, name="cnn_train")


def predict_cnn_train_ms(x_shape, channels, n_classes: int, grid, *,
                         k: int = 3, pool_every: int = 2,
                         schedule: str = "allgather",
                         save_gathered: bool = False,
                         calib=None) -> float:
    return replay_ms(cnn_train_dag(x_shape, channels, n_classes, grid,
                                   k=k, pool_every=pool_every,
                                   schedule=schedule,
                                   save_gathered=save_gathered),
                     _default_calib(calib))


def lm_decode_dag(cfg, grid, *, slots: int,
                  schedule: str = "allgather") -> StepDag:
    """One decode token step across all ``slots``: every grid-routed
    projection replays as a matmul DAG, dense fallbacks (and
    ``grid=None``) contribute replicated compute only, MoE adds the
    combine all-reduce — mirroring ``lm_serve_comm_elems``."""
    from repro_torch.dist.lm import (_moe_decode_group, lm_decode_matmuls,
                                     moe_ffn_comm_elems,
                                     moe_ffn_grid_divides,
                                     projection_routed)

    events: List[CommEvent] = [CommEvent("dispatch/decode", 0.0)]
    flops = 0.0
    for name, M, C, N in lm_decode_matmuls(cfg, slots):
        mult = 1 if name == "lm_head" else cfg.n_layers
        if grid is not None and projection_routed(M, C, N, grid):
            dag = matmul_step_dag(M, C, N, grid, schedule=schedule)
            events.extend(list(dag.events) * mult)
            flops += mult * dag.flops
        else:
            flops += mult * 2.0 * M * C * N    # replicated dense fallback
    if cfg.is_moe:
        g, t = _moe_decode_group(cfg, slots)
        d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
        if grid is not None and moe_ffn_grid_divides(e, f, grid):
            pm, pn, pc = grid
            elems = moe_ffn_comm_elems(g, t, d, grid)
            if elems > 0:
                events.extend([CommEvent("all_reduce", elems)]
                              * cfg.n_layers)
            flops += cfg.n_layers * 3.0 * 2.0 * g * t * d * f / (pn * pc)
        else:
            flops += cfg.n_layers * 3.0 * 2.0 * g * t * d * f
    return StepDag(tuple(events), flops, name="lm_decode")


def predict_decode_step_ms(cfg, grid, *, slots: int,
                           schedule: str = "allgather",
                           calib=None) -> float:
    return replay_ms(lm_decode_dag(cfg, grid, slots=slots,
                                   schedule=schedule),
                     _default_calib(calib))


# ----------------------------------------------- record/spec dispatch ----

def record_dag(rec: Dict) -> Optional[StepDag]:
    """Rebuild the replayable DAG of a ``BENCH_*.json`` record (or a
    synthetic micro-record carrying an explicit ``kind``).  Returns
    ``None`` for records the replay model cannot price (e.g. legacy
    records missing the shape fields).

    One addition to the reference: a ``train/cnn/<algo>`` record
    (``perf/bench.py``'s record of a whole CNN train step) replays as
    :func:`cnn_train_dag` from its ``x_shape`` (the images),
    ``channels``, ``n_classes``, ``k``, ``pool_every``, ``grid`` and
    ``schedule``.  The reference's ``record_dag`` knows no such name and
    skips the record."""
    if "kind" in rec:      # synthetic per-collective micro-record
        return StepDag(
            (CommEvent(rec["kind"], float(rec["elems"]),
                       steps=int(rec.get("steps", 1)),
                       overlap=bool(rec.get("overlap", False))),),
            float(rec.get("flops", 0.0)), name=f"micro/{rec['kind']}")
    name = rec.get("name", "")
    if name.startswith("comm/"):
        if "x_shape" not in rec or "w_shape" not in rec:
            return None
        train = "/train" in name
        sg = "save-gathered" in name
        return conv_step_dag(tuple(rec["x_shape"]), tuple(rec["w_shape"]),
                             tuple(rec["grid"]), schedule=rec["schedule"],
                             train=train, save_gathered=sg)
    if name.startswith("train/cnn/"):
        return cnn_train_dag(tuple(rec["x_shape"]), list(rec["channels"]),
                             int(rec["n_classes"]), tuple(rec["grid"]),
                             k=int(rec["k"]),
                             pool_every=int(rec["pool_every"]),
                             schedule=rec["schedule"])
    if name.startswith("kernel/"):
        if "flops" not in rec:
            return None
        return StepDag((), float(rec["flops"]), name="kernel")
    if name.startswith("serve/"):
        import dataclasses as _dc

        from repro_torch.configs import get_config
        if "slots" not in rec:
            return None
        cfg = get_config(rec["arch"], smoke=rec.get("smoke", True))
        if rec.get("dtype"):
            cfg = _dc.replace(cfg, dtype=rec["dtype"])
        grid = tuple(rec["grid"]) if rec.get("grid") else None
        return lm_decode_dag(cfg, grid, slots=int(rec["slots"]),
                             schedule=rec["schedule"])
    return None


def predict_step_ms(spec, grid=None, schedule: str = "allgather", *,
                    calib=None) -> float:
    """Predict the wall time (ms) of one step.

    ``spec`` is a ``BENCH_*.json`` record / micro-record dict (then
    ``grid``/``schedule`` come from the record), a :class:`StepDag`, or
    a ``repro_torch.models.config.ModelConfig`` (LM decode on ``grid`` with
    ``spec.serve_slots`` or 4 slots).  Raises ``ValueError`` for specs
    the replay model cannot price.
    """
    calib = _default_calib(calib)
    if isinstance(spec, StepDag):
        return replay_ms(spec, calib)
    if isinstance(spec, dict):
        dag = record_dag(spec)
        if dag is None:
            raise ValueError(f"cannot rebuild a DAG for record "
                             f"{spec.get('name', spec)!r}")
        return replay_ms(dag, calib)
    if hasattr(spec, "arch_id"):     # ModelConfig duck-type
        slots = getattr(spec, "serve_slots", None) or 4
        return predict_decode_step_ms(spec, grid, slots=slots,
                                      schedule=schedule, calib=calib)
    raise ValueError(f"unsupported spec {type(spec).__name__}")


# ------------------------------------------------- schedule re-ranking ----

def rank_conv_schedules(x_shape, w_shape, grid, *,
                        schedules: Sequence[str] = ("allgather", "ring",
                                                    "ring2"),
                        stride=(1, 1), padding="SAME", train: bool = True,
                        minimize: str = "time",
                        calib=None) -> List[Tuple[str, float]]:
    """Order ``schedules`` on one conv grid, best first.

    ``minimize="comm"`` scores by the analytic wire total — which is
    *identical* for every schedule (each operand piece crosses its ring
    once however it is pipelined), so the analytic model provably cannot
    separate them.  ``minimize="time"`` scores by the calibrated replay,
    where per-hop latencies and pipelining differ — the measured 2x gap
    ``BENCH_comm.json`` records between ring and ring2 on the
    train/2D-DP grid.  Ties keep the input order (stable sort).
    """
    from repro_torch.dist.conv2d import (conv_comm_elems,
                                         conv_train_comm_elems)
    if minimize not in ("comm", "time"):
        raise ValueError(f"minimize must be 'comm' or 'time', "
                         f"got {minimize!r}")
    calib = _default_calib(calib)
    scored = []
    for sched in schedules:
        if minimize == "time":
            score = predict_conv_step_ms(
                x_shape, w_shape, grid, stride=stride, padding=padding,
                schedule=sched, train=train, calib=calib)
        elif train:
            score = conv_train_comm_elems(x_shape, w_shape, grid,
                                          stride=stride, padding=padding,
                                          schedule=sched)["total"]
        else:
            score = conv_comm_elems(x_shape, w_shape, grid, stride=stride,
                                    padding=padding)["total"]
        scored.append((sched, score))
    return sorted(scored, key=lambda sc: sc[1])
