"""Map the paper's processor-grid synthesis onto a physical mesh -- the
port of ``repro/core/sharding_synthesis.py``.

The paper synthesizes a logical grid ``P_bhw x P_k x P_c`` per operator.  A
real machine exposes a fixed mesh (e.g. ``(pod, data, model)``).
:func:`synthesize_layer` assigns each physical mesh axis wholly to one
logical dimension so that the resulting factorization minimizes the
paper's Eq. 3 cost, and :class:`LayerSharding` gives the specs of the
three tensors of the matmul view:

  logical dim   role                              tensor dims sharded
  ----------    ------------------------------    -------------------
  bhw           data parallelism                  In.b / Out.b (and h/w)
  k             output-feature (column) TP        Ker.k / Out.k
  c             contraction (row) TP + reduce     In.c / Ker.c   (+ psum Out)

The JAX package returns ``jax.sharding.PartitionSpec``s there; the port
returns its own spec convention, the one ``dist.collectives.shard`` and
``dist.conv2d.IN_SPEC`` use: a tuple with one entry per tensor dim --
``None`` (replicated), an axis name, or a tuple of axis names.

The synthesizer also emits explicit ``(Pb, Ph, Pw, Pk, Pc)`` grids for the
``repro_torch.dist`` runtime (:func:`synthesize_dist_grid`, one conv;
:func:`synthesize_cnn_grid`, one grid for every layer of the CNN): it
enumerates every factorization of the device count over the five conv
axes that satisfies the runtime's sub-shard divisibility constraints and
minimizes the fwd+bwd training cost (``cost_model.cost_distributed_train``)
-- the grid a ``dist/train.py`` train step should run on.  The runtime
accounting it reads is imported when a synthesizer runs, so importing
this module does not import ``torch.distributed``.

It also picks the ``(Pm, Pn, Pc)`` grid of the LM serving engine
(:func:`synthesize_serve_grid`, reading ``dist.lm``'s accounting).

Each synthesizer ranks by the analytic objective (``minimize="comm"``)
or by the calibrated trace-replay prediction (``minimize="time"``,
``repro_torch.perf``, under ``calib=`` or the table ``load_calib``
resolves); ``synthesize_dist_grid``'s ``schedule="auto"`` (time mode
only) searches the schedules beside the grids.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core import cost_model, tile_optimizer
from repro_torch.core.cost_model import TileChoice
from repro_torch.core.problem import ConvProblem

Spec = Tuple[object, ...]

LOGICAL_DIMS = ("bhw", "k", "c")


@dataclasses.dataclass(frozen=True)
class LayerSharding:
    """Result of synthesis for one operator on a concrete mesh."""

    assignment: Dict[str, str]       # mesh axis -> logical dim ("bhw"|"k"|"c")
    factors: Dict[str, int]          # logical dim -> product of axis sizes
    algo: str                        # 2D-SUMMA / 2.5D / 3D analogue
    case: str
    cost: float                      # Eq. 3 cost (elements / processor)
    choice: TileChoice

    def axes_for(self, logical: str) -> Tuple[str, ...]:
        """Physical mesh axes assigned to a logical dim (stable order)."""
        return tuple(ax for ax, dim in self.assignment.items()
                     if dim == logical)

    # ---- specs for the matmul view  x:[m,k] w:[k,n] y:[m,n] ------
    def spec_activation(self) -> Spec:
        """x[m(=bhw), c]"""
        return (self._spec(("bhw",)), self._spec(("c",)))

    def spec_weight(self) -> Spec:
        """w[c, k]"""
        return (self._spec(("c",)), self._spec(("k",)))

    def spec_output(self) -> Spec:
        """y[m, k] — partial-summed over the 'c' axes (caller psums)."""
        return (self._spec(("bhw",)), self._spec(("k",)))

    def reduce_axes(self) -> Tuple[str, ...]:
        """Mesh axes over which Out is a partial sum (the 2.5D/3D c axes)."""
        return self.axes_for("c")

    def _spec(self, dims: Sequence[str]):
        axes: List[str] = []
        for d in dims:
            axes.extend(self.axes_for(d))
        if not axes:
            return None
        return tuple(axes) if len(axes) > 1 else axes[0]


def synthesize_layer(p: ConvProblem, mesh_axes: Dict[str, int], M: float,
                     *, ml_correction: bool = True,
                     forced: Optional[Dict[str, str]] = None) -> LayerSharding:
    """Choose the cost-minimizing assignment of mesh axes to logical dims.

    ``forced`` pins specific mesh axes to logical dims (e.g. batch must stay
    on the data axis for a training step shared across layers).
    """
    axes = list(mesh_axes.items())
    Ptot = math.prod(s for _, s in axes)
    M_L = cost_model.ml_from_m(p, M) if ml_correction else float(M)

    best: Optional[LayerSharding] = None
    for combo in itertools.product(LOGICAL_DIMS, repeat=len(axes)):
        assignment = {ax: dim for (ax, _), dim in zip(axes, combo)}
        if forced and any(assignment[a] != d for a, d in forced.items()):
            continue
        factors = {d: 1 for d in LOGICAL_DIMS}
        for (ax, size), dim in zip(axes, combo):
            factors[dim] *= size
        if (factors["bhw"] > p.Nbhw or factors["k"] > p.Nk
                or factors["c"] > p.Nc):
            continue
        Wbhw = p.Nbhw / factors["bhw"]
        Wk = p.Nk / factors["k"]
        Wc = p.Nc / factors["c"]
        Tbhw, Tk = tile_optimizer._best_tiles_given_W(p, Wbhw, Wk, M_L)
        choice = TileChoice(Wbhw=Wbhw, Wk=Wk, Wc=Wc, Tbhw=Tbhw, Tk=Tk)
        cost = cost_model.cost_global_memory(p, choice)
        if best is None or cost < best.cost:
            case = tile_optimizer.classify(p, Ptot, M_L, choice)
            best = LayerSharding(
                assignment=assignment, factors=factors,
                algo=tile_optimizer._CASE_TO_ALGO[case], case=case,
                cost=cost, choice=choice)
    if best is None:
        raise ValueError(
            f"no feasible mesh assignment for {p} on axes {mesh_axes}")
    return best


@dataclasses.dataclass(frozen=True)
class DistGridChoice:
    """An explicit runtime grid for ``repro_torch.dist`` plus its cost
    story."""

    grid: Tuple[int, int, int, int, int]   # (Pb, Ph, Pw, Pk, Pc)
    algo: str                              # 2D / 2.5D / 3D analogue
    model_cost: float                      # cost_model objective (elements)
    comm_elems: Dict                       # runtime wire accounting
    mem_elems: float = 0.0                 # runtime peak-live accounting
    predicted_ms: Optional[float] = None   # replay prediction (time mode)
    schedule: Optional[str] = None         # winning schedule (auto mode)


def _check_minimize(minimize: str) -> None:
    if minimize not in ("comm", "time"):
        raise ValueError(f"minimize must be 'comm' or 'time', "
                         f"got {minimize!r}")


def _resolve_calib(calib):
    from repro_torch.perf.calibrate import load_calib
    return calib if calib is not None else load_calib()


def _algo_family(grid: Tuple[int, int, int, int, int]) -> str:
    pb, ph, pw, pk, pc = grid
    pbhw = pb * ph * pw
    if pc == 1:
        return "2D-SUMMA" if pk > 1 else "2D-DP"
    if pk > 1 and pbhw > 1:
        return "3D" if max(pbhw, pk, pc) <= 2 * min(pbhw, pk, pc) \
            else "2.5D"
    return "2.5D"


def _factorizations(P: int, axes: int):
    """All tuples of ``axes`` positive ints with product ``P``."""
    if axes == 1:
        yield (P,)
        return
    for d in range(1, P + 1):
        if P % d == 0:
            for rest in _factorizations(P // d, axes - 1):
                yield (d,) + rest


def _capped_detail(mem_cap_elems, capped_out: int) -> str:
    return (f" under mem cap {mem_cap_elems:.3e} elems "
            f"({capped_out} grids over cap)"
            if mem_cap_elems is not None and capped_out else "")


def synthesize_dist_grid(x_shape, w_shape, n_devices: int, *,
                         stride=(1, 1), padding="SAME",
                         train: bool = True,
                         schedule: str = "allgather",
                         minimize: str = "comm",
                         calib=None,
                         mem_cap_elems: Optional[float] = None
                         ) -> DistGridChoice:
    """Choose the ``(Pb, Ph, Pw, Pk, Pc)`` grid for ``repro_torch.dist``.

    Enumerates every factorization of ``n_devices`` over the five conv
    axes, keeps those satisfying the runtime divisibility constraints
    (``N % Pb``, spatial in/out extents % Ph/Pw, ``K % Pk``,
    ``C % (Pc*Pk)``, ``C % (Pc*Pb)``), and minimizes the paper's
    distributed cost -- ``cost_distributed_train`` (fwd + dIn + dKer) when
    ``train`` else ``cost_distributed_total`` -- with the runtime
    ``conv_train_comm_elems`` total as tie-break.

    ``minimize="time"`` ranks by the calibrated trace-replay prediction
    (``repro_torch.perf.predict_conv_step_ms`` under ``calib``, default
    the table ``load_calib`` resolves) instead of the analytic objective
    -- per-hop latencies and ring-pipelining overlap then separate grids
    (and schedules) the element accounting provably ties.  With
    ``schedule="auto"`` (time mode only) the allgather/ring/ring2
    schedules enter the search alongside the grids; the winner lands in
    ``DistGridChoice.schedule``.

    ``mem_cap_elems`` optimizes under a per-device memory cap: grids whose
    runtime peak-live accounting (``conv_train_mem_elems`` /
    ``conv_mem_elems`` for ``schedule``) exceeds the cap are discarded --
    the 2.5D/3D memory-for-wire tradeoff as a hard constraint.  The
    ``ring2`` schedule, never materializing a gathered operand, admits
    grids the gather schedules cannot fit.
    """
    from repro_torch.core.grid import grid_from_tuple
    from repro_torch.dist.conv2d import (_conv_effective_schedule,
                                         conv_comm_elems, conv_grid_divides,
                                         conv_mem_elems,
                                         conv_train_comm_elems,
                                         conv_train_mem_elems)
    from repro_torch.kernels.ops import pad_amounts

    _check_minimize(minimize)
    if schedule == "auto":
        if minimize != "time":
            raise ValueError("schedule='auto' needs minimize='time' — "
                             "the analytic objective ties all schedules")
        schedules = ("allgather", "ring", "ring2")
    else:
        schedules = (schedule,)
    if minimize == "time":
        calib = _resolve_calib(calib)
        from repro_torch.perf.predict import predict_conv_step_ms
    if isinstance(stride, int):
        stride = (stride, stride)
    N, C, H, W = x_shape
    K, C2, kh, kw = w_shape
    if C != C2:
        raise ValueError(f"channel mismatch: {x_shape} vs {w_shape}")
    pad_spec = (padding, padding) if isinstance(padding, str) else padding
    _, _, out_h = pad_amounts(H, kh, stride[0], pad_spec[0])
    _, _, out_w = pad_amounts(W, kw, stride[1], pad_spec[1])
    p = ConvProblem(Nb=N, Nk=K, Nc=C, Nh=out_h, Nw=out_w, Nr=kh, Ns=kw,
                    sh=stride[0], sw=stride[1])

    best: Optional[DistGridChoice] = None
    best_key = None
    capped_out = 0
    for grid in _factorizations(n_devices, 5):
        if not conv_grid_divides(x_shape, w_shape, grid, stride=stride,
                                 padding=padding):
            continue
        choice = grid_from_tuple(p, grid).solution.choice
        model_cost = (cost_model.cost_distributed_train(
            p, n_devices, choice) if train
            else cost_model.cost_distributed_total(p, n_devices, choice))
        for sched in schedules:
            if (len(schedules) > 1
                    and _conv_effective_schedule(sched, grid) != sched):
                continue   # falls back to another candidate: skip the dup
            if train:
                elems = conv_train_comm_elems(x_shape, w_shape, grid,
                                              stride=stride,
                                              padding=padding,
                                              schedule=sched)
                mem = conv_train_mem_elems(x_shape, w_shape, grid,
                                           stride=stride, padding=padding,
                                           schedule=sched)["peak"]
            else:
                elems = conv_comm_elems(x_shape, w_shape, grid,
                                        stride=stride, padding=padding)
                mem = conv_mem_elems(x_shape, w_shape, grid, stride=stride,
                                     padding=padding,
                                     schedule=sched)["peak"]
            if mem_cap_elems is not None and mem > mem_cap_elems:
                capped_out += 1
                continue
            pred = None
            if minimize == "time":
                pred = predict_conv_step_ms(
                    x_shape, w_shape, grid, stride=stride, padding=padding,
                    schedule=sched, train=train, calib=calib)
                key = (pred, elems["total"], grid)
            else:
                key = (model_cost, elems["total"], grid)
            if best_key is None or key < best_key:
                best_key = key
                best = DistGridChoice(grid=grid, algo=_algo_family(grid),
                                      model_cost=model_cost,
                                      comm_elems=elems, mem_elems=mem,
                                      predicted_ms=pred, schedule=sched)
    if best is None:
        raise ValueError(
            f"no (Pb,Ph,Pw,Pk,Pc) factorization of {n_devices} devices "
            f"divides conv x{tuple(x_shape)} w{tuple(w_shape)}"
            + _capped_detail(mem_cap_elems, capped_out))
    return best


def synthesize_cnn_grid(x_shape, channels, n_classes: int,
                        n_devices: int, *, k: int = 3,
                        pool_every: int = 2,
                        schedule: str = "allgather",
                        minimize: str = "comm",
                        calib=None,
                        mem_cap_elems: Optional[float] = None
                        ) -> DistGridChoice:
    """Choose ONE ``(Pb, Ph, Pw, Pk, Pc)`` grid for a whole CNN.

    Per-layer synthesis (:func:`synthesize_dist_grid`) can pick a
    different grid per conv; a train step needs a single grid every
    layer divides (activations flow layer to layer on the shared batch
    axes).  Enumerates every 5-factorization of ``n_devices``, keeps
    those where *every* conv layer satisfies the runtime divisibility
    constraints (``dist.train.grid_divides_cnn``), and minimizes the
    summed per-layer ``cost_distributed_train`` with the runtime
    fwd+bwd wire total (``cnn_train_comm_elems``) as tie-break.
    ``mem_cap_elems`` discards grids whose worst per-layer peak
    (``cnn_train_mem_elems``) exceeds the cap.  ``minimize="time"`` ranks
    by the whole-step trace-replay prediction
    (``repro_torch.perf.predict_cnn_train_ms`` under ``calib``) instead
    of the analytic objective.
    """
    from repro_torch.core.grid import grid_from_tuple
    from repro_torch.dist.train import (_cnn_layer_shapes,
                                        cnn_train_comm_elems,
                                        cnn_train_mem_elems,
                                        grid_divides_cnn)

    _check_minimize(minimize)
    if minimize == "time":
        calib = _resolve_calib(calib)
        from repro_torch.perf.predict import predict_cnn_train_ms
    problems = []
    for (N, C, H, W), (K, _, kh, kw) in _cnn_layer_shapes(
            x_shape, channels, k=k, pool_every=pool_every):
        problems.append(ConvProblem(Nb=N, Nk=K, Nc=C, Nh=H, Nw=W,
                                    Nr=kh, Ns=kw))
    best: Optional[DistGridChoice] = None
    best_key = None
    capped_out = 0
    for grid in _factorizations(n_devices, 5):
        if not grid_divides_cnn(x_shape, channels, grid, k=k,
                                pool_every=pool_every):
            continue
        model_cost = sum(
            cost_model.cost_distributed_train(
                p, n_devices, grid_from_tuple(p, grid).solution.choice)
            for p in problems)
        comm = cnn_train_comm_elems(x_shape, channels, n_classes, grid,
                                    k=k, pool_every=pool_every,
                                    schedule=schedule)
        mem = cnn_train_mem_elems(x_shape, channels, n_classes, grid,
                                  k=k, pool_every=pool_every,
                                  schedule=schedule)["peak"]
        if mem_cap_elems is not None and mem > mem_cap_elems:
            capped_out += 1
            continue
        pred = None
        if minimize == "time":
            pred = predict_cnn_train_ms(x_shape, channels, n_classes,
                                        grid, k=k, pool_every=pool_every,
                                        schedule=schedule, calib=calib)
            key = (pred, comm["total"], grid)
        else:
            key = (model_cost, comm["total"], grid)
        if best_key is None or key < best_key:
            best_key = key
            best = DistGridChoice(grid=grid, algo=_algo_family(grid),
                                  model_cost=model_cost, comm_elems=comm,
                                  mem_elems=mem, predicted_ms=pred,
                                  schedule=schedule)
    if best is None:
        raise ValueError(
            f"no (Pb,Ph,Pw,Pk,Pc) factorization of {n_devices} devices "
            f"divides every layer of CNN x{tuple(x_shape)} "
            f"channels={list(channels)}"
            + _capped_detail(mem_cap_elems, capped_out))
    return best


@dataclasses.dataclass(frozen=True)
class ServeGridChoice:
    """A ``(Pm, Pn, Pc)`` serving grid for the LM decode path."""

    grid: Tuple[int, int, int]
    algo: str                   # 2D-SUMMA / 2.5D / 3D analogue
    routed: int                 # projections that run on the grid
    comm_elems: Dict            # lm_serve_comm_elems accounting
    mem_elems: Dict             # lm_serve_mem_elems accounting
    predicted_ms: Optional[float] = None   # replay prediction (time mode)


def synthesize_serve_grid(cfg, n_devices: int, *, slots: int, max_seq: int,
                          schedule: str = "allgather",
                          minimize: str = "comm",
                          calib=None,
                          mem_cap_elems: Optional[float] = None
                          ) -> ServeGridChoice:
    """Choose the ``(Pm, Pn, Pc)`` grid for the LM serving engine.

    Enumerates every 3-factorization of ``n_devices``, keeps those where
    at least one decode projection satisfies the runtime divisibility
    constraints, and picks by: most projections routed through the grid,
    then least per-token decode wire (``lm_serve_comm_elems``), then
    least peak live memory.  ``mem_cap_elems`` discards grids whose
    per-device peak (weights + grid-sharded KV cache + transients,
    ``lm_serve_mem_elems``) exceeds the cap -- the 2.5D memory/wire
    tradeoff deciding the serving grid under the KV-cache budget.
    ``minimize="time"`` replaces the wire rank with the calibrated
    decode-step replay prediction
    (``repro_torch.perf.predict_decode_step_ms`` under ``calib``).
    """
    from repro_torch.dist.lm import (lm_decode_matmuls, lm_serve_comm_elems,
                                     lm_serve_mem_elems, projection_routed)

    _check_minimize(minimize)
    if minimize == "time":
        calib = _resolve_calib(calib)
        from repro_torch.perf.predict import predict_decode_step_ms
    best: Optional[ServeGridChoice] = None
    best_key = None
    capped_out = 0
    for grid in _factorizations(n_devices, 3):
        routed = sum(projection_routed(M, C, N, grid)
                     for _, M, C, N in lm_decode_matmuls(cfg, slots))
        if routed == 0 and n_devices > 1:
            continue
        comm = lm_serve_comm_elems(cfg, grid, slots=slots,
                                   schedule=schedule)
        mem = lm_serve_mem_elems(cfg, grid, slots=slots, max_seq=max_seq,
                                 schedule=schedule)
        if mem_cap_elems is not None and mem["peak"] > mem_cap_elems:
            capped_out += 1
            continue
        pred = None
        if minimize == "time":
            pred = predict_decode_step_ms(cfg, grid, slots=slots,
                                          schedule=schedule, calib=calib)
            key = (-routed, pred, mem["peak"], grid)
        else:
            key = (-routed, comm["total"], mem["peak"], grid)
        if best_key is None or key < best_key:
            best_key = key
            pm, pn, pc = grid
            best = ServeGridChoice(
                grid=grid, algo=_algo_family((pm, 1, 1, pn, pc)),
                routed=routed, comm_elems=comm, mem_elems=mem,
                predicted_ms=pred)
    if best is None:
        raise ValueError(
            f"no (Pm,Pn,Pc) factorization of {n_devices} devices routes "
            f"a decode projection of {cfg.arch_id} at {slots} slots"
            + _capped_detail(mem_cap_elems, capped_out))
    return best


def synthesize_model(layers: Dict[str, ConvProblem], mesh_axes: Dict[str, int],
                     M: float, *, batch_axes: Sequence[str] = ("pod", "data"),
                     ml_correction: bool = True) -> Dict[str, LayerSharding]:
    """Synthesize shardings for a whole model.

    Training constraint: the batch dimension must be partitioned identically
    across layers (activations flow layer to layer), so mesh axes named in
    ``batch_axes`` are pinned to the logical 'bhw' dim; the remaining axes
    are free per layer — giving each layer its own 2D/2.5D/3D regime, which
    is exactly the paper's per-operator synthesis.
    """
    out = {}
    for name, prob in layers.items():
        forced = {a: "bhw" for a in batch_axes if a in mesh_axes}
        out[name] = synthesize_layer(prob, mesh_axes, M,
                                     ml_correction=ml_correction,
                                     forced=forced)
    return out
