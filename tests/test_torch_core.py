"""The port's planner (``repro_torch.core``) against the JAX package's
``repro.core``: every public function on ResNet-50's layer table
(batches 4 and 64), processor counts 1-64 and the fast-memory sizes the
reference's own tile-optimizer tests use.  Integers, strings and grid
tuples must be equal; floats may differ by at most 1e-12 relative (the
same arithmetic in the same order, so in practice they are equal).  Grid
synthesis must pick the same grid with the same costs and accounting,
with and without a memory cap that binds, and fail alike.
"""

import dataclasses
import math

import pytest

from repro.core import cost_model as jcm
from repro.core import grid as jgrid
from repro.core import problem as jproblem
from repro.core import sharding_synthesis as jss
from repro.core import tile_optimizer as jto
from repro_torch.core import cost_model as tcm
from repro_torch.core import grid as tgrid
from repro_torch.core import problem as tproblem
from repro_torch.core import sharding_synthesis as tss
from repro_torch.core import tile_optimizer as tto

BATCHES = (4, 64)
PROCS = (1, 2, 4, 8, 16, 64)
# the fast-memory sizes of tests/test_tile_optimizer.py's cases
MEMORIES = (2e4, 2e5, 1e6, 1e7, 1e9)
SCHEDULES = ("allgather", "ring", "ring2")
SMALL = dict(Nb=16, Nk=32, Nc=32, Nh=8, Nw=8, Nr=3, Ns=3)


def same(got, want, path="result"):
    """Field-by-field equality of two results of the two packages:
    floats within 1e-12 relative, everything else exactly."""
    if dataclasses.is_dataclass(want):
        assert type(got).__name__ == type(want).__name__, path
        got, want = dataclasses.asdict(got), dataclasses.asdict(want)
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            same(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        assert isinstance(got, float), path
        assert (math.isnan(got) and math.isnan(want)) or got == want or \
            math.isclose(got, want, rel_tol=1e-12), (path, got, want)
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


def outcome(fn, *args, **kw):
    """``fn``'s result, or the type and message of its ValueError."""
    try:
        return fn(*args, **kw)
    except ValueError as err:
        return ("ValueError", str(err))


def _layers(batch):
    return (jproblem.resnet50_layers(batch),
            tproblem.resnet50_layers(batch))


@pytest.mark.parametrize("batch", BATCHES)
def test_problem_and_layer_table_equal_reference(batch):
    jl, tl = _layers(batch)
    assert list(tl) == list(jl)
    for name in jl:
        j, t = jl[name], tl[name]
        same(t, j)
        for attr in ("Nbhw", "in_h", "in_w", "stencil_volume",
                     "stride_volume", "K"):
            same(getattr(t, attr), getattr(j, attr), f"{name}.{attr}")
        for meth in ("size_in", "size_ker", "size_out", "flops",
                     "arithmetic_intensity", "iteration_points", "as_dict"):
            same(getattr(t, meth)(), getattr(j, meth)(), f"{name}.{meth}")
    same(tproblem.ConvProblem.from_matmul(512, 4096, 1024, bytes_per_elem=4),
         jproblem.ConvProblem.from_matmul(512, 4096, 1024, bytes_per_elem=4))
    same(tproblem.ConvProblem.from_conv_layer(
        batch=batch, cin=3, cout=64, h=112, w=112, kh=7, kw=7, stride=2),
        jproblem.ConvProblem.from_conv_layer(
            batch=batch, cin=3, cout=64, h=112, w=112, kh=7, kw=7,
            stride=2))


@pytest.mark.parametrize("batch", BATCHES)
def test_cost_model_equals_reference(batch):
    jl, tl = _layers(batch)
    for name in jl:
        j, t = jl[name], tl[name]
        for M in MEMORIES:
            same(tcm.ml_from_m(t, M), jcm.ml_from_m(j, M))
        same(tcm.cost_sequential(t, 2, 16, 7, 7),
             jcm.cost_sequential(j, 2, 16, 7, 7))
        same(tcm.tile_footprint(t, 2, 16, 4, 7, 7),
             jcm.tile_footprint(j, 2, 16, 4, 7, 7))
        same(tcm.tile_footprint_composite(t, 98.0, 16.0),
             jcm.tile_footprint_composite(j, 98.0, 16.0))
        same(tcm.cost_global_memory_exact(t, 2, 32, 16, 7, 7, 1, 8, 7, 7),
             jcm.cost_global_memory_exact(j, 2, 32, 16, 7, 7, 1, 8, 7, 7))
        for P in PROCS:
            same(tcm.cost_simplified(t, P, 1024.0, 32.0, 256.0, 16.0),
                 jcm.cost_simplified(j, P, 1024.0, 32.0, 256.0, 16.0))
            for pbhw, pk, pc in jto.factor_triples(P):
                if pbhw > j.Nbhw or pk > j.Nk or pc > j.Nc:
                    continue
                kw = dict(Wbhw=j.Nbhw / pbhw, Wk=j.Nk / pk, Wc=j.Nc / pc,
                          Tbhw=min(256.0, j.Nbhw / pbhw),
                          Tk=min(16.0, j.Nk / pk))
                jc, tc = jcm.TileChoice(**kw), tcm.TileChoice(**kw)
                same(tc.feasible(t, P), jc.feasible(j, P))
                same(tcm.cost_global_memory(t, tc),
                     jcm.cost_global_memory(j, jc))
                for fn in ("cost_distributed_init", "cost_distributed_total",
                           "cost_distributed_train", "memory_distributed",
                           "memory_distributed_train"):
                    same(getattr(tcm, fn)(t, P, tc),
                         getattr(jcm, fn)(j, P, jc), fn)
                for fn in ("cost_distributed_comm", "cost_distributed_bwd"):
                    same(getattr(tcm, fn)(t, tc), getattr(jcm, fn)(j, jc),
                         fn)


@pytest.mark.parametrize("batch", BATCHES)
def test_tile_optimizer_equals_reference(batch):
    jl, tl = _layers(batch)
    for P in PROCS:
        same(list(tto.factor_triples(P)), list(jto.factor_triples(P)))
    for name in jl:
        j, t = jl[name], tl[name]
        for P in PROCS:
            for M in MEMORIES:
                for ml in (True, False):
                    js = outcome(jto.solve, j, P, M, ml_correction=ml)
                    ts = outcome(tto.solve, t, P, M, ml_correction=ml)
                    same(ts, js, f"{name} solve P={P} M={M}")
                    same(outcome(tto.solve_closed_form, t, P, M,
                                 ml_correction=ml),
                         outcome(jto.solve_closed_form, j, P, M,
                                 ml_correction=ml))
                    if isinstance(js, tuple):
                        continue
                    same(ts.distributed_cost(t), js.distributed_cost(j))
                    same(tto.classify(t, P, js.M_L, ts.choice),
                         jto.classify(j, P, js.M_L, js.choice))
                ML = jcm.ml_from_m(j, M)
                same(tto.table1_cost(t, P, ML), jto.table1_cost(j, P, ML))
                same(tto.table2_cost(t, P, ML), jto.table2_cost(j, P, ML))


def test_brute_force_and_simulation_equal_reference():
    """The exhaustive oracle and the tiled-loop simulation, on the small
    problem the reference's own tests use (both are too slow for the
    ResNet table)."""
    j, t = jproblem.ConvProblem(**SMALL), tproblem.ConvProblem(**SMALL)
    for P in (4, 8, 16, 64):
        for M in (2e2, 2e3, 2e4, 2e5):
            same(outcome(tto.brute_force, t, P, M),
                 outcome(jto.brute_force, j, P, M))
    for tiles in [(1, 1, 1, 1, 1), (2, 4, 2, 4, 2), (4, 8, 4, 8, 8),
                  (16, 32, 32, 8, 8), (3, 5, 7, 3, 5)]:
        same(tcm.simulate_tiled_movement(t, *tiles),
             jcm.simulate_tiled_movement(j, *tiles))
    same(tcm.simulate_tiled_movement(t, 2, 4, 2, 4, 2, Wb=4, Wk=8, Wc=16,
                                     Wh=4, Ww=8),
         jcm.simulate_tiled_movement(j, 2, 4, 2, 4, 2, Wb=4, Wk=8, Wc=16,
                                     Wh=4, Ww=8))


@pytest.mark.parametrize("batch", BATCHES)
def test_grid_synthesis_equals_reference(batch):
    jl, tl = _layers(batch)
    for name in jl:
        j, t = jl[name], tl[name]
        for P in PROCS:
            for M in MEMORIES:
                jg = outcome(jgrid.synthesize, j, P, M)
                tg = outcome(tgrid.synthesize, t, P, M)
                same(tg, jg, f"{name} P={P} M={M}")
                if isinstance(jg, tuple):
                    continue
                for attr in ("P", "Pbhw"):
                    same(getattr(tg, attr), getattr(jg, attr))
                same(tg.axis_sizes(), jg.axis_sizes())
                same(tg.describe(), jg.describe())
                same(tgrid.comm_volume(t, tg), jgrid.comm_volume(j, jg))
                same(tgrid.comm_volume(t, tg).total,
                     jgrid.comm_volume(j, jg).total)
        for grid in [(1, 1, 1, 1, 1), (2, 1, 1, 2, 2), (1, 2, 2, 2, 1),
                     (4, 2, 2, 1, 1), (2, 1, 1, 1, 3), (1, 7, 1, 1, 1)]:
            jg = outcome(jgrid.grid_from_tuple, j, grid)
            tg = outcome(tgrid.grid_from_tuple, t, grid)
            same(tg, jg)
            if not isinstance(jg, tuple):
                same(tgrid.comm_volume(t, tg), jgrid.comm_volume(j, jg))
        memories = {"small": 2e4, "mid": 1e6, "ample": 1e9}
        for P in (16, 64):
            same(outcome(tgrid.compare_algorithms, t, P, memories),
                 outcome(jgrid.compare_algorithms, j, P, memories))


def test_synthesize_layer_and_model_equal_reference():
    """Mesh-axis assignment; the spec methods give the port's tuple specs
    where the reference gives ``PartitionSpec``s of the same entries."""
    for batch in BATCHES:
        jl, tl = _layers(batch)
        for axes in ({"data": 16, "model": 16}, {"pod": 2, "data": 4,
                                                 "model": 8}):
            for M in MEMORIES:
                for name in jl:
                    for forced in (None, {"data": "bhw"}):
                        jr = outcome(jss.synthesize_layer, jl[name], axes,
                                     M, forced=forced)
                        tr = outcome(tss.synthesize_layer, tl[name], axes,
                                     M, forced=forced)
                        same(tr, jr)
                        if isinstance(jr, tuple):
                            continue
                        for meth in ("spec_activation", "spec_weight",
                                     "spec_output"):
                            same(getattr(tr, meth)(),
                                 tuple(getattr(jr, meth)()), meth)
                        same(tr.reduce_axes(), jr.reduce_axes())
                        same(tr.axes_for("bhw"), jr.axes_for("bhw"))
                same(outcome(tss.synthesize_model, tl, axes, M),
                     outcome(jss.synthesize_model, jl, axes, M))
    same(list(tss._factorizations(12, 5)), list(jss._factorizations(12, 5)))


def _capped(fn, *args, **kw):
    """``fn`` without a cap, then with a cap just below the uncapped
    winner's peak (so it binds: that grid is out); each a result or a
    ValueError."""
    free = outcome(fn, *args, **kw)
    if isinstance(free, tuple):
        return free, None
    return free, outcome(fn, *args, mem_cap_elems=free.mem_elems * (
        1 - 1e-9), **kw)


# conv1 (7x7/2, C = 3), a 3x3 and a 1x1 layer; all seven at 4 devices
DIST_LAYERS = ("conv1", "res3a_2b", "res5_1x1")


def _layer_args(p):
    return ((p.Nb, p.Nc, p.Nh * p.sh, p.Nw * p.sw), (p.Nk, p.Nc, p.Nr, p.Ns))


@pytest.mark.parametrize("n", range(1, 17))
def test_synthesize_dist_grid_equals_reference(n):
    jl, tl = _layers(64)
    for name in (jl if n == 4 else DIST_LAYERS):
        x, w = _layer_args(jl[name])
        p = jl[name]
        for sched in SCHEDULES:
            for train in ((True, False) if n == 4 else (True,)):
                kw = dict(stride=(p.sh, p.sw), schedule=sched, train=train)
                same(_capped(tss.synthesize_dist_grid, x, w, n, **kw),
                     _capped(jss.synthesize_dist_grid, x, w, n, **kw),
                     f"{name} n={n} {sched}")


# the CNN of tests/test_torch_train.py (divides many grids), and the
# smoke CNN at ResNet-50's stage widths (C = 3 and a 7x7 last stage)
CNNS = [((8, 8, 16, 16), [16, 16], 8),
        ((64, 3, 56, 56), [64, 64, 128, 128, 256, 256, 512, 512], 1000)]


@pytest.mark.parametrize("n", range(1, 17))
def test_synthesize_cnn_grid_equals_reference(n):
    for x, channels, classes in CNNS:
        for sched in SCHEDULES:
            got = _capped(tss.synthesize_cnn_grid, x, channels, classes, n,
                          schedule=sched)
            same(got, _capped(jss.synthesize_cnn_grid, x, channels,
                              classes, n, schedule=sched))


def test_infeasible_cap_and_arguments_fail_like_reference():
    x, w = (8, 8, 16, 16), (8, 8, 3, 3)
    for fn_j, fn_t, args in [
            (jss.synthesize_dist_grid, tss.synthesize_dist_grid, (x, w, 8)),
            (jss.synthesize_cnn_grid, tss.synthesize_cnn_grid,
             CNNS[0][:3] + (8,))]:
        want = outcome(fn_j, *args, mem_cap_elems=1.0)
        assert want[0] == "ValueError" and "mem cap" in want[1]
        same(outcome(fn_t, *args, mem_cap_elems=1.0), want)
        same(outcome(fn_t, *args, minimize="fast"),
             outcome(fn_j, *args, minimize="fast"))
        with pytest.raises(NotImplementedError, match="repro/perf"):
            fn_t(*args, minimize="time")
    same(outcome(tss.synthesize_dist_grid, x, w, 8, schedule="auto"),
         outcome(jss.synthesize_dist_grid, x, w, 8, schedule="auto"))
    with pytest.raises(NotImplementedError, match="repro/perf"):
        tss.synthesize_dist_grid(x, w, 8, schedule="auto", minimize="time")
