"""The port's chip-level Eq. 4 block plans (``repro_torch.kernels.tiling``
and the plan functions of ``kernels.ops``) and its calibrated cost model
(``repro_torch.perf``) against the JAX package, on the same inputs.

* The plans on ResNet-50's layer table (batches 4 and 64) and on the
  products of a llama3.2-1b and a granite-moe-1b-a400m decode step and
  prefill, at the reference's budget and at the H100's (227 KB of f32,
  64-wide tiles): integers exact, floats within 1e-12 relative.
* Every case of the reference's ``tests/test_perf.py`` mirrored, with
  both packages given the same table: the unit-table anchor, the
  planted-constant recovery, the fit on the checked-in ``BENCH_*.json``
  (read only: equal tables and predictions), the JSON round trip (each
  package reads the other's), ``rank_conv_schedules``, and the three
  synthesizers in time mode, which pick the reference's grid and
  ``predicted_ms``.
* ``perf/bench.py``'s records on the CPU, and the CNN step record the
  port's ``record_dag`` adds.
* One 4-rank gloo launch of ``python -m repro_torch.launch.train --mesh
  dist-grid --minimize time`` under the checked-in ``CALIB.json``: it
  prints the table's provenance and the reference's time-ranked grid.
"""

import dataclasses
import json
import math
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
# torch on one thread in this process: the ops here are smoke-sized, and
# beside the other pytest-xdist workers more threads only spin
torch.set_num_threads(1)

from repro.core import sharding_synthesis as jss  # noqa: E402
from repro.core.problem import resnet50_layers as jlayers  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import tiling as jtiling  # noqa: E402
from repro import perf as jperf  # noqa: E402
from repro.perf import calibrate as jcal  # noqa: E402
from repro_torch.core import sharding_synthesis as tss  # noqa: E402
from repro_torch.core.problem import resnet50_layers as tlayers  # noqa: E402
from repro_torch.kernels import _plan  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import tiling as ttiling  # noqa: E402
from repro_torch import perf as tperf  # noqa: E402
from repro_torch.perf import bench as tbench  # noqa: E402
from repro_torch.perf import calibrate as tcal  # noqa: E402

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

X_SHAPE = (8, 128, 8, 8)          # the reference's bench_comm_volume cell
W_SHAPE = (32, 128, 3, 3)
SCHEDULES = ("allgather", "ring", "ring2")
# the H100's budget: SMEM_PER_BLOCK of f32, aligned to the core's tiles
CARD = dict(vmem_elems=_plan.SMEM_PER_BLOCK // 4, mxu=64)
SERVE_ARCHS = ("llama3.2-1b", "granite-moe-1b-a400m")


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
        assert isinstance(got, float), (path, got)
        assert (math.isnan(got) and math.isnan(want)) or got == want or \
            math.isclose(got, want, rel_tol=1e-12), (path, got, want)
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


def tables(build):
    """``build(package)`` for the reference's and the port's perf."""
    return build(jperf), build(tperf)


# ============================================ Eq. 4 block plans ====

@pytest.mark.parametrize("batch", (4, 64))
def test_block_plans_equal_reference_on_resnet50(batch):
    jl, tl = jlayers(batch), tlayers(batch)
    assert list(tl) == list(jl)
    for name in jl:
        jp, tp = jl[name], tl[name]
        same(ttiling.plan_blocks(tp), jtiling.plan_blocks(jp), name)
        same(ttiling.plan_blocks(tp, **CARD), jtiling.plan_blocks(jp, **CARD),
             f"{name} at the card's budget")
        same(ttiling.plan_blocks(tp, vmem_elems=2 * 128 * 128),
             jtiling.plan_blocks(jp, vmem_elems=2 * 128 * 128), name)
        args = (tp.Nb, tp.Nc, tp.Nk, tp.Nh, tp.Nw, tp.Nr, tp.Ns)
        same(tops.conv_plan(*args), jops.conv_plan(*args), name)
        # the layer's im2col GEMM view
        m, n, k = tp.Nb * tp.Nh * tp.Nw, tp.Nk, tp.Nc * tp.Nr * tp.Ns
        same(ttiling.matmul_blocks(m, n, k), jtiling.matmul_blocks(m, n, k))
        same(tops.matmul_plan(m, n, k), jops.matmul_plan(m, n, k))


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_block_plans_equal_reference_at_serving_shapes(arch):
    from repro_torch.configs import get_config
    from repro_torch.dist.lm import lm_step_products
    cfg = get_config(arch)
    shapes = sorted({s for rows, decode in ((8, True), (64, False))
                     for s in lm_step_products(cfg, rows, decode)})
    assert len(shapes) >= 4
    for m, c, n in shapes:
        same(ttiling.matmul_blocks(m, n, c), jtiling.matmul_blocks(m, n, c))
        same(ttiling.matmul_blocks(m, n, c, vmem_elems=CARD["vmem_elems"]),
             jtiling.matmul_blocks(m, n, c, vmem_elems=CARD["vmem_elems"]))
        same(tops.matmul_plan(m, n, c), jops.matmul_plan(m, n, c),
             (m, c, n))
        p_t = ttiling.ConvProblem.from_matmul(m, n, c)
        p_j = jtiling.ConvProblem.from_matmul(m, n, c)
        same(ttiling.plan_blocks(p_t, **CARD),
             jtiling.plan_blocks(p_j, **CARD))


def test_math_gcd_block_equal_reference():
    for extent in list(range(1, 130)) + [997, 1000, 2048, 8192, 128256,
                                         802816]:
        for want in (1, 3, 8, 64, 128, 256, 100000):
            got = tops.math_gcd_block(extent, want)
            assert got == jops.math_gcd_block(extent, want)
            assert extent % got == 0 and got <= max(1, min(want, extent))


def test_card_plan_models_the_footprint():
    """At the card's budget the (bhw, k) blocks lie between one 64-wide
    tile (or the whole extent) and the extent, and the reported
    footprint is the model's: the TPU contraction floor alone exceeds
    227 KB at the 3x3 layers of C >= 128, as the module doc says.  The
    shrink loop halves a block, so it need not stay a multiple of 64
    (``res2a_2b``: 88 rows)."""
    over = []
    for name, p in tlayers(64).items():
        plan = ttiling.plan_blocks(p, **CARD)
        for block, extent in ((plan.block_bhw, p.Nbhw), (plan.block_k, p.Nk)):
            assert min(64, extent) <= block <= extent, (name, plan)
        if plan.vmem_elems > CARD["vmem_elems"]:
            over.append(name)
    assert {"res3a_2b", "res4a_2b", "res5a_2b"} <= set(over), over
    assert ttiling.plan_blocks(tlayers(64)["res2a_2b"], **CARD).block_bhw == 88


# ================================================= unit-table anchor ====

def test_unit_table_fwd_matches_analytic_elems():
    from repro_torch.dist.conv2d import conv_comm_elems
    for grid in [(8, 1, 1, 1, 1), (2, 1, 1, 2, 2), (4, 1, 1, 2, 1)]:
        expect = conv_comm_elems(X_SHAPE, W_SHAPE, grid)["total"]
        for sched in SCHEDULES:
            want, got = tables(lambda m: m.predict_conv_step_ms(
                X_SHAPE, W_SHAPE, grid, schedule=sched,
                calib=m.CalibTable.unit()))
            assert got == pytest.approx(expect), (grid, sched)
            same(got, want, str((grid, sched)))


def test_unit_table_train_matches_analytic_elems():
    from repro_torch.dist.conv2d import conv_train_comm_elems
    for grid in [(8, 1, 1, 1, 1), (2, 1, 1, 2, 2)]:
        for sched in SCHEDULES:
            expect = conv_train_comm_elems(X_SHAPE, W_SHAPE, grid,
                                           schedule=sched)["total"]
            want, got = tables(lambda m: m.predict_conv_step_ms(
                X_SHAPE, W_SHAPE, grid, schedule=sched, train=True,
                calib=m.CalibTable.unit()))
            assert got == pytest.approx(expect), (grid, sched)
            same(got, want, str((grid, sched)))


def test_prediction_monotone_in_message_size():
    for table in ("unit", "default"):
        prev = None
        for c_mult in (1, 2, 4):
            xs = (8, 128 * c_mult, 8, 8)
            ws = (32, 128 * c_mult, 3, 3)
            want, t = tables(lambda m: m.predict_conv_step_ms(
                xs, ws, (2, 1, 1, 2, 2), schedule="ring", train=True,
                calib=getattr(m.CalibTable, table)()))
            same(t, want)
            if prev is not None:
                assert t > prev, (table, c_mult)
            prev = t


def test_replay_overlap_semantics():
    calib = tperf.CalibTable(
        collectives={"ppermute/ring": tperf.CalibEntry(0.5, 1e-3),
                     "all_reduce": tperf.CalibEntry(0.25, 2e-3)},
        compute_flops_per_ms=1e6)
    events = (tperf.CommEvent("ppermute/ring", 1000.0, steps=3,
                              overlap=True),
              tperf.CommEvent("all_reduce", 500.0))
    dag = tperf.StepDag(events=events, flops=7e6)
    assert tperf.replay_ms(dag, calib) == pytest.approx(7 + 1.5 + 1.25)
    small = tperf.StepDag(events, flops=0.5e6)
    assert tperf.replay_ms(small, calib) == pytest.approx(1 + 1.5 + 1.25)
    assert tperf.EVENT_KEYS == jperf.EVENT_KEYS


# ==================================================== fitting layer ====

def _micro_records(truth, n_sizes=6):
    recs = []
    for key, (alpha, beta) in truth.items():
        for i in range(n_sizes):
            elems = 1000.0 * (i + 1)
            steps = 1 + (i % 3)
            recs.append({"kind": key, "elems": elems, "steps": steps,
                         "wall_ms": alpha * steps + beta * elems})
    return recs


def _same_table(got, want):
    """Equal fitted constants, compute rate and fit summary (the
    provenance names each package's own host stack)."""
    same(got.collectives, want.collectives, "collectives")
    same(got.compute_flops_per_ms, want.compute_flops_per_ms, "rate")
    same(got.fit, want.fit, "fit")


def test_fit_recovers_planted_constants():
    truth = {"all_gather": (0.08, 2e-4), "all_reduce": (0.15, 5e-4),
             "ppermute/ring": (0.03, 1e-4), "ppermute/ring2": (0.06, 1e-4)}
    want, table = tables(lambda m: m.fit_collectives(
        _micro_records(truth), compute_flops_per_ms=1e9))
    _same_table(table, want)
    for key, (alpha, beta) in truth.items():
        ent = table.lookup(key)
        assert ent.alpha_ms == pytest.approx(alpha, rel=0.05), key
        assert ent.beta_ms_per_elem == pytest.approx(beta, rel=0.05), key
        assert ent.n_obs > 0
    assert table.fit["median_rel_err"] < 0.01


def test_fit_clips_negative_params_and_survives_degenerate_input(
        monkeypatch):
    recs = [{"kind": "psum", "elems": 100.0, "steps": 1, "wall_ms": 0.001}]
    want, table = tables(lambda m: m.fit_collectives(
        recs, compute_flops_per_ms=1e9))
    _same_table(table, want)
    ent = table.lookup("psum")
    assert ent.alpha_ms >= 0.0 and ent.beta_ms_per_elem >= 0.0
    empty = tperf.fit_collectives([], compute_flops_per_ms=1e9)
    assert empty.provenance.get("n_records") == 0
    assert empty.provenance.get("platform") == "cpu"
    assert empty.provenance.get("torch") == torch.__version__
    # where scipy's NNLS fails, the reference's clipped lstsq stands in
    import numpy as np
    import scipy.optimize

    def boom(*args, **kw):
        raise RuntimeError("no NNLS")
    A, y = np.array([[1.0, 0.0], [0.0, 1.0]]), np.array([1.0, -2.0])
    monkeypatch.setattr(scipy.optimize, "nnls", boom)
    got = tcal._nonneg_lstsq(A, y)
    np.testing.assert_array_equal(got, jcal._nonneg_lstsq(A, y))
    np.testing.assert_array_equal(got, [1.0, 0.0])


def test_calib_json_round_trip(tmp_path):
    truth = {"all_gather": (0.08, 2e-4), "all_reduce": (0.15, 5e-4)}
    table = tperf.fit_collectives(_micro_records(truth),
                                  compute_flops_per_ms=3e7,
                                  provenance={"source": "test"})
    path = str(tmp_path / "CALIB.json")
    table.save(path)
    back = tperf.CalibTable.load(path)
    assert back.compute_flops_per_ms == table.compute_flops_per_ms
    assert back.provenance["source"] == "test"
    assert back.fit == table.fit
    for key in truth:
        assert back.lookup(key) == table.lookup(key)
    path2 = str(tmp_path / "CALIB2.json")
    back.save(path2)
    with open(path) as a, open(path2) as b:
        assert a.read() == b.read()
    # each package reads the other's file
    ref = jperf.CalibTable.load(path)
    assert ref.to_json() == table.to_json()
    path3 = str(tmp_path / "CALIB3.json")
    ref.save(path3)
    assert tperf.CalibTable.load(path3).to_json() == table.to_json()


def test_noise_aware_rel_err():
    for args in [(10.0, 10.5, 1.0, 4), (20.0, 10.0, 0.0, 5),
                 (10.0, 10.0, 0.0, 1), (3.0, 7.0, 0.5, 9)]:
        same(tperf.noise_aware_rel_err(*args),
             jperf.noise_aware_rel_err(*args))
    assert tperf.noise_aware_rel_err(10.0, 10.5, std_ms=1.0, reps=4) == 0.0
    assert tperf.noise_aware_rel_err(20.0, 10.0, std_ms=0.0, reps=5) == \
        pytest.approx(1.0)


def test_annotate_and_report():
    truth = {"all_gather": (0.08, 2e-4)}
    recs = _micro_records(truth)
    table = tperf.fit_collectives(recs, compute_flops_per_ms=1e9)
    ref_recs = _micro_records(truth)
    jperf.annotate_predictions(ref_recs, jperf.fit_collectives(
        ref_recs, compute_flops_per_ms=1e9))
    tperf.annotate_predictions(recs, table)
    same(recs, ref_recs)
    report = tperf.prediction_error_report(recs, table)
    assert report["summary"]["n_records"] == len(recs)
    assert report["summary"]["median_rel_err"] < 0.01
    assert report["summary"]["tol"] == tperf.CALIB_TOL == jperf.CALIB_TOL


# ============================================== record/spec dispatch ====

def test_predict_step_ms_from_bench_record():
    from repro_torch.dist.conv2d import conv_train_comm_elems
    rec = {"name": "comm/train/2D-DP", "grid": [8, 1, 1, 1, 1],
           "schedule": "ring", "x_shape": list(X_SHAPE),
           "w_shape": list(W_SHAPE), "wall_ms": 1.0}
    expect = conv_train_comm_elems(X_SHAPE, W_SHAPE, (8, 1, 1, 1, 1),
                                   schedule="ring")["total"]
    want, got = tables(lambda m: m.predict_step_ms(
        rec, calib=m.CalibTable.unit()))
    assert got == pytest.approx(expect)
    same(got, want)
    with pytest.raises(ValueError):
        tperf.predict_step_ms({"name": "comm/fwd/legacy",
                               "grid": [8, 1, 1, 1, 1], "schedule": "ring"},
                              calib=tperf.CalibTable.unit())


def test_predict_decode_step_positive_and_grid_sensitive():
    from repro.configs import get_config as jget
    from repro_torch.configs import get_config as tget
    out = {}
    for grid in (None, (2, 2, 2), (1, 1, 1)):
        want = jperf.predict_decode_step_ms(
            jget("llama3.2-1b", smoke=True), grid, slots=4,
            calib=jperf.CalibTable.default())
        got = tperf.predict_decode_step_ms(
            tget("llama3.2-1b", smoke=True), grid, slots=4,
            calib=tperf.CalibTable.default())
        same(got, want, str(grid))
        out[grid] = got
    assert out[None] > 0 and out[(2, 2, 2)] > 0
    assert out[None] != out[(2, 2, 2)]


def test_cnn_step_record_replays_the_whole_cnn():
    """The port's one addition to ``record_dag``: a ``train/cnn/<algo>``
    record is a whole CNN step; the reference's ``record_dag`` knows no
    such name and skips it rather than pricing it as something else."""
    x, channels, classes = (8, 4, 8, 8), [8, 8], 10
    rec = tbench.cnn_train_record([3.0, 5.0], x_shape=x, channels=channels,
                                  n_classes=classes, k=3, pool_every=2,
                                  grid=(1, 1, 1, 1, 1))
    assert rec["name"] == "train/cnn/2D-DP" and rec["wall_ms"] == 4.0
    calib = tperf.CalibTable.default()
    want = jperf.predict_cnn_train_ms(x, channels, classes,
                                      (1, 1, 1, 1, 1), calib=calib)
    same(tperf.predict_step_ms(rec, calib=calib), want)
    assert jperf.record_dag(rec) is None


# ========================================== time-based synthesis ====

def test_minimize_comm_ties_ring_vs_ring2_time_separates():
    grid = (8, 1, 1, 1, 1)
    comm_rank = tperf.rank_conv_schedules(X_SHAPE, W_SHAPE, grid,
                                          schedules=("ring", "ring2"),
                                          minimize="comm")
    assert comm_rank[0][1] == comm_rank[1][1], "analytic tie expected"

    def rank(m):
        calib = m.CalibTable(
            collectives={"ppermute/ring": m.CalibEntry(0.05, 1e-5),
                         "ppermute/ring2": m.CalibEntry(0.50, 1e-5)},
            compute_flops_per_ms=1e9)
        return m.rank_conv_schedules(X_SHAPE, W_SHAPE, grid,
                                     schedules=("ring2", "ring"),
                                     minimize="time", calib=calib)
    want, time_rank = tables(rank)
    same(time_rank, want)
    assert time_rank[0][0] == "ring"
    assert time_rank[0][1] < time_rank[1][1]
    with pytest.raises(ValueError):
        tperf.rank_conv_schedules(X_SHAPE, W_SHAPE, grid, minimize="wat")


def _bench(name):
    with open(os.path.join(_ROOT, name)) as f:
        return json.load(f)


@pytest.mark.bench
def test_time_ranked_winner_has_lower_measured_wall_ms():
    comm = _bench("BENCH_comm.json")
    by = {(r["name"], r["schedule"]): r for r in comm}
    name = "comm/train/2D-DP"
    walls = {s: by[(name, s)]["wall_ms"] for s in ("ring", "ring2")}
    rec = by[(name, "ring")]
    args = (tuple(rec["x_shape"]), tuple(rec["w_shape"]),
            tuple(rec["grid"]))
    want, ranked = tables(lambda m: m.rank_conv_schedules(
        *args, schedules=("ring", "ring2"), train=True, minimize="time",
        calib=m.load_calib()))
    same(ranked, want)
    assert walls[ranked[0][0]] < walls[ranked[1][0]], (ranked, walls)
    comm_rank = tperf.rank_conv_schedules(*args, schedules=("ring", "ring2"),
                                          train=True, minimize="comm")
    assert comm_rank[0][1] == comm_rank[1][1]


def test_synthesize_dist_grid_time_mode_and_auto_schedule():
    for sched in ("auto",) + SCHEDULES:
        for train in (True, False):
            want = jss.synthesize_dist_grid(
                X_SHAPE, W_SHAPE, 8, schedule=sched, minimize="time",
                train=train, calib=jperf.CalibTable.default())
            got = tss.synthesize_dist_grid(
                X_SHAPE, W_SHAPE, 8, schedule=sched, minimize="time",
                train=train, calib=tperf.CalibTable.default())
            same(got, want, f"{sched} train={train}")
    assert got.predicted_ms > 0 and got.schedule in SCHEDULES
    base = tss.synthesize_dist_grid(X_SHAPE, W_SHAPE, 8, schedule="ring")
    assert base.predicted_ms is None and base.schedule == "ring"
    with pytest.raises(ValueError):
        tss.synthesize_dist_grid(X_SHAPE, W_SHAPE, 8, schedule="auto")
    with pytest.raises(ValueError):
        tss.synthesize_dist_grid(X_SHAPE, W_SHAPE, 8, minimize="wat")


def test_synthesize_dist_grid_time_mode_follows_the_calibration():
    def slow_gather(m):
        return m.CalibTable(
            collectives={"all_gather": m.CalibEntry(5.0, 1e-2)},
            compute_flops_per_ms=1e9)
    want = jss.synthesize_dist_grid(X_SHAPE, W_SHAPE, 8,
                                    schedule="allgather", minimize="time",
                                    calib=slow_gather(jperf))
    choice = tss.synthesize_dist_grid(X_SHAPE, W_SHAPE, 8,
                                      schedule="allgather", minimize="time",
                                      calib=slow_gather(tperf))
    same(choice, want)
    for other in [(8, 1, 1, 1, 1), (2, 1, 1, 2, 2), (4, 1, 1, 2, 1)]:
        t = tperf.predict_conv_step_ms(X_SHAPE, W_SHAPE, other, train=True,
                                       schedule="allgather",
                                       calib=slow_gather(tperf))
        assert choice.predicted_ms <= t + 1e-9, (choice.grid, other)


@pytest.mark.parametrize("table", ("default", "checked_in"))
def test_synthesize_cnn_and_serve_time_mode(table):
    """Both CNNs of ``tests/test_torch_core.py`` over 1-8 devices and
    the smoke llama / granite-moe serve grids, under the default table
    and the checked-in ``CALIB.json``: the reference's picks."""
    from repro.configs import get_config as jget
    from repro_torch.configs import get_config as tget

    def calib(m):
        return (m.CalibTable.default() if table == "default"
                else m.load_calib(os.path.join(_ROOT, "CALIB.json")))
    for x, channels, classes in [((8, 4, 8, 8), [8, 8], 10),
                                 ((64, 3, 56, 56), [64, 64, 128, 128],
                                  1000)]:
        for n in (1, 2, 4, 8):
            for sched in ("allgather", "ring2"):
                want = jss.synthesize_cnn_grid(
                    x, channels, classes, n, schedule=sched,
                    minimize="time", calib=calib(jperf))
                got = tss.synthesize_cnn_grid(
                    x, channels, classes, n, schedule=sched,
                    minimize="time", calib=calib(tperf))
                same(got, want, f"{x} n={n} {sched}")
                assert got.predicted_ms > 0
    for arch in SERVE_ARCHS:
        for n in (1, 4, 8):
            want = jss.synthesize_serve_grid(
                jget(arch, smoke=True), n, slots=4, max_seq=64,
                minimize="time", calib=calib(jperf))
            got = tss.synthesize_serve_grid(
                tget(arch, smoke=True), n, slots=4, max_seq=64,
                minimize="time", calib=calib(tperf))
            same(got, want, f"{arch} n={n}")
            assert got.predicted_ms > 0 and got.routed > 0
    with pytest.raises(ValueError):
        tss.synthesize_serve_grid(tget("llama3.2-1b", smoke=True), 8,
                                  slots=4, max_seq=64, minimize="wat")


# ====================================================== the CI gate ====

@pytest.mark.calib
def test_calibration_gate_median_error_within_tolerance():
    """The fit on the checked-in ``BENCH_*.json`` (read only): the
    reference's table and the reference's prediction for every record,
    and the median error within the reference's gate."""
    comm, kern, serve = tcal._load_bench(_ROOT)
    assert (comm, kern, serve) == jcal._load_bench(_ROOT)
    want, table = tables(lambda m: m.fit_collectives(
        comm + serve, kernel_records=kern))
    _same_table(table, want)
    ref = jperf.prediction_error_report(comm + kern + serve, want)
    report = tperf.prediction_error_report(comm + kern + serve, table)
    same(report, ref)
    s = report["summary"]
    assert s["n_records"] > 0
    assert s["median_rel_err"] <= tperf.CALIB_TOL, s


@pytest.mark.calib
def test_checked_in_calib_is_loadable_and_provenance_stamped(monkeypatch):
    monkeypatch.delenv("REPRO_CALIB", raising=False)
    path = os.path.join(_ROOT, "CALIB.json")
    table = tperf.CalibTable.load(path)
    assert table.compute_flops_per_ms > 0
    for key in ("host", "date", "n_records"):
        assert key in table.provenance, key
    assert table.collectives, "empty collective table"
    # the two packages resolve the same table, explicit path > env >
    # checked-in file
    assert tperf.load_calib().to_json() == jperf.load_calib().to_json()
    assert tcal.calib_path() == path
    monkeypatch.setenv("REPRO_CALIB", os.path.join(_ROOT, "nope.json"))
    assert tcal.calib_path() == path
    line = tcal.provenance_line()
    assert "host=vm" in line and "platform=cpu" in line, line


def test_calibrate_cli_writes_only_outside_the_checked_in_files(tmp_path,
                                                                capsys):
    out, rep = tmp_path / "c.json", tmp_path / "r.json"
    assert tcal.main(["--out", str(out), "--report", str(rep)]) == 0
    assert "records" in capsys.readouterr().out
    comm, kern, serve = jcal._load_bench(_ROOT)
    _same_table(tperf.CalibTable.load(str(out)), jperf.fit_collectives(
        comm + serve, kernel_records=kern))
    assert json.loads(rep.read_text())["summary"]["n_records"] > 0
    for name in ("CALIB.json", "CALIB_report.json"):
        with pytest.raises(SystemExit, match="checked-in"):
            tcal.main(["--out", os.path.join(_ROOT, name),
                       "--report", str(rep)])


# ============================================================ bench ====

def test_bench_records_on_the_cpu(tmp_path, monkeypatch):
    """``perf/bench.py``'s kernel records at a tiny batch carry the
    reference's keys, their Eq. 4 fields equal the reference bench's
    arithmetic, and the fit reads them (the compute rate is their median
    flops per ms)."""
    from repro_torch.kernels import autotune
    monkeypatch.setenv(autotune.CACHE_ENV, str(tmp_path / "plans.json"))
    autotune.plan_cache().reset()
    try:
        recs = tbench.kernel_records(batch=1, layers=("res5a_2b",),
                                     device="cpu", reps=2)
    finally:
        autotune.plan_cache().reset()
    assert [r["schedule"] for r in recs] == ["paper-plan", "autotuned"]
    p = jlayers(1)["res5a_2b"]
    plan = jtiling.plan_blocks(p)
    for r in recs:
        assert r["impl"] in ("direct", "winograd", "im2col", "xla")
        assert r["grid"] == [plan.block_bhw, plan.block_k, plan.block_c]
        assert r["wire_bytes"] == plan.hbm_traffic * 4
        assert r["flops"] == p.flops() and r["reps"] == 2
        assert r["wall_ms"] > 0
    assert recs[0]["impl"] == "direct"   # the static plan where it tiles
    rate = tperf.fit_compute_rate(recs)
    assert rate == jperf.fit_compute_rate(recs) > 0
    res = {"tokens_per_s": 10.0, "p50_ms": 2.0, "p99_ms": 3.0,
           "mean_ms": 2.5, "std_ms": 0.5, "reps": 7,
           "wire_bytes_per_tok": 0.0}
    srec = tbench.serve_record(res, arch="llama3.2-1b", dtype="float32",
                               slots=8, smoke=True, grid=(1, 1, 1))
    assert srec["name"] == "serve/llama3.2-1b/1x1x1"
    calib = jperf.CalibTable.default()
    same(tperf.predict_step_ms(srec, calib=calib),
         jperf.predict_step_ms(srec, calib=calib))
    table = tperf.fit_collectives([srec], kernel_records=recs)
    assert table.compute_flops_per_ms == rate
    assert table.collectives["dispatch/decode"].n_obs == 1


def test_bench_cli_writes_the_kernel_records_outside_the_root(tmp_path,
                                                              monkeypatch):
    """The CLI's plumbing, one layer (the records themselves are held
    by the test above): its file, read back as the reference's loader
    reads ``BENCH_kernels.json``, and its refusal of the repo root."""
    from repro_torch.kernels import autotune
    monkeypatch.setenv(autotune.CACHE_ENV, str(tmp_path / "plans.json"))
    records = tbench.kernel_records
    monkeypatch.setattr(tbench, "kernel_records", lambda **kw: records(
        **kw, layers=("res5a_2b",), reps=1))
    autotune.plan_cache().reset()
    out = tmp_path / "out"
    try:
        assert tbench.main(["--batch", "1", "--device", "cpu", "--out",
                            str(out)]) == 0
    finally:
        autotune.plan_cache().reset()
    recs = json.loads((out / "BENCH_kernels.json").read_text())
    assert [(r["name"], r["schedule"], r["batch"]) for r in recs] == [
        ("kernel/res5a_2b", "paper-plan", 1),
        ("kernel/res5a_2b", "autotuned", 1)]
    comm, kern, serve = jcal._load_bench(str(out))
    assert kern == recs and comm == serve == []
    with pytest.raises(SystemExit, match="repo root"):
        tbench.main(["--out", _ROOT])


# ============================================ the CLI, 4 gloo ranks ====

def test_train_cli_minimize_time_picks_the_reference_grid(tmp_path):
    calib = os.path.join(_ROOT, "CALIB.json")
    want = jss.synthesize_cnn_grid((8, 4, 8, 8), [8, 8], 10, 4,
                                   minimize="time",
                                   calib=jperf.load_calib(calib))
    env = dict(os.environ, PYTHONPATH=os.path.join(_ROOT, "src"),
               REPRO_CALIB=calib, REPRO_TORCH_AUTOTUNE="0")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--mesh",
         "dist-grid", "--minimize", "time", "--ranks", "4", "--device",
         "cpu", "--steps", "2"], env=env, cwd=tmp_path,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = proc.stdout
    assert f"[calib] table={calib} host=vm platform=cpu" in out, out
    assert f"[resilient] grid={tuple(want.grid)}" in out, out
    assert "[resilient] done at step 2" in out, out
