"""The port's schedule verifier and source lints (``repro_torch.analysis``)
against the JAX package's (``repro.analysis``).

* The pure helpers and lint passes get the same inputs in both packages
  and must give the same results (the mirror of
  ``tests/test_analysis.py``'s synthetic cases).
* The AST lint is clean on ``src/repro_torch`` and flags seeded breaches
  of both rules in every import spelling; the doc lint is clean on the
  repo and flags seeded stale references.
* The CLI's exit codes on one 2-rank grid.
* One 8-rank gloo launch (``_rank8``) runs every cell of the default
  ``run_matrix`` -- each must be ``ok`` with the recorded wire exactly
  the analytic count on every rank -- and the seeded regressions the
  verifier must catch: a ring hop missing its closing edge and a
  partial sub-ring on the 4-ring of a ``(2, 4)`` mesh (a partial
  permutation is safe to *run* in the port: only the ranks it names
  post a send or a receive), an all-gather on a contraction axis under
  a declared ring schedule, and a collective no term of the accounting
  names.  Worker time ~26 s alone (the 8-rank launch ~9 s, the CLI's
  two 2-rank runs ~10 s).

The rank function lives here and imports no jax: the spawned ranks
import this module.  The JAX package is imported inside the tests.
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis import astlint, doclint, verify  # noqa: E402
from repro_torch.analysis.collect import (Collective,  # noqa: E402
                                          SpmdDivergence,
                                          _nontrivial_subsets, axis_groups,
                                          effective_axes,
                                          extract_collectives,
                                          normalize_mesh_axes, orbits)
from repro_torch.analysis.lints import (Finding, errors,  # noqa: E402
                                        lint_attribution, lint_deadlock,
                                        lint_footprint, lint_wire)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CONV_MESH = (("b", 2), ("h", 1), ("w", 1), ("k", 2), ("c", 2))
MESHES = [CONV_MESH, (("m", 2), ("n", 2), ("c", 2)),
          (("a", 2), ("r", 4)), (("b", 1), ("h", 2), ("w", 2), ("k", 2),
                                 ("c", 1))]
RING4 = (("a", 2), ("r", 4))   # the seeded deadlock cases' mesh


def _findings(found):
    return [(f.lint, f.severity, f.message) for f in found]


# ============================================ the helpers vs the reference

@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(
    str(s) for _, s in m))
def test_axis_groups_match_reference(mesh):
    from repro.analysis import collect as ref

    names = [n for n, _ in mesh]
    for mask in range(1 << len(names)):
        sub = tuple(n for i, n in enumerate(names) if mask >> i & 1)
        assert axis_groups(mesh, sub) == ref.axis_groups(mesh, sub)
        assert effective_axes(mesh, sub) == ref.effective_axes(mesh, sub)
    assert _nontrivial_subsets(mesh) == ref._nontrivial_subsets(mesh)
    with pytest.raises(ValueError, match="not in mesh"):
        axis_groups(mesh, ("zz",))


def test_axis_groups_row_major():
    # conv mesh (2,1,1,2,2): device = 4*b + 2*k + c
    assert axis_groups(CONV_MESH, ("c",)) == frozenset({
        frozenset({0, 1}), frozenset({2, 3}),
        frozenset({4, 5}), frozenset({6, 7})})
    assert axis_groups(CONV_MESH, ("k", "h")) \
        == axis_groups(CONV_MESH, ("k",))
    assert effective_axes(CONV_MESH, ("c", "b")) == ("b", "c")


def test_normalize_and_orbits_match_reference():
    from repro.analysis import collect as ref

    for axes in ({"m": 2, "n": 4}, [("k", 2), ("c", 4)], CONV_MESH):
        assert normalize_mesh_axes(axes) == ref.normalize_mesh_axes(axes)
    for pairs in ([(0, 1), (1, 0), (2, 3), (3, 2)], [(0, 1), (1, 2), (2, 3)],
                  [(i, (i + 1) % 8) for i in range(8)], []):
        assert set(orbits(pairs)) == set(ref.orbits(pairs))


def test_cycles_match_reference():
    from repro.analysis import lints as ref
    from repro_torch.analysis import lints

    for pairs in ([(0, 1), (1, 2), (2, 0)], [(0, 1), (1, 2), (2, 3)],
                  [(0, 1), (1, 0), (2, 3), (3, 2)],
                  [(i, (i + 1) % 4) for i in range(4)], [(0, 0)]):
        assert sorted(map(sorted, lints._cycles(pairs))) \
            == sorted(map(sorted, ref._cycles(pairs)))


@pytest.mark.parametrize("measured,analytic,rtol", [
    (100.0, 100.0, 0.02), (101.0, 100.0, 0.02), (120.0, 100.0, 0.02),
    (5.0, 0.0, 0.02), (0.0, 0.0, 0.02), (97.0, 100.0, 0.05)])
def test_lint_wire_matches_reference(measured, analytic, rtol):
    from repro.analysis.lints import lint_wire as ref_lint_wire

    got = lint_wire(measured, analytic, rtol=rtol, what="fwd")
    assert _findings(got) == _findings(
        ref_lint_wire(measured, analytic, rtol=rtol, what="fwd"))
    if measured == 120.0:
        assert errors(got) and "1.2" in got[0].message


def _both(**fields):
    """The same collective as the port's and the reference's record."""
    from repro.analysis.collect import Collective as RefCollective
    base = dict(kind="collective-permute", name="op", comp="entry",
                mult=1.0, result_bytes=256, wire_bytes=256.0, group_size=4,
                axes=("r",), groups=None, pairs=None)
    base.update(fields)
    return Collective(**base), RefCollective(**base)


def _permute(pairs):
    groups = orbits(pairs)
    return _both(pairs=tuple(pairs), groups=groups,
                 group_size=max(len(o) for o in groups))


DEADLOCK_CASES = {
    # (pairs, tag): ring hop missing its closing edge
    "open_ring_hop": ([(0, 1), (1, 2), (2, 3), (4, 5), (5, 6), (6, 7)],
                      "ring_zip"),
    "partial_sub_ring": ([(0, 1), (1, 0), (4, 5), (5, 4)], "ring_reduce"),
    "total_rotation": ([(a * 4 + i, a * 4 + (i + 1) % 4)
                        for a in range(2) for i in range(4)], "ring_zip"),
    "halo_shift": ([(0, 1), (1, 2), (2, 3), (4, 5), (5, 6), (6, 7)],
                   "halo"),
    "scoped_ring_tag": ([(0, 1), (1, 2), (2, 3), (4, 5), (5, 6), (6, 7)],
                        "wq:ring_reduce"),
    "duplicate_target": ([(0, 1), (2, 1)], "halo"),
}


@pytest.mark.parametrize("case", sorted(DEADLOCK_CASES))
def test_lint_deadlock_matches_reference(case):
    from repro.analysis.lints import lint_deadlock as ref_lint_deadlock
    from repro.dist.collectives import CollectiveNote as RefNote

    pairs, tag = DEADLOCK_CASES[case]
    port, ref = _permute(pairs)
    got = lint_deadlock([port], RING4, [("collective-permute", ("r",), tag)])
    if case == "scoped_ring_tag":
        # the reference reads whole tags; the port its last component
        assert errors(got) and any("bijection" in str(f) for f in got)
        return
    assert _findings(got) == _findings(ref_lint_deadlock(
        [ref], RING4, [RefNote("collective-permute", ("r",), tag)]))
    assert bool(errors(got)) == (case not in ("total_rotation",
                                              "halo_shift"))


@pytest.mark.parametrize("schedule", ["allgather", "ring", "ring2"])
def test_lint_footprint_matches_reference(schedule):
    from repro.analysis.lints import lint_footprint as ref_lint_footprint

    gather = _both(kind="all-gather", axes=("k",), group_size=2,
                   pairs=None)
    reduce = _both(kind="all-reduce", axes=("c",), group_size=2,
                   pairs=None)
    trivial = _both(kind="all-gather", axes=("b",), group_size=1,
                    pairs=None)
    for live in (None, 100.0, 500.0, 10.0):
        kw = dict(schedule=schedule, contraction_axes=("b", "k"),
                  live=live, analytic=100.0, mem_band=(0.4, 1.6))
        got = lint_footprint([c[0] for c in (gather, reduce, trivial)],
                             **kw)
        want = ref_lint_footprint([c[1] for c in (gather, reduce, trivial)],
                                  **kw)
        assert _findings(got) == _findings(want)
        assert bool(errors(got)) == (schedule != "allgather"
                                     or live in (500.0, 10.0))


@pytest.mark.parametrize("op", ["conv", "matmul"])
def test_mem_band_card_widens_only_the_conv_custom_backward(op):
    """The card's train band reaches the conv's custom backward and no
    other cell; the CPU, every forward and every ``save_gathered`` cell
    keep the reference's bands."""
    from repro.analysis import verify as ref_verify

    make = verify.conv_cell if op == "conv" else verify.matmul_cell
    grid = (1,) * 5 if op == "conv" else (1, 1, 1)
    for schedule in verify.SCHEDULES:
        plain = make(grid, schedule)
        sg = make(grid, schedule, save_gathered=True, include_fwd=False)
        fwd = (ref_verify.MEM_BAND_FWD_GATHER
               if verify.effective_schedule(plain) == "allgather"
               else ref_verify.MEM_BAND_FWD)
        for on_card in (False, True):
            assert verify.mem_band(plain, "fwd", on_card=on_card) == fwd
            assert (verify.mem_band(sg, "train", on_card=on_card)
                    == ref_verify.MEM_BAND_TRAIN)
            assert verify.mem_band(plain, "train", on_card=on_card) == (
                verify.CARD_MEM_BAND_CONV_TRAIN if on_card and op == "conv"
                else ref_verify.MEM_BAND_TRAIN)


def test_finding_str_matches_reference():
    from repro.analysis.lints import Finding as RefFinding

    for args in [("wire", "error", "drifted"),
                 ("deadlock", "warning", "odd ring")]:
        assert str(Finding(*args)) == str(RefFinding(*args))
    assert "wire" in str(Finding("wire", "error", "x"))


# ========================================== extraction and attribution

def test_extract_collectives_maps_pairs_and_refuses_divergence():
    coords = [{"a": r // 4, "r": r % 4} for r in range(8)]
    ring = [(i, (i + 1) % 4) for i in range(4)]
    note = ("collective-permute", ("r",), "ring_zip", 16.0, 4, ring)
    gather = ("all-gather", ("a",), "gather_axis", 32.0, 4)
    (perm, ag) = extract_collectives([[note, gather]] * 8, RING4, coords)
    assert perm.axes == ("r",) and perm.wire_bytes == 64.0
    assert perm.pairs == tuple(sorted(
        (a * 4 + i, a * 4 + (i + 1) % 4) for a in range(2)
        for i in range(4)))
    assert ag.axes == ("a",) and ag.group_size == 2
    assert ag.result_bytes == 2 * 32 * 4   # the gathered buffer
    assert not lint_deadlock([perm, ag], RING4, [note])
    with pytest.raises(SpmdDivergence, match="rank 3"):
        extract_collectives([[note]] * 3 + [[gather]] + [[note]] * 4,
                            RING4, coords)
    with pytest.raises(SpmdDivergence, match="recorded 1"):
        extract_collectives([[note, gather]] * 7 + [[note]], RING4, coords)


def test_lint_attribution_by_partition():
    conv = (("b", 2), ("h", 2), ("w", 1), ("k", 2), ("c", 1))
    terms = {"gather_in": ((("k",),), 400.0),
             "gather_ker": ((("b",),), 100.0),
             "reduce_out": ((("c",),), 0.0),
             "halo": ((("h",), ("w",)), 60.0),
             "psum_ker_spatial": ((("h", "w"),), 40.0)}

    def coll(kind, axes, nbytes, name="x"):
        return Collective(kind, name, "note", 1.0, 0, nbytes, 2, axes,
                          None, None)

    paid = [coll("all-gather", ("k",), 400.0),
            coll("all-gather", ("b",), 100.0),
            coll("collective-permute", ("h",), 30.0, "halo"),
            coll("collective-permute", ("h",), 30.0, "halo"),
            coll("all-reduce", ("h",), 40.0, "dker_spatial")]
    assert lint_attribution(paid, terms, conv) == []
    # a collective on a partition no term names
    stray = lint_attribution(paid + [coll("all-reduce", ("b", "k"), 8.0,
                                          "stray")], terms, conv)
    assert len(stray) == 1 and "unaccounted" in stray[0].message
    # a term with no collective on its axes
    unpaid = lint_attribution(paid[:1] + paid[2:], terms, conv)
    assert len(unpaid) == 1 and "never paid" in unpaid[0].message
    assert "gather_ker" in unpaid[0].message
    # the pooled h partition (halo + the spatial psum) off by a byte
    off = lint_attribution(paid[:4] + [coll("all-reduce", ("h",), 41.0)],
                           terms, conv, rtol=0.0)
    assert len(off) == 1 and "halo+psum_ker_spatial" in off[0].message
    # a term on extent-1 axes only cannot be paid
    none = lint_attribution([], {"reduce_out": ((("c",),), 8.0)}, conv)
    assert errors(none) and "never paid" in none[0].message


# =================================================================== lints

def test_astlint_repo_is_clean():
    findings = astlint.lint_tree(astlint.default_root())
    assert findings == [], "\n".join(str(f) for f in findings)
    assert astlint.default_root().endswith(os.path.join("src",
                                                        "repro_torch"))


def test_astlint_flags_raw_collectives(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text(textwrap.dedent("""
        import torch
        import torch as T
        import torch.distributed as dist
        from torch import distributed as tdist
        from torch.distributed import all_reduce as ar, broadcast
        from torch.distributed.device_mesh import DeviceMesh

        def f(x, mesh: DeviceMesh):
            dist.all_reduce(x)
            tdist.all_gather([x], x)
            ar(x)
            broadcast(x, 0)
            torch.distributed.barrier()
            T.distributed.get_rank()
            dist.get_world_size()  # raw-collective-ok
            torch.cuda.synchronize()     # not torch.distributed
            return dist.ReduceOp.SUM, DeviceMesh
    """))
    found = astlint.lint_file(str(bad))
    assert sorted(f.name for f in found) == sorted(
        ["torch.distributed.all_reduce", "torch.distributed.all_gather",
         "torch.distributed.all_reduce", "torch.distributed.broadcast",
         "torch.distributed.barrier", "torch.distributed.get_rank"])
    assert all(f.kind == "collective" for f in found)
    assert "accounted" in str(found[0])


def test_astlint_flags_raw_kernel_imports(tmp_path):
    pkg = tmp_path / "repro_torch"
    for sub in ("dist", "kernels"):
        (pkg / sub).mkdir(parents=True)
    (pkg / "dist" / "bad.py").write_text(textwrap.dedent("""
        import repro_torch.kernels.matmul
        from repro_torch.kernels import conv2d, ops
        from repro_torch.kernels.winograd import wino_gemm
        from repro_torch.kernels._build import load
        from ..kernels import gemm_conv
        from ..kernels import autotune
        from repro_torch.kernels import matmul  # raw-kernel-ok
    """))
    (pkg / "kernels" / "ops.py").write_text(
        "from repro_torch.kernels.conv2d import conv2d\n"
        "from .matmul import matmul\n")
    found = astlint.lint_tree(str(tmp_path))
    assert [(os.path.basename(f.path), f.name) for f in found] == [
        ("bad.py", "matmul"), ("bad.py", "conv2d"), ("bad.py", "winograd"),
        ("bad.py", "_build"), ("bad.py", "gemm_conv")]
    assert all(f.kind == "kernel" for f in found)
    assert "kernels.ops" in str(found[0])


def test_astlint_tree_skips_collectives_and_spawn(tmp_path):
    pkg = tmp_path / "dist"
    pkg.mkdir()
    body = ("import torch.distributed as dist\n"
            "def f(x):\n    dist.all_reduce(x)\n")
    for name in ("collectives.py", "spawn.py", "other.py"):
        (pkg / name).write_text(body)
    found = astlint.lint_tree(str(tmp_path))
    assert len(found) == 1 and found[0].path.endswith("other.py")
    assert astlint.main([str(tmp_path)]) == 1
    assert astlint.main([astlint.default_root()]) == 0


def test_doclint_repo_is_clean():
    findings = doclint.lint_tree(doclint.default_root())
    assert findings == [], "\n".join(str(f) for f in findings)


def test_doclint_flags_stale_references(tmp_path):
    (tmp_path / "Makefile").write_text("test:\n\techo hi\n")
    src = tmp_path / "src" / "repro_torch"
    src.mkdir(parents=True)
    (src / "x.py").write_text(
        "import os\nos.environ['REPRO_TORCH_REAL']\n")
    (tmp_path / "src" / "repro").mkdir()
    (tmp_path / "src" / "repro" / "y.py").write_text(
        "import os\nos.environ['REPRO_TORCH_ELSEWHERE']\n")
    (tmp_path / "README.md").write_text(textwrap.dedent("""
        Run `make test` then `make bogus-target`.
        Set `REPRO_TORCH_REAL=1` or REPRO_TORCH_MISSING.
        REPRO_TORCH_ELSEWHERE is read only by the other package.
        See `src/repro_torch/x.py`, `x.py` and `src/repro_torch/gone.py`.
        Try `python -m repro_torch.x` and `python -m repro_torch.gone`.
        Prose about make targets is not a reference.
        ```
        make test
        ```
    """))
    found = doclint.lint_tree(str(tmp_path))
    msgs = sorted(f.message for f in found)
    assert len(msgs) == 5, msgs
    for stale in ("bogus-target", "REPRO_TORCH_MISSING",
                  "REPRO_TORCH_ELSEWHERE", "src/repro_torch/gone.py",
                  "repro_torch.gone"):
        assert any(stale in m for m in msgs), (stale, msgs)
    assert doclint.main([str(tmp_path)]) == 1


# ===================================================================== CLI

def test_lint_cli_exit_codes(monkeypatch, capsys):
    """The CLI on one 2-rank grid: clean as a subprocess (exit 0), and
    exit 1 with a JSON report once the conv's accounting is seeded with
    a drift (the ranks run the real op; the parent lints)."""
    from repro_torch.analysis import lint
    from repro_torch.dist import conv2d

    args = ["--device", "cpu", "--grids", "2,1,1,1,1",
            "--schedules", "ring", "--skip-variants"]
    env = dict(os.environ, PYTHONPATH=os.path.join(_ROOT, "src"),
               REPRO_TORCH_AUTOTUNE="0")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.lint"] + args,
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "2 cells, 0 failed, 0 schedule error(s), 0 astlint" \
        in proc.stdout

    real = conv2d.conv_comm_elems

    def drifted(*a, **kw):
        out = dict(real(*a, **kw))
        out["gather_ker"] *= 2
        out["total"] = sum(v for k, v in out.items() if k != "total")
        return out

    monkeypatch.setattr(conv2d, "conv_comm_elems", drifted)
    assert lint.main(args + ["--report", "json", "--skip-ast",
                             "--skip-train"]) == 1
    report = json.loads(capsys.readouterr().out)
    assert report["n_cells"] == 1 and not report["ok"]
    lints_hit = {f["lint"] for f in report["cells"][0]["findings"]}
    assert lints_hit == {"wire", "attribution"}
    with pytest.raises(SystemExit, match="bad grid"):
        lint.main(["--grids", "2,2", "--device", "cpu"])


# ================================================== the one 8-rank launch

SEEDED_PERMS = {
    "open_ring_hop": ([(0, 1), (1, 2), (2, 3)], "ring_zip"),
    "partial_sub_ring": ([(0, 1), (1, 0)], "ring_reduce"),
    "total_rotation": ([(i, (i + 1) % 4) for i in range(4)], "ring_zip"),
    "halo_shift": ([(0, 1), (1, 2), (2, 3)], "halo"),
}
STRAY_GRID = (2, 1, 1, 2, 2)


def _rank8(rank):
    """Every default matrix cell, then the seeded regressions, on this
    rank; returns what the parent lints."""
    from repro_torch.dist.collectives import (axis_index, gather_axis,
                                              make_mesh, ppermute, psum,
                                              record_collectives)
    from repro_torch.dist.conv2d import conv2d_distributed, make_conv_mesh

    out = {"matrix": verify.verify_rank(rank, verify.matrix_cells(),
                                        "cpu")}
    mesh = make_mesh((2, 4), ("a", "r"), device="cpu")
    out["ring4_coords"] = {a: axis_index(mesh, a) for a in ("a", "r")}
    x = torch.full((8, 64), float(rank))
    for case, (perm, tag) in SEEDED_PERMS.items():
        with record_collectives() as notes:
            got = ppermute(x, mesh, "r", perm, tag=tag)
        out[case] = [tuple(n) for n in notes]
        out[case + ":got"] = float(got[0, 0])
    kmesh = make_mesh((2, 4), ("b", "k"), device="cpu")
    out["gather_coords"] = {a: axis_index(kmesh, a) for a in ("b", "k")}
    with record_collectives() as notes:
        gather_axis(x, kmesh, "k", dim=0, schedule="allgather")
    out["gather"] = [tuple(n) for n in notes]
    cmesh = make_conv_mesh(STRAY_GRID, device="cpu")
    out["stray_coords"] = {a: axis_index(cmesh, a) for a in "bhwkc"}
    xs, ws = verify._local_shapes(verify.conv_cell(STRAY_GRID, "ring2"))
    with record_collectives() as notes:
        y = conv2d_distributed(torch.randn(xs), torch.randn(ws), cmesh,
                               schedule="ring2")
        psum(y, cmesh, ("b", "k"), tag="stray")
    out["stray"] = [tuple(n) for n in notes]
    return out


@pytest.fixture(scope="module")
def launched():
    from repro_torch.dist.spawn import run_spmd
    return run_spmd(_rank8, 8, device="cpu")


MATRIX = verify.matrix_cells()


@pytest.mark.subprocess
@pytest.mark.parametrize("i", range(len(MATRIX)), ids=[
    f"{s.name}/{'+'.join(s.variants)}" for s in MATRIX])
def test_matrix_cell_ok_with_exact_wire(launched, i):
    spec = MATRIX[i]
    reports = verify.lint_cell(spec, [r["matrix"][i] for r in launched])
    assert [r.variant.split("/")[0] for r in reports] == list(spec.variants)
    for rep in reports:
        assert rep.ok, (rep.name, [str(f) for f in rep.findings])
        assert rep.rank_wire_ratios == (1.0,) * 8 or (
            rep.wire_ratio is None and not any(rep.rank_wire_ratios)), \
            (rep.name, rep.rank_wire_ratios)
        assert rep.mem_ratio is None and rep.mem_note == verify.CPU_MEM_NOTE
        assert rep.analytic_mem_bytes > 0


@pytest.mark.subprocess
def test_ring_on_1_8_1_records_7_hops_on_n(launched):
    i = next(j for j, s in enumerate(MATRIX) if s.op == "matmul"
             and s.grid == (1, 8, 1) and s.schedule == "ring")
    recs = [r["matrix"][i] for r in launched]
    notes = [r["variants"]["fwd"]["notes"] for r in recs]
    colls = extract_collectives(notes, (("m", 1), ("n", 8), ("c", 1)),
                                [r["coords"] for r in recs])
    perms = [c for c in colls if c.kind == "collective-permute"]
    assert len(perms) == 7 and len(colls) == 7
    assert all(c.axes == ("n",) and c.pairs == tuple(
        (r, (r + 1) % 8) for r in range(8)) for c in perms)
    assert sum(c.mult for c in perms) == 7
    assert not lint_deadlock(colls, (("m", 1), ("n", 8), ("c", 1)),
                             notes[0])


@pytest.mark.subprocess
@pytest.mark.parametrize("case", sorted(SEEDED_PERMS))
def test_seeded_deadlock_regression(launched, case):
    """A ring hop missing its closing edge and a partial sub-ring run
    (only the named ranks post a send or a receive) and must fail the
    deadlock lint from the recorded pairs; the total rotation and an
    untagged halo shift must pass."""
    notes = [r[case] for r in launched]
    coords = [r["ring4_coords"] for r in launched]
    colls = extract_collectives(notes, RING4, coords)
    errs = errors(lint_deadlock(colls, RING4, notes[0]))
    perm = dict(SEEDED_PERMS[case][0])
    for rank, r in enumerate(launched):   # what each rank received
        me = r["ring4_coords"]["r"]
        src = [s for s, d in perm.items() if d == me]
        want = float(rank - me + src[0]) if src else 0.0
        assert r[case + ":got"] == want
    if case in ("total_rotation", "halo_shift"):
        assert not errs, errs
    else:
        assert errs, f"deadlock lint missed the {case}"
    if case == "open_ring_hop":
        assert any("bijection" in str(e) for e in errs), errs


@pytest.mark.subprocess
def test_seeded_footprint_regression(launched):
    """An all-gather on k: flagged when the cell claims ring2, clean
    under its true schedule."""
    mesh = (("b", 2), ("k", 4))
    colls = extract_collectives([r["gather"] for r in launched], mesh,
                                [r["gather_coords"] for r in launched])
    assert [c.kind for c in colls] == ["all-gather"]
    errs = errors(lint_footprint(colls, schedule="ring2",
                                 contraction_axes=("b", "k")))
    assert errs and "all-gather" in str(errs[0])
    assert not lint_footprint(colls, schedule="allgather",
                              contraction_axes=("b", "k"))


@pytest.mark.subprocess
def test_seeded_attribution_regressions(launched):
    """A collective no term names (a psum over b x k after the conv) and
    a term with no collective (the recorded Ker gather dropped) both
    fail; the conv's own notes pass."""
    spec = verify.conv_cell(STRAY_GRID, "ring2")
    mesh = tuple(zip("bhwkc", STRAY_GRID))
    terms, _ = verify.analytic(spec, "fwd")
    coords = [r["stray_coords"] for r in launched]
    notes = [r["stray"] for r in launched]
    colls = extract_collectives(notes, mesh, coords)
    assert colls[-1].name == "stray" and colls[-1].axes == ("b", "k")
    assert lint_attribution(colls[:-1], terms, mesh) == []
    stray = errors(lint_attribution(colls, terms, mesh))
    assert len(stray) == 1 and "unaccounted" in str(stray[0])
    unpaid = errors(lint_attribution(
        [c for c in colls[:-1] if c.axes != ("b",)], terms, mesh))
    assert len(unpaid) == 1 and "never paid" in str(unpaid[0])
    assert "gather_ker" in str(unpaid[0])
