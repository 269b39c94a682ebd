"""The port's ring primitives on odd ring sizes, forward and backward --
the mirror of ``tests/test_collectives_rings.py``'s odd-ring cases.

Two gloo launches: 9 ranks as a 3 x 3 mesh (rings of 3, the 3 x 3
``ring_zip`` and the degenerate 1 x 3 zip on a view of the same ranks)
and 5 ranks (rings of 5).  Odd sizes exercise the ``(me - t) % g``
source arithmetic and, backward, the inverse permutations that
``collectives.ppermute`` transposes to: every gradient is held against a
numpy sum over the ranks' coordinates.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# torch on one thread in this process: the ops here are smoke-sized, and
# beside the other pytest-xdist workers more threads only spin
torch.set_num_threads(1)

pytestmark = pytest.mark.subprocess

ROWS, COLS = 2, 4   # one rank's chunk


def _value(seed, *coords, shape=(ROWS, COLS)):
    """A tensor fixed by a seed and a rank's coordinates."""
    rng = np.random.default_rng([seed, *coords])
    return rng.standard_normal(shape).astype(np.float32)


def _ring_checks(mesh, axis, me, g):
    """Forward and backward of the rotating gather and the two
    reduce-scatters on one ring; returns results for numpy to check."""
    from repro_torch.dist.collectives import (ring_all_gather,
                                              ring_reduce_scatter,
                                              ring_scatter_reduce)

    x = torch.from_numpy(np.concatenate([_value(g, r) for r in range(g)]))
    out = {}
    shard = x[me * ROWS:(me + 1) * ROWS].clone().requires_grad_(True)
    gathered = ring_all_gather(shard, mesh, axis, dim=0)
    cot = torch.from_numpy(_value(g + 100, me, shape=(g * ROWS, COLS)))
    (out["gather_grad"],) = torch.autograd.grad(gathered, shard, cot)
    out["gather"] = gathered.detach()
    # reduce-scatter of a rank-dependent x: chunk me of the sum
    xr = torch.from_numpy(_value(g + 200, me, shape=(g * ROWS, COLS)))
    xr.requires_grad_(True)
    scattered = ring_reduce_scatter(xr, mesh, axis, dim=0)
    cot = torch.from_numpy(_value(g + 300, me))
    (out["scatter_grad"],) = torch.autograd.grad(scattered, xr, cot)
    out["scatter"] = scattered.detach()
    # the on-the-fly producer: chunk r of the replicated x
    out["token"] = ring_scatter_reduce(
        mesh, axis, lambda r, _t: x[r * ROWS:(r + 1) * ROWS])
    return {k: v.numpy() for k, v in out.items()}


def _zip_checks(mesh, axis_a, axis_b, ia, ib):
    """``ring_zip`` carrying each shard's origin: the sources it reports
    against the payloads that arrived, and the gradient of a bilinear
    fold whose coefficient depends on the step."""
    from repro_torch.dist.collectives import ring_zip

    a = torch.tensor([float(ia)] + list(_value(1, ia, ib, shape=(3,))),
                     requires_grad=True)
    b = torch.tensor([float(ib)] + list(_value(2, ia, ib, shape=(3,))),
                     requires_grad=True)
    seen = []

    def fold(acc, t, sa, ca, sb, cb):
        seen.append((t, sa, int(ca[0].item()), sb, int(cb[0].item())))
        term = (t + 1) * torch.dot(ca[1:], cb[1:])
        return term if acc is None else acc + term

    acc = ring_zip(a, axis_a, b, axis_b, mesh, fold)
    da, db = torch.autograd.grad(acc, (a, b))
    return {"seen": seen, "acc": float(acc), "da": da[1:].numpy(),
            "db": db[1:].numpy()}


def _rank_9(rank):
    from repro_torch.dist.collectives import (axis_index, make_mesh,
                                              mesh_view)

    mesh = make_mesh((3, 3), ("a", "b"), device="cpu")
    ia, ib = axis_index(mesh, "a"), axis_index(mesh, "b")
    # the same ranks with an axis of size 1 in front: every row of three
    # runs the 1 x 3 zip on the same shards
    line = mesh_view(mesh, (1, 3, 3), ("one", "a", "b"))
    return {"coords": (ia, ib), "ring": _ring_checks(mesh, "a", ia, 3),
            "zip": _zip_checks(mesh, "a", "b", ia, ib),
            "zip_1x3": _zip_checks(line, "one", "b", 0, ib),
            "axes": _axes_checks(mesh)}


def _axes_checks(mesh):
    """The axis sizes and coordinates read through the per-mesh cache, of
    the mesh and of a view over the same ranks, beside DeviceMesh's own;
    whether the view's cache went with the view."""
    import gc
    import weakref

    from repro_torch.dist.collectives import axis_index, axis_size, mesh_view

    flat = mesh_view(mesh, (9,), ("all",))
    out = {}
    for m in (mesh, flat, mesh):     # the mesh again: read from its cache
        out.setdefault("got", []).append(
            [(axis_size(m, a), axis_index(m, a)) for a in m.mesh_dim_names])
        out.setdefault("want", []).append(
            [(m.shape[i], m.get_coordinate()[i])
             for i in range(len(m.mesh_dim_names))])
    ref = weakref.ref(flat)
    del flat, m
    gc.collect()
    out["view_freed"] = ref() is None
    return out


def _rank_5(rank):
    from repro_torch.dist.collectives import axis_index, make_mesh

    mesh = make_mesh((5,), ("r",), device="cpu")
    me = axis_index(mesh, "r")
    return {"coords": (me,), "ring": _ring_checks(mesh, "r", me, 5)}


@pytest.fixture(scope="module")
def runs():
    from repro_torch.dist.spawn import run_spmd

    return {9: run_spmd(_rank_9, 9, device="cpu"),
            5: run_spmd(_rank_5, 5, device="cpu")}


def _ring_ranks(runs, g):
    """(coordinate on the ring, ring results) per rank; rings of 3 are
    the a-axis of the 3 x 3 launch."""
    return [(r["coords"][0], r["ring"]) for r in runs[9 if g == 3 else 5]]


@pytest.mark.parametrize("g", [3, 5])
def test_ring_primitives_odd_sizes(runs, g):
    """Forward: the rotating gather equals the whole tensor, the
    reduce-scatter of the replicated x and the producer variant equal
    ``g`` times the own chunk; sums over the ring of rank-dependent
    inputs for the reduce-scatter."""
    x = np.concatenate([_value(g, r) for r in range(g)])
    ranks = _ring_ranks(runs, g)
    for me, res in ranks:
        np.testing.assert_allclose(res["gather"], x, rtol=1e-6)
        np.testing.assert_allclose(res["token"],
                                   g * x[me * ROWS:(me + 1) * ROWS],
                                   rtol=1e-5)
        want = sum(_value(g + 200, q, shape=(g * ROWS, COLS))
                   for q in range(g))[me * ROWS:(me + 1) * ROWS]
        np.testing.assert_allclose(res["scatter"], want, rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("g", [3, 5])
def test_ring_primitives_odd_sizes_backward(runs, g):
    """Backward through the inverse permutations: the gather's gradient
    is the ring's sum of every rank's cotangent chunk ``me`` (a
    reduce-scatter); the reduce-scatter's is every rank's cotangent in
    its chunk (a gather)."""
    for me, res in _ring_ranks(runs, g):
        want = sum(_value(g + 100, q, shape=(g * ROWS, COLS))
                   for q in range(g))[me * ROWS:(me + 1) * ROWS]
        np.testing.assert_allclose(res["gather_grad"], want, rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(
            res["scatter_grad"],
            np.concatenate([_value(g + 300, q) for q in range(g)]),
            rtol=1e-6)


def _zip_want(ia, ib, ga, gb, a_of, b_of):
    """The fold's value and gradients at rank (ia, ib), in numpy: at step
    t the rank holds a's shard from (src_a, ib) and b's from (ia, src_b);
    each rank's gradient sums the terms its shard entered on every rank
    of its rings."""
    steps = max(ga, gb)

    def src(i, t, g):
        return (i - t) % g if g > 1 else i

    acc = sum((t + 1) * a_of(src(ia, t, ga), ib) @ b_of(ia, src(ib, t, gb))
              for t in range(steps))
    da = sum((t + 1) * b_of(p, src(ib, t, gb))
             for p in range(ga) for t in range(steps)
             if src(p, t, ga) == ia)
    db = sum((t + 1) * a_of(src(ia, t, ga), q)
             for q in range(gb) for t in range(steps)
             if src(q, t, gb) == ib)
    return acc, da, db


def test_mesh_axes_cached_per_mesh_and_freed_with_it(runs):
    """Every rank reads each mesh's own sizes and coordinates (a view over
    the same ranks keeps its own), and a mesh's cached axes do not keep
    it alive."""
    for rank, res in enumerate(runs[9]):
        axes = res["axes"]
        assert axes["got"] == axes["want"]
        assert axes["got"][1] == [(9, rank)]
        assert axes["view_freed"]


@pytest.mark.parametrize("kind", ["zip", "zip_1x3"])
def test_ring_zip_odd_rings_forward_and_backward(runs, kind):
    """3 x 3: the reported sources stay in lockstep with the payloads and
    each rank visits the diagonal ``src_a - src_b == ia - ib (mod 3)``;
    1 x 3: the stationary a-shard meets every b-shard.  The fold's value
    and both gradients match numpy on every rank."""
    ga = 3 if kind == "zip" else 1
    for r in runs[9]:
        ia, ib = r["coords"] if ga == 3 else (0, r["coords"][1])
        res = r[kind]
        assert [s[0] for s in res["seen"]] == [0, 1, 2]
        for t, sa, pa, sb, pb in res["seen"]:
            assert (sa, sb) == (pa, pb)     # payload origin == source
            if ga == 3:
                assert (sa - sb) % 3 == (ia - ib) % 3
            else:
                assert sa == 0 and sb == (ib - t) % 3
        acc, da, db = _zip_want(
            ia, ib, ga, 3, lambda p, q: _value(1, p, q, shape=(3,)),
            lambda p, q: _value(2, p, q, shape=(3,)))
        np.testing.assert_allclose(res["acc"], acc, rtol=1e-5)
        np.testing.assert_allclose(res["da"], da, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(res["db"], db, rtol=1e-5, atol=1e-6)
