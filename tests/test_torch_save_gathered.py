"""The port's native differentiation (``save_gathered=True``) against the
JAX package's.

One 8-device JAX subprocess (autotuner off, XLA local contractions)
computes the JAX package's ``save_gathered=True`` outputs and gradients
of the distributed conv and matmul, and its dense CNN train step, while
one 8-rank gloo launch of the port (its tuner off too, so the ranks
agree) computes the same from the same numpy inputs.  Tolerances are
those of the custom-VJP cases in ``tests/test_torch_train.py``: op
outputs and gradients f32 ``rtol=1e-4, atol=1e-4`` on unit-normal data;
the train step's loss within 1e-5, parameters within 1e-5 absolute,
gradients within 1e-4 of ``max|g|``.  The backward wire the port records
must equal the analytic ``save_gathered=True`` count exactly on every
rank, term by term: each backward collective is tagged with the name of
the accounting term it pays (the halo's accumulation, which the native
path reaches through the halo exchange's own Function, included).
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

# the JAX package is imported inside the tests: the 8 spawned ranks import
# this module for _port_rank and need only torch
from repro_torch.dist import conv2d as tconv  # noqa: E402
from repro_torch.dist import matmul as tmm  # noqa: E402
from repro_torch.dist import train as ttrain  # noqa: E402
from repro_torch.train import optim as toptim  # noqa: E402

pytestmark = pytest.mark.subprocess

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCHEDULES = ("allgather", "ring", "ring2")
GRIDS = [(2, 1, 1, 2, 2), (1, 2, 2, 2, 1)]
CONV_CASES = [(f"conv-{'x'.join(map(str, g))}-{s}", g, s)
              for g in GRIDS for s in SCHEDULES]
# each conv grid's matmul view (Pb*Ph*Pw, Pk, Pc), as the CNN's head uses
MATMUL_CASES = [(f"matmul-{pb * ph * pw}x{pk}x{pc}-{s}",
                 (pb * ph * pw, pk, pc), s)
                for pb, ph, pw, pk, pc in GRIDS for s in SCHEDULES]
# (2,1,1,2,2) ring2 zips both rings; (1,2,2,2,1) has the halo
TRAIN_CASES = [((2, 1, 1, 2, 2), "ring2"), ((1, 2, 2, 2, 1), "allgather")]
X_SHAPE, W_SHAPE, MM = (8, 8, 16, 16), (8, 8, 3, 3), (16, 32, 24)
CHANNELS, IN_CHANNELS, HW, N_CLASSES, BATCH = [16, 16], 8, 16, 8, 8
STEPS, LR = 2, 1e-3


def _inputs():
    rng = np.random.default_rng(1)
    m, c, n = MM
    out = {"x": rng.standard_normal(X_SHAPE, dtype=np.float32),
           "w": rng.standard_normal(W_SHAPE, dtype=np.float32),
           "gc": rng.standard_normal(X_SHAPE, dtype=np.float32),
           "xm": rng.standard_normal((m, c), dtype=np.float32),
           "wm": rng.standard_normal((c, n), dtype=np.float32),
           "gm": rng.standard_normal((m, n), dtype=np.float32),
           "images": rng.standard_normal((BATCH, IN_CHANNELS, HW, HW),
                                         dtype=np.float32),
           "labels": rng.integers(0, N_CLASSES, BATCH).astype(np.int64)}
    cin = IN_CHANNELS
    for i, cout in enumerate(CHANNELS):
        out[f"w{i}"] = (rng.standard_normal((cout, cin, 3, 3),
                                            dtype=np.float32)
                        * np.float32((cin * 9) ** -0.5))
        out[f"b{i}"] = rng.standard_normal(cout, dtype=np.float32) * 0.1
        cin = cout
    out["head"] = (rng.standard_normal((cin, N_CLASSES), dtype=np.float32)
                   * np.float32(cin ** -0.5))
    return out


_JAX_REFERENCE = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    from repro.dist.conv2d import conv2d_distributed, make_conv_mesh
    from repro.dist.matmul import make_matmul_mesh, matmul_distributed
    from repro.models.cnn import loss_cnn
    from repro.train.optim import AdamW
    from repro.train.step import init_train_state, make_train_step
    inp = {k: jnp.asarray(v) for k, v in np.load(sys.argv[1]).items()}
    conv, mm, n_convs, steps, lr = json.loads(sys.argv[3])
    out = {}

    def run(name, op, mesh, sched, x, w, g):
        # one compiled program per case: eager differentiation of a
        # shard_map compiles every primitive on its own and is ~40x slower
        @jax.jit
        def y_and_grads(a, b):
            y, vjp = jax.vjp(lambda a, b: op(a, b, mesh, schedule=sched,
                                             save_gathered=True), a, b)
            return (y,) + vjp(g)
        (out[name + "/y"], out[name + "/dx"],
         out[name + "/dw"]) = y_and_grads(x, w)

    for name, grid, sched in conv:
        run(name, conv2d_distributed, make_conv_mesh(tuple(grid)), sched,
            inp["x"], inp["w"], inp["gc"])
    for name, grid, sched in mm:
        run(name, matmul_distributed, make_matmul_mesh(tuple(grid)), sched,
            inp["xm"], inp["wm"], inp["gm"])
    params = {"convs": [{"w": inp[f"w{i}"], "b": inp[f"b{i}"]}
                        for i in range(n_convs)], "head": inp["head"]}
    batch = {"images": inp["images"], "labels": inp["labels"]}
    grads = jax.grad(lambda p: loss_cnn(p, batch))(params)
    for i, leaf in enumerate(jax.tree.leaves(grads)):
        out[f"train/grad{i}"] = leaf
    opt = AdamW(lr=lr)
    state = init_train_state(params, opt)
    step = make_train_step(lambda p, b: loss_cnn(p, b), opt)
    for s in range(steps):
        state, metrics = step(state, batch)
        out[f"train/loss{s}"] = metrics["loss"]
        for i, leaf in enumerate(jax.tree.leaves(state.params)):
            out[f"train/step{s}/param{i}"] = leaf
    np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in out.items()})
""")


def _params(inp):
    return {"convs": [{"w": torch.from_numpy(inp[f"w{i}"]),
                       "b": torch.from_numpy(inp[f"b{i}"])}
                      for i in range(len(CHANNELS))],
            "head": torch.from_numpy(inp["head"])}


def _leaves(p):
    """Parameters in the JAX package's pytree leaf order."""
    return [t for blk in p["convs"] for t in (blk["b"], blk["w"])] \
        + [p["head"]]


def _by_tag(notes):
    out = {}
    for n in notes:
        out[n.tag] = out.get(n.tag, 0.0) + n.wire_elems
    return out


def _port_rank(rank, inputs_path):
    from repro_torch.kernels.autotune import autotune_disabled

    with autotune_disabled():  # the static plan: ranks agree
        return _port_rank_body(rank, inputs_path)


def _port_rank_body(rank, inputs_path):
    """Every case on this rank: the full outputs, gradients and train
    trajectory (rank 0) and this rank's recorded wire per case."""
    from repro_torch.dist.collectives import (record_collectives, shard,
                                              unshard)
    from repro_torch.models.cnn import loss_cnn

    inp = dict(np.load(inputs_path))
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    meshes = {}

    def mesh_for(grid, make):
        if grid not in meshes:
            meshes[grid] = make(grid, device="cpu")
        return meshes[grid]

    outs, wire = {}, {}
    for cases, make, x, w, g, specs, op in [
            (CONV_CASES, tconv.make_conv_mesh, "x", "w", "gc",
             (tconv.IN_SPEC, tconv.KER_SPEC, tconv.OUT_SPEC),
             tconv.conv2d_distributed),
            (MATMUL_CASES, tmm.make_matmul_mesh, "xm", "wm", "gm",
             (tmm.X_SPEC, tmm.W_SPEC, tmm.OUT_SPEC),
             tmm.matmul_distributed)]:
        for name, grid, sched in cases:
            mesh = mesh_for(grid, make)
            xl = shard(t[x], mesh, specs[0]).requires_grad_(True)
            wl = shard(t[w], mesh, specs[1]).requires_grad_(True)
            with record_collectives() as fwd:
                y = op(xl, wl, mesh, schedule=sched, save_gathered=True)
            with record_collectives() as bwd:
                dxl, dwl = torch.autograd.grad(
                    y, (xl, wl), shard(t[g], mesh, specs[2]))
            wire[name] = (sum(n.wire_elems for n in fwd), _by_tag(bwd))
            outs[name + "/y"] = unshard(y.detach(), mesh, specs[2]).numpy()
            outs[name + "/dx"] = unshard(dxl, mesh, specs[0]).numpy()
            outs[name + "/dw"] = unshard(dwl, mesh, specs[1]).numpy()

    batch = {"images": t["images"], "labels": t["labels"]}
    for grid, sched in TRAIN_CASES:
        mesh = mesh_for(grid, tconv.make_conv_mesh)
        key = f"train-{'x'.join(map(str, grid))}-{sched}"
        leaves = [p.clone().requires_grad_(True)
                  for p in _leaves(_params(inp))]
        params = {"convs": [{"b": leaves[2 * i], "w": leaves[2 * i + 1]}
                            for i in range(len(CHANNELS))],
                  "head": leaves[-1]}
        with record_collectives() as fwd:
            loss = loss_cnn(params, batch, dist_mesh=mesh,
                            dist_schedule=sched, dist_save_gathered=True)
        with record_collectives() as bwd:
            grads = torch.autograd.grad(loss, leaves)
        wire[key] = tuple(sum(n.wire_elems for n in notes
                              if n.tag != "reshard")
                          for notes in (fwd, bwd))
        for i, g in enumerate(grads):
            outs[f"{key}/grad{i}"] = g.numpy()
        opt = toptim.AdamW(lr=LR)
        state = ttrain.init_grid_train_state(_params(inp), opt)
        step = ttrain.make_grid_train_step(opt, mesh, schedule=sched,
                                           save_gathered=True)
        for s in range(STEPS):
            state, metrics = step(state, batch)
            outs[f"{key}/loss{s}"] = float(metrics["loss"])
            for i, leaf in enumerate(_leaves(state.params)):
                outs[f"{key}/step{s}/param{i}"] = leaf.numpy()
    return (outs if rank == 0 else None), wire


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from repro_torch.dist.spawn import run_spmd

    tmp = tmp_path_factory.mktemp("torch_save_gathered")
    inputs = str(tmp / "inputs.npz")
    np.savez(inputs, **_inputs())
    jax_out = str(tmp / "jax.npz")
    env = dict(os.environ, REPRO_AUTOTUNE="0", REPRO_DIST_PALLAS="0",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(_ROOT, "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    cases = json.dumps([CONV_CASES, MATMUL_CASES, len(CHANNELS), STEPS,
                        LR])
    ref = subprocess.Popen(
        [sys.executable, "-c", _JAX_REFERENCE, inputs, jax_out, cases],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        port = run_spmd(_port_rank, 8, inputs, device="cpu")
        _, err = ref.communicate(timeout=600)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0, err
    return {"jax": dict(np.load(jax_out)), "port": port[0][0],
            "wire": [w for _, w in port]}


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def _terms(acc):
    """The accounting's nonzero backward terms, by name."""
    return {k: v for k, v in acc["bwd"].items() if k != "total" and v}


@pytest.mark.parametrize("name,grid,sched", CONV_CASES)
def test_conv2d_save_gathered_matches_jax_and_wire(runs, name, grid,
                                                   sched):
    from repro.dist.conv2d import conv_train_comm_elems

    for part in ("/y", "/dx", "/dw"):
        _close(runs["port"][name + part], runs["jax"][name + part])
    want = conv_train_comm_elems(X_SHAPE, W_SHAPE, grid, schedule=sched,
                                 save_gathered=True)
    if grid[1] * grid[2] > 1:   # the halo's own VJP runs under autograd
        assert want["bwd"]["halo_acc"] > 0
    assert [w[name] for w in runs["wire"]] == \
        [(want["fwd"]["total"], _terms(want))] * 8


@pytest.mark.parametrize("name,grid,sched", MATMUL_CASES)
def test_matmul_save_gathered_matches_jax_and_wire(runs, name, grid,
                                                   sched):
    from repro.dist.matmul import matmul_train_comm_elems

    for part in ("/y", "/dx", "/dw"):
        _close(runs["port"][name + part], runs["jax"][name + part])
    want = matmul_train_comm_elems(*MM, grid, save_gathered=True)
    assert [w[name] for w in runs["wire"]] == \
        [(want["fwd"]["total"], _terms(want))] * 8


@pytest.mark.parametrize("grid,sched", TRAIN_CASES)
def test_save_gathered_train_step_matches_jax_dense(runs, grid, sched):
    """The grid step with ``save_gathered=True`` equals the JAX package's
    dense step through 2 AdamW steps, and the ops' recorded wire of one
    loss and its gradients equals ``cnn_train_comm_elems(...,
    save_gathered=True)`` on every rank, less the first layer's dIn
    terms."""
    from repro.dist.train import cnn_train_comm_elems

    port, ref = runs["port"], runs["jax"]
    key = f"train-{'x'.join(map(str, grid))}-{sched}"
    n_leaves = 2 * len(CHANNELS) + 1
    for i in range(n_leaves):
        g, r = port[f"{key}/grad{i}"], ref[f"train/grad{i}"]
        assert float(np.max(np.abs(g - r)) / (np.max(np.abs(r)) + 1e-12)) \
            < 1e-4, i
    for s in range(STEPS):
        assert abs(port[f"{key}/loss{s}"] - float(ref[f"train/loss{s}"])) \
            < 1e-5
        for i in range(n_leaves):
            assert float(np.max(np.abs(port[f"{key}/step{s}/param{i}"]
                                       - ref[f"train/step{s}/param{i}"]))) \
                < 1e-5, (s, i)
    want = cnn_train_comm_elems((BATCH, IN_CHANNELS, HW, HW), CHANNELS,
                                N_CLASSES, grid, schedule=sched,
                                save_gathered=True)
    # the images carry no gradient: native differentiation (JAX's too)
    # never transposes the first layer's In gather and halo, which the
    # accounting, shared with the custom VJP that always forms dIn, counts
    first = want["layers"][0]["bwd"]
    assert first["rs_in"] + first["halo_acc"] > 0
    assert [w[key] for w in runs["wire"]] == \
        [(want["fwd_total"],
          want["bwd_total"] - first["rs_in"] - first["halo_acc"])] * 8
