"""The port's training path against the JAX package: the dist ops'
gradients, their recorded backward wire, the train accounting, AdamW,
and the grid-parallel CNN train step.

One 8-device JAX subprocess (autotuner off, XLA local contractions)
computes the JAX package's gradients of the distributed conv, matmul and
halo exchange, and its dense CNN train step, while one 8-rank gloo launch
of the port (its tuner off too, so the ranks agree) computes the same
from the same numpy inputs.  Tolerances: op gradients f32 ``rtol=1e-4,
atol=1e-4`` on unit-normal data (as ``tests/test_dist.py``); the train
step as ``tests/test_dist_vjps.py``'s acceptance -- loss within 1e-5,
parameters within 1e-5 absolute, gradients within 1e-4 of ``max|g|``.
The recorded backward wire must equal the analytic ``"bwd"`` count
exactly on every rank, and the accounting functions must equal the JAX
package's exactly.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# torch on one thread in this process: the ops here are smoke-sized, and
# beside the other pytest-xdist workers more threads only spin
torch.set_num_threads(1)

# the JAX package is imported inside the tests: the 8 spawned ranks import
# this module for _port_rank and need only torch
from repro_torch.dist import conv2d as tconv  # noqa: E402
from repro_torch.dist import matmul as tmm  # noqa: E402
from repro_torch.dist import train as ttrain  # noqa: E402
from repro_torch.train import optim as toptim  # noqa: E402

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCHEDULES = ("allgather", "ring", "ring2")
GRIDS = [(2, 1, 1, 2, 2), (1, 2, 2, 2, 1)]
CONV_CASES = [(f"conv-{'x'.join(map(str, g))}-{s}", g, s)
              for g in GRIDS for s in SCHEDULES]
MATMUL_CASES = [(f"matmul-2x2x2-{s}", (2, 2, 2), s) for s in SCHEDULES]
# (name, grid, lo, hi): (5, 3) pushes multi-hop strips back
HALO_CASES = [("halo-1-1", (1, 2, 2, 2, 1), 1, 1),
              ("halo-5-3", (1, 2, 2, 2, 1), 5, 3)]
TRAIN_CASES = [(g, s) for g in GRIDS for s in SCHEDULES]
CHANNELS, IN_CHANNELS, HW, N_CLASSES, BATCH = [16, 16], 8, 16, 8, 8
STEPS, LR = 2, 1e-3


def _inputs():
    rng = np.random.default_rng(0)
    out = {"x": rng.standard_normal((8, 8, 16, 16), dtype=np.float32),
           "w": rng.standard_normal((8, 8, 3, 3), dtype=np.float32),
           "gc": rng.standard_normal((8, 8, 16, 16), dtype=np.float32),
           "xm": rng.standard_normal((16, 32), dtype=np.float32),
           "wm": rng.standard_normal((32, 24), dtype=np.float32),
           "gm": rng.standard_normal((16, 24), dtype=np.float32),
           "xh": rng.standard_normal((2, 4, 8, 8), dtype=np.float32),
           "images": rng.standard_normal((BATCH, IN_CHANNELS, HW, HW),
                                         dtype=np.float32),
           "labels": rng.integers(0, N_CLASSES, BATCH).astype(np.int64)}
    for name, _, lo, hi in HALO_CASES:  # Ph = 2 shards of 4 rows
        out[f"gh-{name}"] = rng.standard_normal(
            (2, 4, 2 * (4 + lo + hi), 8), dtype=np.float32)
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
    from jax.sharding import PartitionSpec as P
    from repro.dist._compat import shard_map
    from repro.dist.conv2d import conv2d_distributed, make_conv_mesh
    from repro.dist.halo import halo_exchange_1d
    from repro.dist.matmul import make_matmul_mesh, matmul_distributed
    from repro.models.cnn import loss_cnn
    from repro.train.optim import AdamW
    from repro.train.step import init_train_state, make_train_step
    inp = {k: jnp.asarray(v) for k, v in np.load(sys.argv[1]).items()}
    conv, mm, halo, n_convs, steps, lr = json.loads(sys.argv[3])
    out = {}
    for name, grid, sched in conv:
        mesh = make_conv_mesh(tuple(grid))
        gx, gw = jax.grad(lambda a, b: jnp.sum(conv2d_distributed(
            a, b, mesh, schedule=sched) * inp["gc"]), (0, 1))(
                inp["x"], inp["w"])
        out[name + "/dx"], out[name + "/dw"] = gx, gw
    for name, grid, sched in mm:
        mesh = make_matmul_mesh(tuple(grid))
        gx, gw = jax.grad(lambda a, b: jnp.sum(matmul_distributed(
            a, b, mesh, schedule=sched) * inp["gm"]), (0, 1))(
                inp["xm"], inp["wm"])
        out[name + "/dx"], out[name + "/dw"] = gx, gw
    for name, grid, lo, hi in halo:
        fn = shard_map(
            lambda x, lo=lo, hi=hi: halo_exchange_1d(
                x, "h", spatial_dim=2, lo=lo, hi=hi),
            mesh=make_conv_mesh(tuple(grid)),
            in_specs=P(None, None, "h", "w"),
            out_specs=P(None, None, "h", "w"), check_rep=False)
        out[name + "/dx"] = jax.grad(lambda a: jnp.sum(
            fn(a) * inp["gh-" + name]))(inp["xh"])
    params = {"convs": [{"w": inp[f"w{i}"], "b": inp[f"b{i}"]}
                        for i in range(n_convs)], "head": inp["head"]}
    batch = {"images": inp["images"], "labels": inp["labels"]}
    grads = jax.grad(lambda p: loss_cnn(p, batch))(params)
    for i, (a, b) in enumerate(zip(jax.tree.leaves(grads),
                                   jax.tree.leaves(params))):
        out[f"train/grad{i}"] = a
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


def _op_grads(xl, wl, gl, op):
    """(y's forward wire, the op's backward wire, dxl, dwl) on this
    rank."""
    from repro_torch.dist.collectives import record_collectives

    xl, wl = xl.requires_grad_(True), wl.requires_grad_(True)
    with record_collectives() as fwd:
        y = op(xl, wl)
    with record_collectives() as bwd:
        dxl, dwl = torch.autograd.grad(y, (xl, wl), gl)
    return (sum(n.wire_elems for n in fwd), sum(n.wire_elems for n in bwd),
            dxl, dwl)


def _port_rank(rank, inputs_path):
    from repro_torch.kernels.autotune import autotune_disabled

    with autotune_disabled():  # the static plan: ranks agree
        return _port_rank_body(rank, inputs_path)


def _port_rank_body(rank, inputs_path):
    """Every case on this rank; returns the full gradients and the train
    trajectory (rank 0) and this rank's recorded wire per case."""
    from repro_torch.dist.collectives import (record_collectives, shard,
                                              unshard)
    from repro_torch.dist.halo import halo_exchange_1d
    from repro_torch.models.cnn import loss_cnn

    inp = dict(np.load(inputs_path))
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    meshes = {}

    def mesh_for(grid, make):
        if grid not in meshes:
            meshes[grid] = make(grid, device="cpu")
        return meshes[grid]

    outs, wire = {}, {}
    for name, grid, sched in CONV_CASES:
        mesh = mesh_for(grid, tconv.make_conv_mesh)
        f, b, dxl, dwl = _op_grads(
            shard(t["x"], mesh, tconv.IN_SPEC),
            shard(t["w"], mesh, tconv.KER_SPEC),
            shard(t["gc"], mesh, tconv.OUT_SPEC),
            lambda a, w: tconv.conv2d_distributed(a, w, mesh,
                                                  schedule=sched))
        wire[name] = (f, b)
        outs[name + "/dx"] = unshard(dxl, mesh, tconv.IN_SPEC).numpy()
        outs[name + "/dw"] = unshard(dwl, mesh, tconv.KER_SPEC).numpy()
    for name, grid, sched in MATMUL_CASES:
        mesh = mesh_for(grid, tmm.make_matmul_mesh)
        f, b, dxl, dwl = _op_grads(
            shard(t["xm"], mesh, tmm.X_SPEC),
            shard(t["wm"], mesh, tmm.W_SPEC),
            shard(t["gm"], mesh, tmm.OUT_SPEC),
            lambda a, w: tmm.matmul_distributed(a, w, mesh, schedule=sched))
        wire[name] = (f, b)
        outs[name + "/dx"] = unshard(dxl, mesh, tmm.X_SPEC).numpy()
        outs[name + "/dw"] = unshard(dwl, mesh, tmm.W_SPEC).numpy()
    for name, grid, lo, hi in HALO_CASES:
        mesh = mesh_for(grid, tconv.make_conv_mesh)
        spec = (None, None, "h", "w")
        xl = shard(t["xh"], mesh, spec).requires_grad_(True)
        y = halo_exchange_1d(xl, mesh, "h", spatial_dim=2, lo=lo, hi=hi)
        (dxl,) = torch.autograd.grad(y, (xl,),
                                     shard(t["gh-" + name], mesh, spec))
        outs[name + "/dx"] = unshard(dxl, mesh, spec).numpy()

    # the reductions the backward passes use, on a rank-dependent tensor
    from repro_torch.dist.collectives import (pmean, psum_scatter,
                                              ring_reduce_scatter)
    mesh = mesh_for(GRIDS[0], tconv.make_conv_mesh)
    v = (rank + 1) * torch.arange(24, dtype=torch.float32).reshape(8, 3)
    wire["collectives"] = {
        "pmean": pmean(v, mesh, ("b", "k")).numpy(),
        "psum_scatter": psum_scatter(v, mesh, "k", dim=0).numpy(),
        "ring_reduce_scatter": ring_reduce_scatter(v, mesh, "c",
                                                   dim=0).numpy()}

    batch = {"images": t["images"], "labels": t["labels"]}
    for grid, sched in TRAIN_CASES:
        mesh = mesh_for(grid, tconv.make_conv_mesh)
        key = f"train-{'x'.join(map(str, grid))}-{sched}"
        leaves = [p.clone().requires_grad_(True) for p in _leaves(
            _params(inp))]
        params = {"convs": [{"b": leaves[2 * i], "w": leaves[2 * i + 1]}
                            for i in range(len(CHANNELS))],
                  "head": leaves[-1]}
        with record_collectives() as fwd:
            loss = loss_cnn(params, batch, dist_mesh=mesh,
                            dist_schedule=sched)
        with record_collectives() as bwd:
            grads = torch.autograd.grad(loss, leaves)
        wire[key] = tuple(sum(n.wire_elems for n in notes
                              if n.tag != "reshard")
                          for notes in (fwd, bwd))
        for i, g in enumerate(grads):
            outs[f"{key}/grad{i}"] = g.numpy()
        opt = toptim.AdamW(lr=LR)
        state = ttrain.init_grid_train_state(_params(inp), opt)
        step = ttrain.make_grid_train_step(opt, mesh, schedule=sched)
        for s in range(STEPS):
            state, metrics = step(state, batch)
            outs[f"{key}/loss{s}"] = float(metrics["loss"])
            for i, leaf in enumerate(_leaves(state.params)):
                outs[f"{key}/step{s}/param{i}"] = leaf.numpy()
    return (outs if rank == 0 else None), wire


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from repro_torch.dist.spawn import run_spmd

    tmp = tmp_path_factory.mktemp("torch_train")
    inputs = str(tmp / "inputs.npz")
    np.savez(inputs, **_inputs())
    jax_out = str(tmp / "jax.npz")
    env = dict(os.environ, REPRO_AUTOTUNE="0", REPRO_DIST_PALLAS="0",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(_ROOT, "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    cases = json.dumps([CONV_CASES, MATMUL_CASES, HALO_CASES,
                        len(CHANNELS), STEPS, LR])
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


pytestmark = pytest.mark.subprocess


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name,grid,sched", CONV_CASES)
def test_conv2d_distributed_grads_and_bwd_wire(runs, name, grid, sched):
    from repro.dist.conv2d import conv_train_comm_elems

    for part in ("/dx", "/dw"):
        _close(runs["port"][name + part], runs["jax"][name + part])
    want = conv_train_comm_elems((8, 8, 16, 16), (8, 8, 3, 3), grid,
                                 schedule=sched)
    assert [w[name] for w in runs["wire"]] == \
        [(want["fwd"]["total"], want["bwd"]["total"])] * 8


@pytest.mark.parametrize("name,grid,sched", MATMUL_CASES)
def test_matmul_distributed_grads_and_bwd_wire(runs, name, grid, sched):
    from repro.dist.matmul import matmul_train_comm_elems

    for part in ("/dx", "/dw"):
        _close(runs["port"][name + part], runs["jax"][name + part])
    want = matmul_train_comm_elems(16, 32, 24, grid)
    assert [w[name] for w in runs["wire"]] == \
        [(want["fwd"]["total"], want["bwd"]["total"])] * 8


def test_pmean_and_reduce_scatters_match_numpy(runs):
    """pmean over (b, k), psum_scatter over k and ring_reduce_scatter
    over c on (2,1,1,2,2), against sums over the ranks' coordinates."""
    grid = GRIDS[0]
    coords = list(np.ndindex(*grid))   # rank-major, axes (b,h,w,k,c)
    base = np.arange(24, dtype=np.float32).reshape(8, 3)
    for r, (b, h, w, k, c) in enumerate(coords):
        got = runs["wire"][r]["collectives"]

        def peers(vary):
            return [q for q, cq in enumerate(coords)
                    if all(cq[i] == (b, h, w, k, c)[i] for i in range(5)
                           if i not in vary)]
        bk, kk, cc = peers((0, 3)), peers((3,)), peers((4,))
        np.testing.assert_allclose(
            got["pmean"], sum((q + 1) * base for q in bk) / len(bk))
        np.testing.assert_allclose(
            got["psum_scatter"],
            sum((q + 1) * base for q in kk)[k * 4:(k + 1) * 4])
        np.testing.assert_allclose(
            got["ring_reduce_scatter"],
            sum((q + 1) * base for q in cc)[c * 4:(c + 1) * 4])


@pytest.mark.parametrize("name,grid,lo,hi", HALO_CASES)
def test_halo_exchange_grad_matches_jax(runs, name, grid, lo, hi):
    _close(runs["port"][name + "/dx"], runs["jax"][name + "/dx"])


@pytest.mark.parametrize("grid,sched", TRAIN_CASES)
def test_grid_train_step_matches_jax_dense(runs, grid, sched):
    """The acceptance of ``tests/test_dist_vjps.py`` and
    ``tests/test_ring2.py``: the 8-rank grid step equals the JAX
    package's dense step through 2 AdamW steps, and the ops' recorded
    wire of one loss and its gradients equals ``cnn_train_comm_elems``
    on every rank."""
    from repro.dist.train import cnn_train_comm_elems

    port, ref = runs["port"], runs["jax"]
    key = f"train-{'x'.join(map(str, grid))}-{sched}"
    n_leaves = 2 * len(CHANNELS) + 1
    for i in range(n_leaves):
        g, r = port[f"{key}/grad{i}"], ref[f"train/grad{i}"]
        assert float(np.max(np.abs(g - r)) / (np.max(np.abs(r)) + 1e-12)) \
            < 1e-4, (i, sched)
    for s in range(STEPS):
        assert abs(port[f"{key}/loss{s}"] - float(ref[f"train/loss{s}"])) \
            < 1e-5
        for i in range(n_leaves):
            assert float(np.max(np.abs(port[f"{key}/step{s}/param{i}"]
                                       - ref[f"train/step{s}/param{i}"]))) \
                < 1e-5, (s, i)
    want = cnn_train_comm_elems((BATCH, IN_CHANNELS, HW, HW), CHANNELS,
                                N_CLASSES, grid, schedule=sched)
    assert [w[key] for w in runs["wire"]] == \
        [(want["fwd_total"], want["bwd_total"])] * 8


# ====================================================== in-process checks ==

# the layers of repro.core.problem.resnet50_layers()
RESNET50_LAYERS = ["conv1", "res2a_2b", "res3a_2b", "res4a_2b", "res5a_2b",
                   "res2_1x1", "res5_1x1"]
ACCOUNT_CONV_GRIDS = [(2, 1, 1, 2, 2), (1, 2, 2, 2, 1), (2, 2, 1, 1, 2),
                      (8, 1, 1, 1, 1), (1, 1, 1, 1, 1), (4, 1, 1, 2, 1),
                      (1, 4, 2, 1, 1), (1, 1, 1, 8, 1)]
ACCOUNT_MM_GRIDS = [(2, 2, 2), (1, 1, 1), (4, 2, 1), (8, 1, 1), (1, 2, 4),
                    (2, 1, 4)]


def _layer_shapes(name):
    from repro.core.problem import resnet50_layers
    p = resnet50_layers()[name]
    return ((p.Nb, p.Nc, p.Nh * p.sh, p.Nw * p.sw),
            (p.Nk, p.Nc, p.Nr, p.Ns), (p.sh, p.sw))


@pytest.mark.parametrize("name", RESNET50_LAYERS)
def test_train_accounting_equals_jax(name):
    from repro.dist import conv2d as jconv
    from repro.dist import matmul as jmm
    x_shape, w_shape, stride = _layer_shapes(name)
    checked = 0
    for grid in ACCOUNT_CONV_GRIDS:
        for padding in ("SAME", "VALID"):
            if not jconv.conv_grid_divides(x_shape, w_shape, grid,
                                           stride=stride, padding=padding):
                continue
            checked += 1
            for sched in SCHEDULES:
                for sg in (False, True):
                    kw = dict(stride=stride, padding=padding,
                              schedule=sched, save_gathered=sg)
                    assert tconv.conv_train_comm_elems(
                        x_shape, w_shape, grid, **kw) == \
                        jconv.conv_train_comm_elems(x_shape, w_shape, grid,
                                                    **kw)
                    assert tconv.conv_train_mem_elems(
                        x_shape, w_shape, grid, **kw) == \
                        jconv.conv_train_mem_elems(x_shape, w_shape, grid,
                                                   **kw)
    assert checked > 0
    (nb, c, h, w), (k, _, _, _), _ = x_shape, w_shape, stride
    m = nb * (h // stride[0]) * (w // stride[1])
    for grid in ACCOUNT_MM_GRIDS:
        for sg in (False, True):
            assert tmm.matmul_train_comm_elems(m, c, k, grid,
                                               save_gathered=sg) == \
                jmm.matmul_train_comm_elems(m, c, k, grid, save_gathered=sg)
            for sched in SCHEDULES:
                assert tmm.matmul_train_mem_elems(
                    m, c, k, grid, schedule=sched, save_gathered=sg) == \
                    jmm.matmul_train_mem_elems(m, c, k, grid, schedule=sched,
                                               save_gathered=sg)


def _outcome(fn, *args, **kw):
    """``fn``'s result, or its error's type and message: a grid that does
    not divide a layer must be refused by both packages alike."""
    try:
        return fn(*args, **kw)
    except ValueError as err:
        return ("ValueError", str(err))


@pytest.mark.parametrize("grid", ACCOUNT_CONV_GRIDS)
def test_cnn_train_accounting_equals_jax(grid):
    from repro.dist import train as jtrain
    for x_shape, channels, n_classes in [
            ((64, 3, 56, 56), [64, 64, 128, 128, 256, 256, 512, 512], 1000),
            ((BATCH, IN_CHANNELS, HW, HW), CHANNELS, N_CLASSES)]:
        for sched in SCHEDULES:
            for name in ("cnn_train_comm_elems", "cnn_train_mem_elems"):
                assert _outcome(getattr(ttrain, name), x_shape, channels,
                                n_classes, grid, schedule=sched) == \
                    _outcome(getattr(jtrain, name), x_shape, channels,
                             n_classes, grid, schedule=sched)
        assert ttrain.grid_divides_cnn(x_shape, channels, grid) == \
            jtrain.grid_divides_cnn(x_shape, channels, grid)


def _tree_np(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"convs": [{"w": rng.standard_normal((4, 3, 3, 3)).astype(
                          np.float32) * scale,
                       "b": rng.standard_normal(4).astype(np.float32)
                       * scale}],
            "head": rng.standard_normal((4, 5)).astype(np.float32) * scale}


def _map(fn, tree):
    return {"convs": [{k: fn(v) for k, v in b.items()}
                      for b in tree["convs"]], "head": fn(tree["head"])}


@pytest.mark.parametrize("grad_scale", [0.01, 10.0])  # clip off / on
def test_adamw_matches_jax(grad_scale):
    import jax.numpy as jnp

    from repro.train import optim as joptim
    params = _tree_np(20)
    kw = dict(lr=joptim.cosine_schedule(1e-2, 2, 6), weight_decay=0.1)
    jopt, topt = joptim.AdamW(**kw), toptim.AdamW(
        lr=toptim.cosine_schedule(1e-2, 2, 6), weight_decay=0.1)
    jp, tp = _map(jnp.asarray, params), _map(torch.from_numpy, params)
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(4):
        grads = _tree_np(21 + step, grad_scale)
        jg, tg = _map(jnp.asarray, grads), _map(torch.from_numpy, grads)
        np.testing.assert_allclose(float(toptim.global_norm(tg)),
                                   float(joptim.global_norm(jg)), rtol=1e-6)
        jp, js = jopt.update(jg, js, jp)
        tp, ts = topt.update(tg, ts, tp)
        assert ts.step == int(js.step)
        for got, want in zip(_map(lambda t: t.numpy(), tp)["convs"]
                             + [{"h": tp["head"].numpy()}],
                             jp["convs"] + [{"h": jp["head"]}]):
            for k in got:
                np.testing.assert_allclose(got[k], np.asarray(want[k]),
                                           rtol=1e-6, atol=1e-6)
    for s in range(8):
        np.testing.assert_allclose(
            toptim.cosine_schedule(1e-2, 2, 6)(s),
            float(joptim.cosine_schedule(1e-2, 2, 6)(jnp.int32(s))),
            rtol=1e-6)


def test_microbatched_dense_step_matches_jax():
    import jax.numpy as jnp

    from repro.models import cnn as jcnn
    from repro.train import optim as joptim
    from repro.train import step as jstep
    from repro_torch.models import cnn as tcnn
    from repro_torch.train import step as tstep
    inp = _inputs()
    jparams = {"convs": [{"w": jnp.asarray(inp[f"w{i}"]),
                          "b": jnp.asarray(inp[f"b{i}"])}
                         for i in range(len(CHANNELS))],
               "head": jnp.asarray(inp["head"])}
    jbatch = {"images": jnp.asarray(inp["images"]),
              "labels": jnp.asarray(inp["labels"])}
    tbatch = {"images": torch.from_numpy(inp["images"]),
              "labels": torch.from_numpy(inp["labels"])}
    jopt, topt = joptim.AdamW(lr=LR), toptim.AdamW(lr=LR)
    jstate = jstep.init_train_state(jparams, jopt)
    tstate = tstep.init_train_state(_params(inp), topt)
    jfn = jstep.make_train_step(lambda p, b: jcnn.loss_cnn(p, b), jopt,
                                n_microbatches=2)
    tfn = tstep.make_train_step(lambda p, b: tcnn.loss_cnn(p, b), topt,
                                n_microbatches=2)
    from repro_torch.kernels.autotune import autotune_disabled
    with autotune_disabled():
        for _ in range(2):
            jstate, jm = jfn(jstate, jbatch)
            tstate, tm = tfn(tstate, tbatch)
            assert abs(float(tm["loss"]) - float(jm["loss"])) < 1e-5
            np.testing.assert_allclose(float(tm["grad_norm"]),
                                       float(jm["grad_norm"]), rtol=1e-4)
    for got, want in zip(_leaves(tstate.params),
                         [l for b in jstate.params["convs"]
                          for l in (b["b"], b["w"])]
                         + [jstate.params["head"]]):
        assert float(np.max(np.abs(got.numpy() - np.asarray(want)))) < 1e-5


def _one_rank_save_gathered(rank):
    """Every entry point that takes ``save_gathered``, both ways, on a
    one-rank grid: the conv and matmul gradients, and one train step."""
    from repro_torch.kernels.autotune import autotune_disabled
    from repro_torch.models import cnn as tcnn

    inp = _inputs()
    mesh = tconv.make_conv_mesh((1, 1, 1, 1, 1), device="cpu")
    mm_mesh = tmm.make_matmul_mesh((1, 1, 1), device="cpu")
    batch = {"images": torch.from_numpy(inp["images"]),
             "labels": torch.from_numpy(inp["labels"])}
    out = {}
    with autotune_disabled():
        for sg in (False, True):
            for name, op, m, x, w in [
                    ("conv", tconv.conv2d_distributed, mesh, "x", "w"),
                    ("matmul", tmm.matmul_distributed, mm_mesh, "xm", "wm")]:
                xl = torch.from_numpy(inp[x]).requires_grad_(True)
                wl = torch.from_numpy(inp[w]).requires_grad_(True)
                y = op(xl, wl, m, save_gathered=sg)
                out[(name, sg)] = torch.autograd.grad(y.square().sum(),
                                                      (xl, wl))
            logits = tcnn.forward_cnn(_params(inp), batch["images"],
                                      dist_mesh=mesh, dist_save_gathered=sg)
            step = ttrain.make_grid_train_step(toptim.AdamW(lr=LR), mesh,
                                               save_gathered=sg)
            state, metrics = step(ttrain.init_grid_train_state(
                _params(inp), toptim.AdamW(lr=LR)), batch)
            out[("cnn", sg)] = (logits, metrics["loss"],
                                *_leaves(state.params))
    return out


def test_save_gathered_waits_for_a_later_slice():
    """The slice has landed: every entry point that takes
    ``save_gathered`` accepts it -- ``conv2d_distributed``,
    ``matmul_distributed``, ``forward_cnn`` and ``make_grid_train_step``
    -- and agrees with the custom VJP on a one-rank grid (the 8-rank
    cases against the JAX package are ``tests/test_torch_save_gathered.py``)."""
    from repro_torch.dist.spawn import run_spmd

    out = run_spmd(_one_rank_save_gathered, 1, device="cpu")[0]
    for name in ("conv", "matmul", "cnn"):
        for got, want in zip(out[(name, True)], out[(name, False)]):
            np.testing.assert_allclose(got.detach().numpy(),
                                       want.detach().numpy(), rtol=1e-5,
                                       atol=1e-6)
