"""The port's CNN and its analytic accounting against the JAX package.

Parameters and images come from numpy with a fixed seed and reach the
port only through ``params_from_jax``.  The dense forward is compared in
this process (JAX on one CPU device).  The dist-grid forward runs on two
grids: the JAX package once per grid in one 8-device subprocess
(autotuner off, XLA local contractions, its default schedule), the port
under all three schedules in one 8-rank gloo launch beside it; every
schedule computes the same function, and ``tests/test_torch_dist.py``
holds each of the port's op schedules against the same JAX schedule.
Logits must agree to f32 ``atol=1e-4`` on unit-scale data (as
``tests/test_dist.py``); the accounting functions must agree exactly.
"""

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
from repro_torch.models import cnn as tcnn  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402

pytestmark = pytest.mark.subprocess

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-4, atol=1e-4)
CHANNELS, IN_CHANNELS, HW, N_CLASSES, BATCH = [16, 16], 8, 8, 8, 4
DIST_GRIDS = [(2, 1, 1, 2, 2), (1, 2, 2, 2, 1)]
DIST_CASES = [(g, s) for g in DIST_GRIDS for s in ("allgather", "ring",
                                                   "ring2")]


def _params_np(seed=0):
    rng = np.random.default_rng(seed)
    convs, cin = [], IN_CHANNELS
    for cout in CHANNELS:
        convs.append({
            "w": (rng.standard_normal((cout, cin, 3, 3), dtype=np.float32)
                  * np.float32((cin * 9) ** -0.5)),
            "b": rng.standard_normal(cout, dtype=np.float32) * 0.1})
        cin = cout
    return {"convs": convs,
            "head": rng.standard_normal((cin, N_CLASSES), dtype=np.float32)
            * np.float32(cin ** -0.5)}


def _images(seed=1):
    return np.random.default_rng(seed).standard_normal(
        (BATCH, IN_CHANNELS, HW, HW), dtype=np.float32)


def _jax_params(p):
    import jax.numpy as jnp

    return {"convs": [{"w": jnp.asarray(b["w"]), "b": jnp.asarray(b["b"])}
                      for b in p["convs"]],
            "head": jnp.asarray(p["head"])}


def test_params_from_jax_round_trip():
    p = _params_np()
    tp = params_from_jax(p, device="cpu")
    for blk, tblk in zip(p["convs"], tp["convs"]):
        np.testing.assert_array_equal(tblk["w"].numpy(), blk["w"])
        np.testing.assert_array_equal(tblk["b"].numpy(), blk["b"])
    np.testing.assert_array_equal(tp["head"].numpy(), p["head"])
    # the JAX package's own init, through numpy, converts unchanged
    import jax

    from repro.models import cnn as jcnn
    jp = jcnn.init_cnn(jax.random.PRNGKey(0), channels=CHANNELS,
                       n_classes=N_CLASSES, in_channels=IN_CHANNELS)
    jp_np = {"convs": [{k: np.asarray(v) for k, v in b.items()}
                       for b in jp["convs"]], "head": np.asarray(jp["head"])}
    tp2 = params_from_jax(jp_np, device="cpu")
    np.testing.assert_array_equal(tp2["convs"][1]["w"].numpy(),
                                  jp_np["convs"][1]["w"])
    bad = dict(p, head=p["head"][:3])
    with pytest.raises(ValueError, match="head"):
        params_from_jax(bad, device="cpu")


def test_init_cnn_is_seeded_and_cuda_by_default():
    kw = dict(channels=CHANNELS, n_classes=N_CLASSES,
              in_channels=IN_CHANNELS, device="cpu")
    a = tcnn.init_cnn(torch.Generator().manual_seed(3), **kw)
    b = tcnn.init_cnn(torch.Generator().manual_seed(3), **kw)
    assert a["convs"][0]["w"].shape == (16, IN_CHANNELS, 3, 3)
    assert a["head"].shape == (16, N_CLASSES)
    torch.testing.assert_close(a["head"], b["head"], rtol=0, atol=0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tcnn.init_cnn(torch.Generator().manual_seed(3),
                          channels=CHANNELS, n_classes=N_CLASSES)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_forward_cnn_dense_matches_jax(use_pallas):
    import jax.numpy as jnp

    from repro.models import cnn as jcnn
    p, x = _params_np(), _images()
    want = jcnn.forward_cnn(_jax_params(p), jnp.asarray(x))
    tp = params_from_jax(p, device="cpu")
    got = tcnn.forward_cnn(tp, torch.from_numpy(x), use_pallas=use_pallas)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    model = tcnn.CNN(tp, use_pallas=use_pallas)
    # the module's parameters are trainable: its output carries a graph
    np.testing.assert_allclose(model(torch.from_numpy(x)).detach().numpy(),
                               got.numpy(), rtol=0, atol=0)
    labels = np.arange(BATCH) % N_CLASSES
    want_loss = jcnn.loss_cnn(_jax_params(p), {
        "images": jnp.asarray(x), "labels": jnp.asarray(labels)})
    got_loss = tcnn.loss_cnn(tp, {"images": torch.from_numpy(x),
                                  "labels": torch.from_numpy(labels)},
                             use_pallas=use_pallas)
    np.testing.assert_allclose(float(got_loss), float(want_loss), **TOL)


_JAX_REFERENCE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax.numpy as jnp, numpy as np
    from repro.dist.conv2d import make_conv_mesh
    from repro.models.cnn import forward_cnn
    inp = dict(np.load(sys.argv[1]))
    n = int(inp["n_convs"])
    params = {"convs": [{"w": jnp.asarray(inp[f"w{i}"]),
                         "b": jnp.asarray(inp[f"b{i}"])} for i in range(n)],
              "head": jnp.asarray(inp["head"])}
    out = {}
    for grid in sys.argv[3:]:
        mesh = make_conv_mesh(tuple(int(g) for g in grid.split("x")))
        out[grid] = np.asarray(forward_cnn(params, jnp.asarray(inp["x"]),
                                           dist_mesh=mesh))
    np.savez(sys.argv[2], **out)
""")


def _grid_key(grid):
    return "x".join(map(str, grid))


def _port_rank(rank, inputs_path):
    """The dist forward for every case; every rank's logits."""
    from repro_torch.kernels.autotune import autotune_disabled

    with autotune_disabled():  # the static plan: ranks agree
        return _port_rank_body(rank, inputs_path)


def _port_rank_body(rank, inputs_path):
    from repro_torch.dist.collectives import record_collectives

    inp = dict(np.load(inputs_path))
    n = int(inp["n_convs"])
    params = params_from_jax(
        {"convs": [{"w": inp[f"w{i}"], "b": inp[f"b{i}"]}
                   for i in range(n)], "head": inp["head"]}, device="cpu")
    x = torch.from_numpy(inp["x"])
    meshes, out = {}, {}
    for grid, sched in DIST_CASES:
        if grid not in meshes:
            meshes[grid] = tconv.make_conv_mesh(grid, device="cpu")
        with record_collectives() as notes:
            logits = tcnn.forward_cnn(params, x, dist_mesh=meshes[grid],
                                      dist_schedule=sched)
        out[(grid, sched)] = (logits.numpy(),
                              sorted({n.tag for n in notes}))
    return out


@pytest.fixture(scope="module")
def dist_runs(tmp_path_factory):
    from repro_torch.dist.spawn import run_spmd

    tmp = tmp_path_factory.mktemp("torch_cnn")
    p = _params_np()
    arrays = {"x": _images(), "head": p["head"],
              "n_convs": np.array(len(p["convs"]))}
    for i, blk in enumerate(p["convs"]):
        arrays[f"w{i}"], arrays[f"b{i}"] = blk["w"], blk["b"]
    inputs, jax_out = str(tmp / "inputs.npz"), str(tmp / "jax.npz")
    np.savez(inputs, **arrays)
    env = dict(os.environ, REPRO_AUTOTUNE="0", REPRO_DIST_PALLAS="0",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(_ROOT, "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    ref = subprocess.Popen(
        [sys.executable, "-c", _JAX_REFERENCE, inputs, jax_out]
        + [_grid_key(g) for g in DIST_GRIDS],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        port = run_spmd(_port_rank, 8, inputs, device="cpu")
        _, err = ref.communicate(timeout=600)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0, err
    return dict(np.load(jax_out)), port


@pytest.mark.parametrize("grid,sched", DIST_CASES)
def test_forward_cnn_dist_matches_jax(dist_runs, grid, sched):
    want, port = dist_runs
    for rank_out in port:  # the logits reach every rank
        logits, tags = rank_out[(grid, sched)]
        np.testing.assert_allclose(logits, want[_grid_key(grid)], **TOL)
        assert "reshard" in tags


# the layers of repro.core.problem.resnet50_layers()
RESNET50_LAYERS = ["conv1", "res2a_2b", "res3a_2b", "res4a_2b", "res5a_2b",
                   "res2_1x1", "res5_1x1"]


def _layer_shapes(name):
    """(x shape, w shape, stride) of one of ``resnet50_layers()``."""
    from repro.core.problem import resnet50_layers
    p = resnet50_layers()[name]
    return ((p.Nb, p.Nc, p.Nh * p.sh, p.Nw * p.sw),
            (p.Nk, p.Nc, p.Nr, p.Ns), (p.sh, p.sw))


ACCOUNT_CONV_GRIDS = [(2, 1, 1, 2, 2), (1, 2, 2, 2, 1), (2, 2, 1, 1, 2),
                      (8, 1, 1, 1, 1), (1, 1, 1, 1, 1), (4, 1, 1, 2, 1),
                      (1, 4, 2, 1, 1), (1, 1, 1, 8, 1)]
ACCOUNT_MM_GRIDS = [(2, 2, 2), (1, 1, 1), (4, 2, 1), (8, 1, 1), (1, 2, 4),
                    (2, 1, 4)]


def _both(f_jax, f_port, *args, **kw):
    """Both results, or both ValueErrors (the shared divisibility rule)."""
    try:
        want = f_jax(*args, **kw)
    except ValueError:
        with pytest.raises(ValueError):
            f_port(*args, **kw)
        return None
    assert f_port(*args, **kw) == want
    return want


@pytest.mark.parametrize("name", RESNET50_LAYERS)
def test_conv_accounting_equals_jax(name):
    from repro.dist import conv2d as jconv
    x_shape, w_shape, stride = _layer_shapes(name)
    checked = 0
    for grid in ACCOUNT_CONV_GRIDS:
        for padding in ("SAME", "VALID"):
            kw = dict(stride=stride, padding=padding)
            if _both(jconv.conv_comm_elems, tconv.conv_comm_elems,
                     x_shape, w_shape, grid, **kw) is None:
                continue
            checked += 1
            assert tconv.conv_grid_divides(x_shape, w_shape, grid, **kw)
            for sched in ("allgather", "ring", "ring2"):
                _both(jconv.conv_mem_elems, tconv.conv_mem_elems, x_shape,
                      w_shape, grid, schedule=sched, **kw)
                assert tconv._conv_effective_schedule(sched, grid) == \
                    jconv._conv_effective_schedule(sched, grid)
    assert checked > 0


@pytest.mark.parametrize("name", RESNET50_LAYERS)
def test_matmul_accounting_equals_jax(name):
    from repro.dist import matmul as jmm
    (nb, c, h, w), (k, _, _, _), stride = _layer_shapes(name)
    m = nb * (h // stride[0]) * (w // stride[1])
    for grid in ACCOUNT_MM_GRIDS:
        assert tmm.matmul_grid_divides(m, c, k, grid) == \
            jmm.matmul_grid_divides(m, c, k, grid)
        assert tmm.matmul_comm_elems(m, c, k, grid) == \
            jmm.matmul_comm_elems(m, c, k, grid)
        for sched in ("allgather", "ring", "ring2"):
            assert tmm.matmul_mem_elems(m, c, k, grid, schedule=sched) == \
                jmm.matmul_mem_elems(m, c, k, grid, schedule=sched)
