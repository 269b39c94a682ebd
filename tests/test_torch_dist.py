"""The port's distributed conv, matmul and halo against the JAX package.

One 8-device JAX subprocess (autotuner off, XLA local contractions, the
CPU setting of the README) and one 8-rank gloo launch of the port compute
every case from the same numpy inputs, concurrently; each case is then a
test of its own.  Outputs must agree to f32 ``atol=1e-4`` on unit-normal
data (as ``tests/test_dist.py``), and on every rank the wire elements the
port records for one op must equal the analytic ``conv_comm_elems`` /
``matmul_comm_elems`` total of the JAX package.  dIn's local stride-1
routes are held against ``jax.vjp`` in process.
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

pytestmark = pytest.mark.subprocess

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCHEDULES = ("allgather", "ring", "ring2")
CONV_GRIDS = [(2, 1, 1, 2, 2), (1, 2, 2, 2, 1), (2, 2, 1, 1, 2),
              (8, 1, 1, 1, 1)]
# (name, grid, schedule, stride, padding, input key)
CONV_CASES = [(f"conv-{'x'.join(map(str, g))}-{s}", g, s, 1, "SAME", "x")
              for g in CONV_GRIDS for s in SCHEDULES]
CONV_CASES.append(("conv-strided-valid", (2, 1, 1, 2, 2), "allgather", 2,
                   "VALID", "x17"))
MATMUL_CASES = [(f"matmul-2x2x2-{s}", (2, 2, 2), s) for s in SCHEDULES]
# (name, grid, lo, hi): halo along h alone; (5, 3) needs multi-hop strips
HALO_CASES = [("halo-1-1", (1, 2, 2, 2, 1), 1, 1),
              ("halo-5-3", (1, 2, 2, 2, 1), 5, 3)]


def _inputs():
    rng = np.random.default_rng(0)
    return {"x": rng.standard_normal((8, 8, 16, 16), dtype=np.float32),
            "x17": rng.standard_normal((8, 8, 17, 17), dtype=np.float32),
            "w": rng.standard_normal((8, 8, 3, 3), dtype=np.float32),
            "xm": rng.standard_normal((16, 32), dtype=np.float32),
            "wm": rng.standard_normal((32, 24), dtype=np.float32),
            "xh": rng.standard_normal((2, 4, 8, 8), dtype=np.float32)}


_JAX_REFERENCE = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, numpy as np
    from jax.sharding import PartitionSpec as P
    from repro.dist._compat import shard_map
    from repro.dist.conv2d import conv2d_distributed, make_conv_mesh
    from repro.dist.halo import halo_exchange_1d
    from repro.dist.matmul import make_matmul_mesh, matmul_distributed
    inp = dict(np.load(sys.argv[1]))
    conv, mm, halo = json.loads(sys.argv[3])
    out = {}
    for name, grid, sched, stride, pad, key in conv:
        out[name] = conv2d_distributed(inp[key], inp["w"],
                                       make_conv_mesh(tuple(grid)),
                                       schedule=sched, stride=stride,
                                       padding=pad)
    for name, grid, sched in mm:
        out[name] = matmul_distributed(inp["xm"], inp["wm"],
                                       make_matmul_mesh(tuple(grid)),
                                       schedule=sched)
    for name, grid, lo, hi in halo:
        fn = shard_map(
            lambda x, lo=lo, hi=hi: halo_exchange_1d(
                x, "h", spatial_dim=2, lo=lo, hi=hi),
            mesh=make_conv_mesh(tuple(grid)),
            in_specs=P(None, None, "h", "w"),
            out_specs=P(None, None, "h", "w"), check_rep=False)
        out[name] = fn(inp["xh"])
    np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in out.items()})
""")


def _port_rank(rank, inputs_path):
    """Every case on this rank; returns the unsharded outputs (rank 0)
    and this rank's recorded wire per op."""
    from repro_torch.kernels.autotune import autotune_disabled

    with autotune_disabled():  # the static plan: ranks agree
        return _port_rank_body(rank, inputs_path)


def _port_rank_body(rank, inputs_path):
    from repro_torch.dist.collectives import (record_collectives, shard,
                                              unshard)
    from repro_torch.dist.conv2d import (IN_SPEC, KER_SPEC, OUT_SPEC,
                                         conv2d_distributed, make_conv_mesh)
    from repro_torch.dist.halo import halo_exchange_1d
    from repro_torch.dist.matmul import (OUT_SPEC as MM_OUT, W_SPEC, X_SPEC,
                                         make_matmul_mesh,
                                         matmul_distributed)

    inp = {k: torch.from_numpy(v) for k, v in np.load(inputs_path).items()}
    meshes = {}

    def mesh_for(grid, make):
        if grid not in meshes:
            meshes[grid] = make(grid, device="cpu")
        return meshes[grid]

    outs, wire = {}, {}
    for name, grid, sched, stride, pad, key in CONV_CASES:
        mesh = mesh_for(grid, make_conv_mesh)
        xl, wl = shard(inp[key], mesh, IN_SPEC), shard(inp["w"], mesh,
                                                       KER_SPEC)
        with record_collectives() as notes:
            y = conv2d_distributed(xl, wl, mesh, schedule=sched,
                                   stride=stride, padding=pad)
        wire[name] = sum(n.wire_elems for n in notes)
        outs[name] = unshard(y, mesh, OUT_SPEC).numpy()
    for name, grid, sched in MATMUL_CASES:
        mesh = mesh_for(grid, make_matmul_mesh)
        xl, wl = shard(inp["xm"], mesh, X_SPEC), shard(inp["wm"], mesh,
                                                       W_SPEC)
        with record_collectives() as notes:
            y = matmul_distributed(xl, wl, mesh, schedule=sched)
        wire[name] = sum(n.wire_elems for n in notes)
        outs[name] = unshard(y, mesh, MM_OUT).numpy()
    for name, grid, lo, hi in HALO_CASES:
        mesh = mesh_for(grid, make_conv_mesh)
        spec = (None, None, "h", "w")
        y = halo_exchange_1d(shard(inp["xh"], mesh, spec), mesh, "h",
                             spatial_dim=2, lo=lo, hi=hi)
        outs[name] = unshard(y, mesh, spec).numpy()
    return (outs if rank == 0 else None), wire


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from repro_torch.dist.spawn import run_spmd

    tmp = tmp_path_factory.mktemp("torch_dist")
    inputs = str(tmp / "inputs.npz")
    np.savez(inputs, **_inputs())
    jax_out = str(tmp / "jax.npz")
    env = dict(os.environ, REPRO_AUTOTUNE="0", REPRO_DIST_PALLAS="0",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(_ROOT, "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    cases = json.dumps([CONV_CASES, MATMUL_CASES, HALO_CASES])
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


@pytest.mark.parametrize("name,grid,sched,stride,pad,key", CONV_CASES)
def test_conv2d_distributed_matches_jax(runs, name, grid, sched, stride,
                                        pad, key):
    from repro.dist.conv2d import conv_comm_elems

    np.testing.assert_allclose(runs["port"][name], runs["jax"][name],
                               rtol=1e-4, atol=1e-4)
    x_shape = _inputs()[key].shape
    want = conv_comm_elems(x_shape, (8, 8, 3, 3), grid,
                           stride=(stride, stride), padding=pad)["total"]
    assert [w[name] for w in runs["wire"]] == [want] * 8


@pytest.mark.parametrize("name,grid,sched", MATMUL_CASES)
def test_matmul_distributed_matches_jax(runs, name, grid, sched):
    from repro.dist.matmul import matmul_comm_elems

    np.testing.assert_allclose(runs["port"][name], runs["jax"][name],
                               rtol=1e-4, atol=1e-4)
    want = matmul_comm_elems(16, 32, 24, grid)["total"]
    assert [w[name] for w in runs["wire"]] == [want] * 8


@pytest.mark.parametrize("name,grid,lo,hi", HALO_CASES)
def test_halo_exchange_matches_jax(runs, name, grid, lo, hi):
    assert runs["port"][name].shape == runs["jax"][name].shape
    np.testing.assert_array_equal(runs["port"][name], runs["jax"][name])


@pytest.mark.parametrize("c,route", [(3, "xla"), (8, "direct")])
def test_dx_local_matches_jax_vjp(c, route):
    """dIn of the local VALID conv on both of its stride-1 routes: the
    library's transposed conv, which pads inside its call (C = 3, where
    the static plan is the library's), and the direct kernel on the
    padded cotangent (C = 8)."""
    import jax
    import jax.numpy as jnp

    from repro_torch.dist.conv2d import _dx_local
    from repro_torch.kernels import ops
    from repro_torch.kernels.autotune import autotune_disabled

    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, c, 9, 10), dtype=np.float32)
    w = rng.standard_normal((8, c, 3, 3), dtype=np.float32)
    g = rng.standard_normal((2, 8, 7, 8), dtype=np.float32)
    _, vjp = jax.vjp(lambda a: jax.lax.conv_general_dilated(
        a, jnp.asarray(w), (1, 1), "VALID",
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
        precision=jax.lax.Precision.HIGHEST), jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    with autotune_disabled():
        assert ops.select_conv_impl((2, 8, 11, 12), (c, 8, 3, 3), (1, 1),
                                    "VALID") == route
        got = _dx_local(torch.from_numpy(g), torch.from_numpy(w),
                        stride=(1, 1))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
