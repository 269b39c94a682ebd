"""The port's kernels and local dispatch against the JAX package.

The port runs on the CPU, so its kernel wrappers take their plain
PyTorch versions; the JAX side runs the Pallas kernels in interpret mode
(as ``tests/test_kernels.py`` does) and its dispatchers with the
autotuner off (the static paper plan, the port's with its tuner off
too).  Inputs come from
numpy with a fixed seed.  Tolerance: f32 ``atol=1e-4`` on unit-normal
data, as ``tests/test_dist.py`` uses.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# torch on one thread in this process: the ops here are smoke-sized, and
# beside the other pytest-xdist workers more threads only spin
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels import autotune  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.conv2d import conv2d_pallas  # noqa: E402
from repro.kernels.matmul import matmul_pallas  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.kernels import autotune as tautotune  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.conv2d import conv2d  # noqa: E402
from repro_torch.kernels.matmul import matmul  # noqa: E402
from repro_torch.kernels.ref import ref_conv2d, ref_matmul  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)


def _normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape,
                                                       dtype=np.float32)


@pytest.mark.parametrize("m,n,k", [(128, 128, 128), (256, 512, 384),
                                   (512, 128, 1024), (128, 384, 256)])
def test_matmul_plain_matches_pallas(m, n, k):
    x, w = _normal(m + n + k, m, k), _normal(m * n + k, k, n)
    want = matmul_pallas(jnp.asarray(x), jnp.asarray(w),
                         block_m=jops.math_gcd_block(m, 128),
                         block_n=jops.math_gcd_block(n, 128),
                         block_k=jops.math_gcd_block(k, 256),
                         interpret=True)
    got = matmul(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(
        ref_matmul(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        np.asarray(want), **TOL)


# (n, c, hw, k, ks, block_c): the tests/test_kernels.py sweep plus a
# C-blocked case that accumulates over several contraction slabs
CONV_CASES = [(2, 8, 8, 8, 3, 8), (4, 16, 14, 32, 3, 8),
              (2, 32, 7, 16, 5, 8), (1, 8, 10, 8, 1, 8),
              (2, 64, 8, 16, 3, 16)]


@pytest.mark.parametrize("padding", ["SAME", "VALID"])
@pytest.mark.parametrize("n,c,hw,k,ks,bc", CONV_CASES)
def test_conv2d_plain_matches_pallas(n, c, hw, k, ks, bc, padding):
    x, w = _normal(n * c + k, n, c, hw, hw), _normal(k * ks, k, c, ks, ks)
    want = conv2d_pallas(jnp.asarray(x), jnp.asarray(w),
                         block_b=min(2, n), block_k=min(8, k), block_c=bc,
                         padding=padding, interpret=True)
    got = conv2d(torch.from_numpy(x), torch.from_numpy(w), padding=padding)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    oracle = ref_conv2d(torch.from_numpy(x), torch.from_numpy(w),
                        padding=padding)
    np.testing.assert_allclose(oracle.numpy(), np.asarray(want), **TOL)


# (x shape, w shape, stride, padding): direct-kernel shapes, then the
# shapes the static plan sends to the xla candidate (C = 3; strided)
LOCAL_CONV_CASES = [((2, 16, 10, 10), (8, 16, 3, 3), (1, 1), "VALID"),
                    ((2, 8, 9, 9), (16, 8, 3, 3), (1, 1), "SAME"),
                    ((2, 3, 12, 12), (8, 3, 3, 3), (1, 1), "SAME"),
                    ((2, 8, 17, 17), (8, 8, 3, 3), (2, 2), "VALID"),
                    ((2, 8, 16, 16), (8, 8, 3, 3), (2, 2), "SAME")]


@pytest.mark.parametrize("xs,ws,stride,padding", LOCAL_CONV_CASES)
def test_local_conv2d_matches_jax(xs, ws, stride, padding):
    x, w = _normal(1, *xs), _normal(2, *ws)
    with autotune.autotune_disabled():
        want_impl = jops.select_conv_impl(xs, ws, jnp.float32, stride,
                                          padding)
        want = jops.local_conv2d(jnp.asarray(x), jnp.asarray(w),
                                 stride=stride, padding=padding)
    with tautotune.autotune_disabled():  # the port's static plan
        assert ops.select_conv_impl(xs, ws, stride, padding) == want_impl
        got = ops.local_conv2d(torch.from_numpy(x), torch.from_numpy(w),
                               stride=stride, padding=padding)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("m,k,n", [(16, 32, 24), (12, 20, 7)])
def test_local_matmul_matches_jax(m, k, n):
    x, w = _normal(3, m, k), _normal(4, k, n)
    with autotune.autotune_disabled():
        want_impl = jops.select_matmul_impl(m, n, k, jnp.float32)
        want = jops.local_matmul(jnp.asarray(x), jnp.asarray(w))
    with tautotune.autotune_disabled():  # the port's static plan
        assert ops.select_matmul_impl(m, n, k) == want_impl
        got = ops.local_matmul(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_conv2d_same_paths_match_jax():
    x, w = _normal(5, 2, 3, 8, 8), _normal(6, 8, 3, 3, 3)
    want = jops.conv2d_same(jnp.asarray(x), jnp.asarray(w),
                            use_pallas=False)
    for use_pallas in (True, False):
        got = ops.conv2d_same(torch.from_numpy(x), torch.from_numpy(w),
                              use_pallas=use_pallas)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# the raw kernel wrappers have no backward (the JAX package has no VJP
# on a raw pallas_call either) and refuse a tensor that requires grad;
# the ops dispatchers differentiate, and their gradients match jax.grad
# (f32 tolerance rtol=1e-3, atol=2e-3, as tests/test_autotune.py)
REQUIRES_GRAD_CASES = [
    ("refuse", lambda a: matmul(a, torch.ones(4, 3))),
    ("refuse", lambda a: conv2d(a.reshape(1, 4, 2, 2),
                                torch.ones(3, 4, 1, 1))),
    ("grad", (lambda a, b: ops.local_matmul(a, b),
              lambda a, b: jops.local_matmul(a, b), (16, 24), (24, 8))),
    ("grad", (lambda a, b: ops.conv2d_same(a, b),
              lambda a, b: jops.conv2d_same(a, b), (2, 8, 8, 8),
              (8, 8, 3, 3))),
]


@pytest.mark.parametrize("kind,call", REQUIRES_GRAD_CASES,
                         ids=[f"call{i}" for i in range(4)])
def test_requires_grad_is_refused(kind, call):
    if kind == "refuse":
        with pytest.raises(NotImplementedError, match="not differentiable"):
            call(torch.ones(4, 4, requires_grad=True))
        return
    import jax

    port_fn, jax_fn, xs, ws = call
    x, w = _normal(18, *xs), _normal(19, *ws)
    with autotune.autotune_disabled(), tautotune.autotune_disabled():
        want = jax.grad(lambda a, b: jnp.sum(jax_fn(a, b) ** 2), (0, 1))(
            jnp.asarray(x), jnp.asarray(w))
        a = torch.from_numpy(x).requires_grad_(True)
        b = torch.from_numpy(w).requires_grad_(True)
        got = torch.autograd.grad((port_fn(a, b) ** 2).sum(), (a, b))
    for g, r in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-3,
                                   atol=2e-3)


def test_cuda_tensor_without_card_raises_not_falls_back():
    """A CUDA tensor goes to the kernel or raises; with no card the build
    refuses, and no plain result comes back."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the kernel would run")
    from torch._subclasses.fake_tensor import FakeTensorMode
    before = (matmul.launches, conv2d.launches)
    with FakeTensorMode():
        x = torch.empty(8, 8, device="cuda")
        with pytest.raises(RuntimeError, match="CUDA"):
            matmul(x, x)
        xc = torch.empty(1, 8, 4, 4, device="cuda")
        with pytest.raises(RuntimeError, match="CUDA"):
            conv2d(xc, torch.empty(8, 8, 3, 3, device="cuda"))
    assert (matmul.launches, conv2d.launches) == before
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(ValueError, match="cuda or cpu"):
        matmul(torch.empty(2, 2, device="meta"),
               torch.empty(2, 2, device="meta"))


def test_library_path_hashes_the_shared_headers(tmp_path, monkeypatch):
    """An edit to a ``csrc/*.cuh`` header names a new library, so a build
    made before the edit is not loaded after it."""
    from repro_torch.kernels import _build

    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "op.cu").write_text('#include "core.cuh"\n')
    header = tmp_path / "core.cuh"
    header.write_text("// the tile core\n")
    before = _build.library_path()
    assert _build.library_path() == before
    header.write_text("// the tile core, edited\n")
    assert _build.library_path() != before


# ---------------------------------------------------------------------------
# The launch plan of the tile GEMM core, at every shape chip_smoke.py's
# kernel phase gives the two wrappers (batch 64, the CNN's 8 layers)
# ---------------------------------------------------------------------------

SMS = 132  # the H100's SMs
LAYERS = [(3, 64, 56), (64, 64, 56), (64, 128, 28), (128, 128, 28),
          (128, 256, 14), (256, 256, 14), (256, 512, 7), (512, 512, 7)]


def _smoke_plan_cases():
    """(id, kind, (t, m, n, r)) of every kernel call in chip_smoke.py's
    kernel phase, plus ragged and unaligned cases."""
    b, cases = 64, []
    for c, k, h in LAYERS:
        cases.append((f"conv SAME {c}->{k} H={h}", "conv",
                      (1, b * h * h, k, 9 * c)))
        if c % 8 == 0:
            cases.append((f"conv fwd {c}->{k} H={h}", "conv",
                          (1, b * h * h, k, 9 * c)))
            cases.append((f"conv dIn {c}->{k} H={h}", "conv",
                          (1, b * (h + 2) ** 2, c, 9 * k)))
        cases.append((f"conv dKer {c}->{k} H={h}", "dker",
                       (1, 9 * c, k, b * h * h)))
        if c % 8 == 0:
            p, pin = b * (-(-h // 2)) ** 2, b * (-(-(h + 2) // 2)) ** 2
            cases += [(f"wino fwd {c}->{k} H={h}", "gemm", (16, p, k, c)),
                      (f"wino dIn fwd {c}->{k} H={h}", "gemm",
                       (16, pin, c, k)),
                      (f"wino dv {c}->{k} H={h}", "gemm", (16, p, c, k)),
                      (f"wino du {c}->{k} H={h}", "gemm", (16, c, k, p))]
    cases += [("head fwd", "head", (1, b, 1000, 512)),
              ("head dX", "head", (1, b, 512, 1000)),
              ("head dW", "gemm", (1, 512, 1000, b)),
              ("matmul ragged", "gemm", (1, 65, 1000, 520)),
              ("im2col dKer", "dker", (1, 576, 64, b * 56 * 56)),
              ("matmul unaligned", "gemm", (1, 64, 1000, 1001)),
              ("tiny", "gemm", (1, 1, 7, 3)),
              ("conv ragged K", "conv", (1, 2 * 18 * 18, 20, 16 * 9)),
              ("empty reduction", "gemm", (1, 20, 12, 0))]
    return cases


PLAN_CASES = _smoke_plan_cases()


@pytest.mark.parametrize("kind,shape", [c[1:] for c in PLAN_CASES],
                         ids=[c[0] for c in PLAN_CASES])
def test_gemm_plan_covers_the_reduction_and_fills_the_card(kind, shape):
    from repro_torch.kernels import _plan

    t, m, n, r = shape
    plan = _plan.gemm_plan(t, m, n, r, sms=SMS)
    assert plan.slab == _plan.TILES[plan.tile]
    tm, tn = plan.tile
    # the first tile that makes a wave over the card, else the smallest
    waves = [tile for tile in _plan.TILES
             if m >= tile[0] and n >= tile[1]
             and t * -(-m // tile[0]) * -(-n // tile[1]) >= SMS]
    assert plan.tile == (waves[0] if waves else (64, 64))
    # whole slabs, every chunk non-empty, the last one ending at r
    assert plan.chunk % plan.slab == 0 and plan.chunk > 0
    assert plan.splits * plan.chunk >= r
    assert plan.splits == 1 or (plan.splits - 1) * plan.chunk < r
    tiles = t * -(-m // tm) * -(-n // tn)
    assert plan.grid == (-(-m // tm), -(-n // tn), t * plan.splits)
    assert plan.grid[0] <= 2 ** 31 - 1
    assert plan.grid[1] <= _plan.GRID_YZ_MAX
    assert plan.grid[2] <= _plan.GRID_YZ_MAX
    # up to MAX_CLUSTER splits sum in a cluster, more through scratch
    assert plan.scratch == (t * m * n * plan.splits
                            if plan.splits > _plan.MAX_CLUSTER else 0)
    blocks = tiles * plan.splits
    if tiles >= _plan.BLOCKS_PER_SM * SMS:  # the card is full: no split
        assert plan.splits == 1
    if kind == "dker":
        assert blocks >= SMS
    if kind == "head":  # more blocks than the 16 and 8 tiles unsplit
        assert blocks > {1000: 16, 512: 8}[n]


# ---------------------------------------------------------------------------
# The launch plan of Winograd's tile GEMM (csrc/wino_gemm.cu) at every wino
# case above, plus ragged and empty-reduction cases, in both dtypes
# ---------------------------------------------------------------------------

WINO_PLAN_CASES = [c for c in PLAN_CASES if c[0].startswith("wino")] + [
    ("wino ragged", "gemm", (16, 130, 72, 136)),
    ("wino ragged unaligned", "gemm", (4, 129, 30, 66)),
    ("wino tiny", "gemm", (2, 7, 5, 3)),
    ("wino empty reduction", "gemm", (2, 20, 16, 0)),
    ("wino du dIn 64->64 H=56", "gemm", (16, 64, 64, 64 * 29 * 29))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [c[2] for c in WINO_PLAN_CASES],
                         ids=[c[0] for c in WINO_PLAN_CASES])
def test_wino_plan_covers_the_output_and_the_reduction(shape, dtype):
    from repro_torch.kernels import _plan

    dtype = getattr(torch, dtype)
    t, m, n, r = shape
    plan = _plan.wino_plan(t, m, n, r, dtype, sms=SMS)
    tm, tn = plan.tile
    assert plan.tile == _plan.WINO_TILE == (128, 64)
    assert plan.slab == 128 // dtype.itemsize
    # every output row and column in exactly one tile, every batch entry
    # times every split in one grid z
    for extent, step, count in ((m, tm, plan.grid[0]),
                                (n, tn, plan.grid[1])):
        owner = np.arange(extent) // step
        assert owner.max() == count - 1
        assert np.bincount(owner, minlength=count).min() >= 1
    assert plan.grid[2] == t * plan.splits <= _plan.GRID_YZ_MAX
    assert plan.grid[1] <= _plan.GRID_YZ_MAX
    # whole slabs, every chunk non-empty, the last one ending at r
    assert plan.chunk % plan.slab == 0 and plan.chunk > 0
    assert plan.splits * plan.chunk >= r
    assert plan.splits == 1 or (plan.splits - 1) * plan.chunk < r
    # a split reduction fills the card once, at most
    tiles = t * plan.grid[0] * plan.grid[1]
    assert plan.splits == 1 or tiles * plan.splits <= (
        _plan.WINO_BLOCKS_PER_SM * SMS)
    # up to MAX_CLUSTER splits sum in a cluster (no scratch), more
    # through scratch
    assert plan.scratch == (t * m * n * plan.splits
                            if plan.splits > _plan.MAX_CLUSTER else 0)
    # the ring ([128][BK + 16 bytes] and [BK][64 + 8] slabs, 3 stages) or
    # the [128][72] f32 output tile, whichever is larger: 227 KB a block,
    # and two blocks (1 KB reserved each) in an SM's 228 KB
    ring = 3 * (128 * 144 + 128 // dtype.itemsize * 72 * dtype.itemsize)
    assert plan.smem == max(ring, 128 * 72 * 4) == 82944
    assert plan.smem <= _plan.SMEM_PER_BLOCK
    assert 2 * (plan.smem + 1024) <= 228 * 1024
