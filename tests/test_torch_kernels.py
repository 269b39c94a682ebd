"""The port's kernels and local dispatch against the JAX package.

The port runs on the CPU, so its kernel wrappers take their plain
PyTorch versions; the JAX side runs the Pallas kernels in interpret mode
(as ``tests/test_kernels.py`` does) and its dispatchers with the
autotuner off (the static paper plan the port carries).  Inputs come from
numpy with a fixed seed.  Tolerance: f32 ``atol=1e-4`` on unit-normal
data, as ``tests/test_dist.py`` uses.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import autotune  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.conv2d import conv2d_pallas  # noqa: E402
from repro.kernels.matmul import matmul_pallas  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
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


@pytest.mark.parametrize("call", [
    lambda a: matmul(a, torch.ones(4, 3)),
    lambda a: conv2d(a.reshape(1, 4, 2, 2), torch.ones(3, 4, 1, 1)),
    lambda a: ops.local_matmul(a, torch.ones(4, 3)),
    lambda a: ops.conv2d_same(a.reshape(1, 4, 2, 2), torch.ones(3, 4, 1, 1)),
])
def test_requires_grad_is_refused(call):
    with pytest.raises(NotImplementedError, match="training is a later"):
        call(torch.ones(4, 4, requires_grad=True))


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
