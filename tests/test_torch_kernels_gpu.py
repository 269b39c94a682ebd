"""The port's CUDA kernels against their plain PyTorch versions, on a
card.  Every test here is marked ``gpu`` and skips without a CUDA device
(the CPU has no ``nvcc`` and no card).  The module imports neither
``jax`` nor ``repro``, so it runs where only the port is installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu \
        tests/test_torch_kernels_gpu.py

(``--noconftest``: ``tests/conftest.py`` imports jax.)  Tolerance: f32
``rtol=1e-4`` and ``atol=1e-4`` (times max|plain| for the conv) on
unit-normal data; the kernel and the plain version sum in different
orders, neither uses TF32.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.kernels.conv2d import conv2d, conv2d_plain  # noqa: E402
from repro_torch.kernels.matmul import matmul, matmul_plain  # noqa: E402

pytestmark = pytest.mark.gpu


def _normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape,
                                                       dtype=np.float32)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return resolve_device()


@pytest.mark.parametrize("m,k,n", [(64, 512, 1000), (65, 520, 1000),
                                   (1, 3, 7), (128, 384, 256)])
def test_matmul_kernel_matches_plain(cuda_device, m, k, n):
    x = torch.from_numpy(_normal(7, m, k)).to(cuda_device)
    w = torch.from_numpy(_normal(8, k, n)).to(cuda_device)
    before = matmul.launches
    got = matmul(x, w)
    torch.cuda.synchronize()
    assert matmul.launches == before + 1
    torch.testing.assert_close(got, matmul_plain(x, w), rtol=1e-4,
                               atol=1e-4)


# (n, c, hw, k, ks): the CPU test sweep, C = 3, a ragged K, and a 56x56
# plane wider than one pixel tile
@pytest.mark.parametrize("padding", ["SAME", "VALID"])
@pytest.mark.parametrize("n,c,hw,k,ks", [
    (2, 8, 8, 8, 3), (4, 16, 14, 32, 3), (2, 32, 7, 16, 5), (1, 8, 10, 8, 1),
    (2, 64, 8, 16, 3), (2, 3, 20, 64, 3), (2, 16, 9, 20, 3),
    (2, 64, 58, 64, 3)])
def test_conv2d_kernel_matches_plain(cuda_device, n, c, hw, k, ks, padding):
    x = torch.from_numpy(_normal(9, n, c, hw, hw)).to(cuda_device)
    w = torch.from_numpy(_normal(10, k, c, ks, ks)).to(cuda_device)
    before = conv2d.launches
    got = conv2d(x, w, padding=padding)
    torch.cuda.synchronize()
    assert conv2d.launches == before + 1
    want = conv2d_plain(x, w, padding=padding)
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * scale)


def test_kernel_refuses_non_contiguous_and_wrong_dtype(cuda_device):
    x = torch.ones(8, 16, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        matmul(x.t(), x)
    with pytest.raises(TypeError, match="float32"):
        matmul(x.double(), x.double().t().contiguous())
