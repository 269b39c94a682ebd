"""The port's CUDA kernels against their plain PyTorch versions, on a
card.  Every test here is marked ``gpu`` and skips without a CUDA device
(the CPU has no ``nvcc`` and no card).  The module imports neither
``jax`` nor ``repro``, so it runs where only the port is installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu \
        tests/test_torch_kernels_gpu.py

(``--noconftest``: ``tests/conftest.py`` imports jax.)  Tolerance: f32
``rtol=1e-4`` and ``atol=1e-4`` (times max|plain| for the conv and the
batched tile GEMM) on unit-normal data; the kernel and the plain version
sum in different orders, neither uses TF32.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.kernels.conv2d import conv2d, conv2d_plain  # noqa: E402
from repro_torch.kernels._plan import gemm_plan  # noqa: E402
from repro_torch.kernels.matmul import matmul, matmul_plain  # noqa: E402
from repro_torch.kernels.winograd import wino_gemm, wino_gemm_plain  # noqa: E402

pytestmark = pytest.mark.gpu


def _normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape,
                                                       dtype=np.float32)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return resolve_device()


# (64, 1001, 1000): rows of A not 16-byte aligned; (33, 1000, 1001): nor
# those of B, which then takes 4-byte copies instead of 16-byte ones
@pytest.mark.parametrize("m,k,n", [(64, 512, 1000), (65, 520, 1000),
                                   (1, 3, 7), (128, 384, 256),
                                   (64, 1001, 1000), (33, 1000, 1001)])
def test_matmul_kernel_matches_plain(cuda_device, m, k, n):
    x = torch.from_numpy(_normal(7, m, k)).to(cuda_device)
    w = torch.from_numpy(_normal(8, k, n)).to(cuda_device)
    before = matmul.launches
    got = matmul(x, w)
    torch.cuda.synchronize()
    assert matmul.launches == before + 1
    torch.testing.assert_close(got, matmul_plain(x, w), rtol=1e-4,
                               atol=1e-4)


# two im2col dKer products, whose long reduction over few output tiles is
# split over the card: sums of 12544-50176 unit-normal products, so the
# tolerance scales with max|plain| as for the conv
@pytest.mark.parametrize("m,k,n", [(576, 50176, 64), (27, 12544, 64)])
def test_matmul_kernel_split_reduction_matches_plain(cuda_device, m, k, n):
    x = torch.from_numpy(_normal(9, m, k)).to(cuda_device)
    w = torch.from_numpy(_normal(10, k, n)).to(cuda_device)
    got = matmul(x, w)
    want = matmul_plain(x, w)
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * scale)


# the LM serving products, M = 8 and 16 slots and the prefill bucket 64:
# llama3.2-1b's projections (C and N up to 8192) and its 128256-wide vocab
# head, granite-moe's wq/wo, wk/wv and expert gate/up (1024 x 1024, 1024 x
# 512) and its expert down-projection (512 x 1024); sums of 512-8192
# unit-normal products, so the tolerance scales with max|plain| as for
# the conv.  The operands are drawn on the card.
@pytest.mark.parametrize("m", [8, 16, 64])
@pytest.mark.parametrize("k,n", [(2048, 2048), (2048, 512), (2048, 8192),
                                 (8192, 2048), (2048, 128256), (1024, 1024),
                                 (1024, 512), (512, 1024)])
def test_matmul_kernel_at_decode_shapes(cuda_device, m, k, n):
    gen = torch.Generator(device=cuda_device).manual_seed(m * k + n)
    x = torch.randn(m, k, generator=gen, device=cuda_device)
    w = torch.randn(k, n, generator=gen, device=cuda_device)
    before = matmul.launches
    got = matmul(x, w)
    torch.cuda.synchronize()
    assert matmul.launches == before + 1
    want = matmul_plain(x, w)
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * scale)


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


# the training backward's shapes (N = 2, 3x3): dIn is a VALID conv of the
# cotangent padded by 2 against the flipped kernel, dKer the N/C-transposed
# VALID conv whose "kernel" is the cotangent -- as wide as the output
# plane (56 on the CNN's path) over a 3x3 output; the first layer's dKer
# (x' = [3, 2, 58, 58], kernel [64, 2, 56, 56]) and ragged K (24)
# included
@pytest.mark.parametrize("c,k,h", [(64, 64, 56), (16, 24, 20), (64, 32, 7),
                                   (8, 8, 15), (3, 64, 56), (64, 24, 28)])
def test_conv2d_kernel_at_backward_shapes(cuda_device, c, k, h):
    x = torch.from_numpy(_normal(11, 2, c, h + 2, h + 2)).to(cuda_device)
    g = torch.from_numpy(_normal(12, 2, k, h, h)).to(cuda_device)
    w = torch.from_numpy(_normal(13, k, c, 3, 3)).to(cuda_device)
    gp = torch.nn.functional.pad(g, (2, 2, 2, 2))
    cases = [(gp, w.flip(2, 3).transpose(0, 1).contiguous()),
             (x.transpose(0, 1).contiguous(), g.transpose(0, 1).contiguous())]
    for a, b in cases:
        before = conv2d.launches
        got = conv2d(a, b, padding="VALID")
        torch.cuda.synchronize()
        assert conv2d.launches == before + 1
        want = conv2d_plain(a, b, padding="VALID")
        scale = float(want.abs().max())
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * scale)


# (t, p, c, k): CNN forward shapes at batch 2, ragged edges, and the
# backward's dU product with a long reduction (split over the card)
@pytest.mark.parametrize("t,p,c,k", [(16, 1568, 64, 64), (16, 32, 512, 512),
                                     (16, 100, 72, 40), (16, 64, 6272, 64),
                                     (16, 1568, 64, 128), (2, 7, 3, 5)])
def test_wino_gemm_kernel_matches_plain(cuda_device, t, p, c, k):
    v = torch.from_numpy(_normal(14, t, p, c)).to(cuda_device)
    u = torch.from_numpy(_normal(15, t, c, k)).to(cuda_device)
    before = wino_gemm.launches
    got = wino_gemm(v, u)
    torch.cuda.synchronize()
    assert wino_gemm.launches == before + 1
    want = wino_gemm_plain(v, u)
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * scale)


def test_gemm_splits_only_long_thin_reductions():
    assert gemm_plan(16, 64, 64, 50176).splits > 1
    assert gemm_plan(16, 50176, 64, 64).splits == 1
    assert gemm_plan(16, 64, 64, 64).splits == 1


# a split reduction sums its partial tiles in split order, with no
# atomics: two launches on the same operands agree to the bit
def test_split_launches_are_bit_equal(cuda_device):
    from repro_torch.kernels._plan import sm_count

    sms = sm_count(torch.cuda.current_device())
    x = torch.from_numpy(_normal(20, 64, 16, 30, 30)).to(cuda_device)
    g = torch.from_numpy(_normal(21, 32, 16, 28, 28)).to(cuda_device)
    a = torch.from_numpy(_normal(22, 64, 1000)).to(cuda_device)
    b = torch.from_numpy(_normal(23, 1000, 512)).to(cuda_device)
    # the head's forward: few enough splits to be summed in a cluster
    a2 = torch.from_numpy(_normal(24, 64, 512)).to(cuda_device)
    b2 = torch.from_numpy(_normal(25, 512, 1000)).to(cuda_device)
    assert gemm_plan(1, 64 * 9, 32, 16 * 28 * 28, sms=sms).splits > 1
    assert gemm_plan(1, 64, 512, 1000, sms=sms).splits > 1
    assert gemm_plan(1, 64, 1000, 512, sms=sms).splits > 1
    for run in (lambda: conv2d(x, g, padding="VALID"),
                lambda: matmul(a, b), lambda: matmul(a2, b2)):
        first, second = run(), run()
        torch.cuda.synchronize()
        assert torch.equal(first, second)


def test_kernel_refuses_non_contiguous_and_wrong_dtype(cuda_device):
    x = torch.ones(8, 16, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        matmul(x.t(), x)
    with pytest.raises(TypeError, match="float32"):
        matmul(x.double(), x.double().t().contiguous())


def test_tuner_lets_a_refusing_kernel_fail_on_the_card(cuda_device,
                                                       tmp_path,
                                                       monkeypatch):
    """A hand-written candidate refusing card operands (here a float64
    matmul) raises out of the tuner instead of losing the race to
    ``torch.matmul``."""
    from repro_torch.kernels import autotune

    monkeypatch.setenv(autotune.CACHE_ENV, str(tmp_path / "plans.json"))
    autotune.plan_cache().reset()
    x = torch.ones(8, 16, dtype=torch.float64, device=cuda_device)
    try:
        with pytest.raises(TypeError, match="float32"):
            autotune.best_of("unit:gpu", [("pallas", matmul),
                                          ("xla", torch.matmul)],
                             lambda: (x, x.t().contiguous()))
    finally:
        autotune.plan_cache().reset()


@pytest.mark.parametrize("impl", ["direct", "winograd", "im2col"])
def test_ops_candidates_differentiate_on_the_card(cuda_device, impl):
    """Each candidate's forward and gradients on the card (the kernels,
    with their backward re-dispatched through the static plan) against
    the same candidate on the CPU (the plain versions)."""
    from repro_torch.kernels import autotune, ops
    from repro_torch.kernels.conv2d import conv2d as conv_kernel

    x = torch.from_numpy(_normal(16, 2, 16, 12, 12))
    w = torch.from_numpy(_normal(17, 24, 16, 3, 3))
    results = []
    with autotune.autotune_disabled():
        for dev in ("cpu", cuda_device):
            a = x.to(dev).requires_grad_(True)
            b = w.to(dev).requires_grad_(True)
            before = (conv_kernel.launches, matmul.launches,
                      wino_gemm.launches)
            out = ops._run_conv_impl(impl, a, b, (1, 1), "SAME")
            ga, gb = torch.autograd.grad((out ** 2).sum(), (a, b))
            after = (conv_kernel.launches, matmul.launches,
                     wino_gemm.launches)
            results.append([t.detach().cpu() for t in (out, ga, gb)])
    want_kernel = {"direct": 0, "im2col": 1, "winograd": 2}[impl]
    assert after[want_kernel] > before[want_kernel]
    for got, want in zip(results[1], results[0]):
        scale = float(want.abs().max())
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * scale)
