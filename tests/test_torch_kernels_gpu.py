"""The port's CUDA kernels against their plain PyTorch versions, on a
card.  Every test here is marked ``gpu`` and skips without a CUDA device
(the CPU has no ``nvcc`` and no card).  The module imports neither
``jax`` nor ``repro``, so it runs where only the port is installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu \
        tests/test_torch_kernels_gpu.py

(``--noconftest``: ``tests/conftest.py`` imports jax.)  Tolerance: f32
``rtol=1e-4`` and ``atol=1e-4`` (times max|plain| for the conv and the
batched tile GEMM) on unit-normal data; the kernel and the plain version
sum in different orders, neither uses TF32.  bfloat16: max|kernel -
plain| within ``BF16_KERNEL_RTOL`` = 8e-3 of max|plain|, two bfloat16
ulps: both sum in float32 in their own orders and round once.
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
BF16_KERNEL_RTOL = 8e-3


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


# the CNN's seven Winograd layers (C, K, H; the C = 3 layer takes the
# library) in the four directions the kernel serves (csrc/wino_gemm.cu),
# (t, p, c, k) at batch b (a multiple of 8 keeps P and P' whole 16-byte
# vectors of bfloat16): fwd [16,P,C]@[16,C,K], dIn fwd
# [16,P',K]@[16,K,C], autograd's dv [16,P,K]@[16,K,C] and du
# [16,C,P]@[16,P,K], P = b ceil(H/2)^2, P' = b ceil((H+2)/2)^2
WINO_LAYERS = [(64, 64, 56), (64, 128, 28), (128, 128, 28), (128, 256, 14),
               (256, 256, 14), (256, 512, 7), (512, 512, 7)]


def _wino_cnn_shapes(b):
    shapes = []
    for c, k, h in WINO_LAYERS:
        p, pin = b * (-(-h // 2)) ** 2, b * (-(-(h + 2) // 2)) ** 2
        shapes += [(16, p, c, k), (16, pin, k, c), (16, p, k, c),
                   (16, c, p, k)]
    return shapes


# (t, p, c, k): CNN forward shapes at batch 2, ragged edges, and the
# backward's dU product with a long reduction (split over the card); the
# CNN's shapes at batch 8 in every direction; ragged P, C and K; float32
# rows that are not whole 16-byte vectors (C or K not a multiple of 4:
# 4-byte copies and element stores); an empty reduction
@pytest.mark.parametrize("t,p,c,k", [(16, 1568, 64, 64), (16, 32, 512, 512),
                                     (16, 100, 72, 40), (16, 64, 6272, 64),
                                     (16, 1568, 64, 128), (2, 7, 3, 5)]
                         + _wino_cnn_shapes(8)
                         + [(16, 130, 136, 72), (3, 257, 40, 200),
                            (16, 1030, 72, 136), (4, 129, 66, 30),
                            (16, 1030, 130, 254), (2, 20, 0, 16)])
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
    with pytest.raises(TypeError, match="float32 or bfloat16"):
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


# ---- bfloat16, and the skinny GEMM (csrc/skinny_gemm.cu) ----------------

def _bf16_rel(got, want):
    assert got.dtype == want.dtype == torch.bfloat16
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


# Queue 3's case: a decode step's projections in bfloat16 through the
# dispatcher the grid calls (static plan), at 8 slots and the bucket 64
@pytest.mark.parametrize("m", [8, 64])
@pytest.mark.parametrize("k,n", [(2048, 2048), (2048, 512), (2048, 8192),
                                 (8192, 2048), (2048, 128256), (1024, 1024),
                                 (1024, 512), (512, 1024)])
def test_local_matmul_bf16_at_decode_shapes(cuda_device, m, k, n):
    from repro_torch.kernels import autotune, ops

    gen = torch.Generator(device=cuda_device).manual_seed(m * k + n)
    x = torch.randn(m, k, generator=gen, device=cuda_device
                    ).to(torch.bfloat16)
    w = torch.randn(k, n, generator=gen, device=cuda_device
                    ).to(torch.bfloat16)
    before = (matmul.launches, matmul.skinny_launches)
    with autotune.autotune_disabled(), torch.inference_mode():
        got = ops.local_matmul(x, w)
    torch.cuda.synchronize()
    assert (matmul.launches, matmul.skinny_launches) == (before[0] + 1,
                                                         before[1] + 1)
    assert _bf16_rel(got, matmul_plain(x, w)) <= BF16_KERNEL_RTOL


# the float32 route of the skinny GEMM: M <= SKINNY_M rows, IEEE FFMA
@pytest.mark.parametrize("m", [1, 8, 16, 32])
@pytest.mark.parametrize("k,n", [(2048, 2048), (8192, 2048), (1024, 512),
                                 (2048, 128256)])
def test_skinny_f32_route_matches_plain(cuda_device, m, k, n):
    from repro_torch.kernels._plan import SKINNY_M

    gen = torch.Generator(device=cuda_device).manual_seed(m + k + n)
    x = torch.randn(m, k, generator=gen, device=cuda_device)
    w = torch.randn(k, n, generator=gen, device=cuda_device)
    before = matmul.skinny_launches
    got = matmul(x, w)
    torch.cuda.synchronize()
    assert matmul.skinny_launches == before + (m <= SKINNY_M)
    want = matmul_plain(x, w)
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * scale)


# ragged reductions: K not a whole number of slabs (the last slab of the
# last split zero-filled), a last split shorter than the others, rows
# past one 64-row block and not a multiple of 8, N past a whole strip;
# a long reduction past SKINNY_LAUNCH_BOUND_BYTES, summed through scratch
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k,n", [(8, 2056, 2048), (8, 1000, 520),
                                   (8, 8192, 2048), (72, 4104, 264),
                                   (3, 520, 1032), (130, 264, 128),
                                   (8, 65544, 1032)])
def test_skinny_ragged_splits_match_plain(cuda_device, dtype, m, k, n):
    from repro_torch.kernels._plan import skinny_plan, skinny_route, sm_count
    from repro_torch.kernels.matmul import launch_skinny

    x = torch.from_numpy(_normal(30, m, k)).to(cuda_device, dtype)
    w = torch.from_numpy(_normal(31, k, n)).to(cuda_device, dtype)
    plan = skinny_plan(m, n, k, dtype, sm_count(torch.cuda.current_device()))
    assert plan.splits * plan.chunk >= k > (plan.splits - 1) * plan.chunk
    got = (matmul(x, w) if skinny_route(m, n, k, dtype)
           else launch_skinny(x, w))
    torch.cuda.synchronize()
    want = matmul_plain(x, w)
    if dtype == torch.bfloat16:
        assert _bf16_rel(got, want) <= BF16_KERNEL_RTOL
    else:
        scale = float(want.abs().max())
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * scale)


# the splits sum in split order (a cluster, or scratch and a second
# kernel), with no atomics: two launches agree to the bit
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_skinny_launches_are_bit_equal(cuda_device, dtype):
    from repro_torch.kernels._plan import MAX_CLUSTER, skinny_plan, sm_count

    sms = sm_count(torch.cuda.current_device())
    # a decode step's small products sum in a cluster; a weight past
    # SKINNY_LAUNCH_BOUND_BYTES over few strips through scratch
    shapes = [(8, 2048, 2048), (8, 2048, 512), (8, 65536, 1024)]
    splits = {skinny_plan(m, n, k, dtype, sms).splits for m, k, n in shapes}
    assert max(splits) > MAX_CLUSTER and 1 < min(splits) <= MAX_CLUSTER
    for m, k, n in shapes:
        x = torch.from_numpy(_normal(32, m, k)).to(cuda_device, dtype)
        w = torch.from_numpy(_normal(33, k, n)).to(cuda_device, dtype)
        first, second = matmul(x, w), matmul(x, w)
        torch.cuda.synchronize()
        assert torch.equal(first, second)


def test_bf16_conv2d_and_wino_gemm_match_plain(cuda_device):
    x = torch.from_numpy(_normal(34, 4, 64, 30, 30)).to(cuda_device,
                                                         torch.bfloat16)
    w = torch.from_numpy(_normal(35, 32, 64, 3, 3)).to(cuda_device,
                                                        torch.bfloat16)
    before = conv2d.launches
    for padding in ("SAME", "VALID"):
        got = conv2d(x, w, padding=padding)
        assert _bf16_rel(got, conv2d_plain(x, w, padding=padding)) \
            <= BF16_KERNEL_RTOL
    assert conv2d.launches == before + 2
    v = torch.from_numpy(_normal(36, 16, 1568, 64)).to(cuda_device,
                                                        torch.bfloat16)
    u = torch.from_numpy(_normal(37, 16, 64, 128)).to(cuda_device,
                                                       torch.bfloat16)
    before = wino_gemm.launches
    got = wino_gemm(v, u)
    assert wino_gemm.launches == before + 1
    assert _bf16_rel(got, wino_gemm_plain(v, u)) <= BF16_KERNEL_RTOL
    # native bfloat16 (no widening): ragged P, C and K, a split
    # reduction summed in a cluster and one through scratch
    for seed, (t, p, c, k) in enumerate([(16, 130, 136, 72), (5, 300, 24, 16),
                                         (16, 1030, 72, 136),
                                         (16, 64, 1024, 64),
                                         (16, 64, 6272, 64)]):
        v = torch.from_numpy(_normal(60 + seed, t, p, c)).to(
            cuda_device, torch.bfloat16)
        u = torch.from_numpy(_normal(70 + seed, t, c, k)).to(
            cuda_device, torch.bfloat16)
        got = wino_gemm(v, u)
        assert got.dtype == torch.bfloat16
        assert _bf16_rel(got, wino_gemm_plain(v, u)) <= BF16_KERNEL_RTOL


@pytest.mark.parametrize("t,p,c,k", _wino_cnn_shapes(8))
def test_wino_gemm_bf16_matches_plain_at_the_cnn_shapes(cuda_device, t, p,
                                                        c, k):
    v = torch.from_numpy(_normal(38, t, p, c)).to(cuda_device,
                                                   torch.bfloat16)
    u = torch.from_numpy(_normal(39, t, c, k)).to(cuda_device,
                                                   torch.bfloat16)
    before = wino_gemm.launches
    got = wino_gemm(v, u)
    torch.cuda.synchronize()
    assert wino_gemm.launches == before + 1
    assert _bf16_rel(got, wino_gemm_plain(v, u)) <= BF16_KERNEL_RTOL


# du's split reduction: up to MAX_CLUSTER splits sum in a cluster, more
# through scratch; both in split order, so two launches agree to the bit
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wino_gemm_split_launches_are_bit_equal(cuda_device, dtype):
    from repro_torch.kernels._plan import MAX_CLUSTER, sm_count, wino_plan

    sms = sm_count(torch.cuda.current_device())
    splits = []
    for t, p, c, k in [(16, 64, 1024, 64), (16, 64, 6272, 64),
                       (16, 256, 3136, 128)]:
        splits.append(wino_plan(t, p, k, c, dtype, sms).splits)
        v = torch.from_numpy(_normal(40, t, p, c)).to(cuda_device, dtype)
        u = torch.from_numpy(_normal(41, t, c, k)).to(cuda_device, dtype)
        first, second = wino_gemm(v, u), wino_gemm(v, u)
        torch.cuda.synchronize()
        assert torch.equal(first, second)
    assert min(splits) > 1 and any(s <= MAX_CLUSTER for s in splits)
    assert any(s > MAX_CLUSTER for s in splits)


def test_kernels_refuse_mixed_dtypes_and_misaligned_bf16(cuda_device):
    x = torch.ones(8, 16, device=cuda_device)
    xb = x.to(torch.bfloat16)
    with pytest.raises(TypeError, match="both operands alike"):
        matmul(xb, x.t().contiguous())
    with pytest.raises(TypeError, match="both operands alike"):
        conv2d(xb.view(1, 8, 4, 4), torch.ones(8, 8, 3, 3,
                                               device=cuda_device))
    with pytest.raises(TypeError, match="both operands alike"):
        wino_gemm(xb[None], x.t().contiguous()[None])
    # the skinny GEMM's 16-byte copies: no ragged N in bfloat16, no
    # misaligned operand
    with pytest.raises(ValueError, match="multiples of 8"):
        matmul(xb, torch.ones(16, 12, dtype=torch.bfloat16,
                              device=cuda_device))
    flat = torch.ones(8 * 16 + 1, dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError, match="16-byte aligned"):
        matmul(flat[1:].view(8, 16), xb.t().contiguous())
    # wino_gemm: no non-contiguous operand; in bfloat16 no R or N that is
    # not a multiple of 8, no misaligned operand
    with pytest.raises(ValueError, match="contiguous"):
        wino_gemm(x.t()[None], x[None])
    with pytest.raises(ValueError, match="multiples of 8"):
        wino_gemm(xb[:, :12].contiguous()[None],
                  torch.ones(1, 12, 16, dtype=torch.bfloat16,
                             device=cuda_device))
    with pytest.raises(ValueError, match="16-byte aligned"):
        wino_gemm(flat[1:].view(1, 8, 16), xb.t().contiguous()[None])


# ------------------------------------------------ checkpoints, compression --

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_checkpoint_roundtrip_of_a_card_train_state(cuda_device, tmp_path,
                                                    dtype):
    """A train state on the card (parameters in ``dtype``, f32 moments and
    residuals) saved asynchronously and restored onto the card, bit-equal
    (bfloat16 travels as its bits)."""
    from torch.utils import _pytree as pytree

    from repro_torch.ckpt.checkpointer import CheckpointManager
    from repro_torch.models.cnn import init_cnn
    from repro_torch.train.optim import AdamW
    from repro_torch.train.step import init_train_state

    params = pytree.tree_map(lambda t: t.to(dtype), init_cnn(
        torch.Generator().manual_seed(0), channels=[64, 64], n_classes=10,
        in_channels=3, device=cuda_device))
    state = init_train_state(params, AdamW(), compress=True)
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    state = state._replace(opt=state.opt._replace(step=7, m=pytree.tree_map(
        lambda t: torch.randn(t.shape, generator=gen, device=cuda_device),
        state.opt.m)))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(state, 7, async_=True)
    mgr.wait()
    like = init_train_state(pytree.tree_map(torch.zeros_like, params),
                            AdamW(), compress=True)
    restored, step = mgr.restore_latest(like)
    assert step == 7 and restored.opt.step == 7
    for a, b in zip(pytree.tree_leaves(restored), pytree.tree_leaves(state)):
        if isinstance(b, torch.Tensor):
            assert a.device == b.device and a.dtype == b.dtype
            assert torch.equal(a, b)


def _compress_one_rank(rank, g):
    from repro_torch.dist.collectives import make_mesh, record_collectives
    from repro_torch.dist.compress import compressed_psum

    mesh = make_mesh((1,), ("pod",))
    with record_collectives() as notes:
        red, err = compressed_psum(g.cuda(), mesh, "pod")
    return red.cpu(), err.cpu(), [(n.kind, n.tag, n.itemsize) for n in notes]


def test_compressed_psum_on_a_one_rank_nccl_mesh(cuda_device):
    """The int8 all-gather runs on nccl; on one rank the mean is this
    rank's quantized round trip, the same as the CPU's."""
    from repro_torch.dist.compress import _quantize_int8
    from repro_torch.dist.spawn import run_spmd

    g = torch.from_numpy(_normal(11, 64, 100))
    red, err, notes = run_spmd(_compress_one_rank, 1, g)[0]
    want = _quantize_int8(g)
    assert torch.equal(red, want) and torch.equal(err, g - want)
    assert notes == [("all-gather", "compress_s8", 1),
                     ("all-gather", "compress_s8", 4)]
