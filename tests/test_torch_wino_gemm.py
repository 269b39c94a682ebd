"""Winograd's tile GEMM on the CPU: the arithmetic of its CUDA kernel
(``csrc/wino_gemm.cu``) emulated in torch, and the wrapper's CPU route.

The kernel runs float32 as 3xTF32 on the tensor cores: each operand
element x is split into hi = tf32(x), rounded to nearest with ties away
from zero (an integer add and mask, as ``cvt.rna.tf32.f32``), and
lo = x - hi, which the tensor core reads as TF32 by dropping its low 13
bits; a product is lo_a*hi_b + hi_a*lo_b + hi_a*hi_b, each exact in
float32, summed in float32 one 32-deep slab at a time and slab after
slab.  The emulation (test code only) repeats that, bit masks and all,
and holds it against a float64 einsum at the CNN's on-path widths (C up
to 512) and at du's reduction of 50,176: within 1e-5 of max|ref|, ten
times inside the kernels' 1e-4 gate, and far closer than one TF32
product (hi_a*hi_b alone).  No card and no JAX here.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# torch on one thread in this process: the ops here are smoke-sized, and
# beside the other pytest-xdist workers more threads only spin
torch.set_num_threads(1)

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.winograd import wino_gemm, wino_gemm_plain  # noqa: E402

SLAB = 32          # float32 reduction indices per slab (wino_gemm.cu: BK)
EMULATION_RTOL = 1e-5


def _tf32_rna(x):
    """TF32 of float32 ``x``, rounded to nearest, ties away from zero."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _tf32_trunc(x):
    """TF32 of float32 ``x`` with its low 13 bits dropped (the tensor
    core's reading of a float32 operand)."""
    return (x.view(torch.int32) & -0x2000).view(torch.float32)


def _emulate(v, u, terms=3):
    """``[T,M,R] @ [T,R,N]`` as the kernel computes it in float32:
    ``terms`` = 3 is 3xTF32, 1 is one TF32 product (hi_a*hi_b)."""
    hv, hu = _tf32_rna(v), _tf32_rna(u)
    lv, lu = _tf32_trunc(v - hv), _tf32_trunc(u - hu)
    acc = torch.zeros(v.shape[0], v.shape[1], u.shape[2])
    for k in range(0, v.shape[2], SLAB):
        s = slice(k, k + SLAB)
        part = torch.bmm(hv[:, :, s], hu[:, s])
        if terms == 3:
            part = (torch.bmm(lv[:, :, s], hu[:, s])
                    + torch.bmm(hv[:, :, s], lu[:, s])) + part
        acc += part
    return acc


def _rel(got, v, u):
    want = torch.einsum("tmr,trn->tmn", v.double(), u.double())
    return float((got.double() - want).abs().max() / want.abs().max())


def test_tf32_rounding_is_round_half_away_from_zero():
    ulp = 2.0 ** -10  # TF32 keeps 10 bits of mantissa
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2 ** -23,
                      1 + 1.5 * ulp, 3.0, 0.0], dtype=torch.float32)
    want = [1 + ulp, -(1 + ulp), 1.0, 1 + 2 * ulp, 3.0, 0.0]
    assert _tf32_rna(x).tolist() == want
    assert _tf32_trunc(torch.tensor([1 + 1.99 * ulp])).item() == 1 + ulp
    # hi + lo is x exactly, and lo is at most half a TF32 ulp of x
    y = torch.from_numpy(np.random.default_rng(0).standard_normal(
        4096, dtype=np.float32))
    hi = _tf32_rna(y)
    lo = y - hi
    assert torch.equal(hi + lo, y)
    assert bool((lo.abs() <= hi.abs() * 2.0 ** -11).all())


# (t, m, r, n): the 512 -> 512 layer's forward and the 256 -> 512 dIn
# forward (C up to 512), the 64-wide layer's forward, du of the 64 -> 64
# layer at 56x56 (a reduction of 50,176); two batch entries each
@pytest.mark.parametrize("t,m,r,n", [(2, 256, 512, 512), (2, 256, 512, 256),
                                     (2, 1024, 64, 64), (2, 64, 50176, 64)])
def test_3xtf32_emulation_is_within_1e5_of_float64(t, m, r, n):
    rng = np.random.default_rng(m + r + n)
    v = torch.from_numpy(rng.standard_normal((t, m, r), dtype=np.float32))
    u = torch.from_numpy(rng.standard_normal((t, r, n), dtype=np.float32))
    three = _rel(_emulate(v, u), v, u)
    one = _rel(_emulate(v, u, terms=1), v, u)
    assert three <= EMULATION_RTOL
    assert three * 30 < one  # the two small products are what buys it


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wino_gemm_on_cpu_is_the_plain_version(dtype, monkeypatch):
    def no_build():
        raise AssertionError("a CPU tensor must not build the kernels")

    monkeypatch.setattr(_build, "load", no_build)
    rng = np.random.default_rng(5)
    v = torch.from_numpy(rng.standard_normal((16, 40, 24),
                                             dtype=np.float32)).to(dtype)
    u = torch.from_numpy(rng.standard_normal((16, 24, 12),
                                             dtype=np.float32)).to(dtype)
    before = wino_gemm.launches
    got = wino_gemm(v, u)
    assert wino_gemm.launches == before
    assert got.dtype == dtype and torch.equal(got, wino_gemm_plain(v, u))
