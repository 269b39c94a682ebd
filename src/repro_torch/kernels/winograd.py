"""Winograd F(2x2, 3x3) convolution -- the port of
``repro/kernels/winograd.py``.

Each 2x2 output tile is computed from a 4x4 input tile in the transform
domain: ``Y = A^T [ (G g G^T) . (B^T d B) ] A``.  Collecting every tile of
every image turns the elementwise products into 16 independent
``[P, C] @ [C, K]`` GEMMs (P = N * ceil(Ho/2) * ceil(Wo/2)), 2.25x fewer
multiplies than the direct 3x3 conv.

The transforms are small dense contractions left as torch code
(differentiable through autograd), as the JAX package leaves them to jnp
outside any Pallas kernel.  The batched tile GEMM is the hand-written
CUDA kernel in ``csrc/wino_gemm.cu``, which replaces the Pallas
``wino_gemm_pallas`` on Hopper's tensor cores: float32 as 3xTF32
(``mma.sync`` m16n8k8, each operand split into two TF32 halves, three
products, f32 sums) and bfloat16 natively (m16n8k16, f32 sums, one
rounding), with no widening in the wrapper.  :func:`wino_gemm`
launches it on a CUDA tensor and runs :func:`wino_gemm_plain`, its
plain PyTorch version, on a CPU tensor, with no fallback between the
two.  :func:`wino_gemm_einsum` is the GEMM's library backend (the JAX
package's XLA einsum).  The GEMM callable of :func:`conv2d_winograd` is
injected by ``kernels.ops``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from repro_torch.device import forward_only
from repro_torch.kernels import _build
from repro_torch.kernels._plan import sm_count, wino_plan

# F(2x2, 3x3) transform matrices (Lavin & Gray 2015, Sec. 4).
_BT = ((1, 0, -1, 0), (0, 1, 1, 0), (0, -1, 1, 0), (0, 1, 0, -1))
_G = ((1, 0, 0), (.5, .5, .5), (.5, -.5, .5), (0, 0, 1))
_AT = ((1, 1, 1, 0), (0, 1, -1, -1))

def winograd_applicable(x_shape, w_shape, stride, padding) -> bool:
    """F(2x2,3x3) covers 3x3 stride-1 SAME/VALID convs (any extent: odd
    outputs pad the tile grid and crop)."""
    n, c, h, wd = x_shape
    k, c2, kh, kw = w_shape
    return (c == c2 and kh == 3 and kw == 3 and tuple(stride) == (1, 1)
            and padding in ("SAME", "VALID") and h >= kh and wd >= kw)


# --------------------------------------------------------------------------
# The batched 16-frequency tile GEMM: kernel, plain version, library call
# --------------------------------------------------------------------------

def wino_gemm_plain(v: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """``[T,P,C] @ [T,C,K]`` as an f32 einsum, cast back to ``v.dtype``."""
    return torch.einsum("tpc,tck->tpk", v.float(), u.float()).to(v.dtype)


def wino_gemm_einsum(v: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The library backend of the batched tile GEMM (``torch.bmm``, f32
    accumulation; TF32 is pinned off on the card)."""
    return torch.bmm(v.float(), u.float()).to(v.dtype)


def launch_wino_gemm(v: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Launch ``repro_wino_gemm`` on checked CUDA operands ``[T,M,R] @
    [T,R,N]`` of one dtype (float32 or bfloat16), with the plan of
    :func:`~repro_torch.kernels._plan.wino_plan` (and its scratch).
    Raises on bfloat16 that its 16-byte copies cannot take: R or N not a
    multiple of 8, or an operand not 16-byte aligned."""
    lib = _build.load()
    t, m, r = v.shape
    n = u.shape[2]
    bf16 = v.dtype == torch.bfloat16
    if bf16 and (r % 8 or n % 8):
        raise ValueError(f"the bfloat16 wino_gemm needs R and N multiples "
                         f"of 8, got {tuple(v.shape)} @ {tuple(u.shape)}")
    if bf16 and (v.data_ptr() % 16 or u.data_ptr() % 16):
        raise ValueError("the bfloat16 wino_gemm needs 16-byte aligned "
                         "operands")
    plan = wino_plan(t, m, n, r, v.dtype, sm_count(v.get_device()))
    out = v.new_empty(t, m, n)
    scratch = (v.new_empty(plan.scratch, dtype=torch.float32)
               if plan.scratch else None)
    _build.check(lib, lib.repro_wino_gemm(
        v.data_ptr(), u.data_ptr(), out.data_ptr(),
        scratch.data_ptr() if scratch is not None else None, int(bf16),
        t, m, n, r, *plan.tile, plan.splits, plan.chunk,
        _build.stream_handle(v)), "wino_gemm")
    return out


def wino_gemm(v: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """``[T,P,C] @ [T,C,K] -> [T,P,K]`` (v.dtype), f32 accumulation; on the
    card float32 or bfloat16, both operands of one dtype.

    ``wino_gemm.launches`` counts the kernel's launches."""
    forward_only(v, u)
    if (v.dim() != 3 or u.dim() != 3 or v.shape[0] != u.shape[0]
            or v.shape[2] != u.shape[1]):
        raise ValueError(f"wino_gemm needs [T,P,C] @ [T,C,K], got "
                         f"{tuple(v.shape)} @ {tuple(u.shape)}")
    if v.device != u.device:
        raise ValueError(f"operands on {v.device} and {u.device}")
    if v.device.type == "cpu":
        return wino_gemm_plain(v, u)
    if v.device.type != "cuda":
        raise ValueError(f"wino_gemm runs on cuda or cpu, not {v.device}")
    if v.dtype != u.dtype or v.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the CUDA wino_gemm takes float32 or bfloat16, "
                        f"both operands alike, got {v.dtype} @ {u.dtype}")
    if not (v.is_contiguous() and u.is_contiguous()):
        raise ValueError("the CUDA wino_gemm takes contiguous operands")
    out = launch_wino_gemm(v, u)
    wino_gemm.launches += 1
    return out


wino_gemm.launches = 0


# --------------------------------------------------------------------------
# The conv itself: transform -> batched GEMM -> inverse transform
# --------------------------------------------------------------------------

def conv2d_winograd(x: torch.Tensor, w: torch.Tensor, *,
                    padding: str = "SAME",
                    gemm: Optional[Callable] = None) -> torch.Tensor:
    """3x3 stride-1 conv, NCHW x OIHW, via F(2x2,3x3).

    ``gemm(v, u)`` runs the ``[16, P, C] @ [16, C, K]`` batched tile GEMM
    (``kernels.ops`` injects its dispatcher); the default is
    :func:`wino_gemm_einsum`."""
    n, c, h, wd = x.shape
    k, c2, kh, kw = w.shape
    if not winograd_applicable(x.shape, w.shape, (1, 1), padding):
        raise ValueError(f"winograd F(2x2,3x3) does not cover "
                         f"{tuple(x.shape)} * {tuple(w.shape)} "
                         f"pad={padding!r}")
    lo = 1 if padding == "SAME" else 0
    ho, wo = h + 2 * lo - 2, wd + 2 * lo - 2
    th, tw = -(-ho // 2), -(-wo // 2)    # tile grid (pad odd, crop below)
    # pad so the tile grid reads exactly 2*t + 2 rows/cols
    xp = F.pad(x.float(), (lo, 2 * tw + 2 - wd - lo, lo, 2 * th + 2 - h - lo))
    f32 = dict(dtype=torch.float32, device=x.device)
    bt, g, at = (torch.tensor(m, **f32) for m in (_BT, _G, _AT))
    # 4x4 input tiles at stride 2: d[n,c,ti,tj,i,j] = xp[n,c,2ti+i,2tj+j]
    d = xp.unfold(2, 4, 2).unfold(3, 4, 2)              # [N,C,th,tw,4,4]
    v = torch.einsum("ai,bj,nctwij->abnctw", bt, bt, d)
    uu = torch.einsum("ai,bj,kcij->abck", g, g, w.float())
    v2 = (v.reshape(16, n, c, th, tw).permute(0, 1, 3, 4, 2)
           .reshape(16, n * th * tw, c).contiguous())
    u2 = uu.reshape(16, c, k).contiguous()
    m = wino_gemm_einsum(v2, u2) if gemm is None else gemm(v2, u2)
    m2 = m.float().reshape(4, 4, n, th, tw, k)
    y = torch.einsum("pa,qb,abntwk->ntwkpq", at, at, m2)  # [N,th,tw,K,2,2]
    y = y.permute(0, 3, 1, 4, 2, 5).reshape(n, k, 2 * th, 2 * tw)
    return y[:, :, :ho, :wo].to(torch.result_type(x, w))
