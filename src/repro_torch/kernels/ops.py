"""Local-kernel engine -- the port of ``repro/kernels/ops.py``: the
candidate menus, the best-of selectors and the dispatchers the
distributed hot path routes through.

Every per-step slab contraction of the distributed schedules lands on
:func:`local_conv2d` / :func:`local_matmul`.  Per unique
``(op, shape, dtype, stride, padding)`` key the selector times every
applicable candidate once (``kernels.autotune``), memoizes the winner and
persists the plan table; with the tuner off (``REPRO_TORCH_AUTOTUNE=0``
or ``autotune.autotune_disabled()``) it takes the static paper plan.

The conv menu:

* ``direct``   -- the hand-written direct conv (``kernels.conv2d``;
  stride 1, feature dims that are multiples of 8);
* ``winograd`` -- ``kernels.winograd.conv2d_winograd``, F(2x2,3x3)
  transforms around the batched tile GEMM (3x3 stride 1);
* ``im2col``   -- ``kernels.gemm_conv.conv2d_im2col``, whose GEMM is
  :func:`local_matmul` (any stride, any extent);
* ``xla``      -- ``F.conv2d``, where the JAX package leaves the work to
  XLA outside any Pallas kernel.

The matmul menu is ``pallas`` (the hand-written GEMM,
``kernels.matmul``) vs ``xla`` (``torch.matmul``); :func:`matmul`, the
reference's public GEMM, takes the hand-written one at an explicit
block plan; Winograd's batched
tile GEMM has its own ``pallas`` (``kernels.winograd.wino_gemm``, the
hand-written tensor-core kernel ``csrc/wino_gemm.cu``) / ``einsum``
(``torch.bmm``) menu.  The candidate
names stay the JAX package's, so each counterpart is easy to find.

Each hand-written kernel runs inside a ``torch.autograd.Function`` whose
backward re-dispatches the same kernel family on transposed, contiguous
operands (the JAX package's ``custom_vjp``s): dX of a matmul is a matmul,
dIn / dKer of a stride-1 conv are VALID convs, the tile GEMM's are tile
GEMMs.  The library candidates and the transforms differentiate through
autograd, so every candidate -- and every winner -- has a gradient.
``REPRO_TORCH_DIST_PALLAS=0`` removes the hand-written candidates.
"""

from __future__ import annotations

import functools
import math
import os

import torch
import torch.nn.functional as F

from repro_torch.device import pin_fp32, resolve_device
from repro_torch.kernels import autotune
from repro_torch.kernels import matmul as _kmatmul
from repro_torch.kernels._plan import block_tile
from repro_torch.kernels.conv2d import conv2d
from repro_torch.kernels.gemm_conv import conv2d_im2col
from repro_torch.kernels.winograd import (conv2d_winograd, winograd_applicable,
                                          wino_gemm as wino_gemm_kernel,
                                          wino_gemm_einsum)

_DIST_PALLAS_ENV = "REPRO_TORCH_DIST_PALLAS"


def _pallas_enabled() -> bool:
    return os.environ.get(_DIST_PALLAS_ENV, "1") != "0"


@functools.lru_cache(maxsize=None)
def math_gcd_block(extent: int, want: int) -> int:
    """Largest divisor of ``extent`` not exceeding ``want`` -- by divisor
    enumeration in O(sqrt(extent)), memoized alongside the plans."""
    want = min(want, extent)
    best = 1
    for d in range(1, math.isqrt(extent) + 1):
        if extent % d == 0:
            if d <= want:
                best = max(best, d)
            q = extent // d
            if q <= want:
                best = max(best, q)
    return best


# --------------------------------------------------------------------------
# Memoized Eq. 4 block plans (``kernels.tiling``, one solve per shape).  The
# reference sizes its Pallas blocks with them; the hand-written kernels
# take their launches from ``kernels._plan`` instead, and these stand
# beside them as the paper's chip-level plan
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def matmul_plan(m: int, n: int, k: int):
    """Paper-planned ``(block_m, block_n, block_k)`` for an ``[m,k]@[k,n]``
    matmul, projected onto exact divisors of the extents."""
    from repro_torch.kernels import tiling

    bm, bn, bk = tiling.matmul_blocks(m, n, k)
    return (bm if m % bm == 0 else math_gcd_block(m, bm),
            bn if n % bn == 0 else math_gcd_block(n, bn),
            bk if k % bk == 0 else math_gcd_block(k, bk))


@functools.lru_cache(maxsize=None)
def conv_plan(n: int, c: int, k: int, h: int, w: int, kh: int, kw: int):
    """Paper-planned ``(block_b, block_k, block_c)`` for an NCHW/OIHW conv,
    projected onto exact divisors."""
    from repro_torch.core.problem import ConvProblem
    from repro_torch.kernels import tiling

    prob = ConvProblem.from_conv_layer(batch=n, cin=c, cout=k, h=h, w=w,
                                       kh=kh, kw=kw)
    plan = tiling.plan_blocks(prob)
    return (math_gcd_block(n, max(1, plan.block_bhw // (h * w))),
            math_gcd_block(k, plan.block_k),
            math_gcd_block(c, plan.block_c))


# --------------------------------------------------------------------------
# autograd Functions: the kernels differentiate through the same kernel
# family on transposed operands
# --------------------------------------------------------------------------

class _MatmulKernel(torch.autograd.Function):
    """The raw GEMM wrapper (``kernels.matmul.matmul``), forward at the
    tile core's ``tile`` (``None``: the plan's own)."""

    @staticmethod
    def forward(ctx, x, w, tile=None):
        ctx.save_for_backward(x, w)
        return _kmatmul.matmul(x.detach().contiguous(),
                               w.detach().contiguous(), tile=tile)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.contiguous()
        # dX = g @ W^T and dW = X^T @ g are matmuls: re-dispatch (the
        # transposed shapes get their own winner)
        dx = local_matmul(g, w.t().contiguous())
        dw = local_matmul(x.t().contiguous(), g)
        return dx.to(x.dtype), dw.to(w.dtype), None


class _ConvKernel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, padding):
        ctx.save_for_backward(x, w)
        ctx.padding = padding
        return conv2d(x.detach().contiguous(), w.detach().contiguous(),
                      padding=padding)

    @staticmethod
    def backward(ctx, g):
        """Stride-1 conv transposes inside the family: dIn is the VALID
        conv of the edge-padded cotangent against the flipped, O/I-swapped
        kernel, dKer the N/C-transposed VALID correlation -- both
        re-dispatched."""
        x, w = ctx.saved_tensors
        kh, kw = w.shape[2], w.shape[3]
        if ctx.padding == "SAME":
            lo_h, lo_w = (kh - 1) // 2, (kw - 1) // 2
            xp = F.pad(x, (lo_w, kw - 1 - lo_w, lo_h, kh - 1 - lo_h))
        else:
            lo_h = lo_w = 0
            xp = x
        wt = w.flip(2, 3).transpose(0, 1).contiguous()
        # the padded cotangent is a temporary of the call: it is released
        # before dKer's operands are made
        dxp = local_conv2d(F.pad(g, (kw - 1, kw - 1, kh - 1, kh - 1)),
                           wt, padding="VALID")
        dx = dxp[:, :, lo_h:lo_h + x.shape[2], lo_w:lo_w + x.shape[3]] \
            if ctx.padding == "SAME" else dxp
        dw = local_conv2d(xp.transpose(0, 1).contiguous(),
                          g.transpose(0, 1).contiguous(),
                          padding="VALID").transpose(0, 1)
        return dx.to(x.dtype), dw.contiguous().to(w.dtype), None


class _WinoGemmKernel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, v, u):
        ctx.save_for_backward(v, u)
        return wino_gemm_kernel(v.detach().contiguous(),
                                u.detach().contiguous())

    @staticmethod
    def backward(ctx, g):
        v, u = ctx.saved_tensors
        g = g.contiguous()
        dv = wino_gemm(g, u.transpose(1, 2).contiguous())
        du = wino_gemm(v.transpose(1, 2).contiguous(), g)
        return dv.to(v.dtype), du.to(u.dtype)


# --------------------------------------------------------------------------
# Applicability predicates
# --------------------------------------------------------------------------

def pallas_applicable_matmul(m: int, n: int, k: int) -> bool:
    """The tiled matmul kernel covers the shape when every extent is a
    multiple of 8 (the JAX package's sublane rule, kept for parity)."""
    return m % 8 == 0 and n % 8 == 0 and k % 8 == 0


def pallas_applicable_conv(x_shape, w_shape, stride, padding) -> bool:
    """The direct conv kernel covers stride-1 SAME/VALID with feature dims
    that are multiples of 8 and kernels no larger than the image."""
    n, c, h, wd = x_shape
    k, c2, kh, kw = w_shape
    return (tuple(stride) == (1, 1) and padding in ("SAME", "VALID")
            and c == c2 and k % 8 == 0 and c % 8 == 0
            and kh <= h and kw <= wd)


def wino_gemm_applicable(p: int, k: int, c: int) -> bool:
    """The batched tile GEMM kernel covers the shapes the matmul does."""
    return pallas_applicable_matmul(p, k, c)


# --------------------------------------------------------------------------
# Autotune keys and candidate menus
# --------------------------------------------------------------------------

def _dt(dtype) -> str:
    return str(dtype).replace("torch.", "")


def conv_key(x_shape, w_shape, dtype, stride, padding) -> str:
    n, c, h, wd = x_shape
    k, _, kh, kw = w_shape
    return (f"conv2d:{n}x{c}x{h}x{wd}:k{k}:{kh}x{kw}"
            f":s{stride[0]}x{stride[1]}:{padding}:{_dt(dtype)}")


def matmul_key(m: int, n: int, k: int, dtype) -> str:
    return f"matmul:{m}x{k}x{n}:{_dt(dtype)}"


def wino_gemm_key(p: int, k: int, c: int, dtype) -> str:
    return f"wino_gemm:16x{p}x{c}:k{k}:{_dt(dtype)}"


def _rand(shapes, dtype, device):
    """Timing operands, drawn from an explicit generator on ``device``."""
    gen = torch.Generator(device=device).manual_seed(0)
    return tuple(torch.randn(s, generator=gen, dtype=dtype, device=device)
                 for s in shapes)


def _run_matmul_impl(impl: str, x, w):
    if impl == "pallas":
        return _MatmulKernel.apply(x, w)
    if x.is_cuda:
        pin_fp32()
    return torch.matmul(x.float(), w.float()).to(torch.result_type(x, w))


def select_matmul_impl(m: int, n: int, k: int, *, dtype=torch.float32,
                       device=None) -> str:
    """Winning matmul impl (``pallas`` | ``xla``) for the shape: the
    static paper plan (the kernel when the shape tiles) when the tuner is
    off, the timed best-of on ``device`` otherwise (the card unless the
    caller asks for the CPU: resolved only when a key has to be timed)."""
    if not (_pallas_enabled() and pallas_applicable_matmul(m, n, k)):
        return "xla"
    if not autotune.enabled():
        return "pallas"
    cands = [(name, functools.partial(_run_matmul_impl, name))
             for name in ("pallas", "xla")]
    return autotune.best_of(matmul_key(m, n, k, dtype), cands,
                            lambda: _rand([(m, k), (k, n)], dtype,
                                          resolve_device(device)))


def _run_wino_gemm_impl(impl: str, v, u):
    if impl == "pallas":
        return _WinoGemmKernel.apply(v, u)
    if v.is_cuda:
        pin_fp32()
    return wino_gemm_einsum(v, u)


def wino_gemm(v: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Autotuned ``[16,P,C] @ [16,C,K]`` batched tile GEMM (the Winograd
    hot spot): the hand-written kernel when the shape tiles and wins,
    ``torch.bmm`` otherwise."""
    t, p, c = v.shape
    k = u.shape[2]
    if not (_pallas_enabled() and wino_gemm_applicable(p, k, c)):
        impl = "einsum"
    elif not autotune.enabled():
        impl = "pallas"
    else:
        cands = [(name, functools.partial(_run_wino_gemm_impl, name))
                 for name in ("pallas", "einsum")]
        impl = autotune.best_of(
            wino_gemm_key(p, k, c, v.dtype), cands,
            lambda: _rand([tuple(v.shape), tuple(u.shape)], v.dtype,
                          v.device))
    return _run_wino_gemm_impl(impl, v, u)


def _xla_conv(x, w, stride, padding):
    """``F.conv2d`` with XLA's SAME/VALID padding, f32 accumulation (no
    TF32 on the card, where cuDNN would otherwise default to it)."""
    if x.is_cuda:
        pin_fp32()
    lo_h, hi_h, _ = pad_amounts(x.shape[2], w.shape[2], stride[0], padding)
    lo_w, hi_w, _ = pad_amounts(x.shape[3], w.shape[3], stride[1], padding)
    if lo_h == hi_h and lo_w == hi_w:  # the library pads; no padded copy
        out = F.conv2d(x.float(), w.float(), stride=stride,
                       padding=(lo_h, lo_w))
    else:
        out = F.conv2d(F.pad(x.float(), (lo_w, hi_w, lo_h, hi_h)),
                       w.float(), stride=stride)
    return out.to(torch.result_type(x, w))


def _run_conv_impl(impl: str, x, w, stride, padding):
    if impl == "direct":
        return _ConvKernel.apply(x, w, padding)
    if impl == "winograd":
        return conv2d_winograd(x, w, padding=padding, gemm=wino_gemm)
    if impl == "im2col":
        return conv2d_im2col(x, w, stride=stride, padding=padding,
                             matmul=local_matmul)
    return _xla_conv(x, w, stride, padding)


def conv_candidates(x_shape, w_shape, stride, padding) -> list:
    """Ordered applicable candidate names for the conv shape (the static
    paper-plan choice first)."""
    direct_ok = (_pallas_enabled()
                 and pallas_applicable_conv(x_shape, w_shape, stride,
                                            padding))
    cands = ["direct"] if direct_ok else []
    if winograd_applicable(x_shape, w_shape, stride, padding):
        cands.append("winograd")
    cands.append("im2col")
    cands.append("xla")
    if not direct_ok:  # static choice (xla) leads when direct is out
        cands.remove("xla")
        cands.insert(0, "xla")
    return cands


def select_conv_impl(x_shape, w_shape, stride, padding, *,
                     dtype=torch.float32, device=None) -> str:
    """Winning conv impl (``direct`` | ``winograd`` | ``im2col`` |
    ``xla``) for the shape: the static paper plan when the tuner is off,
    the timed best-of on ``device`` otherwise (the card unless the caller
    asks for the CPU: resolved only when a key has to be timed)."""
    stride = tuple(stride)
    cands = conv_candidates(x_shape, w_shape, stride, padding)
    if not autotune.enabled():
        return cands[0]  # static paper plan: direct when it tiles, else xla
    menu = [(name, functools.partial(_run_conv_impl, name, stride=stride,
                                     padding=padding))
            for name in cands]
    return autotune.best_of(
        conv_key(x_shape, w_shape, dtype, stride, padding), menu,
        lambda: _rand([tuple(x_shape), tuple(w_shape)], dtype,
                      resolve_device(device)))


def pad_amounts(size: int, k: int, s: int, pad):
    """(lo, hi, out_size) for one spatial dim, XLA's SAME/VALID rules or
    an explicit ``(lo, hi)`` pair."""
    if isinstance(pad, str):
        if pad.upper() == "SAME":
            out = -(-size // s)
            total = max((out - 1) * s + k - size, 0)
            return total // 2, total - total // 2, out
        if pad.upper() == "VALID":
            return 0, 0, (size - k) // s + 1
        raise ValueError(f"unknown padding {pad!r}")
    lo, hi = pad
    return lo, hi, (size + lo + hi - k) // s + 1


# --------------------------------------------------------------------------
# Local-contraction dispatchers: the dist hot path calls these for every
# per-step slab contraction
# --------------------------------------------------------------------------

def local_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``[m,k] @ [k,n]`` for a distributed inner step, through the
    selector (f32 accumulation on every path); differentiable."""
    m, k = x.shape
    n = w.shape[1]
    impl = select_matmul_impl(m, n, k, dtype=x.dtype, device=x.device)
    return _run_matmul_impl(impl, x, w)


def planned_blocks(m: int, n: int, k: int, block_m: int = 0,
                   block_n: int = 0, block_k: int = 0) -> tuple:
    """The block plan :func:`matmul` runs for ``[m,k] @ [k,n]``: the Eq. 4
    plan (:func:`matmul_plan`) unless all three blocks are given, each
    block clamped to its extent; a plan whose blocks do not divide the
    extents is refused (``ValueError``), as the reference's
    ``matmul_pallas`` refuses it."""
    blocks = (block_m, block_n, block_k)
    if any(b < 0 for b in blocks):
        raise ValueError(f"block plan {blocks} has a negative block")
    if not all(blocks):
        blocks = matmul_plan(m, n, k)
    bm, bn, bk = (min(b, e) for b, e in zip(blocks, (m, n, k)))
    if m % bm or n % bn or k % bk:
        raise ValueError(f"the block plan {blocks} (clamped {(bm, bn, bk)}) "
                         f"does not divide [{m},{k}] @ [{k},{n}]")
    return bm, bn, bk


def matmul(x: torch.Tensor, w: torch.Tensor, *, block_m: int = 0,
           block_n: int = 0, block_k: int = 0) -> torch.Tensor:
    """The reference's public GEMM: ``[m,k] @ [k,n]`` (x.dtype), f32
    accumulation, at an explicit ``(block_m, block_n, block_k)`` plan
    (:func:`planned_blocks`: the Eq. 4 plan by default, refused where it
    does not divide); differentiable, its dX and dW re-dispatched through
    :func:`local_matmul`, as the reference's ``_matmul_pallas_bwd``.

    The forward always launches the hand-written GEMM on a CUDA tensor
    (the plain version on a CPU one), whatever the selector would pick.
    A Pallas block ``(block_m, block_n)`` is the output tile that stays
    resident: on the tile-core route it becomes the launch's tile where
    the core compiles one (``_plan.TILES``: 128x128, 64x64;
    ``_plan.block_tile``), and the launch takes ``_plan.gemm_plan``'s own
    tile otherwise.  ``block_k`` is a streaming depth, while the core
    compiles its slab depth in: it is validated and does not change the
    launch.  The skinny route (bfloat16, or float32 of at most
    ``_plan.SKINNY_M`` rows) keeps ``_plan.skinny_plan``."""
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"matmul needs [m,k] @ [k,n], got "
                         f"{tuple(x.shape)} @ {tuple(w.shape)}")
    (m, k), n = x.shape, w.shape[1]
    bm, bn, _ = planned_blocks(m, n, k, block_m, block_n, block_k)
    return _MatmulKernel.apply(x, w, block_tile(bm, bn))


def local_conv2d(x: torch.Tensor, w: torch.Tensor, *, stride=(1, 1),
                 padding: str = "VALID") -> torch.Tensor:
    """NCHW/OIHW conv for a distributed inner step, through the selector
    over the full candidate menu; differentiable."""
    stride = tuple(stride)
    impl = select_conv_impl(x.shape, w.shape, stride, padding,
                            dtype=x.dtype, device=x.device)
    return _run_conv_impl(impl, x, w, stride, padding)


def conv2d_same(x: torch.Tensor, w: torch.Tensor, *,
                use_pallas: bool = True) -> torch.Tensor:
    """stride-1 SAME conv, NCHW/OIHW: the direct kernel with no
    applicability check, as the JAX package calls its Pallas kernel here
    (``use_pallas=False`` is the ``F.conv2d`` baseline path);
    differentiable."""
    if not use_pallas:
        return _xla_conv(x, w, (1, 1), "SAME")
    return _ConvKernel.apply(x, w, "SAME")
