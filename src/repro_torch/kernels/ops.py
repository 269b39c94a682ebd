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
``kernels.matmul``) vs ``xla`` (``torch.matmul``); Winograd's batched
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
import os

import torch
import torch.nn.functional as F

from repro_torch.device import pin_fp32
from repro_torch.kernels import autotune
from repro_torch.kernels.conv2d import conv2d
from repro_torch.kernels.gemm_conv import conv2d_im2col
from repro_torch.kernels.matmul import matmul
from repro_torch.kernels.winograd import (conv2d_winograd, winograd_applicable,
                                          wino_gemm as wino_gemm_kernel,
                                          wino_gemm_einsum)

_DIST_PALLAS_ENV = "REPRO_TORCH_DIST_PALLAS"


def _pallas_enabled() -> bool:
    return os.environ.get(_DIST_PALLAS_ENV, "1") != "0"


# --------------------------------------------------------------------------
# autograd Functions: the kernels differentiate through the same kernel
# family on transposed operands
# --------------------------------------------------------------------------

class _MatmulKernel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return matmul(x.detach().contiguous(), w.detach().contiguous())

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.contiguous()
        # dX = g @ W^T and dW = X^T @ g are matmuls: re-dispatch (the
        # transposed shapes get their own winner)
        dx = local_matmul(g, w.t().contiguous())
        dw = local_matmul(x.t().contiguous(), g)
        return dx.to(x.dtype), dw.to(w.dtype)


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
        gp = F.pad(g, (kw - 1, kw - 1, kh - 1, kh - 1))
        wt = w.flip(2, 3).transpose(0, 1).contiguous()
        dxp = local_conv2d(gp.contiguous(), wt, padding="VALID")
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
                       device="cpu") -> str:
    """Winning matmul impl (``pallas`` | ``xla``) for the shape: the
    static paper plan (the kernel when the shape tiles) when the tuner is
    off, the timed best-of on ``device`` otherwise."""
    if not (_pallas_enabled() and pallas_applicable_matmul(m, n, k)):
        return "xla"
    if not autotune.enabled():
        return "pallas"
    cands = [(name, functools.partial(_run_matmul_impl, name))
             for name in ("pallas", "xla")]
    return autotune.best_of(matmul_key(m, n, k, dtype), cands,
                            lambda: _rand([(m, k), (k, n)], dtype, device))


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
    xf = F.pad(x.float(), (lo_w, hi_w, lo_h, hi_h))
    return F.conv2d(xf, w.float(), stride=stride).to(torch.result_type(x, w))


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
                     dtype=torch.float32, device="cpu") -> str:
    """Winning conv impl (``direct`` | ``winograd`` | ``im2col`` |
    ``xla``) for the shape: the static paper plan when the tuner is off,
    the timed best-of on ``device`` otherwise."""
    stride = tuple(stride)
    cands = conv_candidates(x_shape, w_shape, stride, padding)
    if not autotune.enabled():
        return cands[0]  # static paper plan: direct when it tiles, else xla
    menu = [(name, functools.partial(_run_conv_impl, name, stride=stride,
                                     padding=padding))
            for name in cands]
    return autotune.best_of(
        conv_key(x_shape, w_shape, dtype, stride, padding), menu,
        lambda: _rand([tuple(x_shape), tuple(w_shape)], dtype, device))


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
