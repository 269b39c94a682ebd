"""Local-kernel dispatch -- the static subset of ``repro/kernels/ops.py``.

Every per-step slab contraction of the distributed schedules lands on
:func:`local_conv2d` / :func:`local_matmul`.  This port carries the
dispatch the JAX package runs with its autotuner off
(``REPRO_AUTOTUNE=0``), the paper's static plan:

* conv: ``direct`` -- the hand-written direct-conv kernel
  (``kernels.conv2d.conv2d``) -- when the shape tiles
  (:func:`pallas_applicable_conv`), else ``xla``;
* matmul: ``pallas`` -- the hand-written GEMM (``kernels.matmul.matmul``)
  -- when every extent is a multiple of 8, else ``xla``.

``xla`` is where the JAX package leaves the work to XLA outside any
Pallas kernel; here it is ``F.conv2d`` / ``torch.matmul`` (on the CNN
path: the first conv, with C = 3, and any strided conv).  The candidate
and predicate names stay those of the JAX package so each counterpart is
easy to find.  The autotuner, Winograd and im2col candidates are a later
slice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.device import forward_only, pin_fp32
from repro_torch.kernels.conv2d import conv2d
from repro_torch.kernels.matmul import matmul


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


def select_matmul_impl(m: int, n: int, k: int) -> str:
    """``pallas`` when the shape tiles, else ``xla``."""
    return "pallas" if pallas_applicable_matmul(m, n, k) else "xla"


def conv_candidates(x_shape, w_shape, stride, padding) -> list:
    """Ordered applicable candidates, the static choice first."""
    if pallas_applicable_conv(x_shape, w_shape, stride, padding):
        return ["direct", "xla"]
    return ["xla"]


def select_conv_impl(x_shape, w_shape, stride, padding) -> str:
    """``direct`` when the conv tiles, else ``xla``."""
    return conv_candidates(x_shape, w_shape, stride, padding)[0]


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


def _xla_conv(x, w, stride, padding):
    """``F.conv2d`` with XLA's SAME/VALID padding, f32 accumulation (no
    TF32 on the card, where cuDNN would otherwise default to it)."""
    if x.is_cuda:
        pin_fp32()
    lo_h, hi_h, _ = pad_amounts(x.shape[2], w.shape[2], stride[0], padding)
    lo_w, hi_w, _ = pad_amounts(x.shape[3], w.shape[3], stride[1], padding)
    xf = F.pad(x.float(), (lo_w, hi_w, lo_h, hi_h))
    return F.conv2d(xf, w.float(), stride=stride).to(x.dtype)


def local_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``[m,k] @ [k,n]`` for a distributed inner step, on the static plan
    (f32 accumulation on every path)."""
    forward_only(x, w)
    m, k = x.shape
    n = w.shape[1]
    if select_matmul_impl(m, n, k) == "pallas":
        return matmul(x.contiguous(), w.contiguous())
    return torch.matmul(x.float(), w.float()).to(x.dtype)


def local_conv2d(x: torch.Tensor, w: torch.Tensor, *, stride=(1, 1),
                 padding: str = "VALID") -> torch.Tensor:
    """NCHW/OIHW conv for a distributed inner step, on the static plan."""
    forward_only(x, w)
    stride = tuple(stride)
    if select_conv_impl(x.shape, w.shape, stride, padding) == "direct":
        return conv2d(x.contiguous(), w.contiguous(), padding=padding)
    return _xla_conv(x, w, stride, padding)


def conv2d_same(x: torch.Tensor, w: torch.Tensor, *,
                use_pallas: bool = True) -> torch.Tensor:
    """stride-1 SAME conv, NCHW/OIHW: the direct kernel with no
    applicability check, as the JAX package calls its Pallas kernel here
    (``use_pallas=False`` is the ``F.conv2d`` baseline path)."""
    forward_only(x, w)
    if not use_pallas:
        return _xla_conv(x, w, (1, 1), "SAME")
    return conv2d(x.contiguous(), w.contiguous(), padding="SAME")
