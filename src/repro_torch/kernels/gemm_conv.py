"""im2col-GEMM convolution -- the port of ``repro/kernels/gemm_conv.py``.

Every output pixel's receptive field becomes one row of a
``[N*Ho*Wo, C*kh*kw]`` patch matrix, the kernel a ``[C*kh*kw, K]``
matrix, and the conv one GEMM.  It covers every shape (strides, tiny
channel counts, prime extents), which makes it the tuner's universal
candidate.  The patch extraction is torch code that autograd
differentiates; the GEMM is injected by the caller (``kernels.ops``
passes ``local_matmul``, so on the card it runs the hand-written GEMM).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F


def _pad_lo_hi(size: int, k: int, s: int, padding: str) -> Tuple[int, int, int]:
    """(lo, hi, out) for one spatial dim under XLA's SAME/VALID rules."""
    if padding == "SAME":
        out = -(-size // s)
        total = max((out - 1) * s + k - size, 0)
        return total // 2, total - total // 2, out
    if padding == "VALID":
        return 0, 0, (size - k) // s + 1
    raise ValueError(f"padding must be SAME or VALID, got {padding!r}")


def im2col(x: torch.Tensor, kh: int, kw: int, *, stride=(1, 1),
           padding: str = "SAME") -> Tuple[torch.Tensor, Tuple[int, int]]:
    """Patch matrix of an NCHW input: ``[N*Ho*Wo, C*kh*kw]``, plus
    ``(Ho, Wo)``.  Row ``n*Ho*Wo + i*Wo + j`` holds the (c, r, s)-ordered
    receptive field of output pixel ``(n, i, j)``, the ordering of
    ``w.reshape(K, C*kh*kw)``."""
    n, c, h, wd = x.shape
    sh, sw = stride
    lo_h, hi_h, ho = _pad_lo_hi(h, kh, sh, padding)
    lo_w, hi_w, wo = _pad_lo_hi(wd, kw, sw, padding)
    xp = F.pad(x, (lo_w, hi_w, lo_h, hi_h))
    cols = torch.stack(
        [xp[:, :, r:r + sh * (ho - 1) + 1:sh, s:s + sw * (wo - 1) + 1:sw]
         for r in range(kh) for s in range(kw)], dim=2)  # [N,C,kh*kw,Ho,Wo]
    lhs = cols.permute(0, 3, 4, 1, 2).reshape(n * ho * wo, c * kh * kw)
    return lhs, (ho, wo)


def conv2d_im2col(x: torch.Tensor, w: torch.Tensor, *, stride=(1, 1),
                  padding: str = "SAME",
                  matmul: Optional[Callable] = None) -> torch.Tensor:
    """NCHW x OIHW conv as one patch-matrix GEMM; any stride, SAME/VALID.

    ``matmul(lhs, rhs)`` performs the ``[N*Ho*Wo, C*kh*kw] @ [C*kh*kw, K]``
    product; the default is ``torch.matmul`` in f32."""
    n, c, h, wd = x.shape
    k, c2, kh, kw = w.shape
    if c != c2:
        raise ValueError(f"channel mismatch: x {tuple(x.shape)} vs w "
                         f"{tuple(w.shape)}")
    lhs, (ho, wo) = im2col(x, kh, kw, stride=tuple(stride), padding=padding)
    rhs = w.reshape(k, c * kh * kw).t()
    if matmul is None:
        out = torch.matmul(lhs.float(), rhs.float())
    else:
        out = matmul(lhs.contiguous(), rhs.contiguous())
    out = out.reshape(n, ho, wo, k).permute(0, 3, 1, 2)
    return out.to(torch.result_type(x, w))
