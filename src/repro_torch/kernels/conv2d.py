"""Stride-1 direct conv -- the port of ``repro/kernels/conv2d.py``.

:func:`conv2d` is the wrapper of the hand-written CUDA kernel in
``csrc/conv2d.cu`` (which replaces the Pallas ``conv2d_pallas``): on a
CUDA tensor it launches the kernel on PyTorch's current stream, on a CPU
tensor it runs :func:`conv2d_plain`, the kernel's plain PyTorch version
-- the Pallas body's sum over (r, s) of shifted-window contractions, in
f32.  There is no fallback between the two.

The kernel computes in float32.  bfloat16 card operands are widened to
float32 in the wrapper (exact), run through the same kernel, and the
result narrowed to bfloat16 once: the reference's arithmetic exactly
(bfloat16 products are exact in float32, the sums are float32, one
rounding at the end), for the price of the two widening copies and the
narrowing one.  The kernel's loaders are 4- and 16-byte ``cp.async``
copies of floats into a k-major layout, which a 2-byte element cannot
take; native bfloat16 loaders wait for a later slice (no CNN of either
package runs bfloat16).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.device import forward_only
from repro_torch.kernels import _build
from repro_torch.kernels._plan import gemm_plan, sm_count


def _pads(kh: int, kw: int, padding: str):
    """(pad_h, pad_w) above/left for the stride-1 conv."""
    if padding == "SAME":
        return (kh - 1) // 2, (kw - 1) // 2
    if padding == "VALID":
        return 0, 0
    raise ValueError(f"padding must be SAME or VALID, got {padding!r}")


def conv2d_plain(x: torch.Tensor, w: torch.Tensor, *,
                 padding: str = "SAME") -> torch.Tensor:
    """stride-1 conv: x [N,C,H,W], w [K,C,kh,kw] -> [N,K,H',W'] as kh*kw
    shifted-window contractions in f32, cast back to ``x.dtype``."""
    kh, kw = w.shape[2], w.shape[3]
    ph, pw = _pads(kh, kw, padding)
    if padding == "SAME":
        x = F.pad(x, (pw, kw - 1 - pw, ph, kh - 1 - ph))
    ho, wo = x.shape[2] - kh + 1, x.shape[3] - kw + 1
    xf, wf = x.float(), w.float()
    out = None
    for r in range(kh):
        for s in range(kw):
            part = torch.einsum("nchw,kc->nkhw",
                                xf[:, :, r:r + ho, s:s + wo], wf[:, :, r, s])
            out = part if out is None else out + part
    return out.to(x.dtype)


def conv2d(x: torch.Tensor, w: torch.Tensor, *,
           padding: str = "SAME") -> torch.Tensor:
    """stride-1 conv: x [N,C,H,W], w [K,C,kh,kw] -> [N,K,H',W'].

    ``padding="SAME"`` zero-pads to the input extent; ``"VALID"`` runs on
    the raw input (H' = H - kh + 1), the form every per-step contraction
    of the distributed schedules takes after halo windowing.
    ``conv2d.launches`` counts the kernel's launches."""
    forward_only(x, w)
    if x.dim() != 4 or w.dim() != 4 or x.shape[1] != w.shape[1]:
        raise ValueError(f"conv2d needs NCHW x OIHW with matching C, got "
                         f"{tuple(x.shape)} x {tuple(w.shape)}")
    if x.device != w.device:
        raise ValueError(f"operands on {x.device} and {w.device}")
    n, c, h, wd = x.shape
    k, _, kh, kw = w.shape
    pad_h, pad_w = _pads(kh, kw, padding)
    ho, wo = (h, wd) if padding == "SAME" else (h - kh + 1, wd - kw + 1)
    if ho <= 0 or wo <= 0:
        raise ValueError(f"kernel {kh}x{kw} larger than the input {h}x{wd}")
    if not x.is_cuda:
        if x.device.type == "cpu":
            return conv2d_plain(x, w, padding=padding)
        raise ValueError(f"conv2d runs on cuda or cpu, not {x.device}")
    if x.dtype != w.dtype or x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the CUDA conv2d takes float32 or bfloat16, both "
                        f"operands alike, got {x.dtype} x {w.dtype}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("the CUDA conv2d takes contiguous operands")
    dtype = x.dtype
    x, w = x.float(), w.float()   # bfloat16: widened, exactly
    lib = _build.load()
    plan = gemm_plan(1, n * ho * wo, k, c * kh * kw,
                     sm_count(x.get_device()))
    out = x.new_empty(n, k, ho, wo)
    scratch = x.new_empty(plan.scratch) if plan.scratch else None
    _build.check(lib, lib.repro_conv2d_f32(
        x.data_ptr(), w.data_ptr(), out.data_ptr(),
        scratch.data_ptr() if scratch is not None else None, n, c, h, wd, k,
        kh, kw, ho, wo, pad_h, pad_w, *plan.tile, plan.splits, plan.chunk,
        _build.stream_handle(x)), "conv2d")
    conv2d.launches += 1
    return out.to(dtype)


conv2d.launches = 0
