"""Tiled f32 matmul -- the port of ``repro/kernels/matmul.py``.

:func:`matmul` is the wrapper of the hand-written CUDA kernel in
``csrc/gemm.cu`` at one batch entry (which replaces the Pallas
``matmul_pallas``; the same kernel is Winograd's tile GEMM): on a
CUDA tensor it launches the kernel on PyTorch's current stream, on a CPU
tensor it runs :func:`matmul_plain`, the kernel's plain PyTorch version.
There is no fallback between the two.
"""

from __future__ import annotations

import torch

from repro_torch.device import forward_only
from repro_torch.kernels import _build
from repro_torch.kernels._plan import gemm_plan, sm_count


def launch_gemm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch ``repro_gemm_f32`` on checked CUDA operands, ``[M,K] @
    [K,N]`` as one batch entry or ``[T,M,K] @ [T,K,N]``, with the tile
    and the split reduction of :func:`~repro_torch.kernels._plan.gemm_plan`
    (and its scratch)."""
    lib = _build.load()
    n = b.shape[-1]
    if a.dim() == 3:
        t, m, k = a.shape
        out = a.new_empty(t, m, n)
    else:
        t, (m, k) = 1, a.shape
        out = a.new_empty(m, n)
    plan = gemm_plan(t, m, n, k, sm_count(a.get_device()))
    scratch = a.new_empty(plan.scratch) if plan.scratch else None
    _build.check(lib, lib.repro_gemm_f32(
        a.data_ptr(), b.data_ptr(), out.data_ptr(),
        scratch.data_ptr() if scratch is not None else None,
        t, m, n, k, *plan.tile, plan.splits, plan.chunk,
        _build.stream_handle(a)), "gemm")
    return out


def matmul_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``[M,K] @ [K,N]`` in f32, cast back to ``x.dtype``."""
    return (x.float() @ w.float()).to(x.dtype)


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``[M,K] @ [K,N] -> [M,N]`` (x.dtype), f32 accumulation.

    ``matmul.launches`` counts the kernel's launches."""
    forward_only(x, w)
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"matmul needs [M,K] @ [K,N], got "
                         f"{tuple(x.shape)} @ {tuple(w.shape)}")
    if x.device != w.device:
        raise ValueError(f"operands on {x.device} and {w.device}")
    if not x.is_cuda:
        if x.device.type == "cpu":
            return matmul_plain(x, w)
        raise ValueError(f"matmul runs on cuda or cpu, not {x.device}")
    if x.dtype != torch.float32 or w.dtype != torch.float32:
        raise TypeError(f"the CUDA matmul takes float32, got {x.dtype} "
                        f"@ {w.dtype}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("the CUDA matmul takes contiguous operands")
    out = launch_gemm(x, w)
    matmul.launches += 1
    return out


matmul.launches = 0
