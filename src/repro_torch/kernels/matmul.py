"""The matmul -- the port of ``repro/kernels/matmul.py``.

:func:`matmul` is the wrapper of the two hand-written CUDA kernels that
replace the Pallas ``matmul_pallas``: on a CUDA tensor it launches one of
them on PyTorch's current stream, on a CPU tensor it runs
:func:`matmul_plain`, their plain PyTorch version.  There is no fallback
between the two.  Which kernel a card operand takes is a rule of the
shape and dtype (``_plan.skinny_route``):

* ``csrc/skinny_gemm.cu`` (:func:`launch_skinny`): every bfloat16
  product (tensor cores, f32 accumulation, bfloat16 out), and the float32
  ones with at most ``_plan.SKINNY_M`` rows (FFMA) -- a decode step's
  products, bound by the bytes of the weight;
* ``csrc/gemm.cu`` at one batch entry (:func:`launch_gemm`, the tile
  core): every other float32 product.
"""

from __future__ import annotations

import torch

from repro_torch.device import forward_only
from repro_torch.kernels import _build
from repro_torch.kernels._plan import (gemm_plan, skinny_plan, skinny_route,
                                       sm_count)


def launch_gemm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch ``repro_gemm_f32`` on checked CUDA operands ``[M,K] @
    [K,N]`` as one batch entry, with the tile and the split reduction of
    :func:`~repro_torch.kernels._plan.gemm_plan` (and its scratch)."""
    lib = _build.load()
    t, (m, k), n = 1, a.shape, b.shape[1]
    out = a.new_empty(m, n)
    plan = gemm_plan(t, m, n, k, sm_count(a.get_device()))
    scratch = a.new_empty(plan.scratch) if plan.scratch else None
    _build.check(lib, lib.repro_gemm_f32(
        a.data_ptr(), b.data_ptr(), out.data_ptr(),
        scratch.data_ptr() if scratch is not None else None,
        t, m, n, k, *plan.tile, plan.splits, plan.chunk,
        _build.stream_handle(a)), "gemm")
    return out


def launch_skinny(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Launch ``repro_skinny_gemm`` on checked CUDA operands ``[M,K] @
    [K,N]`` of one dtype (bfloat16 or float32), with the plan of
    :func:`~repro_torch.kernels._plan.skinny_plan` (and its scratch).
    Raises on what its 16-byte copies cannot take: N or K not a whole
    number of 16-byte vectors, or an operand not 16-byte aligned."""
    lib = _build.load()
    m, k = x.shape
    n = w.shape[1]
    vec = 16 // x.element_size()
    if n % vec or k % vec:
        raise ValueError(f"the skinny GEMM needs N and K multiples of {vec} "
                         f"in {x.dtype}, got [{m},{k}] @ [{k},{n}]")
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("the skinny GEMM needs 16-byte aligned operands")
    plan = skinny_plan(m, n, k, x.dtype, sm_count(x.get_device()))
    out = x.new_empty(m, n)
    scratch = (x.new_empty(plan.scratch, dtype=torch.float32)
               if plan.scratch else None)
    _build.check(lib, lib.repro_skinny_gemm(
        x.data_ptr(), w.data_ptr(), out.data_ptr(),
        scratch.data_ptr() if scratch is not None else None,
        int(x.dtype == torch.bfloat16), m, n, k, plan.strip, plan.slab,
        plan.rows, plan.splits, plan.chunk, _build.stream_handle(x)),
        "skinny_gemm")
    return out


def matmul_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``[M,K] @ [K,N]`` in f32, cast back to ``x.dtype``."""
    return (x.float() @ w.float()).to(x.dtype)


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``[M,K] @ [K,N] -> [M,N]`` (x.dtype), f32 accumulation; on the card
    float32 or bfloat16, both operands of one dtype.

    ``matmul.launches`` counts the launches of both kernels,
    ``matmul.skinny_launches`` those of the skinny GEMM alone."""
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
    if x.dtype != w.dtype or x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the CUDA matmul takes float32 or bfloat16, both "
                        f"operands alike, got {x.dtype} @ {w.dtype}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("the CUDA matmul takes contiguous operands")
    if skinny_route(x.shape[0], w.shape[1], x.shape[1], x.dtype):
        out = launch_skinny(x, w)
        matmul.skinny_launches += 1
    else:
        out = launch_gemm(x, w)
    matmul.launches += 1
    return out


matmul.launches = 0
matmul.skinny_launches = 0
