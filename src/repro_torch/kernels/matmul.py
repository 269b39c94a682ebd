"""Tiled f32 matmul -- the port of ``repro/kernels/matmul.py``.

:func:`matmul` is the wrapper of the hand-written CUDA kernel in
``csrc/matmul.cu`` (which replaces the Pallas ``matmul_pallas``): on a
CUDA tensor it launches the kernel on PyTorch's current stream, on a CPU
tensor it runs :func:`matmul_plain`, the kernel's plain PyTorch version.
There is no fallback between the two.
"""

from __future__ import annotations

import torch

from repro_torch.device import forward_only
from repro_torch.kernels import _build


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
    if x.device.type == "cpu":
        return matmul_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"matmul runs on cuda or cpu, not {x.device}")
    if x.dtype != torch.float32 or w.dtype != torch.float32:
        raise TypeError(f"the CUDA matmul takes float32, got {x.dtype} "
                        f"@ {w.dtype}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("the CUDA matmul takes contiguous operands")
    lib = _build.load()
    (m, k), n = x.shape, w.shape[1]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    _build.check(lib, lib.repro_matmul_f32(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), m, n, k,
        _build.stream_handle(x)), "matmul")
    matmul.launches += 1
    return out


matmul.launches = 0
