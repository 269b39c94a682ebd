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

# a reduction this long over this few output tiles is split (see
# csrc/gemm.cu): aim at two blocks per SM of the H100's 132
_SPLIT_MIN_BLOCKS = 264
_SPLIT_MIN_CHUNK = 512


def split_count(t: int, m: int, n: int, k: int) -> int:
    """How many chunks the GEMM kernels split a ``[t, m, k] @ [t, k, n]``
    reduction into: 1 unless the 64x64 output tiles are too few to fill
    the card and K is long."""
    blocks = t * -(-m // 64) * -(-n // 64)
    if blocks >= _SPLIT_MIN_BLOCKS or k < 2 * _SPLIT_MIN_CHUNK:
        return 1
    return max(1, min(-(-_SPLIT_MIN_BLOCKS // blocks),
                      k // _SPLIT_MIN_CHUNK))


def launch_gemm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch ``repro_gemm_f32`` on checked CUDA operands, ``[M,K] @
    [K,N]`` as one batch entry or ``[T,M,K] @ [T,K,N]``, with
    split-reduction scratch where :func:`split_count` asks for it."""
    lib = _build.load()
    t = a.shape[0] if a.dim() == 3 else 1
    m, k = a.shape[-2:]
    n = b.shape[-1]
    splits = split_count(t, m, n, k)
    shape = a.shape[:-2] + (m, n)
    out = torch.empty(shape, dtype=a.dtype, device=a.device)
    scratch = (torch.empty((splits,) + shape, dtype=a.dtype, device=a.device)
               if splits > 1 else None)
    _build.check(lib, lib.repro_gemm_f32(
        a.data_ptr(), b.data_ptr(), out.data_ptr(),
        scratch.data_ptr() if scratch is not None else None,
        t, m, n, k, splits, _build.stream_handle(a)), "gemm")
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
    if x.device.type == "cpu":
        return matmul_plain(x, w)
    if x.device.type != "cuda":
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
