"""The port's device rule and the raw kernel wrappers' grad guard.

Every entry point resolves its device here: ``cuda`` unless the caller
asks for another device, and an error -- never a quiet CPU run -- when no
card is present.  Resolving a CUDA device also pins float32 to IEEE
float32 (no TF32 in cuDNN convolutions or matmuls), so that every
``torch.matmul`` / ``F.conv2d`` the port leaves to PyTorch keeps parity
with the f32 reference.
"""

from __future__ import annotations

import torch


def pin_fp32() -> None:
    """Turn TF32 off for cuDNN and cuBLAS float32 work."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means ``cuda``.  Raises
    when a CUDA device is asked for (or defaulted to) and none exists."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the plain PyTorch versions on the CPU")
        pin_fp32()
    return device


def forward_only(*tensors) -> None:
    """Refuse tensors that require grad.  The raw kernel wrappers have no
    backward (the JAX package has no VJP on a raw ``pallas_call``
    either): differentiable calls go through ``kernels.ops``, whose
    autograd Functions run the kernels on detached operands."""
    if any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            "a raw kernel wrapper is not differentiable; call the "
            "kernels.ops dispatchers (got a tensor with requires_grad=True)")
