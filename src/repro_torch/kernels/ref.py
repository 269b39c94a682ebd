"""Plain-PyTorch oracles for the kernels and for attention (port of
``repro/kernels/ref.py``).

Written as explicit index arithmetic / einsums, not ``F.conv2d``, so they
are a reference independent of cuDNN and of the kernels' own plain
versions.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def ref_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[M, C] @ [C, N] with f32 accumulation, result in x.dtype."""
    return torch.einsum("mc,cn->mn", x.float(), w.float()).to(x.dtype)


def ref_conv2d(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
               padding: str = "SAME") -> torch.Tensor:
    """NCHW x OIHW stride-``stride`` conv via explicit stencil shifts.

    Out[n,k,h,w] = sum_{c,r,s} In[n,c,stride*h+r,stride*w+s] * Ker[k,c,r,s]
    """
    n, c, h_in, w_in = x.shape
    k, c2, kh, kw = w.shape
    if c != c2:
        raise ValueError(f"channel mismatch: {tuple(x.shape)} x "
                         f"{tuple(w.shape)}")
    if padding == "SAME":
        if stride != 1:
            raise ValueError("SAME padding is stride 1 here")
        ph, pw = (kh - 1) // 2, (kw - 1) // 2
        x = F.pad(x, (pw, kw - 1 - pw, ph, kh - 1 - ph))
        h_out, w_out = h_in, w_in
    elif padding == "VALID":
        h_out = (h_in - kh) // stride + 1
        w_out = (w_in - kw) // stride + 1
    else:
        raise ValueError(padding)

    out = torch.zeros((n, k, h_out, w_out), dtype=torch.float32,
                      device=x.device)
    for r in range(kh):
        for s in range(kw):
            patch = x[:, :, r:r + stride * (h_out - 1) + 1:stride,
                      s:s + stride * (w_out - 1) + 1:stride]
            out = out + torch.einsum("nchw,kc->nkhw", patch.float(),
                                     w[:, :, r, s].float())
    return out.to(x.dtype)


def ref_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True,
                        scale: float | None = None) -> torch.Tensor:
    """[B, H, S, D] attention oracle in f32 (the causal mask is aligned to
    the last key, as the JAX package's: query ``i`` sees keys up to
    ``i + Sk - Sq``)."""
    d = q.shape[-1]
    s, sk = q.shape[2], k.shape[2]
    scale = scale if scale is not None else d ** -0.5
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        mask = torch.ones((s, sk), dtype=torch.bool,
                          device=q.device).tril(sk - s)
        logits = logits.masked_fill(~mask, float("-inf"))
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
