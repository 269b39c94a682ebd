"""Compressed cross-rank gradient reduction with error feedback -- the
port of ``repro/dist/compress.py``.

``compressed_psum`` lossily compresses this rank's gradient before the
mean over a mesh axis and carries the compression residual forward as an
error-feedback accumulator (Karimireddy et al., "Error Feedback Fixes
SignSGD", 2019): the residual is added to the next step's gradient before
compressing, so the *accumulated* applied update converges to the true
gradient sum even though each reduction is lossy.

Two compressors, composable:

* int8 uniform quantization (default): per-tensor symmetric scale
  ``max|g|/127``; the wire carries one int8 payload and one f32 scale per
  tensor;
* top-k sparsification (``k_frac``): keep only the ``k`` entries largest
  in magnitude (ties to the lower position, as ``lax.top_k``); the rest
  go straight into the residual.

With ``wire="s8"`` (the default) the reduction really moves int8: the
payload and the per-rank scales are all-gathered over the axis through
``dist.collectives.all_gather`` and the mean is taken locally after
dequantization, so the notes record one-byte elements.  A ring all-gather
moves ``n (g - 1)`` bytes per rank against ``8 n (g - 1) / g`` for the
f32 all-reduce, a factor ``8 / g`` that breaks even at ``g = 8``, so at
axis sizes of 8 or more the s8 path falls back to the mean of the
dequantized tensor (``pmean``), as the reference does.  ``wire="f32"``
forces that fallback; both transmit the same quantized values and agree
up to the order of the mean's sums.

The port has no bound axis: the axis is named on a ``DeviceMesh`` passed
beside it, and every rank calls with its own gradient.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.utils import _pytree as pytree

from repro_torch.dist.collectives import all_gather, axis_size, pmean

WIRE_FORMATS = ("s8", "f32")


def _quantize_parts(v: torch.Tensor):
    """Symmetric int8 quantization; returns the int8 payload and the f32
    scale (a 0-d tensor).  The arithmetic stays in ``v``'s dtype and
    rounds half to even, as ``jnp.round``."""
    scale = torch.clamp_min(v.abs().max(), 1e-30) / 127.0
    q = torch.clamp(torch.round(v / scale), -127, 127).to(torch.int8)
    return q, scale.float()


def _quantize_int8(v: torch.Tensor) -> torch.Tensor:
    """Symmetric int8 round trip; returns the dequantized value in
    ``v``'s dtype."""
    q, scale = _quantize_parts(v)
    return (q.float() * scale).to(v.dtype)


def _topk_mask(v: torch.Tensor, k_frac: float) -> torch.Tensor:
    """1 at exactly the ``k`` largest-|v| positions.  A stable sort of
    ``-|v|`` breaks ties by position, as ``lax.top_k`` does (``torch.topk``
    promises no order among ties), so magnitude-tied tensors still keep
    the same ``k`` positions in both packages."""
    flat = v.abs().reshape(-1)
    k = max(1, int(round(k_frac * flat.numel())))
    idx = torch.sort(-flat, stable=True).indices[:k]
    mask = torch.zeros_like(flat)
    mask[idx] = 1
    return mask.reshape(v.shape).to(v.dtype)


def compressed_psum(g: torch.Tensor, mesh: DeviceMesh, axis: str, err=None,
                    *, k_frac: Optional[float] = None,
                    quantize: bool = True,
                    wire: str = "s8") -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean of ``g`` over ``mesh``'s ``axis`` through a lossy compressor.

    Returns ``(reduced, new_err)``: ``new_err`` is this rank's residual
    (the error-feedback state) to pass back in on the next step; ``err=None``
    means a zero accumulator.  ``wire="s8"`` all-gathers the int8 payload
    and the scales (tag ``compress_s8``) below an axis size of 8;
    ``wire="f32"``, and any axis of 8 ranks or more, all-reduce the
    dequantized tensor (tag ``compress``)."""
    if wire not in WIRE_FORMATS:
        raise ValueError(f"wire must be one of {WIRE_FORMATS}, got {wire!r}")
    acc = g if err is None else g + err
    comp = acc
    if k_frac is not None:
        comp = comp * _topk_mask(comp, k_frac)
    if not quantize:
        return pmean(comp, mesh, axis, tag="compress"), acc - comp
    q, scale = _quantize_parts(comp)
    # dequantize in f32, then back to the input dtype, so the residual
    # keeps its dtype across steps (bf16 gradients, bf16 residual)
    dq = (q.float() * scale).to(acc.dtype)
    new_err = acc - dq
    # the gather moves int8 only below the 8/g break-even (module docstring)
    if wire == "s8" and axis_size(mesh, axis) < 8:
        qg = all_gather(q.unsqueeze(0), mesh, axis, dim=0,
                        tag="compress_s8")                    # int8 wire
        sg = all_gather(scale.reshape(1), mesh, axis, dim=0,
                        tag="compress_s8")                    # [g] f32
        sg = sg.reshape((-1,) + (1,) * q.dim())
        out = (qg.float() * sg).mean(dim=0).to(acc.dtype)
    else:
        out = pmean(dq, mesh, axis, tag="compress")
    return out, new_err


def compressed_psum_tree(grads, mesh: DeviceMesh, axis: str, err=None, *,
                         k_frac: Optional[float] = None,
                         quantize: bool = True,
                         wire: str = "s8") -> Tuple[Any, Any]:
    """:func:`compressed_psum` over every gradient leaf.  ``err`` is a
    matching pytree of residuals, or ``None`` for a fresh zero state.
    Returns ``(reduced_tree, new_err_tree)``."""
    flat_g, spec = pytree.tree_flatten(grads)
    if err is None:
        flat_e = [torch.zeros_like(x) for x in flat_g]
    else:
        flat_e, err_spec = pytree.tree_flatten(err)
        if err_spec != spec:
            raise ValueError(
                f"error-feedback pytree structure {err_spec} does not "
                f"match grads {spec}")
    outs = [compressed_psum(x, mesh, axis, e, k_frac=k_frac,
                            quantize=quantize, wire=wire)
            for x, e in zip(flat_g, flat_e)]
    return (pytree.tree_unflatten([o[0] for o in outs], spec),
            pytree.tree_unflatten([o[1] for o in outs], spec))
