"""Halo exchange for spatially partitioned convolutions (paper Sec. 3.2)
-- the port of ``repro/dist/halo.py``.

When the h/w image dimensions are split over ranks, each rank needs ``lo``
boundary rows from its predecessor and ``hi`` rows from its successor
along the mesh axis.  The exchange is a pair of neighbour pushes
(:func:`collectives.ppermute`); ranks at the global boundary receive
zeros, which is exactly SAME-style zero padding, so the single-rank case
reduces to plain zero padding and the caller never special-cases it.

Shards smaller than the halo are handled by multi-hop pushes: hop ``j``
fetches the block ``j`` ranks away, and the strips are concatenated to the
requested width.  The permutations are partial (rank 0 has no
predecessor); only the ranks named in a permutation send or receive.

The exchange is linear; its transpose is :func:`halo_accumulate_1d`,
which pushes a cotangent's halo strips back to the shards that own those
rows and sums them into their boundaries (strips past the global
boundary are dropped, the transpose of the zero fill).
:func:`halo_exchange_1d` is differentiable through it.
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.dist.collectives import axis_size, ppermute


def _strip_from_prev(x, mesh, axis: str, dim: int, lo: int, n: int):
    """Last ``lo`` rows of the concatenation of all preceding shards,
    zero-extended past the global lower boundary.  Each hop pushes only
    the rows it contributes to the strip, not the whole shard."""
    size = x.shape[dim]
    hops = -(-lo // size)  # ceil
    blocks = []
    for hop in range(hops, 0, -1):  # farthest neighbour first
        take = min(size, lo - (hop - 1) * size)
        src = x.narrow(dim, size - take, take)
        perm = [(i, i + hop) for i in range(n - hop)]
        blocks.append(ppermute(src, mesh, axis, perm, tag="halo") if perm
                      else torch.zeros_like(src))
    return torch.cat(blocks, dim=dim)


def _strip_from_next(x, mesh, axis: str, dim: int, hi: int, n: int):
    """First ``hi`` rows of the concatenation of all following shards,
    zero-extended past the global upper boundary."""
    size = x.shape[dim]
    hops = -(-hi // size)
    blocks = []
    for hop in range(1, hops + 1):  # nearest neighbour first
        take = min(size, hi - (hop - 1) * size)
        src = x.narrow(dim, 0, take)
        perm = [(i, i - hop) for i in range(hop, n)]
        blocks.append(ppermute(src, mesh, axis, perm, tag="halo") if perm
                      else torch.zeros_like(src))
    return torch.cat(blocks, dim=dim)


def _exchange(x, mesh, axis: str, spatial_dim: int, lo: int, hi: int):
    n = axis_size(mesh, axis)
    parts = []
    if lo > 0:
        parts.append(_strip_from_prev(x, mesh, axis, spatial_dim, lo, n))
    parts.append(x)
    if hi > 0:
        parts.append(_strip_from_next(x, mesh, axis, spatial_dim, hi, n))
    return torch.cat(parts, dim=spatial_dim)


def halo_accumulate_1d(y: torch.Tensor, mesh: DeviceMesh, axis: str, *,
                       spatial_dim: int, lo: int, hi: int) -> torch.Tensor:
    """Transpose of :func:`halo_exchange_1d`: fold the ``lo``/``hi`` halo
    strips of a cotangent back into the shards that own those rows.

    ``y`` has extent ``size + lo + hi`` along ``spatial_dim``; the result
    has extent ``size``: the core plus, summed into its boundary rows, the
    halo strips pushed back along the inverted neighbour permutations
    (multi-hop blocks retrace their hops)."""
    if lo < 0 or hi < 0:
        raise ValueError(f"halo widths must be >= 0, got lo={lo} hi={hi}")
    if lo == 0 and hi == 0:
        return y
    size = y.shape[spatial_dim] - lo - hi
    if size <= 0:
        raise ValueError(f"cotangent extent {y.shape[spatial_dim]} too "
                         f"small for halo lo={lo} hi={hi}")
    n = axis_size(mesh, axis)
    dx = y.narrow(spatial_dim, lo, size).clone()
    if lo > 0:
        off = 0
        for hop in range(-(-lo // size), 0, -1):  # farthest first
            take = min(size, lo - (hop - 1) * size)
            blk = y.narrow(spatial_dim, off, take)
            off += take
            perm = [(i + hop, i) for i in range(n - hop)]
            if perm:
                dx.narrow(spatial_dim, size - take, take).add_(
                    ppermute(blk, mesh, axis, perm, tag="halo_acc"))
    if hi > 0:
        off = lo + size
        for hop in range(1, -(-hi // size) + 1):  # nearest first
            take = min(size, hi - (hop - 1) * size)
            blk = y.narrow(spatial_dim, off, take)
            off += take
            perm = [(i, i + hop) for i in range(n - hop)]
            if perm:
                dx.narrow(spatial_dim, 0, take).add_(
                    ppermute(blk, mesh, axis, perm, tag="halo_acc"))
    return dx


class _HaloExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, spatial_dim, lo, hi):
        ctx.args = (mesh, axis, spatial_dim, lo, hi)
        return _exchange(x, mesh, axis, spatial_dim, lo, hi)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, spatial_dim, lo, hi = ctx.args
        return (halo_accumulate_1d(g.contiguous(), mesh, axis,
                                   spatial_dim=spatial_dim, lo=lo, hi=hi),
                None, None, None, None, None)


def halo_exchange_1d(x: torch.Tensor, mesh: DeviceMesh, axis: str, *,
                     spatial_dim: int, lo: int, hi: int) -> torch.Tensor:
    """Extend the local shard by ``lo``/``hi`` halo rows along
    ``spatial_dim``, filled from the neighbouring shards on mesh axis
    ``axis`` (zeros beyond the global array boundary).  Returns a tensor
    whose ``spatial_dim`` extent is ``x.shape[spatial_dim] + lo + hi``.
    Differentiable: the backward is :func:`halo_accumulate_1d`."""
    if lo < 0 or hi < 0:
        raise ValueError(f"halo widths must be >= 0, got lo={lo} hi={hi}")
    if lo == 0 and hi == 0:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _HaloExchange.apply(x, mesh, axis, spatial_dim, lo, hi)
    return _exchange(x, mesh, axis, spatial_dim, lo, hi)
