"""Halo exchange for spatially partitioned convolutions (paper Sec. 3.2)
-- the forward of ``repro/dist/halo.py``.

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
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.device import forward_only
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


def halo_exchange_1d(x: torch.Tensor, mesh: DeviceMesh, axis: str, *,
                     spatial_dim: int, lo: int, hi: int) -> torch.Tensor:
    """Extend the local shard by ``lo``/``hi`` halo rows along
    ``spatial_dim``, filled from the neighbouring shards on mesh axis
    ``axis`` (zeros beyond the global array boundary).  Returns a tensor
    whose ``spatial_dim`` extent is ``x.shape[spatial_dim] + lo + hi``."""
    forward_only(x)
    if lo < 0 or hi < 0:
        raise ValueError(f"halo widths must be >= 0, got lo={lo} hi={hi}")
    if lo == 0 and hi == 0:
        return x
    n = axis_size(mesh, axis)
    parts = []
    if lo > 0:
        parts.append(_strip_from_prev(x, mesh, axis, spatial_dim, lo, n))
    parts.append(x)
    if hi > 0:
        parts.append(_strip_from_next(x, mesh, axis, spatial_dim, hi, n))
    return torch.cat(parts, dim=spatial_dim)
