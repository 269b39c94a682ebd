"""Microbatch pipeline parallelism over a mesh axis (GPipe schedule) --
the port of ``repro/dist/pipeline.py``.

Stage ``s`` of the network runs on rank ``s`` of the pipeline axis: the
stage parameters are stacked on a leading dimension of extent ``S`` and
rank ``s`` takes slice ``s``.  Microbatches are fed into stage 0 one per
tick; activations hop to the next rank with one neighbour ``ppermute``
per tick, so after the ``S - 1``-tick fill the pipe is full and every
rank computes every tick.  Total ticks: ``n_micro + S - 1``.  A rank
skips the stage on a tick that carries no microbatch for it (the
reference computes it on zeros and discards the result).

**Backward pass.**  ``pipelined_apply`` is a ``torch.autograd.Function``:
the forward stashes each stage's *inputs*, one activation per tick per
rank (the GPipe stash; everything inside a stage is recomputed), and the
backward runs the reverse schedule: output cotangents enter the last
stage one per tick and hop *backwards* along the ring (the forward
neighbour push transposed), each rank re-running its stage's forward
under ``enable_grad`` at the stashed input and accumulating its
parameter gradient locally, as the reference's ``_pipe_bwd_local``.
Backward ticks mirror forward ticks one for one, so the ring's wire
doubles and stays neighbour-only.

The input and the output are replicated over the axis, and by the
port's convention (``dist.collectives``) their cotangents arrive
complete on every rank.  The stacked parameters are replicated too, so
each rank's stage gradient is gathered over the axis (tag ``pipe_dp``)
into the complete ``[S, ...]`` gradient on every rank; the reference
leaves it sharded on the axis instead.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.utils import _pytree as pytree

from repro_torch.dist.collectives import (axis_index, axis_size, ppermute,
                                          psum, shard)


def _valid(s: int, t: int, n_micro: int) -> bool:
    """Whether rank ``s`` holds a microbatch at tick ``t``."""
    return s <= t < s + n_micro


def _pipe_fwd_local(stage_fn, spec, p_here, x, mesh, axis, stash):
    n_stages, n_micro = axis_size(mesh, axis), x.shape[0]
    s = axis_index(mesh, axis)
    fwd = [(i, i + 1) for i in range(n_stages - 1)]
    params = pytree.tree_unflatten(list(p_here), spec)
    recv = torch.zeros_like(x[0])
    acc = torch.zeros_like(x)
    for t in range(n_micro + n_stages - 1):
        if _valid(s, t, n_micro):
            h_in = x[t] if s == 0 else recv
            if stash is not None:
                stash[t] = h_in
            h_out = stage_fn(params, h_in)
        else:
            h_out = torch.zeros_like(x[0])
        m = t - (n_stages - 1)  # the microbatch leaving the pipe
        if s == n_stages - 1 and 0 <= m < n_micro:
            acc[m] = h_out
        if fwd and t < n_micro + n_stages - 2:
            recv = ppermute(h_out, mesh, axis, fwd, tag="pipe_fwd")
    # only the last stage holds real outputs; psum replicates them
    return psum(acc, mesh, axis, tag="pipe_out")


def _stage_vjp(stage_fn, spec, p_here, h, dh_out):
    """``(dp, dh)`` of ``stage_fn`` at ``(p_here, h)`` against ``dh_out``,
    the stage's forward re-run under ``enable_grad``."""
    leaves = [p.detach().requires_grad_(True) for p in p_here]
    h = h.detach().requires_grad_(True)
    with torch.enable_grad():
        out = stage_fn(pytree.tree_unflatten(leaves, spec), h)
        grads = torch.autograd.grad(out, leaves + [h], dh_out,
                                    allow_unused=True)
    grads = [torch.zeros_like(a) if g is None else g
             for g, a in zip(grads, leaves + [h])]
    return grads[:-1], grads[-1]


def _pipe_bwd_local(stage_fn, spec, p_here, stash, g, mesh, axis):
    """Reverse schedule: cotangents enter the last stage and hop
    backwards; each rank replays its stage at the stashed input."""
    n_stages, n_micro = axis_size(mesh, axis), g.shape[0]
    s = axis_index(mesh, axis)
    bwd = [(i + 1, i) for i in range(n_stages - 1)]
    recv = torch.zeros_like(g[0])
    dx = torch.zeros_like(g)
    dp = [torch.zeros_like(p) for p in p_here]
    for t in reversed(range(n_micro + n_stages - 1)):
        if _valid(s, t, n_micro):
            dh_out = g[t - (n_stages - 1)] if s == n_stages - 1 else recv
            dpt, dh_in = _stage_vjp(stage_fn, spec, p_here, stash[t], dh_out)
            dp = [a + b for a, b in zip(dp, dpt)]
        else:
            dh_in = torch.zeros_like(g[0])
        if bwd and t > 0:
            recv = ppermute(dh_in, mesh, axis, bwd, tag="pipe_bwd")
        if s == 0 and t < n_micro:  # rank 0 consumed x[t] at tick t
            dx[t] = dh_in
    # only rank 0 holds the real input cotangents
    return dp, psum(dx, mesh, axis, tag="pipe_dx")


class _Pipelined(torch.autograd.Function):
    @staticmethod
    def forward(ctx, stage_fn, spec, mesh, axis, x, *p_here):
        stash = {}
        out = _pipe_fwd_local(stage_fn, spec, p_here, x, mesh, axis, stash)
        ctx.args = (stage_fn, spec, mesh, axis, stash)
        ctx.save_for_backward(*p_here)
        return out

    @staticmethod
    def backward(ctx, g):
        stage_fn, spec, mesh, axis, stash = ctx.args
        dp, dx = _pipe_bwd_local(stage_fn, spec, ctx.saved_tensors, stash,
                                 g.contiguous(), mesh, axis)
        return (None, None, None, None, dx, *dp)


def pipelined_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                    params, x: torch.Tensor, mesh: DeviceMesh, *,
                    axis: str = "pod") -> torch.Tensor:
    """Run ``x`` through ``S = axis_size(mesh, axis)`` stages of
    ``stage_fn``, on this rank.

    ``params``: a pytree whose leaves have a leading stage dimension
    ``S``, the same on every rank (rank ``s`` runs slice ``s``).  ``x``:
    ``[n_micro, mb, ...]`` microbatched input, the same on every rank.
    Returns the last stage's output ``[n_micro, mb, ...]`` on every rank.
    ``stage_fn(stage_params, h) -> h`` must keep the activation's shape
    (each stage's output feeds the next stage).

    Differentiable: the backward runs the reverse pipeline schedule (see
    the module docstring) and returns the complete stacked parameter
    gradient and input gradient on every rank."""
    n_stages = axis_size(mesh, axis)
    leaves, spec = pytree.tree_flatten(params)
    paths = [pytree.keystr(p)
             for p, _ in pytree.tree_flatten_with_path(params)[0]]
    for path, leaf in zip(paths, leaves):
        if tuple(leaf.shape[:1]) != (n_stages,):
            raise ValueError(
                f"param leaf {path} has leading dim "
                f"{tuple(leaf.shape[:1])}, expected ({n_stages},) = the "
                f"size of mesh axis {axis!r} (one slice per pipeline stage)")
    p_here = [shard(p, mesh, (axis,) + (None,) * (p.dim() - 1),
                    bwd_tag="pipe_dp")[0] for p in leaves]
    return _Pipelined.apply(stage_fn, spec, mesh, axis, x, *p_here)
