"""Accounted collectives and ring schedules -- the forward subset of
``repro/dist/collectives.py``.

Where the JAX package runs one ``shard_map``'d function over a named
mesh, every rank here runs the same Python function on its own shard.  A
mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with named axes;
:func:`axis_index` / :func:`axis_size` read this rank's coordinate and an
axis' extent, and every collective takes the mesh and the axis it runs
over.

Three schedules for the same logical contraction-operand movement:

* ``"allgather"`` -- one all-gather collective;
* ``"ring"``      -- an explicit ring of ``g - 1`` neighbour exchanges
  (:func:`ring_reduce`), the building block the pipelined schedules
  contract against as each shard arrives;
* ``"ring2"``     -- both contraction operands rotate around their rings
  in lockstep (:func:`ring_zip`), so no rank materializes a gathered
  operand.

This is the only module of the port that calls ``torch.distributed``.
Every collective goes through an accounted wrapper, and under
:func:`record_collectives` each call appends a :class:`CollectiveNote`
carrying the elements it puts on the wire, by the model the JAX package's
static verifier applies to compiled HLO: a collective-permute counts its
buffer once per call (on every rank of the program, sender or not), an
all-gather ``shard * (g - 1)``, an all-reduce ``2 * v * (g - 1) / g``.
"""

from __future__ import annotations

import contextlib
import math
from typing import NamedTuple, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.device import resolve_device

SCHEDULES = ("allgather", "ring", "ring2")


class CollectiveNote(NamedTuple):
    """One collective: its kind, the mesh axes it runs over, the call-site
    tag (which primitive emitted it) and its per-rank wire elements."""

    kind: str             # all-reduce | all-gather | collective-permute
    axes: Tuple[str, ...]
    tag: str
    wire_elems: float


_RECORD_STACK: list = []


@contextlib.contextmanager
def record_collectives():
    """Collect a :class:`CollectiveNote` for every accounted collective
    run while inside this context; yields the list."""
    buf: list = []
    _RECORD_STACK.append(buf)
    try:
        yield buf
    finally:
        _RECORD_STACK.pop()


def _note(kind: str, axis: str, tag: str, wire_elems: float) -> None:
    if _RECORD_STACK:
        _RECORD_STACK[-1].append(
            CollectiveNote(kind, (axis,), tag, float(wire_elems)))


# --------------------------------------------------------------------------
# Meshes
# --------------------------------------------------------------------------

def make_mesh(grid, axes, *, device=None) -> DeviceMesh:
    """Named mesh over ``axes`` from a parallel tuple of per-axis extents,
    rank-major in axis order (rank ``r`` sits at ``unravel(r, grid)``, as
    a ``jax.sharding.Mesh`` over the first devices lays them out).  Needs
    an initialized process group of exactly ``prod(grid)`` ranks."""
    if len(grid) != len(axes):
        raise ValueError(f"grid {grid} must have one extent per axis {axes}")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(see repro_torch.dist.spawn.run_spmd)")
    n = math.prod(grid)
    if n != dist.get_world_size():
        raise ValueError(f"grid {grid} needs {n} ranks, the process group "
                         f"has {dist.get_world_size()}")
    device = resolve_device(device)
    return init_device_mesh(device.type, tuple(grid),
                            mesh_dim_names=tuple(axes))


def mesh_view(mesh: DeviceMesh, grid, axes) -> DeviceMesh:
    """The same ranks, in the same order, reshaped onto other axes."""
    return DeviceMesh(mesh.device_type, mesh.mesh.reshape(tuple(grid)),
                      mesh_dim_names=tuple(axes))


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    # mesh.shape, not mesh.mesh.shape: DeviceMesh may rebuild its mesh
    # tensor on every .mesh access, and this runs hundreds of times per
    # forward
    return mesh.shape[mesh.mesh_dim_names.index(axis)]


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate along ``axis``."""
    return mesh.get_coordinate()[mesh.mesh_dim_names.index(axis)]


def mesh_grid(mesh: DeviceMesh, axes) -> tuple:
    return tuple(axis_size(mesh, a) for a in axes)


def _spec_axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def shard(t: torch.Tensor, mesh: DeviceMesh, spec) -> torch.Tensor:
    """This rank's block of ``t`` under ``spec``, what ``shard_map``'s
    ``in_specs`` hand each device: one entry per dim -- ``None``
    (replicated), an axis name, or a tuple of axis names, major first
    (``("c", "k")`` makes block ``c * Pk + k``)."""
    for dim, entry in enumerate(spec):
        parts, idx = 1, 0
        for a in _spec_axes(entry):
            idx = idx * axis_size(mesh, a) + axis_index(mesh, a)
            parts *= axis_size(mesh, a)
        if t.shape[dim] % parts:
            raise ValueError(f"dim {dim} of extent {t.shape[dim]} does not "
                             f"split into {parts} blocks ({entry})")
        size = t.shape[dim] // parts
        t = t.narrow(dim, idx * size, size)
    return t.contiguous()


def unshard(t: torch.Tensor, mesh: DeviceMesh, spec, *,
            tag: str = "reshard") -> torch.Tensor:
    """Inverse of :func:`shard`: all-gather the blocks back into the
    global tensor on every rank (minor axes first)."""
    for dim, entry in enumerate(spec):
        for a in reversed(_spec_axes(entry)):
            if axis_size(mesh, a) > 1:
                t = all_gather(t, mesh, a, dim=dim, tag=tag)
    return t


# --------------------------------------------------------------------------
# Accounted collective wrappers
# --------------------------------------------------------------------------

def ppermute(x: torch.Tensor, mesh: DeviceMesh, axis: str, perm, *,
             tag: str = "") -> torch.Tensor:
    """Send ``x`` along the ``(src, dst)`` pairs of ``perm`` (axis
    coordinates); returns what this rank received, zeros where no pair
    targets it -- JAX's zero fill.  Only ranks named in ``perm`` post a
    send or a receive, so a partial permutation is safe."""
    _note("collective-permute", axis, tag, x.numel())
    me = axis_index(mesh, axis)
    group = mesh.get_group(axis)
    x = x.contiguous()
    out = torch.zeros_like(x)
    ops = [dist.P2POp(dist.isend, x, dist.get_global_rank(group, d), group)
           for s, d in perm if s == me]
    ops += [dist.P2POp(dist.irecv, out, dist.get_global_rank(group, s),
                       group)
            for s, d in perm if d == me]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


def psum(x: torch.Tensor, mesh: DeviceMesh, axis: str, *,
         tag: str = "") -> torch.Tensor:
    """All-reduce (sum) over one mesh axis; returns a new tensor."""
    g = axis_size(mesh, axis)
    _note("all-reduce", axis, tag, 2.0 * x.numel() * (g - 1) / g)
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=mesh.get_group(axis))
    return out


def all_gather(x: torch.Tensor, mesh: DeviceMesh, axis: str, *, dim: int,
               tag: str = "") -> torch.Tensor:
    """Shards of every rank on ``axis`` concatenated along ``dim`` in
    axis order (``lax.all_gather(..., tiled=True)``)."""
    g = axis_size(mesh, axis)
    _note("all-gather", axis, tag, x.numel() * (g - 1))
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(g)]
    dist.all_gather(parts, x, group=mesh.get_group(axis))
    return torch.cat(parts, dim=dim)


# --------------------------------------------------------------------------
# Ring schedules
# --------------------------------------------------------------------------

def ring_reduce(x, mesh: DeviceMesh, axis: str, body, init):
    """Rotate shards of ``x`` around the ``axis`` ring and fold them:
    ``acc = body(acc, src, shard)`` once per rank, where ``src`` is the
    coordinate whose shard has just arrived.  One rotating buffer is live
    at a time."""
    g = axis_size(mesh, axis)
    me = axis_index(mesh, axis)
    perm = [(i, (i + 1) % g) for i in range(g)]
    acc = body(init, me, x)
    cur = x
    for step in range(1, g):
        cur = ppermute(cur, mesh, axis, perm, tag="ring_reduce")
        acc = body(acc, (me - step) % g, cur)
    return acc


def ring_zip(a, axis_a: str, b, axis_b: str, mesh: DeviceMesh, body,
             init=None):
    """Rotate ``a`` around ``axis_a`` and ``b`` around ``axis_b`` in
    lockstep and fold the co-resident pieces:

        acc = body(acc, step, src_a, cur_a, src_b, cur_b)

    once per step for ``max(ga, gb)`` steps.  A ring of size 1 never
    rotates.  Ring sizes must be equal or trivial: with ``1 < ga < gb``
    the shorter ring would stop mid-zip and ``src`` would no longer name
    the resident piece."""
    ga, gb = axis_size(mesh, axis_a), axis_size(mesh, axis_b)
    if not (ga == gb or ga == 1 or gb == 1):
        raise ValueError(f"ring_zip needs equal or trivial ring sizes, "
                         f"got {ga} x {gb}")
    ia, ib = axis_index(mesh, axis_a), axis_index(mesh, axis_b)
    perm_a = [(i, (i + 1) % ga) for i in range(ga)]
    perm_b = [(i, (i + 1) % gb) for i in range(gb)]
    steps = max(ga, gb)
    cur_a, cur_b, acc = a, b, init
    for t in range(steps):
        acc = body(acc, t, (ia - t) % ga, cur_a, (ib - t) % gb, cur_b)
        if t < steps - 1:
            if t < ga - 1:
                cur_a = ppermute(cur_a, mesh, axis_a, perm_a, tag="ring_zip")
            if t < gb - 1:
                cur_b = ppermute(cur_b, mesh, axis_b, perm_b, tag="ring_zip")
    return acc


def stream_elems(g: int, unit: float) -> float:
    """Transient footprint model of a ring stream: the in-flight piece
    plus the receive buffer (one piece when the ring is a single hop).
    Shared by the conv/matmul peak-live accounting."""
    return min(2, g - 1) * unit if g > 1 else 0.0


def ring_all_gather(x, mesh: DeviceMesh, axis: str, *, dim: int):
    """All-gather ``x`` over ``axis`` via a neighbour ring."""
    g = axis_size(mesh, axis)
    if g == 1:
        return x
    chunk = x.shape[dim]
    shape = list(x.shape)
    shape[dim] = chunk * g

    def place(acc, src, shard):
        acc.narrow(dim, src * chunk, chunk).copy_(shard)
        return acc

    return ring_reduce(x, mesh, axis, place,
                       torch.empty(shape, dtype=x.dtype, device=x.device))


def gather_axis(x, mesh: DeviceMesh, axis: str, *, dim: int, schedule: str):
    """Dispatch between the collective and ring gathers."""
    if schedule not in SCHEDULES:
        raise ValueError(f"schedule must be one of {SCHEDULES}, "
                         f"got {schedule!r}")
    if schedule in ("ring", "ring2"):
        return ring_all_gather(x, mesh, axis, dim=dim)
    return all_gather(x, mesh, axis, dim=dim, tag="gather_axis")
