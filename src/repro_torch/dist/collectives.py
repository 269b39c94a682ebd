"""Accounted collectives and ring schedules -- the port of
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
all-gather ``shard * (g - 1)``, a reduce-scatter ``v * (g - 1) / g``, an
all-reduce ``2 * v * (g - 1) / g``, over the group of every axis named.

Gradients.  The ops' custom backward passes are written out
(``dist.conv2d``, ``dist.matmul``, ``dist.halo``); between ops, the
glue's collectives differentiate by one convention: a tensor replicated
over ranks has its complete cotangent on every rank.  So :func:`psum`'s
backward is the identity, :func:`unshard` (an all-gather) transposes to a
slice, and :func:`shard` of a replicated tensor transposes to a gather of
the gradient shards (after a psum over the axes whose ranks each hold
only a partial sum, when the caller names them).

The ops' native differentiation (``save_gathered=True``) runs autograd
through the forward schedule itself, so the collectives it calls carry
their own transposes, as JAX's do: :func:`ppermute` transposes to the
inverse permutation (zeros where no pair targets a rank), so the rings
built on it (:func:`ring_reduce`, :func:`ring_zip`,
:func:`ring_all_gather`) differentiate through it; :func:`all_gather`
transposes to :func:`psum_scatter`; :func:`psum_native` all-reduces
its cotangent (JAX's transpose of a psum whose result leaves the op
replicated); :func:`pvary` is the identity whose transpose psums the
cotangent (a rank-invariant operand meeting rank-varying ones).  Each
records its backward wire under ``bwd_tag``, the name of the term of
``*_train_comm_elems`` it pays.  These forms take the autograd path only
when their input requires grad with grad mode on, which never holds
inside the custom backward passes' Functions.
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.device import resolve_device

SCHEDULES = ("allgather", "ring", "ring2")


class CollectiveNote(NamedTuple):
    """One collective: its kind, the mesh axes it runs over, the call-site
    tag (which primitive emitted it), its per-rank wire elements, the
    bytes of one element (``wire_elems * itemsize`` is its wire bytes)
    and, for a permute, its ``(src, dst)`` pairs in axis coordinates (the
    static verifier's ring and deadlock lints read them)."""

    kind: str             # all-reduce | all-gather | collective-permute
    axes: Tuple[str, ...]
    tag: str
    wire_elems: float
    itemsize: int = 4
    pairs: Optional[Tuple[Tuple[int, int], ...]] = None


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


_SCOPES: list = []


@contextlib.contextmanager
def note_scope(name: str):
    """Prefix ``name + ":"`` to the tag of every note recorded inside (an
    empty name adds nothing), so a caller can attribute an op's notes:
    ``dist.lm`` scopes each routed projection by its parameter name."""
    _SCOPES.append(name)
    try:
        yield
    finally:
        _SCOPES.pop()


def _note(kind: str, axes, tag: str, wire_elems: float,
          itemsize: int = 4, pairs=None) -> None:
    if _RECORD_STACK:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        tag = ":".join([s for s in _SCOPES if s] + [tag])
        if pairs is not None:
            pairs = tuple((int(s), int(d)) for s, d in pairs)
        _RECORD_STACK[-1].append(
            CollectiveNote(kind, axes, tag, float(wire_elems), itemsize,
                           pairs))


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


def _mesh_axes(mesh: DeviceMesh) -> dict:
    """``{axis: (extent, this rank's coordinate)}``, read once per mesh
    object: DeviceMesh recomputes its shape and this rank's coordinate on
    every access, and these are read tens of times per distributed op (a
    served decode step runs hundreds of ops).  Kept on the mesh object
    itself (meshes compare equal by layout alone, whatever the process
    group behind them), so it goes away with its mesh."""
    axes = mesh.__dict__.get("_repro_axes")
    if axes is None:
        coord = mesh.get_coordinate()
        axes = {a: (mesh.shape[i], coord[i])
                for i, a in enumerate(mesh.mesh_dim_names)}
        mesh._repro_axes = axes
    return axes


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return _mesh_axes(mesh)[axis][0]


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate along ``axis``."""
    return _mesh_axes(mesh)[axis][1]


def mesh_grid(mesh: DeviceMesh, axes) -> tuple:
    return tuple(axis_size(mesh, a) for a in axes)


def _spec_axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _slice(t: torch.Tensor, mesh: DeviceMesh, spec) -> torch.Tensor:
    for dim, entry in enumerate(spec):
        parts, idx = 1, 0
        for a in _spec_axes(entry):
            idx = idx * axis_size(mesh, a) + axis_index(mesh, a)
            parts *= axis_size(mesh, a)
        if parts == 1:
            continue
        if t.shape[dim] % parts:
            raise ValueError(f"dim {dim} of extent {t.shape[dim]} does not "
                             f"split into {parts} blocks ({entry})")
        size = t.shape[dim] // parts
        t = t.narrow(dim, idx * size, size)
    return t.contiguous()


def _gather(t: torch.Tensor, mesh: DeviceMesh, spec, tag: str):
    for dim, entry in enumerate(spec):
        for a in reversed(_spec_axes(entry)):
            if axis_size(mesh, a) > 1:
                t = all_gather(t, mesh, a, dim=dim, tag=tag)
    return t


class _Shard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, spec, grad_psum_axes, bwd_tag):
        ctx.mesh, ctx.spec, ctx.axes = mesh, spec, grad_psum_axes
        ctx.bwd_tag = bwd_tag
        return _slice(t, mesh, spec)

    @staticmethod
    def backward(ctx, g):
        if ctx.axes:
            g = psum(g, ctx.mesh, ctx.axes, tag=ctx.bwd_tag)
        return (_gather(g, ctx.mesh, ctx.spec, ctx.bwd_tag),
                None, None, None, None)


class _Unshard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, spec, tag):
        ctx.mesh, ctx.spec = mesh, spec
        return _gather(t, mesh, spec, tag)

    @staticmethod
    def backward(ctx, g):
        return _slice(g, ctx.mesh, ctx.spec), None, None, None


def shard(t: torch.Tensor, mesh: DeviceMesh, spec, *,
          grad_psum_axes=(), bwd_tag: str = "reshard") -> torch.Tensor:
    """This rank's block of ``t`` under ``spec``, what ``shard_map``'s
    ``in_specs`` hand each device: one entry per dim -- ``None``
    (replicated), an axis name, or a tuple of axis names, major first
    (``("c", "k")`` makes block ``c * Pk + k``).

    Differentiable for a replicated ``t``: the gradient shards are
    gathered (tag ``bwd_tag``, ``"reshard"`` by default) so every rank
    holds the complete gradient, after a psum over ``grad_psum_axes`` when
    each rank of those axes holds only a partial sum of its shard's
    gradient."""
    if torch.is_grad_enabled() and t.requires_grad:
        return _Shard.apply(t, mesh, spec, tuple(grad_psum_axes), bwd_tag)
    return _slice(t, mesh, spec)


def unshard(t: torch.Tensor, mesh: DeviceMesh, spec, *,
            tag: str = "reshard") -> torch.Tensor:
    """Inverse of :func:`shard`: all-gather the blocks back into the
    global tensor on every rank (minor axes first).  Differentiable: the
    backward slices this rank's block of the (complete) cotangent."""
    if torch.is_grad_enabled() and t.requires_grad:
        return _Unshard.apply(t, mesh, spec, tag)
    return _gather(t, mesh, spec, tag)


# --------------------------------------------------------------------------
# Accounted collective wrappers
# --------------------------------------------------------------------------

class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, perm, tag, bwd_tag):
        ctx.args = (mesh, axis, [(d, s) for s, d in perm], bwd_tag)
        return _ppermute(x, mesh, axis, perm, tag)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, inverse, bwd_tag = ctx.args
        return (_ppermute(g, mesh, axis, inverse, bwd_tag),
                None, None, None, None, None)


def ppermute(x: torch.Tensor, mesh: DeviceMesh, axis: str, perm, *,
             tag: str = "", bwd_tag: str = "") -> torch.Tensor:
    """Send ``x`` along the ``(src, dst)`` pairs of ``perm`` (axis
    coordinates); returns what this rank received, zeros where no pair
    targets it -- JAX's zero fill.  Only ranks named in ``perm`` post a
    send or a receive, so a partial permutation is safe.
    Differentiable: the backward sends the cotangent along the inverted
    pairs (tag ``bwd_tag``)."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _Ppermute.apply(x, mesh, axis, perm, tag, bwd_tag)
    return _ppermute(x, mesh, axis, perm, tag)


def _ppermute(x, mesh, axis, perm, tag):
    _note("collective-permute", axis, tag, x.numel(), x.element_size(),
          perm)
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


@functools.lru_cache(maxsize=None)
def _axes_group(mesh: DeviceMesh, axes: tuple):
    """The process group over the mesh axes ``axes`` that holds this rank.
    For several axes every rank must reach this at the same point the
    first time (it creates the subgroups of every rank)."""
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    names = list(mesh.mesh_dim_names)
    ranks = mesh.mesh.permute(
        [i for i, a in enumerate(names) if a not in axes]
        + [names.index(a) for a in axes])
    size = math.prod(axis_size(mesh, a) for a in axes)
    group, _ = dist.new_subgroups_by_enumeration(
        ranks.reshape(-1, size).tolist())
    return group


def _live_axes(mesh: DeviceMesh, axes) -> tuple:
    """``axes`` (one name or several), without those of size 1."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    return tuple(a for a in axes if axis_size(mesh, a) > 1)


def _psum(x, mesh, axes, tag):
    g = math.prod(axis_size(mesh, a) for a in axes)
    _note("all-reduce", axes, tag, 2.0 * x.numel() * (g - 1) / g,
          x.element_size())
    out = x.detach().clone(memory_format=torch.contiguous_format)
    live = _live_axes(mesh, axes)
    if live:
        dist.all_reduce(out, group=_axes_group(mesh, live))
    return out


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, tag):
        return _psum(x, mesh, axes, tag)

    @staticmethod
    def backward(ctx, g):
        # the sum is replicated over the axes: each rank's cotangent is
        # complete and is its partial's cotangent too
        return g, None, None, None


def psum(x: torch.Tensor, mesh: DeviceMesh, axes, *,
         tag: str = "") -> torch.Tensor:
    """All-reduce (sum) over one mesh axis or a tuple of them; returns a
    new tensor.  Differentiable (identity backward, see the module
    docstring)."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    if torch.is_grad_enabled() and x.requires_grad:
        return _Psum.apply(x, mesh, axes, tag)
    return _psum(x, mesh, axes, tag)


class _PsumNative(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, tag, bwd_tag):
        ctx.args = (mesh, axes, bwd_tag)
        return _psum(x, mesh, axes, tag)

    @staticmethod
    def backward(ctx, g):
        mesh, axes, bwd_tag = ctx.args
        size = math.prod(axis_size(mesh, a) for a in axes)
        return _psum(g, mesh, axes, bwd_tag) / size, None, None, None, None


def psum_native(x: torch.Tensor, mesh: DeviceMesh, axes, *, tag: str = "",
                bwd_tag: str = "") -> torch.Tensor:
    """All-reduce (sum) over ``axes`` whose backward all-reduces the
    cotangent too (tag ``bwd_tag``): the transpose JAX's native
    differentiation takes for the partial-sum reduction at the end of an
    op whose output is replicated over ``axes``.  JAX divides the
    replicated output's cotangent by the axes' size at the op boundary
    and transposes the psum to a psum; here the cotangent arrives
    complete on every rank (the module's convention), so the backward is
    that psum over the size -- the same arithmetic and the same wire."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    if torch.is_grad_enabled() and x.requires_grad:
        return _PsumNative.apply(x, mesh, axes, tag, bwd_tag)
    return _psum(x, mesh, axes, tag)


class _Pvary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, bwd_tag):
        ctx.args = (mesh, axes, bwd_tag)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        mesh, axes, bwd_tag = ctx.args
        return _psum(g, mesh, axes, bwd_tag), None, None, None


def pvary(x: torch.Tensor, mesh: DeviceMesh, axes, *,
          bwd_tag: str = "") -> torch.Tensor:
    """The identity, whose backward all-reduces the cotangent over
    ``axes`` (tag ``bwd_tag``): ``x`` is the same on every rank of those
    axes and each rank's use of it contributes part of its gradient --
    JAX's ``pvary``, and its ``shard_map``'s psum of an input cotangent
    over the mesh axes the input's spec leaves out."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    if torch.is_grad_enabled() and x.requires_grad and \
            _live_axes(mesh, axes):
        return _Pvary.apply(x, mesh, axes, bwd_tag)
    return x


def pmean(x: torch.Tensor, mesh: DeviceMesh, axes, *,
          tag: str = "") -> torch.Tensor:
    """All-reduce mean over one mesh axis or a tuple of them."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    return psum(x, mesh, axes, tag=tag) / math.prod(
        axis_size(mesh, a) for a in axes)


def world_size() -> int:
    """Ranks in the default process group; 1 when there is none."""
    return dist.get_world_size() if dist.is_initialized() else 1


def world_rank() -> int:
    """This rank in the default process group; 0 when there is none."""
    return dist.get_rank() if dist.is_initialized() else 0


def any_rank(flag: bool, *, device=None, tag: str = "stop_vote") -> bool:
    """True on every rank when ``flag`` is true on any rank: a one-int max
    all-reduce over the default process group (on ``device``, which must
    be a card under nccl), recorded under ``tag``.  It is control, not
    part of any op, so no analytic count includes it.  A world of one
    (or no process group) returns ``flag`` without a collective."""
    g = world_size()
    if g == 1:
        return bool(flag)
    _note("all-reduce", ("world",), tag, 2.0 * (g - 1) / g)
    t = torch.tensor([int(bool(flag))], dtype=torch.int32,
                     device=torch.device("cpu" if device is None else device))
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def psum_scatter(x: torch.Tensor, mesh: DeviceMesh, axis: str, *, dim: int,
                 tag: str = "") -> torch.Tensor:
    """Reduce-scatter over one axis: chunk ``r`` (in axis order along
    ``dim``) of the sum over the axis' ranks ends on rank ``r``
    (``lax.psum_scatter(..., tiled=True)``).  Gloo has no reduce-scatter,
    so there it runs as an all-reduce and a slice; the note records the
    reduce-scatter the schedule calls for."""
    g = axis_size(mesh, axis)
    if x.shape[dim] % g:
        raise ValueError(f"reduce-scatter dim {dim} of extent "
                         f"{x.shape[dim]} not divisible by axis size {g}")
    _note("reduce-scatter", axis, tag, x.numel() * (g - 1) / g,
          x.element_size())
    group = mesh.get_group(axis)
    chunk = x.shape[dim] // g
    if dist.get_backend(group) == "nccl":
        full = x.movedim(dim, 0).contiguous()
        out = torch.empty((chunk,) + tuple(full.shape[1:]), dtype=x.dtype,
                          device=x.device)
        dist.reduce_scatter_tensor(out, full, group=group)
        return out.movedim(0, dim).contiguous()
    full = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(full, group=group)
    return full.narrow(dim, axis_index(mesh, axis) * chunk,
                       chunk).contiguous()


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim, tag, bwd_tag):
        ctx.args = (mesh, axis, dim, bwd_tag)
        return _all_gather(x, mesh, axis, dim, tag)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, dim, bwd_tag = ctx.args
        return (psum_scatter(g, mesh, axis, dim=dim, tag=bwd_tag),
                None, None, None, None, None)


def all_gather(x: torch.Tensor, mesh: DeviceMesh, axis: str, *, dim: int,
               tag: str = "", bwd_tag: str = "") -> torch.Tensor:
    """Shards of every rank on ``axis`` concatenated along ``dim`` in
    axis order (``lax.all_gather(..., tiled=True)``).  Differentiable:
    the backward reduce-scatters the cotangent (:func:`psum_scatter`,
    tag ``bwd_tag``)."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _AllGather.apply(x, mesh, axis, dim, tag, bwd_tag)
    return _all_gather(x, mesh, axis, dim, tag)


def _all_gather(x, mesh, axis, dim, tag):
    g = axis_size(mesh, axis)
    _note("all-gather", axis, tag, x.numel() * (g - 1), x.element_size())
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(g)]
    dist.all_gather(parts, x, group=mesh.get_group(axis))
    return torch.cat(parts, dim=dim)


# --------------------------------------------------------------------------
# Ring schedules
# --------------------------------------------------------------------------

def ring_reduce(x, mesh: DeviceMesh, axis: str, body, init, *,
                bwd_tag: str = ""):
    """Rotate shards of ``x`` around the ``axis`` ring and fold them:
    ``acc = body(acc, src, shard)`` once per rank, where ``src`` is the
    coordinate whose shard has just arrived.  One rotating buffer is live
    at a time.  Differentiable through :func:`ppermute` (backward tag
    ``bwd_tag``)."""
    g = axis_size(mesh, axis)
    me = axis_index(mesh, axis)
    perm = [(i, (i + 1) % g) for i in range(g)]
    acc = body(init, me, x)
    cur = x
    for step in range(1, g):
        cur = ppermute(cur, mesh, axis, perm, tag="ring_reduce",
                       bwd_tag=bwd_tag)
        acc = body(acc, (me - step) % g, cur)
    return acc


def ring_zip(a, axis_a: str, b, axis_b: str, mesh: DeviceMesh, body,
             init=None, *, bwd_tags=("", "")):
    """Rotate ``a`` around ``axis_a`` and ``b`` around ``axis_b`` in
    lockstep and fold the co-resident pieces:

        acc = body(acc, step, src_a, cur_a, src_b, cur_b)

    once per step for ``max(ga, gb)`` steps.  A ring of size 1 never
    rotates.  Ring sizes must be equal or trivial: with ``1 < ga < gb``
    the shorter ring would stop mid-zip and ``src`` would no longer name
    the resident piece.  Differentiable through :func:`ppermute`
    (backward tags ``bwd_tags`` for ``a`` and ``b``)."""
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
                cur_a = ppermute(cur_a, mesh, axis_a, perm_a,
                                 tag="ring_zip", bwd_tag=bwd_tags[0])
            if t < gb - 1:
                cur_b = ppermute(cur_b, mesh, axis_b, perm_b,
                                 tag="ring_zip", bwd_tag=bwd_tags[1])
    return acc


def stream_elems(g: int, unit: float) -> float:
    """Transient footprint model of a ring stream: the in-flight piece
    plus the receive buffer (one piece when the ring is a single hop).
    Shared by the conv/matmul peak-live accounting."""
    return min(2, g - 1) * unit if g > 1 else 0.0


def ring_all_gather(x, mesh: DeviceMesh, axis: str, *, dim: int,
                    bwd_tag: str = ""):
    """All-gather ``x`` over ``axis`` via a neighbour ring;
    differentiable (its backward is a ring reduce-scatter by the inverse
    permutations, tag ``bwd_tag``)."""
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
                       torch.empty(shape, dtype=x.dtype, device=x.device),
                       bwd_tag=bwd_tag)


def gather_axis(x, mesh: DeviceMesh, axis: str, *, dim: int, schedule: str,
                bwd_tag: str = ""):
    """Dispatch between the collective and ring gathers (both
    differentiable, backward tag ``bwd_tag``)."""
    if schedule not in SCHEDULES:
        raise ValueError(f"schedule must be one of {SCHEDULES}, "
                         f"got {schedule!r}")
    if schedule in ("ring", "ring2"):
        return ring_all_gather(x, mesh, axis, dim=dim, bwd_tag=bwd_tag)
    return all_gather(x, mesh, axis, dim=dim, tag="gather_axis",
                      bwd_tag=bwd_tag)


def ring_scatter_reduce(mesh: DeviceMesh, axis: str, produce):
    """Ring reduce-scatter with on-the-fly chunk production -- the
    transpose of :func:`ring_reduce`.

    ``produce(r, step)`` returns this rank's additive contribution to the
    chunk that must end on rank ``r``.  The token for chunk ``r`` starts
    on rank ``r + 1`` and travels the whole ring, gathering every rank's
    contribution, and arrives home after ``g - 1`` hops; the return value
    is the fully reduced own chunk.  Wire: ``chunk * (g - 1)`` per rank,
    without ever materializing the concatenation."""
    g = axis_size(mesh, axis)
    me = axis_index(mesh, axis)
    cur = produce((me - 1) % g, 0)
    perm = [(i, (i + 1) % g) for i in range(g)]
    for t in range(1, g):
        cur = ppermute(cur, mesh, axis, perm, tag="ring_scatter_reduce")
        cur = cur + produce((me - 1 - t) % g, t)
    return cur


def ring_reduce_scatter(x, mesh: DeviceMesh, axis: str, *, dim: int):
    """Reduce-scatter ``x`` over ``axis`` via a neighbour ring: chunk
    ``r`` of the result (rank order along ``dim``) ends on rank ``r``
    holding the sum over ranks -- the transpose of
    :func:`ring_all_gather`, at the same wire volume."""
    g = axis_size(mesh, axis)
    if g == 1:
        return x
    if x.shape[dim] % g:
        raise ValueError(f"reduce-scatter dim {dim} of extent "
                         f"{x.shape[dim]} not divisible by axis size {g}")
    chunk = x.shape[dim] // g
    me = axis_index(mesh, axis)
    perm = [(i, (i + 1) % g) for i in range(g)]
    cur = x.narrow(dim, ((me - 1) % g) * chunk, chunk)
    for t in range(1, g):
        cur = ppermute(cur, mesh, axis, perm, tag="ring_reduce_scatter")
        cur = cur + x.narrow(dim, ((me - 1 - t) % g) * chunk, chunk)
    return cur


def scatter_axis(x, mesh: DeviceMesh, axis: str, *, dim: int,
                 schedule: str):
    """Reduce-scatter over a mesh axis -- the transpose of
    :func:`gather_axis` (rank-ordered chunks along ``dim``), dispatched on
    the schedule the same way."""
    if schedule not in SCHEDULES:
        raise ValueError(f"schedule must be one of {SCHEDULES}, "
                         f"got {schedule!r}")
    if schedule in ("ring", "ring2"):
        return ring_reduce_scatter(x, mesh, axis, dim=dim)
    return psum_scatter(x, mesh, axis, dim=dim, tag="scatter_axis")
