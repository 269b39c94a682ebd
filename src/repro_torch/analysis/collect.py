"""Collective extraction: the notes every rank recorded -> attributed
collectives -- the port of ``repro/analysis/collect.py``.

The reference reads its collectives out of compiled post-SPMD HLO.  The
port issues its collectives eagerly, one ``torch.distributed`` call each,
and :func:`repro_torch.dist.collectives.record_collectives` notes every
one of them on the rank that runs it.  So the collectives of a cell are
the notes themselves: :func:`extract_collectives` lines up the i-th note
of every rank into one :class:`Collective`, maps a permute's pairs from
axis coordinates to global ranks through each rank's mesh coordinates,
and attributes each collective to the mesh axes it ran over (extent-1
axes dropped).  Ranks that recorded different sequences diverged, which
in SPMD code is a hang waiting to happen: it raises
:class:`SpmdDivergence`.

The pure helpers (axis partitions, orbits) are the reference's.  This
module imports neither torch nor jax: notes may be the port's
``CollectiveNote`` or plain tuples of its fields.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

MeshAxes = Tuple[Tuple[str, int], ...]  # ordered (name, extent) pairs

PERMUTE = "collective-permute"


def normalize_mesh_axes(mesh_axes) -> MeshAxes:
    """Accept a ``Mesh.shape`` dict (insertion-ordered) or a sequence of
    ``(name, extent)`` pairs; return the canonical tuple form."""
    if isinstance(mesh_axes, dict):
        return tuple(mesh_axes.items())
    return tuple((str(n), int(s)) for n, s in mesh_axes)


def axis_groups(mesh_axes, subset: Sequence[str]) -> frozenset:
    """Device-id partition induced by an axis subset of the row-major
    mesh: one group per assignment of the *other* axes' coordinates —
    the replica groups a collective over ``subset`` runs on.  Returned
    as a ``frozenset`` of ``frozenset`` so partitions compare by value
    regardless of group or member order."""
    axes = normalize_mesh_axes(mesh_axes)
    names = [n for n, _ in axes]
    sizes = [s for _, s in axes]
    sub = set(subset)
    unknown = sub - set(names)
    if unknown:
        raise ValueError(f"axes {sorted(unknown)} not in mesh {names}")
    strides = [1] * len(sizes)
    for i in range(len(sizes) - 2, -1, -1):
        strides[i] = strides[i + 1] * sizes[i + 1]
    keep = [i for i, n in enumerate(names) if n not in sub]
    take = [i for i, n in enumerate(names) if n in sub]
    groups = []
    for outer in range(math.prod(sizes[i] for i in keep) or 1):
        base, rem = 0, outer
        for i in keep:
            base += (rem // math.prod(sizes[j] for j in keep
                                      if j > i) % sizes[i]) * strides[i]
        members = []
        for inner in range(math.prod(sizes[i] for i in take) or 1):
            dev, rem = base, inner
            for i in take:
                dev += (rem // math.prod(sizes[j] for j in take
                                         if j > i) % sizes[i]) * strides[i]
            members.append(dev)
        groups.append(frozenset(members))
    return frozenset(groups)


def effective_axes(mesh_axes, subset: Sequence[str]) -> Tuple[str, ...]:
    """The axis subset with extent-1 axes dropped (they do not change
    the induced partition), in mesh order — the canonical attribution."""
    axes = normalize_mesh_axes(mesh_axes)
    sub = set(subset)
    return tuple(n for n, s in axes if n in sub and s > 1)


def _nontrivial_subsets(mesh_axes):
    """All non-empty subsets of the extent>1 axes, smallest group first
    (mesh order within equal sizes), paired with their partitions."""
    axes = [(n, s) for n, s in normalize_mesh_axes(mesh_axes) if s > 1]
    names = [n for n, _ in axes]
    out = []
    for mask in range(1, 1 << len(names)):
        sub = tuple(n for i, n in enumerate(names) if mask >> i & 1)
        size = math.prod(s for n, s in axes if n in sub)
        out.append((size, sub))
    out.sort(key=lambda t: (t[0], t[1]))
    return [sub for _, sub in out]


def orbits(pairs: Sequence[Tuple[int, int]]) -> Tuple[frozenset, ...]:
    """Weakly-connected components of a ppermute's source-target pairs —
    the device sets that exchange data with each other."""
    parent: Dict[int, int] = {}

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    for s, t in pairs:
        parent.setdefault(s, s)
        parent.setdefault(t, t)
        parent[find(s)] = find(t)
    comps: Dict[int, set] = {}
    for d in parent:
        comps.setdefault(find(d), set()).add(d)
    return tuple(frozenset(c) for c in comps.values())


@dataclasses.dataclass(frozen=True)
class Collective:
    """One collective of a cell, as every rank ran it, with mesh-axis
    attribution.  ``name`` is the call-site tag of its notes (scoped
    ``<scope>:<tag>``), ``comp`` its place in the ranks' sequences; the
    port runs no loops it does not unroll, so ``mult`` is 1."""

    kind: str                       # all-reduce | all-gather | ...
    name: str                       # the notes' tag
    comp: str                       # "note <i>": position in the sequence
    mult: float                     # enclosing while-loop trip product
    result_bytes: int               # bytes of the op's result, per rank
    wire_bytes: float               # ring-model wire x mult (per device)
    group_size: int
    axes: Optional[Tuple[str, ...]]           # attributed axes, or None
    groups: Optional[frozenset]     # replica groups / ppermute orbits
    pairs: Optional[Tuple[Tuple[int, int], ...]]  # ppermute only, global

    @property
    def is_trivial(self) -> bool:
        """Degenerate collective (group size 1, e.g. over an extent-1
        axis): moves no bytes, exempt from attribution."""
        return self.group_size <= 1


class SpmdDivergence(ValueError):
    """The ranks of one SPMD program recorded different collectives."""


def note_fields(note) -> tuple:
    """``(kind, axes, tag, wire_elems, itemsize, pairs)`` of a note, a
    ``CollectiveNote`` or a plain tuple of its fields."""
    kind, axes, tag = note[0], note[1], note[2]
    wire = note[3] if len(note) > 3 else 0.0
    itemsize = note[4] if len(note) > 4 else 4
    pairs = note[5] if len(note) > 5 else None
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    if pairs is not None:
        pairs = tuple((int(s), int(d)) for s, d in pairs)
    return (str(kind), axes, str(tag), float(wire), int(itemsize), pairs)


def _coords(coords, names) -> tuple:
    if isinstance(coords, dict):
        return tuple(int(coords[n]) for n in names)
    return tuple(int(c) for c in coords)


def _result_elems(kind: str, wire: float, g: int) -> float:
    """The result's elements, from the note's wire model (the inverse of
    ``collectives``' per-kind formulas)."""
    if kind == PERMUTE:
        return wire
    if g <= 1:
        return 0.0
    if kind == "all-reduce":
        return wire * g / (2.0 * (g - 1))
    if kind == "reduce-scatter":
        return wire / (g - 1)
    return wire * g / (g - 1)       # all-gather: the gathered buffer


def _global_pairs(pairs, axis: str, names, coords, rank_of):
    """A permute's ``(src, dst)`` axis-coordinate pairs as global-rank
    pairs: each rank sends along the pairs whose source is its own
    coordinate on ``axis``, to the rank whose coordinates differ from its
    own on ``axis`` alone."""
    i = names.index(axis)
    out = []
    for rank, c in enumerate(coords):
        for s, d in pairs:
            if s == c[i]:
                dst = c[:i] + (d,) + c[i + 1:]
                if dst not in rank_of:
                    raise ValueError(f"pair ({s}, {d}) leaves axis {axis!r}")
                out.append((rank, rank_of[dst]))
    return tuple(sorted(out))


def extract_collectives(notes_by_rank: Sequence[Sequence],
                        mesh_axes, coords_by_rank: Sequence
                        ) -> Tuple[Collective, ...]:
    """Every collective of one SPMD run, with mesh-axis attribution.

    ``notes_by_rank[r]`` is what rank ``r`` recorded under
    ``record_collectives()``; ``coords_by_rank[r]`` its mesh coordinates
    (a dict by axis name, or a tuple in mesh order); ``mesh_axes`` the
    mesh's ``(name, extent)`` pairs in mesh order, ranks row-major over
    them as ``collectives.make_mesh`` lays them out.  The i-th notes of
    all ranks must agree in kind, axes, tag, wire, item size and pairs;
    otherwise :class:`SpmdDivergence` is raised naming the first
    difference."""
    mesh_axes = normalize_mesh_axes(mesh_axes)
    names = [n for n, _ in mesh_axes]
    extents = dict(mesh_axes)
    n_ranks = math.prod(extents.values())
    if len(notes_by_rank) != n_ranks or len(coords_by_rank) != n_ranks:
        raise ValueError(f"mesh {mesh_axes} has {n_ranks} ranks; got notes "
                         f"of {len(notes_by_rank)} and coordinates of "
                         f"{len(coords_by_rank)}")
    coords = [_coords(c, names) for c in coords_by_rank]
    rank_of = {c: r for r, c in enumerate(coords)}
    if len(rank_of) != n_ranks:
        raise ValueError("two ranks report the same mesh coordinates")
    seqs = [[note_fields(n) for n in notes] for notes in notes_by_rank]
    for r, seq in enumerate(seqs[1:], 1):
        if len(seq) != len(seqs[0]):
            raise SpmdDivergence(
                f"rank {r} recorded {len(seq)} collectives, rank 0 "
                f"{len(seqs[0])}")
    out = []
    for i, recs in enumerate(zip(*seqs)):
        first = recs[0]
        for r, rec in enumerate(recs[1:], 1):
            if rec != first:
                raise SpmdDivergence(f"collective {i}: rank {r} recorded "
                                     f"{rec}, rank 0 {first}")
        kind, axes, tag, wire, itemsize, pairs = first
        unknown = set(axes) - set(names)
        if unknown:
            raise ValueError(f"collective {i} ({tag}) runs over axes "
                             f"{sorted(unknown)} not in mesh {names}")
        eff = effective_axes(mesh_axes, axes)
        g = math.prod(extents[a] for a in axes)
        groups = axis_groups(mesh_axes, axes)
        gpairs = None
        if kind == PERMUTE and pairs is not None:
            if len(axes) != 1:
                raise ValueError(f"permute {i} ({tag}) names axes {axes}")
            gpairs = _global_pairs(pairs, axes[0], names, coords, rank_of)
            obs = orbits(gpairs)
            fits = all(any(o <= grp for grp in groups) for o in obs)
            attributed = eff if fits else None
            groups, g = obs, max((len(o) for o in obs), default=1)
        else:
            attributed = eff
        out.append(Collective(
            kind=kind, name=tag, comp=f"note {i}", mult=1.0,
            result_bytes=int(round(_result_elems(kind, wire, g) * itemsize)),
            wire_bytes=wire * itemsize, group_size=g, axes=attributed,
            groups=groups, pairs=gpairs))
    return tuple(out)
