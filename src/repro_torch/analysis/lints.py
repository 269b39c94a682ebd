"""Lint passes over extracted collectives: deadlock/ring structure,
gathered-footprint, accounting drift, and note-vs-accounting attribution
-- the port of ``repro/analysis/lints.py``.

Each pass returns a list of :class:`Finding`; an empty list is a clean
pass.  ``severity`` is ``"error"`` for violated invariants and
``"warning"`` for suspicious-but-legal structure.  The deadlock,
footprint and wire passes are the reference's, with its messages.
:func:`lint_attribution` takes the port's meaning: the reference holds
trace-time notes against compiled IR, but here the notes *are* the
collectives that ran, so it holds them against the analytic breakdown
of ``*_comm_elems`` / ``*_train_comm_elems``, term by term, by the axes
each term is paid on.

This module imports neither torch nor jax.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

from repro_torch.analysis.collect import (Collective, axis_groups,
                                          effective_axes,
                                          normalize_mesh_axes, note_fields)

#: Call-site tags of the ring primitives (``repro_torch.dist.collectives``)
#: whose ppermutes promise a *total* rotation of their ring: every rank
#: sends and receives exactly once per hop.  Partial shifts (halo
#: exchange, pipeline stage handoff) are legal ppermutes but must never
#: appear under these tags.  ``note_scope`` prefixes tags with
#: ``<scope>:``, so a tag is matched by its last ``:`` component.
RING_TAGS = frozenset({"ring_reduce", "ring_zip", "ring_scatter_reduce",
                       "ring_reduce_scatter"})


@dataclasses.dataclass(frozen=True)
class Finding:
    lint: str        # deadlock | footprint | wire | memory | attribution
    severity: str    # error | warning
    message: str

    def __str__(self):
        return f"[{self.severity}] {self.lint}: {self.message}"


def errors(findings: Iterable[Finding]) -> List[Finding]:
    return [f for f in findings if f.severity == "error"]


def base_tag(tag: str) -> str:
    """A note's tag without the ``note_scope`` prefixes."""
    return tag.rsplit(":", 1)[-1]


# ------------------------------------------------------------- deadlock

def _cycles(pairs: Sequence[Tuple[int, int]]):
    """Simple cycles of the (unique-source, unique-target) pair graph:
    each node has out-degree <= 1, so following successors from any node
    either terminates (open chain) or closes a cycle."""
    succ = dict(pairs)
    seen = set()
    cycles = []
    for start in succ:
        if start in seen:
            continue
        path, node = [], start
        on_path = {}
        while node in succ and node not in seen:
            on_path[node] = len(path)
            path.append(node)
            seen.add(node)
            node = succ[node]
            if node in on_path:
                cycles.append(frozenset(path[on_path[node]:]))
                break
    return cycles


def lint_deadlock(collectives: Sequence[Collective], mesh_axes,
                  notes: Optional[Sequence] = None) -> List[Finding]:
    """Ring/permutation structure of every ppermute.

    Unconditionally: sources unique, targets unique, every orbit inside
    one mesh-axis group, and any cycle must cover its *entire* axis
    group (a partial cycle starves the ranks outside it of a hop they
    are waiting on — the SPMD hang this lint exists to catch).  When
    ``notes`` (a rank's ``CollectiveNote``s, or tuples of their fields)
    declare ring ppermutes on an axis (tags in :data:`RING_TAGS`), every
    ppermute on that axis must additionally be a total bijection: one
    cycle per group, covering every group of the axis."""
    mesh_axes = normalize_mesh_axes(mesh_axes)
    out: List[Finding] = []
    ring_axes = set()
    for n in notes or ():
        kind, axes, tag = note_fields(n)[:3]
        if kind == "collective-permute" and base_tag(tag) in RING_TAGS:
            ring_axes.add(effective_axes(mesh_axes, axes))
    ring_axes.discard(())
    for c in collectives:
        if c.kind != "collective-permute" or c.pairs is None:
            continue
        where = f"ppermute {c.name} ({c.comp})"
        srcs = [s for s, _ in c.pairs]
        tgts = [t for _, t in c.pairs]
        if len(set(srcs)) != len(srcs) or len(set(tgts)) != len(tgts):
            out.append(Finding("deadlock", "error",
                               f"{where}: duplicate source or target in "
                               f"pairs {c.pairs}"))
            continue
        if c.axes is None:
            out.append(Finding("deadlock", "error",
                               f"{where}: orbits {c.groups} fit no "
                               f"mesh-axis group of {mesh_axes}"))
            continue
        groups = axis_groups(mesh_axes, c.axes)
        for cyc in _cycles(c.pairs):
            full = next((g for g in groups if cyc <= g), None)
            if full is None or cyc != full:
                out.append(Finding(
                    "deadlock", "error",
                    f"{where}: cycle over {sorted(cyc)} covers only part "
                    f"of its {'x'.join(c.axes)} group"
                    f"{sorted(full) if full else ''}"))
        if c.axes in ring_axes:
            # declared ring hop: total bijection on every group
            if set(srcs) != set(tgts):
                out.append(Finding(
                    "deadlock", "error",
                    f"{where}: ring hop on axis {'x'.join(c.axes)} is not "
                    f"a bijection (sources != targets); a rank blocks "
                    f"forever on a message no peer sends"))
                continue
            covered = {d for o in c.groups for d in o}
            missing = [sorted(g) for g in groups if not g <= covered]
            if missing:
                out.append(Finding(
                    "deadlock", "error",
                    f"{where}: ring hop on axis {'x'.join(c.axes)} skips "
                    f"groups {missing}"))
    return out


# ------------------------------------------------------------ footprint

def lint_footprint(collectives: Sequence[Collective], *,
                   schedule: str,
                   contraction_axes: Sequence[str],
                   live: Optional[float] = None,
                   analytic: Optional[float] = None,
                   mem_band: Optional[Tuple[float, float]] = None,
                   ) -> List[Finding]:
    """Slab-memory promise of the ring schedules.

    ``"ring"``/``"ring2"`` pipeline the contraction operands around
    ppermute rings, so a cell must run *no* all-gather on a contraction
    axis (one is a gathered-operand materialization — the exact
    footprint the schedule exists to avoid).  When ``live`` (the card
    allocator's peak over the cell) and ``analytic``
    (``conv/matmul_mem_elems`` in bytes) are given, their ratio must lie
    inside ``mem_band``; on the CPU nothing is measured and that half is
    skipped."""
    out: List[Finding] = []
    caxes = set(contraction_axes)
    if schedule in ("ring", "ring2"):
        for c in collectives:
            if c.kind != "all-gather" or c.is_trivial:
                continue
            if c.axes and caxes & set(c.axes):
                out.append(Finding(
                    "footprint", "error",
                    f"{schedule} cell compiled an all-gather ({c.name}) "
                    f"on contraction axis {'x'.join(c.axes)}: gathered "
                    f"operand materialized, slab-memory promise broken"))
    if live is not None and analytic is not None and mem_band is not None:
        ratio = live / analytic if analytic else float("inf")
        lo, hi = mem_band
        if not (lo <= ratio <= hi):
            out.append(Finding(
                "memory", "error",
                f"peak live {live:.3g} B vs analytic {analytic:.3g} B: "
                f"ratio {ratio:.3f} outside [{lo}, {hi}]"))
    return out


# ----------------------------------------------------------- wire drift

def lint_wire(measured_bytes: float, analytic_bytes: float, *,
              rtol: float = 0.02, what: str = "fwd") -> List[Finding]:
    """Accounting drift guard: the wire bytes the notes record must equal
    the analytic ``*_comm_elems`` model (ratio 1.00 within ``rtol``)."""
    if analytic_bytes == 0:
        if measured_bytes == 0:
            return []
        return [Finding("wire", "error",
                        f"{what}: analytic model says zero wire but IR "
                        f"moves {measured_bytes:.3g} B")]
    ratio = measured_bytes / analytic_bytes
    if abs(ratio - 1.0) > rtol:
        return [Finding(
            "wire", "error",
            f"{what}: IR wire {measured_bytes:.4g} B vs analytic "
            f"{analytic_bytes:.4g} B — ratio {ratio:.4f} drifts past "
            f"+/-{rtol}")]
    return []


# ---------------------------------------------------------- attribution

#: A term of the analytic breakdown: the axis sets it is paid on (one
#: or more alternatives, e.g. the halo on ``h`` and on ``w``) and its
#: bytes.
Term = Tuple[Tuple[Tuple[str, ...], ...], float]


def lint_attribution(collectives: Sequence[Collective],
                     terms: Mapping[str, Term], mesh_axes, *,
                     rtol: float = 0.02, what: str = "fwd"
                     ) -> List[Finding]:
    """Notes-vs-accounting cross-check, by device partition.

    Each term of ``*_comm_elems`` / ``*_train_comm_elems`` is paid on
    its axis sets (``terms[name] = (axis_sets, bytes)``); terms whose
    sets share a partition are pooled.  Then the wire of the collectives
    attributed to each pool's partitions must equal the pool's bytes
    (within ``rtol``), a collective on a partition no term names is an
    unaccounted collective, and a non-zero term whose pool saw no wire
    is accounting the op never paid.  Matched by axes, not by tag: the
    forward notes carry the primitive's tag, not the term's name."""
    mesh_axes = normalize_mesh_axes(mesh_axes)
    out: List[Finding] = []
    parent: Dict[Tuple[str, ...], Tuple[str, ...]] = {}

    def find(k):
        while parent[k] != k:
            k = parent[k]
        return k

    term_keys: Dict[str, List[Tuple[str, ...]]] = {}
    for name, (axis_sets, _) in terms.items():
        keys = sorted({effective_axes(mesh_axes, s) for s in axis_sets}
                      - {()})
        term_keys[name] = keys
        for k in keys:
            parent.setdefault(k, k)
        for k in keys[1:]:
            parent[find(k)] = find(keys[0])
    owed: Dict[Tuple[str, ...], float] = {}
    names: Dict[Tuple[str, ...], List[str]] = {}
    for name, (_, nbytes) in terms.items():
        keys = term_keys[name]
        if not keys:
            if nbytes:
                out.append(Finding(
                    "attribution", "error",
                    f"{what}: term {name} counts {nbytes:.4g} B on axes "
                    f"of extent 1: accounting the op never paid"))
            continue
        root = find(keys[0])
        owed[root] = owed.get(root, 0.0) + nbytes
        names.setdefault(root, []).append(name)
    paid: Dict[Tuple[str, ...], float] = {}
    stray: Dict[Tuple[str, ...], List[str]] = {}
    for c in collectives:
        if c.is_trivial:
            continue
        if c.axes is None:
            out.append(Finding(
                "attribution", "error",
                f"{what}: {c.kind} {c.name} ({c.comp}) fits no mesh-axis "
                f"group: an unaccounted collective"))
            continue
        if c.axes not in parent:
            stray.setdefault(c.axes, []).append(c.name)
            continue
        root = find(c.axes)
        paid[root] = paid.get(root, 0.0) + c.wire_bytes
    for axes, tags in stray.items():
        out.append(Finding(
            "attribution", "error",
            f"{what}: {len(tags)} collective(s) on axis {'x'.join(axes)} "
            f"({', '.join(sorted(set(tags)))}) that no term of the "
            f"accounting names: an unaccounted collective"))
    for root, want in owed.items():
        got = paid.get(root, 0.0)
        pool = "+".join(sorted(names[root]))
        where = "/".join("x".join(k) for k in sorted(
            k for k in parent if find(k) == root))
        if got == 0.0 and want > 0.0:
            out.append(Finding(
                "attribution", "error",
                f"{what}: {pool} counts {want:.4g} B on axis {where} but "
                f"no collective ran there: accounting the op never paid"))
        elif abs(got - want) > rtol * max(want, 1e-30) and got != want:
            out.append(Finding(
                "attribution", "error",
                f"{what}: collectives on axis {where} move {got:.4g} B, "
                f"the terms {pool} count {want:.4g} B"))
    return out
