"""Cell runner: run, record and lint every (op, grid, schedule) cell --
the port of ``repro/analysis/verify.py``.

The reference compiles each cell on a fake host mesh and lints the HLO
without running it.  The port runs it: every rank of a ``prod(grid)``
process group makes its operand shards from a seed, runs the distributed
op forward, and forward plus backward (``autograd.grad`` of ``y``
against both operands with cotangent ``y``, the reference's
``vjp(y)``), each under ``record_collectives()``, and returns its notes
and mesh coordinates.  The parent lines the ranks' notes up
(:func:`repro_torch.analysis.collect.extract_collectives`) and runs the
lint battery: deadlock lint, note-vs-accounting attribution, the wire
drift guard on every rank, and the ring-footprint lint with, on a card,
the peak-live memory band.

``live`` is the card allocator's peak over the cell,
``torch.cuda.max_memory_allocated()`` after ``reset_peak_memory_stats()``
less what was allocated before the operands were made: arguments,
temporaries and outputs, as the reference's ``live_bytes`` reads
``memory_analysis()``.  On the CPU nothing is measured: ``mem_ratio`` is
``None``, the memory half of ``lint_footprint`` is skipped and
:class:`CellReport` says so.

:func:`verify_rank` is the per-rank body: it runs inside a process
group that already exists, so a caller can run many cells in one launch.
:func:`run_matrix` starts one ``dist.spawn.run_spmd`` group per rank
count and turns the tuner off in every rank (the static paper plan; the
tuner would time candidates inside the cells).  The kernels stay on:
the reference turns its Pallas kernels off because interpret-mode
buffers swamp ``memory_analysis()`` on a CPU, which does not apply here.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.analysis import lints
from repro_torch.analysis.collect import SpmdDivergence, extract_collectives
from repro_torch.device import resolve_device
from repro_torch.dist import conv2d as dconv
from repro_torch.dist import matmul as dmatmul
from repro_torch.dist.collectives import axis_index, record_collectives
from repro_torch.dist.spawn import run_spmd
from repro_torch.kernels.autotune import autotune_disabled

CONV_CONTRACTION_AXES = ("b", "k")   # In gathers over k, Ker over b
MATMUL_CONTRACTION_AXES = ("m", "n")

#: Drift tolerance of the wire guard: recorded wire / analytic wire must
#: be 1.00 within this.
WIRE_RTOL = 0.02
#: Peak-live vs analytic ``*_mem_elems`` bands, the reference's (set for
#: XLA's buffer assignment; the analytic model counts schedule buffers).
#: The gather schedule gets more headroom on the forward pass: a gathered
#: result and a layout copy of it may both be live, and the model counts
#: the gathered buffer once.  The ring schedules must hold the tight
#: band -- slab memory is their whole promise.
MEM_BAND_FWD = (0.4, 1.6)
MEM_BAND_FWD_GATHER = (0.4, 2.1)
MEM_BAND_TRAIN = (0.05, 1.3)
#: The conv's custom backward on a card (the ``train`` variant without
#: ``save_gathered``), read against the caching allocator's peak.  Its
#: dKer at stride 1 runs the direct kernel on the N/C-transposed
#: operands (``dist/conv2d.py::_dw_local``), which the kernel takes
#: contiguous: the cotangent is copied whole, beside the kernel's
#: split-reduction scratch.  XLA's conv reads any dimension order, and
#: Eq. 11 counts no such copy.  Where the cotangent dwarfs the operands
#: -- the CNN's C = 3 first layer, 51 MB against a 2.4 MB input -- the
#: copy is most of the count: that cell reads 1.855 on an H100
#: (``chip_smoke.py`` phase 12), every other cell at most 1.23.  The top
#: moves that far and no further; every other cell, and every cell on
#: the CPU, keeps the reference's bands.
CARD_MEM_BAND_CONV_TRAIN = (0.05, 1.9)

#: Default verification matrix: the 8-rank acceptance grids -- 2.5D,
#: pure-DP, degenerate-ring and spatial+contraction conv grids; the 3D,
#: 1D-ring and pure-m matmul grids.  c-heavy shapes so the contraction
#: operands dominate scratch in the memory band.
DEFAULT_CONV_GRIDS = ((2, 1, 1, 2, 2), (8, 1, 1, 1, 1),
                      (1, 1, 1, 2, 4), (1, 2, 2, 2, 1))
DEFAULT_MATMUL_GRIDS = ((2, 2, 2), (1, 8, 1), (8, 1, 1))
CONV_X, CONV_W = (8, 128, 8, 8), (32, 128, 3, 3)
MATMUL_MCN = (256, 1024, 64)
SCHEDULES = ("allgather", "ring", "ring2")

#: The axis sets each term of ``conv_comm_elems`` /
#: ``conv_train_comm_elems`` is paid on (``dist/conv2d.py``): the forward
#: gathers In over k and Ker over b, all-reduces Out over c and trades
#: halos on h and w; the backward replays and transposes them, and sums
#: dKer over the spatial axes.
CONV_TERM_AXES = {
    "gather_in": (("k",),), "gather_ker": (("b",),),
    "reduce_out": (("c",),), "halo": (("h",), ("w",)),
    "halo_replay": (("h",), ("w",)), "gather_in_replay": (("k",),),
    "gather_ker_replay": (("b",),), "rs_in": (("k",),),
    "rs_ker": (("b",),), "psum_ker_spatial": (("h", "w"),),
    "psum_out_bwd": (("c",),), "halo_acc": (("h",), ("w",)),
}
#: The same for ``matmul_comm_elems`` / ``matmul_train_comm_elems``: In
#: gathers over n, Ker over m, Out all-reduces over c.
MATMUL_TERM_AXES = {
    "gather_in": (("n",),), "gather_ker": (("m",),),
    "reduce_out": (("c",),), "gather_in_replay": (("n",),),
    "gather_ker_replay": (("m",),), "rs_in": (("n",),),
    "rs_ker": (("m",),), "psum_out_bwd": (("c",),),
}

ITEMSIZE = 4   # the cells run in float32
CPU_MEM_NOTE = "not measured: the CPU has no allocator peak to read"


@dataclasses.dataclass(frozen=True)
class CellSpec:
    """One cell: the op, its grid, schedule and variants.  ``x_shape`` /
    ``w_shape`` are global: In/Ker for the conv, ``(M, C)`` / ``(C, N)``
    for the matmul."""

    op: str                               # conv | matmul
    grid: Tuple[int, ...]
    schedule: str
    x_shape: Tuple[int, ...]
    w_shape: Tuple[int, ...]
    stride: Tuple[int, int] = (1, 1)
    padding: str = "SAME"
    save_gathered: bool = False
    include_fwd: bool = True
    include_train: bool = True
    check_mem: bool = True

    @property
    def tag(self) -> str:
        """The stride / padding suffix of the cell's name."""
        return "".join([f"/s{self.stride[0]}{self.stride[1]}"
                        if self.stride != (1, 1) else "",
                        f"/{self.padding.lower()}"
                        if self.padding != "SAME" else ""])

    @property
    def name(self) -> str:
        return (f"{self.op}[{','.join(map(str, self.grid))}]/"
                f"{self.schedule}{self.tag}")

    @property
    def variants(self) -> Tuple[str, ...]:
        out = ("fwd",) if self.include_fwd else ()
        if self.include_train:
            out += ("train-sg" if self.save_gathered else "train",)
        return out

    @property
    def ranks(self) -> int:
        return math.prod(self.grid)


def conv_cell(grid, schedule: str, *, stride=(1, 1), padding="SAME",
              save_gathered: bool = False, x_shape=CONV_X, w_shape=CONV_W,
              include_fwd: bool = True, include_train: bool = True,
              check_mem: bool = True) -> CellSpec:
    return CellSpec("conv", tuple(grid), schedule, tuple(x_shape),
                    tuple(w_shape), tuple(stride), padding, save_gathered,
                    include_fwd, include_train, check_mem)


def matmul_cell(grid, schedule: str, *, save_gathered: bool = False,
                mcn=MATMUL_MCN, include_fwd: bool = True,
                include_train: bool = True,
                check_mem: bool = True) -> CellSpec:
    M, C, N = mcn
    return CellSpec("matmul", tuple(grid), schedule, (M, C), (C, N),
                    save_gathered=save_gathered, include_fwd=include_fwd,
                    include_train=include_train, check_mem=check_mem)


@dataclasses.dataclass
class CellReport:
    """Lint outcome of one cell variant."""

    name: str                 # e.g. conv[2,1,1,2,2]/ring2/train
    op: str                   # conv | matmul
    grid: Tuple[int, ...]
    schedule: str             # requested
    effective: str            # after ring2 fallback
    variant: str              # fwd | train | train-sg (+ stride/pad tags)
    wire_ratio: Optional[float]
    mem_ratio: Optional[float]
    n_collectives: int
    findings: List[lints.Finding]
    rank_wire_ratios: Tuple[Optional[float], ...] = ()
    wire_bytes: float = 0.0                  # recorded, the most of a rank
    analytic_wire_bytes: float = 0.0
    live_bytes: Optional[float] = None       # allocator peak (card)
    analytic_mem_bytes: Optional[float] = None
    mem_band: Optional[Tuple[float, float]] = None
    mem_note: str = ""

    @property
    def ok(self) -> bool:
        return not lints.errors(self.findings)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["ok"] = self.ok
        d["findings"] = [dataclasses.asdict(f) for f in self.findings]
        return d


# --------------------------------------------------------------------------
# The op side: shapes, accounting, the per-rank run
# --------------------------------------------------------------------------

def _axes(op: str) -> Tuple[str, ...]:
    return dconv.AXES if op == "conv" else dmatmul.AXES


def effective_schedule(spec: CellSpec) -> str:
    if spec.op == "conv":
        return dconv._conv_effective_schedule(spec.schedule, spec.grid)
    return dmatmul._matmul_effective_schedule(spec.schedule, spec.grid)


def _local_shapes(spec: CellSpec):
    """This rank's In and Ker shard shapes (``IN_SPEC``/``KER_SPEC``,
    ``X_SPEC``/``W_SPEC``)."""
    if spec.op == "conv":
        pb, ph, pw, pk, pc = spec.grid
        n, c, h, w = spec.x_shape
        k, _, kh, kw = spec.w_shape
        return ((n // pb, c // (pc * pk), h // ph, w // pw),
                (k // pk, c // (pc * pb), kh, kw))
    pm, pn, pc = spec.grid
    (m, c), (_, n) = spec.x_shape, spec.w_shape
    return (m // pm, c // (pc * pn)), (c // (pc * pm), n // pn)


def analytic(spec: CellSpec, variant: str) -> Tuple[dict, float]:
    """``({term: (axis sets, bytes)}, peak-live bytes)`` of one variant:
    the terms of ``*_comm_elems`` (forward) or both halves of
    ``*_train_comm_elems``, and ``*_mem_elems``' peak."""
    train = variant != "fwd"
    if spec.op == "conv":
        args = (spec.x_shape, spec.w_shape, spec.grid)
        kw = dict(stride=spec.stride, padding=spec.padding)
        if train:
            kw.update(schedule=spec.schedule,
                      save_gathered=spec.save_gathered)
            wire = dconv.conv_train_comm_elems(*args, **kw)
            mem = dconv.conv_train_mem_elems(*args, **kw)
        else:
            wire = dconv.conv_comm_elems(*args, **kw)
            mem = dconv.conv_mem_elems(*args, schedule=spec.schedule, **kw)
        axes_of = CONV_TERM_AXES
    else:
        (M, C), (_, N) = spec.x_shape, spec.w_shape
        args = (M, C, N, spec.grid)
        if train:
            wire = dmatmul.matmul_train_comm_elems(
                *args, save_gathered=spec.save_gathered)
            mem = dmatmul.matmul_train_mem_elems(
                *args, schedule=spec.schedule,
                save_gathered=spec.save_gathered)
        else:
            wire = dmatmul.matmul_comm_elems(*args)
            mem = dmatmul.matmul_mem_elems(*args, schedule=spec.schedule)
        axes_of = MATMUL_TERM_AXES
    parts = [wire["fwd"], wire["bwd"]] if train else [wire]
    terms = {name: (axes_of[name], v * ITEMSIZE)
             for part in parts for name, v in part.items()
             if name != "total"}
    return terms, mem["peak"] * ITEMSIZE


def _make_mesh(spec: CellSpec, device):
    if spec.op == "conv":
        return dconv.make_conv_mesh(spec.grid, device=device)
    return dmatmul.make_matmul_mesh(spec.grid, device=device)


def _op(spec: CellSpec, mesh):
    if spec.op == "conv":
        return lambda a, b: dconv.conv2d_distributed(
            a, b, mesh, schedule=spec.schedule, stride=spec.stride,
            padding=spec.padding, save_gathered=spec.save_gathered)
    return lambda a, b: dmatmul.matmul_distributed(
        a, b, mesh, schedule=spec.schedule,
        save_gathered=spec.save_gathered)


def _run_variant(spec: CellSpec, mesh, device, train: bool, seed: int):
    """One variant on this rank: its notes, and on a card the
    allocator's peak over the cell less what was live before."""
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.synchronize(device)
        base = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    xs, ws = _local_shapes(spec)
    gen = torch.Generator(device=device).manual_seed(seed)
    xl = torch.randn(xs, generator=gen, device=device)
    wl = torch.randn(ws, generator=gen, device=device)
    op = _op(spec, mesh)
    with record_collectives() as notes:
        if train:
            xl.requires_grad_(True)
            wl.requires_grad_(True)
            with torch.enable_grad():
                y = op(xl, wl)
                grads = torch.autograd.grad(y, (xl, wl),
                                            grad_outputs=y.detach())
            del grads
        else:
            with torch.no_grad():
                y = op(xl, wl)
    live = None
    if on_card:
        torch.cuda.synchronize(device)
        live = float(torch.cuda.max_memory_allocated(device) - base)
    del y, xl, wl
    return [tuple(n) for n in notes], live


def run_cell(spec: CellSpec, *, device=None, mesh=None, seed: int = 0
             ) -> dict:
    """Run one cell on this rank of an existing ``prod(grid)``-rank
    process group: ``{"coords": {axis: coordinate}, "variants":
    {variant: {"notes": [...], "live": bytes or None}}}``."""
    device = resolve_device(device)
    mesh = _make_mesh(spec, device) if mesh is None else mesh
    out = {"coords": {a: axis_index(mesh, a) for a in _axes(spec.op)},
           "variants": {}}
    for variant in spec.variants:
        notes, live = _run_variant(spec, mesh, device, variant != "fwd",
                                   seed)
        out["variants"][variant] = {"notes": notes, "live": live}
    return out


def verify_rank(rank: int, specs: Sequence[CellSpec], device=None
                ) -> List[dict]:
    """The per-rank body, in a process group of ``prod(grid)`` ranks that
    already exists (a ``dist.spawn.run_spmd`` target): :func:`run_cell`
    for each spec, one mesh per grid, the tuner off (the static paper
    plan)."""
    meshes: Dict[tuple, object] = {}
    out = []
    with autotune_disabled():
        for spec in specs:
            key = (spec.op, spec.grid)
            if key not in meshes:
                meshes[key] = _make_mesh(spec, device)
            out.append(run_cell(spec, device=device, mesh=meshes[key]))
    return out


# --------------------------------------------------------------------------
# The parent side: line the ranks up and lint
# --------------------------------------------------------------------------

def mem_band(spec: CellSpec, variant: str, *, on_card: bool = False
             ) -> Tuple[float, float]:
    if variant == "fwd":
        return (MEM_BAND_FWD_GATHER if effective_schedule(spec) == "allgather"
                else MEM_BAND_FWD)
    if on_card and spec.op == "conv" and not spec.save_gathered:
        return CARD_MEM_BAND_CONV_TRAIN
    return MEM_BAND_TRAIN


def lint_cell(spec: CellSpec, records: Sequence[dict], *,
              wire_rtol: float = WIRE_RTOL) -> List[CellReport]:
    """Lint one cell from what each of its ranks returned (rank order)."""
    mesh_axes = tuple(zip(_axes(spec.op), spec.grid))
    eff = effective_schedule(spec)
    contraction = (CONV_CONTRACTION_AXES if spec.op == "conv"
                   else MATMUL_CONTRACTION_AXES)
    coords = [r["coords"] for r in records]
    reports = []
    for variant in spec.variants:
        runs = [r["variants"][variant] for r in records]
        notes_by_rank = [run["notes"] for run in runs]
        terms, an_mem = analytic(spec, variant)
        an_wire = sum(v for _, v in terms.values())
        findings: List[lints.Finding] = []
        try:
            colls = extract_collectives(notes_by_rank, mesh_axes, coords)
        except SpmdDivergence as e:
            colls = ()
            findings.append(lints.Finding("divergence", "error", str(e)))
        findings += lints.lint_deadlock(colls, mesh_axes, notes_by_rank[0])
        findings += lints.lint_attribution(colls, terms, mesh_axes,
                                           rtol=wire_rtol, what=variant)
        ratios, wires = [], []
        for r, notes in enumerate(notes_by_rank):
            measured = sum(n[3] * (n[4] if len(n) > 4 else ITEMSIZE)
                           for n in notes)
            findings += lints.lint_wire(measured, an_wire, rtol=wire_rtol,
                                        what=f"{variant} rank {r}")
            ratios.append(measured / an_wire if an_wire else None)
            wires.append(measured)
        lives = [run["live"] for run in runs]
        measured_mem = spec.check_mem and all(v is not None for v in lives)
        live = max(lives) if measured_mem else None
        band = (mem_band(spec, variant, on_card=measured_mem)
                if spec.check_mem else None)
        findings += lints.lint_footprint(
            colls, schedule=eff, contraction_axes=contraction,
            live=live, analytic=an_mem if measured_mem else None,
            mem_band=band)
        reports.append(CellReport(
            name=f"{spec.name}/{variant}", op=spec.op, grid=spec.grid,
            schedule=spec.schedule, effective=eff,
            variant=f"{variant}{spec.tag}", wire_ratio=ratios[0],
            mem_ratio=live / an_mem if live is not None and an_mem
            else None,
            n_collectives=len(colls), findings=findings,
            rank_wire_ratios=tuple(ratios), wire_bytes=max(wires),
            analytic_wire_bytes=an_wire, live_bytes=live,
            analytic_mem_bytes=an_mem if spec.check_mem else None,
            mem_band=band,
            mem_note="" if measured_mem or not spec.check_mem
            else CPU_MEM_NOTE))
    return reports


def run_specs(specs: Sequence[CellSpec], *, device=None,
              wire_rtol: float = WIRE_RTOL, progress=None
              ) -> List[CellReport]:
    """Run and lint ``specs``: one ``run_spmd`` group per rank count, on
    ``device`` (the card unless the caller asks for the CPU)."""
    by_ranks: Dict[int, List[int]] = {}
    for i, spec in enumerate(specs):
        by_ranks.setdefault(spec.ranks, []).append(i)
    records: Dict[int, List[dict]] = {}
    for n, idx in by_ranks.items():
        per_rank = run_spmd(verify_rank, n, [specs[i] for i in idx],
                            device, device=device)
        for j, i in enumerate(idx):
            records[i] = [rank_out[j] for rank_out in per_rank]
    reports: List[CellReport] = []
    for i, spec in enumerate(specs):
        cells = lint_cell(spec, records[i], wire_rtol=wire_rtol)
        reports.extend(cells)
        if progress is not None:
            for c in cells:
                progress(c)
    return reports


def verify_conv_cell(grid, schedule: str, *, stride=(1, 1),
                     padding="SAME", save_gathered: bool = False,
                     x_shape=CONV_X, w_shape=CONV_W,
                     include_fwd: bool = True, include_train: bool = True,
                     check_mem: bool = True, wire_rtol: float = WIRE_RTOL,
                     device=None) -> List[CellReport]:
    """Run + lint one conv cell (fwd and/or fwd+backward)."""
    return run_specs([conv_cell(
        grid, schedule, stride=stride, padding=padding,
        save_gathered=save_gathered, x_shape=x_shape, w_shape=w_shape,
        include_fwd=include_fwd, include_train=include_train,
        check_mem=check_mem)], device=device, wire_rtol=wire_rtol)


def verify_matmul_cell(grid, schedule: str, *,
                       save_gathered: bool = False, mcn=MATMUL_MCN,
                       include_fwd: bool = True,
                       include_train: bool = True, check_mem: bool = True,
                       wire_rtol: float = WIRE_RTOL,
                       device=None) -> List[CellReport]:
    """Run + lint one matmul cell (fwd and/or fwd+backward)."""
    return run_specs([matmul_cell(
        grid, schedule, save_gathered=save_gathered, mcn=mcn,
        include_fwd=include_fwd, include_train=include_train,
        check_mem=check_mem)], device=device, wire_rtol=wire_rtol)


def matrix_cells(*, conv_grids=DEFAULT_CONV_GRIDS,
                 matmul_grids=DEFAULT_MATMUL_GRIDS,
                 schedules: Sequence[str] = SCHEDULES,
                 include_train: bool = True,
                 include_variants: bool = True) -> List[CellSpec]:
    """The cells of :func:`run_matrix`, in the reference's order."""
    cells = [conv_cell(g, s, include_train=include_train)
             for g in conv_grids for s in schedules]
    cells += [matmul_cell(g, s, include_train=include_train)
              for g in matmul_grids for s in schedules]
    if include_variants:
        flagship = conv_grids[0] if conv_grids else None
        for sched in schedules:
            if flagship is not None:
                cells.append(conv_cell(flagship, sched, stride=(2, 2),
                                       include_train=include_train))
                cells.append(conv_cell(flagship, sched, stride=(2, 2),
                                       padding="VALID",
                                       include_train=include_train))
                if include_train:
                    cells.append(conv_cell(flagship, sched,
                                           save_gathered=True,
                                           include_fwd=False))
            if matmul_grids and include_train:
                cells.append(matmul_cell(matmul_grids[0], sched,
                                         save_gathered=True,
                                         include_fwd=False))
    return cells


def run_matrix(*, conv_grids=DEFAULT_CONV_GRIDS,
               matmul_grids=DEFAULT_MATMUL_GRIDS,
               schedules: Sequence[str] = SCHEDULES,
               include_train: bool = True, include_variants: bool = True,
               wire_rtol: float = WIRE_RTOL, progress=None,
               device=None) -> List[CellReport]:
    """The full verification matrix: grids x schedules x {fwd, backward},
    plus (``include_variants``) the stride/VALID-padding and
    ``save_gathered`` variants on the flagship grids."""
    return run_specs(matrix_cells(
        conv_grids=conv_grids, matmul_grids=matmul_grids,
        schedules=schedules, include_train=include_train,
        include_variants=include_variants),
        device=device, wire_rtol=wire_rtol, progress=progress)


def summarize(reports: Sequence[CellReport]) -> dict:
    """JSON-ready summary: per-cell results plus total error count."""
    n_err = sum(len(lints.errors(r.findings)) for r in reports)
    return {"cells": [r.to_dict() for r in reports],
            "n_cells": len(reports),
            "n_failed_cells": sum(not r.ok for r in reports),
            "n_errors": n_err,
            "ok": n_err == 0}
