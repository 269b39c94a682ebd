"""Distributed matrix multiplication on a 3-axis processor grid (paper
Sec. 2.2: the 2D-SUMMA / 2.5D / 3D family) -- the port of
``repro/dist/matmul.py``.

Grid ``(Pm, Pn, Pc)`` over mesh axes ``("m", "n", "c")``:

* ``In  [M, C]`` -- :data:`X_SPEC` ``("m", ("c", "n"))``: rows over m,
  contraction block ``c * Pn + n``;
* ``Ker [C, N]`` -- :data:`W_SPEC` ``(("c", "m"), "n")``: contraction
  block ``c * Pm + m``, columns over n;
* ``Out [M, N]`` -- :data:`OUT_SPEC` ``("m", "n")``, replicated over c.

Per-device communication (the paper's cost_C): all-gather In over n,
all-gather Ker over m, all-reduce Out over c.  ``schedule="ring"`` rotates
Ker shards around the m-ring against the gathered In; ``schedule="ring2"``
rotates both (:func:`collectives.ring_zip`) on the grids
:func:`matmul_ring2_supported` accepts and falls back to ``"ring"``
elsewhere.  :func:`matmul_distributed` is per-rank code on shards, like
``dist.conv2d.conv2d_distributed``.  Per-step products go through
``kernels.ops.local_matmul``.  Differentiable like the conv: the backward
replays the gathers (or re-streams, for ``ring2``) and reduce-scatters
each operand gradient; ``save_gathered=True`` is a later slice.
"""

from __future__ import annotations

import functools

import torch
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.dist.collectives import (SCHEDULES, axis_index, gather_axis,
                                          make_mesh, mesh_grid, mesh_view,
                                          ppermute, psum, ring_reduce,
                                          ring_scatter_reduce, ring_zip,
                                          scatter_axis, stream_elems)
from repro_torch.dist.conv2d import AXES as CONV_AXES
from repro_torch.dist.conv2d import SAVE_GATHERED_LATER
from repro_torch.kernels import ops as kops

AXES = ("m", "n", "c")
X_SPEC = ("m", ("c", "n"))
W_SPEC = (("c", "m"), "n")
OUT_SPEC = ("m", "n")


def make_matmul_mesh(grid, *, device=None) -> DeviceMesh:
    """Mesh over axes ``("m", "n", "c")`` from a ``(Pm, Pn, Pc)`` tuple."""
    if len(grid) != 3:
        raise ValueError(f"matmul grid must be (Pm, Pn, Pc), got {grid}")
    return make_mesh(grid, AXES, device=device)


@functools.lru_cache(maxsize=None)
def matmul_mesh_from_conv(mesh: DeviceMesh) -> DeviceMesh:
    """View a conv ``(b,h,w,k,c)`` mesh as a matmul ``(m,n,c)`` mesh: the
    composite ``b*h*w`` extent becomes m (rows), k becomes n (columns), c
    stays the contraction axis.  Rank order is preserved.  Building the
    view creates process groups on every rank, so it is made once per
    mesh (every rank must call it at the same point the first time)."""
    if tuple(mesh.mesh_dim_names or ()) != CONV_AXES:
        raise ValueError(f"expected a 5-axis conv mesh, got {mesh}")
    pb, ph, pw, pk, pc = mesh_grid(mesh, CONV_AXES)
    return mesh_view(mesh, (pb * ph * pw, pk, pc), AXES)


def matmul_ring2_supported(grid) -> bool:
    """True when the two-ring schedule covers ``grid = (Pm, Pn, Pc)``: a
    trivial contraction ring on either side or both rings of size 2."""
    pm, pn, pc = grid
    return pm == 1 or pn == 1 or (pm == 2 and pn == 2)


def _matmul_effective_schedule(schedule: str, grid) -> str:
    if schedule == "ring2" and not matmul_ring2_supported(grid):
        return "ring"
    return schedule


def _check_matmul_shapes(M: int, C: int, N: int, grid) -> None:
    """Raise unless the shapes satisfy the sub-shard divisibility
    constraints."""
    pm, pn, pc = grid
    for extent, div, what in [(M, pm, "M % Pm"), (N, pn, "N % Pn"),
                              (C, pc * pn, "C % (Pc*Pn)"),
                              (C, pc * pm, "C % (Pc*Pm)")]:
        if div <= 0 or extent % div:
            raise ValueError(f"shape not divisible by grid: {what} != 0 "
                             f"({extent} % {div})")


def matmul_grid_divides(M: int, C: int, N: int, grid) -> bool:
    """True when the operand shapes satisfy the divisibility constraints
    of :func:`matmul_distributed`."""
    try:
        _check_matmul_shapes(M, C, N, grid)
    except ValueError:
        return False
    return True


def _add(acc, part):
    return part if acc is None else acc + part


def _matmul_fwd_ring2(xl, wl, mesh, *, pm, pn, mm):
    """Two-ring forward: In slabs rotate the n-ring, Ker chunks the
    m-ring (see ``dist.conv2d`` for the coverage argument)."""
    cx = xl.shape[1]   # C / (Pc*Pn), the In c-slab width
    cw = wl.shape[0]   # C / (Pc*Pm), the Ker c-chunk width
    if pm == 1 and pn == 1:
        return mm(xl, wl)
    if pn == 1:
        # In holds its full C/Pc columns: stream Ker chunks around m
        return ring_reduce(
            wl, mesh, "m",
            lambda acc, src, wchunk: _add(
                acc, mm(xl.narrow(1, src * cw, cw), wchunk)), None)
    if pm == 1:
        # Ker holds its full C/Pc rows: stream In slabs around n
        return ring_reduce(
            xl, mesh, "n",
            lambda acc, src, slab: _add(
                acc, mm(slab, wl.narrow(0, src * cx, cx))), None)
    # Pm == Pn == 2: zip both rings, own shards cover the misaligned pairs
    nu, mu = axis_index(mesh, "n"), axis_index(mesh, "m")
    aligned = nu == mu

    def zip_body(acc, t, sx, cur_x, sw, cur_w):
        if aligned or sx == mu:
            acc = _add(acc, mm(cur_x, cur_w if aligned else wl))
        if not aligned and sw == nu:
            acc = _add(acc, mm(xl, cur_w))
        return acc

    return ring_zip(xl, "n", wl, "m", mesh, zip_body, None)


def _local_matmul(xl, wl, mesh, *, schedule):
    pm, pn, pc = mesh_grid(mesh, AXES)
    mm = kops.local_matmul
    if schedule == "ring2":
        out = _matmul_fwd_ring2(xl, wl, mesh, pm=pm, pn=pn, mm=mm)
    else:
        # gather In's contraction sub-shard over n -> full C/Pc slab
        xg = gather_axis(xl, mesh, "n", dim=1, schedule=schedule) \
            if pn > 1 else xl
        if pm == 1:
            out = mm(xg, wl)
        elif schedule == "ring":
            # pipelined SUMMA: rotate Ker shards around the m-ring,
            # contract each against its matching column slab of In
            chunk = wl.shape[0]
            out = ring_reduce(
                wl, mesh, "m",
                lambda acc, src, wchunk: _add(
                    acc, mm(xg.narrow(1, src * chunk, chunk), wchunk)),
                None)
        else:
            out = mm(xg, gather_axis(wl, mesh, "m", dim=0,
                                     schedule=schedule))
    if pc > 1:
        out = psum(out, mesh, "c", tag="matmul_out")
    return out


def _place(acc, part, start, dim):
    acc.narrow(dim, start, part.shape[dim]).copy_(part)
    return acc


def _matmul_bwd_ring2(xl, wl, gl, mesh, *, pm, pn):
    """Streaming backward of the two-ring schedule: dIn slabs are produced
    on the fly and reduced around the n-ring, dKer chunks around the
    m-ring -- no gathered operand or gradient is materialized."""
    cx = xl.shape[1]
    cw = wl.shape[0]
    mm = kops.local_matmul
    ring2 = [(i, (i + 1) % 2) for i in range(2)]
    aligned = axis_index(mesh, "n") == axis_index(mesh, "m")

    def tr(t):
        return t.t().contiguous()

    # --- dIn = g @ Ker^T, slab-wise --------------------------------------
    if pn == 1:
        if pm == 1:
            dxl = mm(gl, tr(wl))
        else:
            dxl = ring_reduce(
                wl, mesh, "m",
                lambda acc, src, wchunk: _place(acc, mm(gl, tr(wchunk)),
                                                src * cw, 1),
                torch.zeros(xl.shape, dtype=gl.dtype, device=gl.device))
    elif pm == 1:
        dxl = ring_scatter_reduce(
            mesh, "n", lambda r, t: mm(gl, tr(wl.narrow(0, r * cx, cx))))
    else:  # Pm == Pn == 2: one m-hop re-delivers the foreign Ker chunk
        w_arr = ppermute(wl, mesh, "m", ring2, tag="ring2_redeliver")

        def produce_dx(r, t):
            first = w_arr if aligned else wl
            other = wl if aligned else w_arr
            return mm(gl, tr(first if t == 0 else other))

        dxl = ring_scatter_reduce(mesh, "n", produce_dx)

    # --- dKer = In^T @ g, chunk-wise -------------------------------------
    if pm == 1:
        if pn == 1:
            dwl = mm(tr(xl), gl)
        else:
            dwl = ring_reduce(
                xl, mesh, "n",
                lambda acc, src, slab: _place(acc, mm(tr(slab), gl),
                                              src * cx, 0),
                torch.zeros(wl.shape, dtype=gl.dtype, device=gl.device))
    elif pn == 1:
        dwl = ring_scatter_reduce(
            mesh, "m", lambda r, t: mm(tr(xl.narrow(1, r * cw, cw)), gl))
    else:  # Pm == Pn == 2: one n-hop re-delivers the foreign In slab
        x_arr = ppermute(xl, mesh, "n", ring2, tag="ring2_redeliver")

        def produce_dw(r, t):
            first = x_arr if aligned else xl
            other = xl if aligned else x_arr
            return mm(tr(first if t == 0 else other), gl)

        dwl = ring_scatter_reduce(mesh, "m", produce_dw)
    return dxl, dwl


def _local_matmul_bwd(xl, wl, gl, mesh, *, schedule):
    """Transposed schedule: replay the gathers (or re-stream, for ring2),
    contract against the Out cotangent (complete on every c rank),
    reduce-scatter each operand gradient."""
    pm, pn, pc = mesh_grid(mesh, AXES)
    if schedule == "ring2":
        dxl, dwl = _matmul_bwd_ring2(xl, wl, gl, mesh, pm=pm, pn=pn)
        return dxl.to(xl.dtype), dwl.to(wl.dtype)
    mm = kops.local_matmul
    xg = gather_axis(xl, mesh, "n", dim=1, schedule=schedule) \
        if pn > 1 else xl
    wg = gather_axis(wl, mesh, "m", dim=0, schedule=schedule) \
        if pm > 1 else wl
    dxg = mm(gl, wg.t().contiguous())              # [M/pm, C/pc]
    dwg = mm(xg.t().contiguous(), gl)              # [C/pc, N/pn]
    dxl = scatter_axis(dxg, mesh, "n", dim=1, schedule=schedule) \
        if pn > 1 else dxg
    dwl = scatter_axis(dwg, mesh, "m", dim=0, schedule=schedule) \
        if pm > 1 else dwg
    return dxl.to(xl.dtype), dwl.to(wl.dtype)


class _MatmulDistributed(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xl, wl, mesh, schedule):
        ctx.save_for_backward(xl, wl)
        ctx.args = (mesh, schedule)
        return _local_matmul(xl.detach(), wl.detach(), mesh,
                             schedule=schedule)

    @staticmethod
    def backward(ctx, g):
        xl, wl = ctx.saved_tensors
        mesh, schedule = ctx.args
        dxl, dwl = _local_matmul_bwd(xl, wl, g.contiguous(), mesh,
                                     schedule=schedule)
        return dxl, dwl, None, None


def matmul_distributed(xl: torch.Tensor, wl: torch.Tensor,
                       mesh: DeviceMesh, *,
                       schedule: str = "allgather",
                       save_gathered: bool = False) -> torch.Tensor:
    """``x @ w`` on the 3-axis grid, per rank: ``xl`` / ``wl`` are this
    rank's :data:`X_SPEC` / :data:`W_SPEC` shards; returns its
    :data:`OUT_SPEC` shard.  Differentiable (the backward rematerializes
    the gathers).  ``schedule="ring2"`` falls back to ``"ring"`` on grids
    :func:`matmul_ring2_supported` rejects."""
    if save_gathered:
        raise NotImplementedError(SAVE_GATHERED_LATER)
    if schedule not in SCHEDULES:
        raise ValueError(f"schedule must be one of {SCHEDULES}")
    if tuple(mesh.mesh_dim_names or ()) != AXES:
        raise ValueError(f"mesh axes must be {AXES}; use make_matmul_mesh")
    grid = mesh_grid(mesh, AXES)
    pm, pn, pc = grid
    M, C, N = xl.shape[0] * pm, xl.shape[1] * pc * pn, wl.shape[1] * pn
    if wl.shape[0] * pc * pm != C:
        raise ValueError(f"contraction mismatch: shards {tuple(xl.shape)} "
                         f"@ {tuple(wl.shape)} on grid {grid}")
    _check_matmul_shapes(M, C, N, grid)
    schedule = _matmul_effective_schedule(schedule, grid)
    if torch.is_grad_enabled() and (xl.requires_grad or wl.requires_grad):
        return _MatmulDistributed.apply(xl, wl, mesh, schedule)
    return _local_matmul(xl, wl, mesh, schedule=schedule)


def matmul_comm_elems(M: int, C: int, N: int, grid) -> dict:
    """Analytic per-device communication (elements) of the forward
    schedule -- identical for every schedule: each operand piece crosses
    its ring exactly once however it is pipelined."""
    pm, pn, pc = grid
    P_tot = pm * pn * pc
    gather_in = (M * C / P_tot) * (pn - 1)
    gather_ker = (C * N / P_tot) * (pm - 1)
    reduce_out = 2 * (M / pm) * (N / pn) * (pc - 1) / pc
    return {"gather_in": gather_in, "gather_ker": gather_ker,
            "reduce_out": reduce_out,
            "total": gather_in + gather_ker + reduce_out}


def matmul_train_comm_elems(M: int, C: int, N: int, grid, *,
                            save_gathered: bool = False) -> dict:
    """Forward + backward analytic per-device wire volume (elements): the
    backward replays both gathers and transposes each into an
    equal-volume reduce-scatter; the c-axis all-reduce transposes to
    nothing.  ``save_gathered=True`` drops the replay terms and pays the
    forward ``reduce_out`` once more."""
    fwd = matmul_comm_elems(M, C, N, grid)
    replay = 0.0 if save_gathered else 1.0
    bwd = {"gather_in_replay": replay * fwd["gather_in"],
           "gather_ker_replay": replay * fwd["gather_ker"],
           "rs_in": fwd["gather_in"],
           "rs_ker": fwd["gather_ker"],
           "psum_out_bwd": fwd["reduce_out"] if save_gathered else 0.0}
    bwd["total"] = sum(v for k, v in bwd.items() if k != "total")
    return {"fwd": fwd, "bwd": bwd, "total": fwd["total"] + bwd["total"]}


def _matmul_mem_parts(M: int, C: int, N: int, grid) -> dict:
    pm, pn, pc = grid
    return {"xl": (M / pm) * C / (pc * pn),
            "wl": (C / (pc * pm)) * (N / pn),
            "out": (M / pm) * (N / pn)}


def matmul_mem_elems(M: int, C: int, N: int, grid, *,
                     schedule: str = "allgather") -> dict:
    """Analytic per-device peak live memory (elements) of one forward
    pass: resident shards + the schedule's gather results / stream
    buffers + the output (doubled under a ``Pc > 1`` all-reduce)."""
    pm, pn, pc = grid
    schedule = _matmul_effective_schedule(schedule, grid)
    p = _matmul_mem_parts(M, C, N, grid)
    xl, wl, out = p["xl"], p["wl"], p["out"]
    if schedule == "allgather":
        in_t = pn * xl if pn > 1 else 0.0
        ker_t = pm * wl if pm > 1 else 0.0
    elif schedule == "ring":
        in_t = pn * xl + (xl if pn > 1 else 0.0) if pn > 1 else 0.0
        ker_t = stream_elems(pm, wl)
    else:  # ring2
        in_t = stream_elems(pn, xl)
        ker_t = stream_elems(pm, wl)
    comp = {"args": xl + wl, "in_transient": in_t, "ker_transient": ker_t,
            "out": out * (2.0 if pc > 1 else 1.0)}
    comp["peak"] = sum(comp.values())
    return comp


def matmul_train_mem_elems(M: int, C: int, N: int, grid, *,
                           schedule: str = "allgather",
                           save_gathered: bool = False) -> dict:
    """Peak live memory (elements) of a forward + backward pass (see
    ``dist.conv2d.conv_train_mem_elems`` for the model)."""
    pm, pn, pc = grid
    schedule = _matmul_effective_schedule(schedule, grid)
    fwd = matmul_mem_elems(M, C, N, grid, schedule=schedule)
    p = _matmul_mem_parts(M, C, N, grid)
    xl, wl, g = p["xl"], p["wl"], p["out"]
    if schedule == "ring2":
        din_t = stream_elems(pn, xl)
        dker_t = stream_elems(pm, wl)
    else:
        din_t = pn * xl if pn > 1 else 0.0
        dker_t = pm * wl if pm > 1 else 0.0
    resid = (pn * xl + pm * wl) if save_gathered else 0.0
    bwd = {"args": fwd["args"], "cotangent": g,
           "in_transient": 0.0 if save_gathered else fwd["in_transient"],
           "ker_transient": 0.0 if save_gathered else fwd["ker_transient"],
           "din": din_t + xl, "dker": dker_t + wl,
           "residuals": resid}
    bwd["peak"] = sum(v for k, v in bwd.items() if k != "peak")
    return {"fwd": fwd, "bwd": bwd,
            "peak": max(fwd["peak"] + resid, bwd["peak"])}
