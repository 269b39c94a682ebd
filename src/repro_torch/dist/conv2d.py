"""Distributed 2-D convolution on the paper's 5-axis processor grid -- the
port of ``repro/dist/conv2d.py``.

Grid tuple convention: ``(Pb, Ph, Pw, Pk, Pc)`` over mesh axes
``("b", "h", "w", "k", "c")`` -- batch, image height, image width, output
features, input features (contraction).

Data placement (NCHW activations, OIHW kernels), as ``shard`` specs:

* ``In  [N, C, H, W]``  -- :data:`IN_SPEC` ``("b", ("c", "k"), "h", "w")``:
  channel block ``c * Pk + k``, so the only input collective is a gather
  over the k-axis;
* ``Ker [K, C, kh, kw]`` -- :data:`KER_SPEC` ``("k", ("c", "b"))``:
  channel block ``c * Pb + b``, gathered over the b-axis;
* ``Out [N, K, H', W']`` -- :data:`OUT_SPEC` ``("b", "k", "h", "w")``,
  produced by an all-reduce over the c-axis (replicated over c).

:func:`conv2d_distributed` is per-rank code: it takes this rank's In and
Ker shards and returns its Out shard (``shard`` / ``unshard`` in
``collectives`` do what ``shard_map``'s specs did implicitly).  Spatial
decomposition partitions the *output* rows evenly and rebuilds each
rank's input window from the evenly sharded input with
:func:`halo_exchange_1d` plus a per-rank window slice
(:class:`SpatialPlan`); the halo's zero fill is the SAME padding at the
global image edge.

``schedule="ring"`` rotates In's C-slabs around the k-ring and contracts
each as it arrives; ``schedule="ring2"`` rotates Ker's C-chunks around
the b-ring as well (:func:`collectives.ring_zip`), on the grids
:func:`conv_ring2_supported` accepts (``Pb == 1``, ``Pk == 1`` or
``Pb == Pk == 2``) and falls back to ``"ring"`` elsewhere.

**Differentiation** (the JAX package's ``custom_vjp``, here a
``torch.autograd.Function``): the backward rematerializes the forward
halo and gathers and transposes the forward communication -- the c-axis
all-reduce to nothing (the Out cotangent is complete on every c rank),
the k-axis In gather to a k-axis reduce-scatter of dIn, the b-axis Ker
gather to a b-axis reduce-scatter of dKer (after a psum over the spatial
axes, which replicate Ker), the halo exchange to
:func:`halo.halo_accumulate_1d`; ``ring2`` streams both gradients around
their rings (:func:`collectives.ring_scatter_reduce`).  Every local
contraction, forward and backward, goes through ``kernels.ops``.

``save_gathered=True`` differentiates the forward schedule natively
instead (the JAX package's ``_conv2d_raw``): autograd runs through the
forward's own collectives, whose transposes ``dist.collectives``
carries -- each gather (collective or ring) to a
reduce-scatter of its operand's gradient (``rs_in`` / ``rs_ker``), the
c-axis all-reduce to an all-reduce of the Out cotangent
(``psum_out_bwd``: the native transpose does not know the cotangent is
replicated), Ker's use on every spatial rank to a psum of dKer over h
and w (``psum_ker_spatial``, on the gathered kernel as in the custom
backward, on the chunk for ``ring2``), and the halo exchange to
:func:`halo.halo_accumulate_1d` (``halo_acc``) through the halo's own
Function.  The local contractions differentiate through their
``kernels.ops`` Functions, so the hand-written kernels run in the
backward too.  The gathered operands stay alive as autograd's saved
tensors: no gather is replayed, at the memory
``conv_train_mem_elems(..., save_gathered=True)`` counts.  The wire is
``conv_train_comm_elems(..., save_gathered=True)``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple, Union

import torch
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.dist.collectives import (SCHEDULES, axis_index, gather_axis,
                                          make_mesh, mesh_grid, ppermute,
                                          psum, psum_native, pvary,
                                          ring_reduce, ring_scatter_reduce,
                                          ring_zip, scatter_axis,
                                          stream_elems)
from repro_torch.dist.halo import halo_accumulate_1d, halo_exchange_1d
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ops import pad_amounts as _pad_amounts

AXES = ("b", "h", "w", "k", "c")
IN_SPEC = ("b", ("c", "k"), "h", "w")
KER_SPEC = ("k", ("c", "b"), None, None)
OUT_SPEC = ("b", "k", "h", "w")

Padding = Union[str, Tuple[Tuple[int, int], Tuple[int, int]]]


def make_conv_mesh(grid, *, device=None) -> DeviceMesh:
    """Mesh over ``("b", "h", "w", "k", "c")`` from ``(Pb,Ph,Pw,Pk,Pc)``."""
    if len(grid) != 5:
        raise ValueError(f"conv grid must be (Pb,Ph,Pw,Pk,Pc), got {grid}")
    return make_mesh(grid, AXES, device=device)


class SpatialPlan(NamedTuple):
    """Decomposition of one spatial dim over ``p`` ranks, general stride.

    Output rows are split evenly (``out % p == 0``); rank ``r`` evaluates
    global output rows ``[r*out/p, (r+1)*out/p)``, which read global input
    rows ``[r*(out/p)*s - lo, ...)`` -- a window of ``win`` rows whose
    start drifts by ``shift = (size - out*s)/p`` rows per rank relative to
    the evenly sharded input.  The uniform halo ``(lo_x, hi_x)`` covers
    the worst-case drift for every rank; each rank then slices its
    ``win``-row window at offset ``lo_x - lo - r*shift``.
    """

    p: int        # ranks on this axis
    size: int     # global input extent
    k: int        # kernel extent
    s: int        # stride
    lo: int       # conv padding below
    hi: int       # conv padding above
    out: int      # global output extent
    win: int      # per-rank input window rows = (out/p - 1)*s + k
    shift: int    # per-rank window drift = (size - out*s)/p
    lo_x: int     # uniform halo rows fetched from predecessors (+ zero pad)
    hi_x: int     # uniform halo rows fetched from successors (+ zero pad)

    @property
    def identity_slice(self) -> bool:
        return self.win == self.size // self.p + self.lo_x + self.hi_x \
            and self.shift == 0 and self.lo_x == self.lo

    def offset(self, index: int) -> int:
        """Local window start within the halo-extended block of the rank
        at coordinate ``index`` on this axis."""
        return self.lo_x - self.lo - index * self.shift


def _spatial_plan(size: int, k: int, s: int, pad, p: int,
                  dim: str) -> SpatialPlan:
    lo, hi, out = _pad_amounts(size, k, s, pad)
    if p <= 0 or size % p or out % p:
        raise ValueError(
            f"spatial sharding over '{dim}' needs the input extent "
            f"({size}) and output extent ({out}) divisible by P{dim}={p}")
    win = (out // p - 1) * s + k
    shift = (size - out * s) // p  # exact: p | size and p | out*s
    lo_x = lo + max(0, (p - 1) * shift)
    hi_x = max(0, win - lo - size // p + max(0, -(p - 1) * shift))
    return SpatialPlan(p=p, size=size, k=k, s=s, lo=lo, hi=hi, out=out,
                       win=win, shift=shift, lo_x=lo_x, hi_x=hi_x)


def _halo_and_window(xl, mesh, plans: Tuple[SpatialPlan, SpatialPlan]):
    """Halo-extend the local shard and slice this rank's conv window.

    Returns ``(extended_block, window, (off_h, off_w))``: the forward
    consumes the window; the backward also needs the block and the slice
    offsets to transpose the reconstruction."""
    plan_h, plan_w = plans
    xh = halo_exchange_1d(xl, mesh, "h", spatial_dim=2, lo=plan_h.lo_x,
                          hi=plan_h.hi_x)
    xh = halo_exchange_1d(xh, mesh, "w", spatial_dim=3, lo=plan_w.lo_x,
                          hi=plan_w.hi_x)
    off_h = plan_h.offset(axis_index(mesh, "h"))
    off_w = plan_w.offset(axis_index(mesh, "w"))
    xwin = xh
    if not plan_h.identity_slice:
        xwin = xwin.narrow(2, off_h, plan_h.win)
    if not plan_w.identity_slice:
        xwin = xwin.narrow(3, off_w, plan_w.win)
    return xh, xwin, (off_h, off_w)


def _add(acc, part):
    return part if acc is None else acc + part


def _conv_fwd_ring2(xwin, wl, mesh, *, pb, pk, conv):
    """Two-ring forward: In slabs rotate the k-ring, Ker chunks the b-ring.

    Supported cases: a trivial ring on either side (pure streaming
    against the stationary shard) or both rings of size 2 (own-shard
    covered zip)."""
    cx = xwin.shape[1]   # C / (Pc*Pk), the In c-slab width
    cw = wl.shape[1]     # C / (Pc*Pb), the Ker c-chunk width
    if pb == 1 and pk == 1:
        return conv(xwin, wl)
    if pk == 1:
        # In holds its full C/Pc columns: stream Ker chunks around the
        # b-ring, contract each against the matching In c-slice
        return ring_reduce(
            wl, mesh, "b",
            lambda acc, src, wchunk: _add(
                acc, conv(xwin.narrow(1, src * cw, cw), wchunk)), None,
            bwd_tag="rs_ker")
    if pb == 1:
        # Ker holds its full C/Pc rows: stream In slabs around the k-ring
        return ring_reduce(
            xwin, mesh, "k",
            lambda acc, src, slab: _add(
                acc, conv(slab, wl.narrow(1, src * cx, cx))), None,
            bwd_tag="rs_in")
    # Pb == Pk == 2: zip both rings.  Aligned ranks (k == b) see matching
    # c-ranges arrive together every step; misaligned ranks pair each
    # arrival against their own stationary shard instead.  Per rank the
    # alignment is a plain bool, so a masked-out contraction is skipped.
    kappa, beta = axis_index(mesh, "k"), axis_index(mesh, "b")
    aligned = kappa == beta

    def zip_body(acc, t, sx, cur_x, sw, cur_w):
        if aligned or sx == beta:
            acc = _add(acc, conv(cur_x, cur_w if aligned else wl))
        if not aligned and sw == kappa:
            acc = _add(acc, conv(xwin, cur_w))
        return acc

    return ring_zip(xwin, "k", wl, "b", mesh, zip_body, None,
                    bwd_tags=("rs_in", "rs_ker"))


def _local_conv(xl, wl, mesh, *, stride, plans, schedule):
    """The forward schedule, per rank.  Its collectives are the
    differentiable forms, so autograd through it is the native
    differentiation (``save_gathered=True``); inside the custom
    Function, without grad, they are the plain collectives."""
    pb, ph, pw, pk, pc = mesh_grid(mesh, AXES)
    # halo (interior) / zero pad (global boundary) on the thin C sub-shard,
    # before any gather so boundary traffic is minimal
    _, xl, _ = _halo_and_window(xl, mesh, plans)
    # per-step local contraction through the kernel dispatcher
    conv = functools.partial(kops.local_conv2d, stride=stride,
                             padding="VALID")
    if schedule == "ring2":
        # Ker meets every spatial rank's In: its gradient sums over h, w
        wl = pvary(wl, mesh, ("h", "w"), bwd_tag="psum_ker_spatial")
        out = _conv_fwd_ring2(xl, wl, mesh, pb=pb, pk=pk, conv=conv)
    else:
        # kernel contraction sub-shard gathered over the batch axis
        wg = gather_axis(wl, mesh, "b", dim=1, schedule=schedule,
                         bwd_tag="rs_ker") if pb > 1 else wl
        wg = pvary(wg, mesh, ("h", "w"), bwd_tag="psum_ker_spatial")
        if pk == 1:
            out = conv(xl, wg)
        elif schedule == "ring":
            # ring-pipelined c-slab reduction: In's C-slabs rotate around
            # the k-ring; contract each against the matching kernel slice
            csub = xl.shape[1]
            out = ring_reduce(
                xl, mesh, "k",
                lambda acc, src, slab: _add(
                    acc, conv(slab, wg.narrow(1, src * csub, csub))), None,
                bwd_tag="rs_in")
        else:
            out = conv(gather_axis(xl, mesh, "k", dim=1, schedule=schedule,
                                   bwd_tag="rs_in"), wg)
    if pc > 1:
        out = psum_native(out, mesh, "c", tag="conv_out",
                          bwd_tag="psum_out_bwd")
    return out


# --------------------------------------------------------------------------
# Backward pass: the transposed communication schedule
# --------------------------------------------------------------------------

def _dx_local(gl, wg, *, stride):
    """dIn of the local VALID conv: the transposed-kernel conv.  Stride 1
    is a VALID conv of the edge-padded cotangent against the flipped,
    O/I-swapped kernel and goes through the kernel dispatcher; a strided
    conv dilates the cotangent (``conv_transpose2d``)."""
    kh, kw = wg.shape[2], wg.shape[3]
    if tuple(stride) == (1, 1):
        gp = F.pad(gl, (kw - 1, kw - 1, kh - 1, kh - 1)).contiguous()
        wt = wg.flip(2, 3).transpose(0, 1).contiguous()
        return kops.local_conv2d(gp, wt, stride=(1, 1), padding="VALID")
    return F.conv_transpose2d(gl.float(), wg.float(), stride=stride)


def _dw_local(xg, gl, *, stride, ksize):
    """dKer of the local VALID conv: In slides under the (stride-dilated)
    cotangent, contracting over N.  Stride 1 is the N/C-transposed VALID
    conv through the kernel dispatcher; strided needs a dilated kernel."""
    if tuple(stride) == (1, 1):
        out = kops.local_conv2d(xg.transpose(0, 1).contiguous(),
                                gl.transpose(0, 1).contiguous(),
                                stride=(1, 1), padding="VALID")
        return out.transpose(0, 1).contiguous()
    out = F.conv2d(xg.transpose(0, 1).float(), gl.transpose(0, 1).float(),
                   dilation=stride)
    return out.transpose(0, 1)[:, :, :ksize[0], :ksize[1]].contiguous()


def _place(acc, part, start, dim):
    acc.narrow(dim, start, part.shape[dim]).copy_(part)
    return acc


def _conv_bwd_ring2(xwin, wl, gl, mesh, *, pb, pk, stride, psp):
    """Streaming backward of the two-ring schedule: dIn slabs are produced
    on the fly and reduced around the k-ring, dKer chunks around the
    b-ring; the spatial psum applies to the already-scattered chunk.
    Returns ``(dxwin, dwl)`` in windowed/local layout."""
    cx = xwin.shape[1]
    cw = wl.shape[1]
    ksize = wl.shape[2:]
    ring2 = [(i, (i + 1) % 2) for i in range(2)]
    aligned = axis_index(mesh, "k") == axis_index(mesh, "b")

    # --- dIn: per-slab transposed-kernel conv ------------------------------
    if pk == 1:
        if pb == 1:
            dxwin = _dx_local(gl, wl, stride=stride)
        else:
            # stream Ker chunks around the b-ring; each fills its c-rows
            dxwin = ring_reduce(
                wl, mesh, "b",
                lambda acc, src, wchunk: _place(
                    acc, _dx_local(gl, wchunk, stride=stride), src * cw, 1),
                torch.zeros(xwin.shape, dtype=gl.dtype, device=gl.device))
    elif pb == 1:
        # Ker holds its full rows: produce each k-ring token's slab locally
        dxwin = ring_scatter_reduce(
            mesh, "k", lambda r, t: _dx_local(
                gl, wl.narrow(1, r * cx, cx), stride=stride))
    else:  # Pb == Pk == 2: one b-hop re-delivers the foreign Ker chunk
        w_arr = ppermute(wl, mesh, "b", ring2, tag="ring2_redeliver")

        def produce_dx(r, t):
            first = w_arr if aligned else wl
            other = wl if aligned else w_arr
            return _dx_local(gl, first if t == 0 else other, stride=stride)

        dxwin = ring_scatter_reduce(mesh, "k", produce_dx)

    # --- dKer: per-chunk batch contraction -------------------------------
    if pb == 1:
        if pk == 1:
            dwl = _dw_local(xwin, gl, stride=stride, ksize=ksize)
        else:
            # stream In slabs around the k-ring; each fills its c-rows
            dwl = ring_reduce(
                xwin, mesh, "k",
                lambda acc, src, slab: _place(
                    acc, _dw_local(slab, gl, stride=stride, ksize=ksize),
                    src * cx, 1),
                torch.zeros((wl.shape[0], cw) + tuple(ksize),
                            dtype=gl.dtype, device=gl.device))
    elif pk == 1:
        dwl = ring_scatter_reduce(
            mesh, "b", lambda r, t: _dw_local(
                xwin.narrow(1, r * cw, cw), gl, stride=stride, ksize=ksize))
    else:  # Pb == Pk == 2: one k-hop re-delivers the foreign In slab
        x_arr = ppermute(xwin, mesh, "k", ring2, tag="ring2_redeliver")

        def produce_dw(r, t):
            first = x_arr if aligned else xwin
            other = xwin if aligned else x_arr
            return _dw_local(first if t == 0 else other, gl, stride=stride,
                             ksize=ksize)

        dwl = ring_scatter_reduce(mesh, "b", produce_dw)
    if psp > 1:  # Ker was replicated over h/w: the transpose is a psum
        dwl = psum(dwl, mesh, ("h", "w"), tag="dker_spatial")
    return dxwin, dwl


def _local_conv_bwd(xl, wl, gl, mesh, *, stride, plans, schedule):
    """The transposed schedule, per rank: ``gl`` (the Out cotangent)
    arrives complete on every c rank (transpose of the all-reduce); the
    forward gathers are replayed (or re-streamed, for ``ring2``), dIn is
    reduce-scattered over k and halo-accumulated, dKer is psum'd over the
    spatial axes and reduce-scattered over b."""
    pb, ph, pw, pk, pc = mesh_grid(mesh, AXES)
    plan_h, plan_w = plans
    # replay the forward operand reconstruction (rematerialized, not saved)
    xh, xwin, (off_h, off_w) = _halo_and_window(xl, mesh, plans)
    ksize = wl.shape[2:]
    if schedule == "ring2":
        dxwin, dwl = _conv_bwd_ring2(xwin, wl, gl, mesh, pb=pb, pk=pk,
                                     stride=stride, psp=ph * pw)
    else:
        wg = gather_axis(wl, mesh, "b", dim=1, schedule=schedule) \
            if pb > 1 else wl
        xg = gather_axis(xwin, mesh, "k", dim=1, schedule=schedule) \
            if pk > 1 else xwin
        # --- dIn: transposed-kernel conv, k-gather -> k-scatter ----------
        dxg = _dx_local(gl, wg, stride=stride)
        dxwin = scatter_axis(dxg, mesh, "k", dim=1, schedule=schedule) \
            if pk > 1 else dxg
        # --- dKer: batch/spatial contraction, b-gather -> b-scatter ------
        dwg = _dw_local(xg, gl, stride=stride, ksize=ksize)
        if ph * pw > 1:  # Ker was replicated over h/w: transpose is a psum
            dwg = psum(dwg, mesh, ("h", "w"), tag="dker_spatial")
        dwl = scatter_axis(dwg, mesh, "b", dim=1, schedule=schedule) \
            if pb > 1 else dwg
    if plan_h.identity_slice and plan_w.identity_slice:
        dxe = dxwin
    else:  # transpose of the window slice: scatter back into the block
        dxe = torch.zeros(xh.shape, dtype=dxwin.dtype, device=dxwin.device)
        dst = dxe
        if not plan_h.identity_slice:
            dst = dst.narrow(2, off_h, plan_h.win)
        if not plan_w.identity_slice:
            dst = dst.narrow(3, off_w, plan_w.win)
        dst.copy_(dxwin)
    dxl = halo_accumulate_1d(dxe, mesh, "w", spatial_dim=3, lo=plan_w.lo_x,
                             hi=plan_w.hi_x)
    dxl = halo_accumulate_1d(dxl, mesh, "h", spatial_dim=2, lo=plan_h.lo_x,
                             hi=plan_h.hi_x)
    return dxl.to(xl.dtype), dwl.to(wl.dtype)


class _Conv2dDistributed(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xl, wl, mesh, stride, plans, schedule):
        ctx.save_for_backward(xl, wl)
        ctx.args = (mesh, stride, plans, schedule)
        return _local_conv(xl.detach(), wl.detach(), mesh, stride=stride,
                           plans=plans, schedule=schedule)

    @staticmethod
    def backward(ctx, g):
        xl, wl = ctx.saved_tensors
        mesh, stride, plans, schedule = ctx.args
        dxl, dwl = _local_conv_bwd(xl, wl, g.contiguous(), mesh,
                                   stride=stride, plans=plans,
                                   schedule=schedule)
        return dxl, dwl, None, None, None, None


def conv_ring2_supported(grid) -> bool:
    """True when the two-ring schedule covers ``grid = (Pb,Ph,Pw,Pk,Pc)``:
    a trivial ring on either contraction side or both rings of size 2."""
    pb, ph, pw, pk, pc = grid
    return pb == 1 or pk == 1 or (pb == 2 and pk == 2)


def _conv_effective_schedule(schedule: str, grid) -> str:
    if schedule == "ring2" and not conv_ring2_supported(grid):
        return "ring"
    return schedule


def _conv_plans(x_shape, w_shape, grid, stride, padding
                ) -> Tuple[SpatialPlan, SpatialPlan]:
    N, C, H, W = x_shape
    K, C2, kh, kw = w_shape
    pb, ph, pw, pk, pc = grid
    if C != C2:
        raise ValueError(f"channel mismatch: x {x_shape} vs w {w_shape}")
    pad_spec = (padding, padding) if isinstance(padding, str) else padding
    plan_h = _spatial_plan(H, kh, stride[0], pad_spec[0], ph, "h")
    plan_w = _spatial_plan(W, kw, stride[1], pad_spec[1], pw, "w")
    for extent, div, what in [
            (N, pb, "N % Pb"), (K, pk, "K % Pk"), (C, pc * pk, "C % (Pc*Pk)"),
            (C, pc * pb, "C % (Pc*Pb)")]:
        if div <= 0 or extent % div:
            raise ValueError(f"shape not divisible by grid: {what} != 0 "
                             f"({extent} % {div})")
    return plan_h, plan_w


def conv_grid_divides(x_shape, w_shape, grid, *, stride=(1, 1),
                      padding: Padding = "SAME") -> bool:
    """True when the global shapes satisfy every divisibility constraint
    of :func:`conv2d_distributed` on ``grid``."""
    if isinstance(stride, int):
        stride = (stride, stride)
    try:
        _conv_plans(x_shape, w_shape, grid, tuple(stride), padding)
    except ValueError:
        return False
    return True


def conv2d_distributed(xl: torch.Tensor, wl: torch.Tensor,
                       mesh: DeviceMesh, *, schedule: str = "allgather",
                       stride: Union[int, Tuple[int, int]] = (1, 1),
                       padding: Padding = "SAME",
                       save_gathered: bool = False) -> torch.Tensor:
    """NCHW x OIHW convolution distributed over a 5-axis grid, per rank.

    ``xl`` / ``wl`` are this rank's :data:`IN_SPEC` / :data:`KER_SPEC`
    shards (``collectives.shard``); returns its :data:`OUT_SPEC` shard.
    Unsharded, the result matches ``F.conv2d`` with XLA's ``padding``
    rules.  Differentiable: by default the backward rematerializes the
    forward gathers; ``save_gathered=True`` differentiates the forward
    natively, keeping the gathered operands for the backward and paying
    no gather-replay wire (see the module docstring).
    ``schedule="ring2"`` falls back to ``"ring"`` on grids
    :func:`conv_ring2_supported` rejects."""
    if schedule not in SCHEDULES:
        raise ValueError(f"schedule must be one of {SCHEDULES}")
    if tuple(mesh.mesh_dim_names or ()) != AXES:
        raise ValueError(f"mesh axes must be {AXES}; use make_conv_mesh")
    if isinstance(stride, int):
        stride = (stride, stride)
    grid = mesh_grid(mesh, AXES)
    pb, ph, pw, pk, pc = grid
    n, cx, h, w = xl.shape
    k, cw, kh, kw = wl.shape
    x_shape = (n * pb, cx * pc * pk, h * ph, w * pw)
    w_shape = (k * pk, cw * pc * pb, kh, kw)
    plans = _conv_plans(x_shape, w_shape, grid, tuple(stride), padding)
    schedule = _conv_effective_schedule(schedule, grid)
    if not save_gathered and torch.is_grad_enabled() and (
            xl.requires_grad or wl.requires_grad):
        return _Conv2dDistributed.apply(xl, wl, mesh, tuple(stride), plans,
                                        schedule)
    return _local_conv(xl, wl, mesh, stride=tuple(stride), plans=plans,
                       schedule=schedule)


# --------------------------------------------------------------------------
# Analytic per-device communication and memory accounting (fwd and bwd)
# --------------------------------------------------------------------------

def conv_comm_elems(x_shape, w_shape, grid, *, stride=(1, 1),
                    padding: Padding = "SAME") -> dict:
    """Analytic per-device communication (elements) of the forward
    schedule: gather In over k, gather Ker over b, all-reduce Out over c,
    plus the spatial halo."""
    if isinstance(stride, int):
        stride = (stride, stride)
    N, C, H, W = x_shape
    K, _, kh, kw = w_shape
    pb, ph, pw, pk, pc = grid
    plan_h, plan_w = _conv_plans(x_shape, w_shape, grid, stride, padding)
    csub_in = C / (pc * pk)
    gather_in = (N / pb) * csub_in * plan_h.win * plan_w.win * (pk - 1)
    gather_ker = K / pk * (C / (pc * pb)) * kh * kw * (pb - 1)
    reduce_out = 2 * (N / pb) * (K / pk) * (plan_h.out / ph) \
        * (plan_w.out / pw) * (pc - 1) / pc
    halo = 0.0
    if ph > 1:
        halo += (plan_h.lo_x + plan_h.hi_x) * (N / pb) * csub_in * (W // pw)
    if pw > 1:
        h_ext = H // ph + plan_h.lo_x + plan_h.hi_x
        halo += (plan_w.lo_x + plan_w.hi_x) * (N / pb) * csub_in * h_ext
    return {"gather_in": gather_in, "gather_ker": gather_ker,
            "reduce_out": reduce_out, "halo": halo,
            "total": gather_in + gather_ker + reduce_out + halo}


def conv_train_comm_elems(x_shape, w_shape, grid, *, stride=(1, 1),
                          padding: Padding = "SAME",
                          schedule: str = "allgather",
                          save_gathered: bool = False) -> dict:
    """Forward + backward analytic per-device wire volume (elements).

    The backward replays the forward halo and both gathers, then
    transposes them: dIn reduce-scatters over k (the In gather's volume)
    and halo-accumulates (the halo's), dKer all-reduces over the spatial
    axes and reduce-scatters over b (the Ker gather's).  The c-axis
    all-reduce has no backward counterpart.  ``save_gathered=True``
    models the residual-saving VJP: no replay terms, one extra
    ``reduce_out`` psum.  ``ring2`` (on supported grids) scatters dKer
    over b *before* the spatial psum, shrinking that term by ``1/Pb``."""
    if isinstance(stride, int):
        stride = (stride, stride)
    K, C, kh, kw = w_shape[0], w_shape[1], w_shape[2], w_shape[3]
    pb, ph, pw, pk, pc = grid
    schedule = _conv_effective_schedule(schedule, grid)
    fwd = conv_comm_elems(x_shape, w_shape, grid, stride=stride,
                          padding=padding)
    psp = ph * pw
    ker_rows = C / pc if schedule != "ring2" else C / (pc * pb)
    psum_ker = (2 * (K / pk) * ker_rows * kh * kw * (psp - 1) / psp
                if psp > 1 else 0.0)
    replay = 0.0 if save_gathered else 1.0
    bwd = {"halo_replay": replay * fwd["halo"],
           "gather_in_replay": replay * fwd["gather_in"],
           "gather_ker_replay": replay * fwd["gather_ker"],
           "rs_in": fwd["gather_in"],
           "rs_ker": fwd["gather_ker"],
           "psum_ker_spatial": psum_ker,
           "psum_out_bwd": fwd["reduce_out"] if save_gathered else 0.0,
           "halo_acc": fwd["halo"]}
    bwd["total"] = sum(v for k, v in bwd.items() if k != "total")
    return {"fwd": fwd, "bwd": bwd, "total": fwd["total"] + bwd["total"]}


def _conv_mem_parts(x_shape, w_shape, grid, stride, padding) -> dict:
    """Per-device buffer sizes (elements) the peak-live accounting is
    assembled from."""
    N, C, H, W = x_shape
    K, _, kh, kw = w_shape
    pb, ph, pw, pk, pc = grid
    plan_h, plan_w = _conv_plans(x_shape, w_shape, grid, stride, padding)
    cx = C / (pc * pk)
    nb = N / pb
    return {
        "xl": nb * cx * (H / ph) * (W / pw),
        "xh": nb * cx * (H / ph + plan_h.lo_x + plan_h.hi_x)
              * (W / pw + plan_w.lo_x + plan_w.hi_x),
        "xwin": nb * cx * plan_h.win * plan_w.win,
        "wl": (K / pk) * (C / (pc * pb)) * kh * kw,
        "out": nb * (K / pk) * (plan_h.out / ph) * (plan_w.out / pw),
    }


def conv_mem_elems(x_shape, w_shape, grid, *, stride=(1, 1),
                   padding: Padding = "SAME",
                   schedule: str = "allgather") -> dict:
    """Analytic per-device peak live memory (elements) of one forward
    pass: resident shards, the halo-extended block and conv window, the
    schedule's gather results / stream buffers, and the output (doubled
    under a ``Pc > 1`` all-reduce for the partial-sum buffer)."""
    if isinstance(stride, int):
        stride = (stride, stride)
    pb, ph, pw, pk, pc = grid
    schedule = _conv_effective_schedule(schedule, grid)
    p = _conv_mem_parts(x_shape, w_shape, grid, stride, padding)
    xwin, wl = p["xwin"], p["wl"]
    if schedule == "allgather":
        in_t = pk * xwin if pk > 1 else 0.0
        ker_t = pb * wl if pb > 1 else 0.0
    elif schedule == "ring":
        in_t = stream_elems(pk, xwin)
        ker_t = pb * wl + (wl if pb > 1 else 0.0) if pb > 1 else 0.0
    else:  # ring2: both operands stream, nothing gathered
        in_t = stream_elems(pk, xwin)
        ker_t = stream_elems(pb, wl)
    comp = {"args": p["xl"] + wl, "halo": p["xh"] + xwin,
            "in_transient": in_t, "ker_transient": ker_t,
            "out": p["out"] * (2.0 if pc > 1 else 1.0)}
    comp["peak"] = sum(comp.values())
    return comp


def conv_train_mem_elems(x_shape, w_shape, grid, *, stride=(1, 1),
                         padding: Padding = "SAME",
                         schedule: str = "allgather",
                         save_gathered: bool = False) -> dict:
    """Peak live memory (elements) of a forward + backward pass: the
    rematerializing backward replays the forward reconstruction and also
    holds the cotangent, the gathered gradient buffers (``Pk`` dIn
    windows / ``Pb`` dKer chunks; O(1) token buffers for ``ring2``) and
    the operand gradients.  ``save_gathered=True`` adds the saved
    residuals to both phases."""
    if isinstance(stride, int):
        stride = (stride, stride)
    pb, ph, pw, pk, pc = grid
    schedule = _conv_effective_schedule(schedule, grid)
    fwd = conv_mem_elems(x_shape, w_shape, grid, stride=stride,
                         padding=padding, schedule=schedule)
    p = _conv_mem_parts(x_shape, w_shape, grid, stride, padding)
    xwin, wl = p["xwin"], p["wl"]
    if schedule == "ring2":
        din_t = stream_elems(pk, xwin)   # dIn token ring
        dker_t = stream_elems(pb, wl)    # dKer token ring
    else:
        din_t = pk * xwin if pk > 1 else 0.0    # materialized dxg
        dker_t = pb * wl if pb > 1 else 0.0     # materialized dwg
    resid = (pk * xwin + pb * wl) if save_gathered else 0.0
    bwd = {"args": fwd["args"], "halo": fwd["halo"], "cotangent": p["out"],
           "in_transient": 0.0 if save_gathered else fwd["in_transient"],
           "ker_transient": 0.0 if save_gathered else fwd["ker_transient"],
           # token/gathered buffers + unwindow block + dxl / + dwl
           "din": din_t + p["xh"] + p["xl"],
           "dker": dker_t + wl,
           "residuals": resid}
    bwd["peak"] = sum(v for k, v in bwd.items() if k != "peak")
    fwd_peak = fwd["peak"] + resid
    return {"fwd": fwd, "bwd": bwd,
            "peak": max(fwd_peak, bwd["peak"])}
