"""Distributed 2-D convolution on the paper's 5-axis processor grid -- the
forward of ``repro/dist/conv2d.py``.

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
``Pb == Pk == 2``) and falls back to ``"ring"`` elsewhere.  The
forward-only slice: the custom VJP of the JAX package is a later slice.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple, Union

import torch
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.device import forward_only
from repro_torch.dist.collectives import (SCHEDULES, axis_index, gather_axis,
                                          make_mesh, mesh_grid, psum,
                                          ring_reduce, ring_zip,
                                          stream_elems)
from repro_torch.dist.halo import halo_exchange_1d
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
    """Halo-extend the local shard and slice this rank's conv window."""
    plan_h, plan_w = plans
    xh = halo_exchange_1d(xl, mesh, "h", spatial_dim=2, lo=plan_h.lo_x,
                          hi=plan_h.hi_x)
    xh = halo_exchange_1d(xh, mesh, "w", spatial_dim=3, lo=plan_w.lo_x,
                          hi=plan_w.hi_x)
    if not plan_h.identity_slice:
        xh = xh.narrow(2, plan_h.offset(axis_index(mesh, "h")), plan_h.win)
    if not plan_w.identity_slice:
        xh = xh.narrow(3, plan_w.offset(axis_index(mesh, "w")), plan_w.win)
    return xh


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
                acc, conv(xwin.narrow(1, src * cw, cw), wchunk)), None)
    if pb == 1:
        # Ker holds its full C/Pc rows: stream In slabs around the k-ring
        return ring_reduce(
            xwin, mesh, "k",
            lambda acc, src, slab: _add(
                acc, conv(slab, wl.narrow(1, src * cx, cx))), None)
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

    return ring_zip(xwin, "k", wl, "b", mesh, zip_body, None)


def _local_conv(xl, wl, mesh, *, stride, plans, schedule):
    pb, ph, pw, pk, pc = mesh_grid(mesh, AXES)
    # halo (interior) / zero pad (global boundary) on the thin C sub-shard,
    # before any gather so boundary traffic is minimal
    xl = _halo_and_window(xl, mesh, plans)
    # per-step local contraction through the kernel dispatcher
    conv = functools.partial(kops.local_conv2d, stride=stride,
                             padding="VALID")
    if schedule == "ring2":
        out = _conv_fwd_ring2(xl, wl, mesh, pb=pb, pk=pk, conv=conv)
    else:
        # kernel contraction sub-shard gathered over the batch axis
        wg = gather_axis(wl, mesh, "b", dim=1, schedule=schedule) \
            if pb > 1 else wl
        if pk == 1:
            out = conv(xl, wg)
        elif schedule == "ring":
            # ring-pipelined c-slab reduction: In's C-slabs rotate around
            # the k-ring; contract each against the matching kernel slice
            csub = xl.shape[1]
            out = ring_reduce(
                xl, mesh, "k",
                lambda acc, src, slab: _add(
                    acc, conv(slab, wg.narrow(1, src * csub, csub))), None)
        else:
            out = conv(gather_axis(xl, mesh, "k", dim=1, schedule=schedule),
                       wg)
    if pc > 1:
        out = psum(out, mesh, "c", tag="conv_out")
    return out


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
                       padding: Padding = "SAME") -> torch.Tensor:
    """NCHW x OIHW convolution distributed over a 5-axis grid, per rank.

    ``xl`` / ``wl`` are this rank's :data:`IN_SPEC` / :data:`KER_SPEC`
    shards (``collectives.shard``); returns its :data:`OUT_SPEC` shard.
    Unsharded, the result matches ``F.conv2d`` with XLA's ``padding``
    rules.  ``schedule="ring2"`` falls back to ``"ring"`` on grids
    :func:`conv_ring2_supported` rejects."""
    forward_only(xl, wl)
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
    return _local_conv(xl, wl, mesh, stride=tuple(stride), plans=plans,
                       schedule=_conv_effective_schedule(schedule, grid))


# --------------------------------------------------------------------------
# Analytic per-device communication and memory accounting (forward)
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
