"""Analytical data-movement cost model (paper Eqs. 1, 3, 4, 10, 11) --
the port of ``repro/core/cost_model.py`` (pure Python, a copy the port
keeps).

All costs are in *elements moved* between a fast memory of capacity ``M``
(elements) and a slow/global memory, exactly as in the paper.  The
distributed variants (Eq. 10/11) add the initial-distribution footprint.

Terminology follows the paper:
  N_i  problem extents,      i in {b, k, c, h, w}  (+ stencil r, s)
  W_i  work-partition extents (per-processor share of the iteration space)
  T_i  tile extents (unit executed out of fast memory)
  bhw  composite reuse-equivalent index, T_bhw = T_b*T_h*T_w
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

from repro_torch.core.problem import ConvProblem


@dataclasses.dataclass(frozen=True)
class TileChoice:
    """A concrete (W, T) choice.  Composite bhw extents are used throughout;
    the per-axis split of bhw is decided later (grid construction) and does
    not change any cost below (paper Sec. 2)."""

    Wbhw: float
    Wk: float
    Wc: float
    Tbhw: float
    Tk: float
    Tc: float = 1.0

    def feasible(self, p: ConvProblem, P: int, *, rtol: float = 1e-6) -> bool:
        ok = (
            1 - rtol <= self.Tbhw <= self.Wbhw * (1 + rtol)
            and 1 - rtol <= self.Tk <= self.Wk * (1 + rtol)
            and 1 - rtol <= self.Tc <= self.Wc * (1 + rtol)
            and self.Wbhw <= p.Nbhw * (1 + rtol)
            and self.Wk <= p.Nk * (1 + rtol)
            and self.Wc <= p.Nc * (1 + rtol)
        )
        work = P * self.Wbhw * self.Wk * self.Wc
        total = p.Nbhw * p.Nk * p.Nc
        return ok and math.isclose(work, total, rel_tol=1e-3)


# --------------------------------------------------------------------------
# Tile footprints (the "g" constraint expressions)
# --------------------------------------------------------------------------

def tile_footprint(p: ConvProblem, Tb: float, Tk: float, Tc: float,
                   Th: float, Tw: float) -> float:
    """Paper Eq. 1/3 constraint g: exact footprint of one tile in fast memory.

    g = (sw*Tw + Ns - 1)(sh*Th + Nr - 1) * Tb * Tc     (In tile + halo)
      + Tw*Th*Tb*Tk                                    (Out tile)
      + Nr*Ns*Tk*Tc                                    (Ker tile)
    """
    in_tile = (p.sw * Tw + p.Ns - 1) * (p.sh * Th + p.Nr - 1) * Tb * Tc
    out_tile = Tw * Th * Tb * Tk
    ker_tile = p.Nr * p.Ns * Tk * Tc
    return in_tile + out_tile + ker_tile


def tile_footprint_composite(p: ConvProblem, Tbhw: float, Tk: float,
                             Tc: float = 1.0) -> float:
    """Simplified footprint used in Eq. 4: g_L = Tbhw*Tk (+ dropped terms).

    We keep the dominant In/Ker terms for reporting but the Eq. 4 constraint
    itself is Tbhw*Tk <= M_L.
    """
    return Tbhw * Tk


# --------------------------------------------------------------------------
# Eq. 1: sequential single-level cost (global problem, single processor)
# --------------------------------------------------------------------------

def cost_sequential(p: ConvProblem, Tb: float, Tk: float, Th: float,
                    Tw: float) -> float:
    """Paper Eq. 1 with c as innermost tile loop (Tc = 1 slicing)."""
    out_term = p.Nb * p.Nk * p.Nw * p.Nh
    ker_term = (p.Nk * p.Nc * p.Nr * p.Ns * p.Nw * p.Nh * p.Nb
                / (Tw * Th * Tb))
    in_term = (p.Nb * p.Nc * (p.sw * Tw + p.Ns - 1) * (p.sh * Th + p.Nr - 1)
               * p.Nw * p.Nh * p.Nk / (Tw * Th * Tk))
    return out_term + ker_term + in_term


# --------------------------------------------------------------------------
# Eq. 3: per-processor cost under the global virtual-memory model
# --------------------------------------------------------------------------

def cost_global_memory(p: ConvProblem, c: TileChoice) -> float:
    """Paper Eq. 3 (composite-bhw form).

    cost = Wk*Wbhw                                  (Out written once)
         + Wk*Wc*Nr*Ns*Wbhw / Tbhw                  (Ker loaded per bhw tile)
         + Wc*(sw*sh approximately)*Wbhw*Wk / Tk    (In loaded per k tile)

    We use the exact halo form for the In term via an effective per-point
    expansion: for square-ish tiles Tbhw = Tb*Th*Tw the halo overhead of a
    (Th, Tw) footprint is (sh*Th+Nr-1)(sw*Tw+Ns-1)/(Th*Tw).  The composite
    model is exact when the caller provides `halo_factor`; by default we use
    the paper's Eq. 4 simplification (drop the Nr-1/Ns-1 additive terms),
    i.e. halo_factor = sh*sw.
    """
    out_term = c.Wk * c.Wbhw
    ker_term = c.Wk * c.Wc * p.Nr * p.Ns * c.Wbhw / c.Tbhw
    in_term = c.Wc * p.sh * p.sw * c.Wbhw * c.Wk / c.Tk
    return out_term + ker_term + in_term


def cost_global_memory_exact(p: ConvProblem, Wb: float, Wk: float, Wc: float,
                             Wh: float, Ww: float, Tb: float, Tk: float,
                             Th: float, Tw: float) -> float:
    """Paper Eq. 3 exact (with halos), per-axis form."""
    out_term = Wb * Wk * Ww * Wh
    ker_term = Wk * Wc * p.Nr * p.Ns * Ww * Wh * Wb / (Tw * Th * Tb)
    in_term = (Wb * Wc * (p.sw * Tw + p.Ns - 1) * (p.sh * Th + p.Nr - 1)
               * Ww * Wh * Wk / (Tw * Th * Tk))
    return out_term + ker_term + in_term


# --------------------------------------------------------------------------
# Eq. 4: the simplified analytically-solvable objective
# --------------------------------------------------------------------------

def cost_simplified(p: ConvProblem, P: int, Wbhw: float, Wk: float,
                    Tbhw: float, Tk: float) -> float:
    """Paper Eq. 4:

    cost_L = Wk*Wbhw + (Nk*Nc*Nbhw / P) * (Nr*Ns/Tbhw + sw*sh/Tk)
    """
    reuse = p.Nk * p.Nc * p.Nbhw / P
    return (Wk * Wbhw
            + reuse * (p.Nr * p.Ns / Tbhw + p.sw * p.sh / Tk))


def ml_from_m(p: ConvProblem, M: float) -> float:
    """Paper's correction mapping the true capacity M to the Eq. 4 capacity:

        M_L = M - (1/2) * 3K * (sqrt(9K^2 + 4M) - 3K),   K = sqrt(sw*sh*Nr*Ns)

    Using M_L = M instead yields lower bounds.
    """
    K = p.K
    return M - 1.5 * K * (math.sqrt(9 * K * K + 4 * M) - 3 * K)


# --------------------------------------------------------------------------
# Eq. 10/11: distributed-memory cost and memory constraint
# --------------------------------------------------------------------------

def cost_distributed_init(p: ConvProblem, P: int, c: TileChoice) -> float:
    """Paper Eq. 10 cost_I: initial distribution + final Out reduction.

    = Wbhw*Wk (Out slice, incl. reduction target) + size(In)/P + size(Ker)/P
    """
    return (c.Wbhw * c.Wk
            + p.size_in() / P
            + p.size_ker() / P)


def cost_distributed_comm(p: ConvProblem, c: TileChoice) -> float:
    """Paper Eq. 10 cost_C: broadcast volume for In and Ker (composite form,
    Eq. 4 simplification for the halo)."""
    ker_bcast = c.Wk * c.Wc * p.Nr * p.Ns * c.Wbhw / c.Tbhw
    in_bcast = c.Wc * p.sh * p.sw * c.Wbhw * c.Wk / c.Tk
    return ker_bcast + in_bcast


def cost_distributed_total(p: ConvProblem, P: int, c: TileChoice) -> float:
    """cost_D = cost_I + cost_C.  The paper proves
    cost_D - cost_globalmem = (size(In) + size(Ker)) / P."""
    return cost_distributed_init(p, P, c) + cost_distributed_comm(p, c)


def cost_distributed_bwd(p: ConvProblem, c: TileChoice) -> float:
    """Compute-phase communication of the backward passes (dIn + dKer).

    Both gradient passes reuse the forward grid (Demmel & Dinh 2018 /
    Chen et al. 2022 derive their bounds for the combined computation):
    dIn re-broadcasts Ker and reduce-scatters the In gradient (volume of
    the In broadcast it transposes); dKer re-broadcasts In and
    reduce-scatters the Ker gradient (volume of the Ker broadcast).  The
    Out all-reduce transposes to a broadcast of the already replicated
    cotangent — free.  Hence cost_C_bwd = 2 * cost_C_fwd.
    """
    return 2.0 * cost_distributed_comm(p, c)


def cost_distributed_train(p: ConvProblem, P: int, c: TileChoice) -> float:
    """Eq. 10 extended to a full training step: initial distribution +
    forward compute-phase communication + both backward passes,

        cost_T = cost_I + 3 * cost_C.

    This is the objective the dist-grid synthesizer
    (``core.sharding_synthesis.synthesize_dist_grid``) minimizes; the
    runtime counterpart with exact halo / sub-shard terms is
    ``repro_torch.dist.conv2d.conv_train_comm_elems``.
    """
    return (cost_distributed_init(p, P, c)
            + cost_distributed_comm(p, c)
            + cost_distributed_bwd(p, c))


def memory_distributed(p: ConvProblem, P: int, c: TileChoice) -> float:
    """Paper Eq. 11 g_D: tile buffers + resident initial distribution."""
    # Tile working buffers (In tile with halo + Ker tile).  Composite form.
    in_tile = p.sh * p.sw * c.Tbhw * c.Tc
    ker_tile = p.Nr * p.Ns * c.Tk * c.Tc
    resident = (c.Wbhw * c.Wk        # Out slice (replicated over c)
                + p.size_ker() / P       # Ker initial shard
                + p.size_in() / P)       # In initial shard
    return in_tile + ker_tile + resident


def memory_distributed_train(p: ConvProblem, P: int, c: TileChoice) -> float:
    """Eq. 11 extended to a training step: the backward pass additionally
    holds the Out cotangent (``Wbhw*Wk``, replicated like Out) and one
    gradient buffer per operand shard (dIn + dKer mirror the initial
    distribution).  Tile buffers are shared between the passes, so

        g_T = g_D + Wbhw*Wk + (size(In) + size(Ker)) / P.

    This is the model-level counterpart of the runtime
    ``repro_torch.dist.conv2d.conv_train_mem_elems`` peak; the
    synthesizer's ``mem_cap_elems`` filter uses the runtime accounting
    (exact halo / schedule terms), this closed form serves the paper-style
    analysis.
    """
    return (memory_distributed(p, P, c)
            + c.Wbhw * c.Wk
            + (p.size_in() + p.size_ker()) / P)


# --------------------------------------------------------------------------
# Simulation oracle: count data movement of an actual tiled execution
# --------------------------------------------------------------------------

def simulate_tiled_movement(p: ConvProblem, Tb: int, Tk: int, Tc: int,
                            Th: int, Tw: int,
                            Wb: Optional[int] = None,
                            Wk: Optional[int] = None,
                            Wc: Optional[int] = None,
                            Wh: Optional[int] = None,
                            Ww: Optional[int] = None) -> float:
    """Count elements moved by literally executing the tiled loop nest of
    Listing 3 (load In+halo tile, load Ker tile, store Out tile once).

    Used by tests to validate the closed-form Eq. 3 against ground truth.
    Extents default to the whole problem (single work-partition).
    """
    Wb = Wb or p.Nb
    Wk_ = Wk or p.Nk
    Wc_ = Wc or p.Nc
    Wh = Wh or p.Nh
    Ww = Ww or p.Nw

    def ceil_div(a: int, b: int) -> int:
        return -(-a // b)

    nb, nk, nc = ceil_div(Wb, Tb), ceil_div(Wk_, Tk), ceil_div(Wc_, Tc)
    nh, nw = ceil_div(Wh, Th), ceil_div(Ww, Tw)

    moved = 0.0
    # Out: each (b, k, h, w) tile written exactly once (c innermost).
    moved += Wb * Wk_ * Wh * Ww
    # Per (kt, bt, wt, ht, ct) iteration: load Ker tile + In tile with halo.
    for bt in range(nb):
        tb = min(Tb, Wb - bt * Tb)
        for ht in range(nh):
            th = min(Th, Wh - ht * Th)
            for wt in range(nw):
                tw = min(Tw, Ww - wt * Tw)
                for kt in range(nk):
                    tk = min(Tk, Wk_ - kt * Tk)
                    for ct in range(nc):
                        tc = min(Tc, Wc_ - ct * Tc)
                        in_tile = (tb * tc * (p.sh * th + p.Nr - 1)
                                   * (p.sw * tw + p.Ns - 1))
                        ker_tile = tk * tc * p.Nr * p.Ns
                        moved += in_tile + ker_tile
    return moved
