"""Processor-grid synthesis (paper Sec. 2.2) -- the port of
``repro/core/grid.py`` (pure Python, a copy the port keeps).

Turns a tile/work-partition solution into the logical multi-dimensional
processor grid ``P_b x P_k x P_c x P_h x P_w`` with ``P_i = N_i / W_i``,
splits the composite ``bhw`` extent over the physical axes (batch first --
batch partitioning needs no halo -- then h, then w), and reports the
algorithm family (2D SUMMA / 2.5D / 3D analogue).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

from repro_torch.core import cost_model, tile_optimizer
from repro_torch.core.problem import ConvProblem
from repro_torch.core.tile_optimizer import Solution


@dataclasses.dataclass(frozen=True)
class ProcessorGrid:
    """Logical grid; product of all extents == P."""

    Pb: int
    Pk: int
    Pc: int
    Ph: int
    Pw: int
    algo: str               # "2D-SUMMA" | "2.5D" | "3D"
    case: str
    solution: Solution

    @property
    def P(self) -> int:
        return self.Pb * self.Pk * self.Pc * self.Ph * self.Pw

    @property
    def Pbhw(self) -> int:
        return self.Pb * self.Ph * self.Pw

    def axis_sizes(self) -> Dict[str, int]:
        return {"b": self.Pb, "k": self.Pk, "c": self.Pc,
                "h": self.Ph, "w": self.Pw}

    def describe(self) -> str:
        return (f"{self.algo} grid b={self.Pb} h={self.Ph} w={self.Pw} "
                f"k={self.Pk} c={self.Pc} ({self.case})")


def _split_bhw(p: ConvProblem, pbhw: int) -> Tuple[int, int, int]:
    """Split the composite bhw processor extent into (Pb, Ph, Pw).

    Preference order: batch (embarrassingly parallel, no halo), then h,
    then w -- halos grow with spatial partitioning so spatial axes are used
    only when the batch extent is exhausted.  Each factor must divide the
    remaining composite extent; we greedily take the largest divisor of
    pbhw that divides the axis extent.
    """
    def prime_factors(n: int):
        d = 2
        while d * d <= n:
            while n % d == 0:
                yield d
                n //= d
            d += 1
        if n > 1:
            yield n

    pb = ph = pw = 1
    cap_b, cap_h, cap_w = p.Nb, p.Nh, p.Nw
    for f in sorted(prime_factors(pbhw), reverse=True):
        if cap_b % f == 0:
            pb *= f
            cap_b //= f
        elif cap_h % f == 0:
            ph *= f
            cap_h //= f
        elif cap_w % f == 0:
            pw *= f
            cap_w //= f
        else:
            raise ValueError(
                f"cannot split composite bhw extent {pbhw} over "
                f"(Nb={p.Nb}, Nh={p.Nh}, Nw={p.Nw}); stuck at factor {f}")
    return pb, ph, pw


def synthesize(p: ConvProblem, P: int, M: float, *,
               ml_correction: bool = True) -> ProcessorGrid:
    """End-to-end: solve the tile problem, build the processor grid."""
    sol = tile_optimizer.solve(p, P, M, ml_correction=ml_correction)
    pbhw = int(round(p.Nbhw / sol.choice.Wbhw))
    pk = int(round(p.Nk / sol.choice.Wk))
    pc = int(round(p.Nc / sol.choice.Wc))
    # Guard against drift: the integer solver always uses exact divisors.
    assert pbhw * pk * pc == P, (pbhw, pk, pc, P)
    pb, ph, pw = _split_bhw(p, pbhw)
    return ProcessorGrid(Pb=pb, Pk=pk, Pc=pc, Ph=ph, Pw=pw,
                         algo=sol.algo, case=sol.case, solution=sol)


def grid_from_tuple(p: ConvProblem, grid: Tuple[int, int, int, int, int],
                    *, algo: str = "manual") -> ProcessorGrid:
    """ProcessorGrid for an explicit ``(Pb, Ph, Pw, Pk, Pc)`` tuple.

    Per-processor work is ``W_i = N_i / P_i`` with maximal tiles
    ``T = W`` (single broadcast round), so :func:`comm_volume` on the
    result reports the paper's Eq. 10 cost for that explicit grid rather
    than for a solver-chosen tiling.  Validation here is the paper
    model's per-axis divisibility only; the ``repro_torch.dist`` runtime
    imposes stricter sub-shard constraints (e.g. ``Nc % (Pc*Pk)``) and
    checks them itself — use ``repro_torch.dist.conv2d.conv_comm_elems``
    for the runtime schedule's own wire accounting.
    """
    pb, ph, pw, pk, pc = grid
    for extent, div, what in [(p.Nb, pb, "Nb % Pb"), (p.Nh, ph, "Nh % Ph"),
                              (p.Nw, pw, "Nw % Pw"), (p.Nk, pk, "Nk % Pk"),
                              (p.Nc, pc, "Nc % Pc")]:
        if div <= 0 or extent % div:
            raise ValueError(f"grid {grid} does not divide the problem: "
                             f"{what} != 0 ({extent} % {div})")
    P = pb * ph * pw * pk * pc
    pbhw = pb * ph * pw
    choice = cost_model.TileChoice(
        Wbhw=p.Nbhw / pbhw, Wk=p.Nk / pk, Wc=p.Nc / pc,
        Tbhw=p.Nbhw / pbhw, Tk=p.Nk / pk)
    sol = Solution(case="manual", algo=algo, choice=choice,
                   cost=float("nan"), M_L=float("nan"), P=P)
    return ProcessorGrid(Pb=pb, Pk=pk, Pc=pc, Ph=ph, Pw=pw,
                         algo=algo, case="manual", solution=sol)


# --------------------------------------------------------------------------
# Communication-volume accounting for a concrete grid (per processor)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CommVolume:
    """Per-processor communication volume (elements) of the synthesized
    distributed algorithm, split by phase (paper Eq. 10)."""

    init_in: float        # initial scatter share of In
    init_ker: float       # initial scatter share of Ker
    bcast_in: float       # broadcast volume of In during compute
    bcast_ker: float      # broadcast volume of Ker during compute
    reduce_out: float     # final reduction of Out over the c axis
    halo: float           # spatial halo exchange (Ph/Pw > 1)

    @property
    def total(self) -> float:
        return (self.init_in + self.init_ker + self.bcast_in
                + self.bcast_ker + self.reduce_out + self.halo)


def comm_volume(p: ConvProblem, g: ProcessorGrid) -> CommVolume:
    c = g.solution.choice
    P = g.P
    init_in = p.size_in() / P
    init_ker = p.size_ker() / P
    # Broadcasts only happen along grid axes with >1 processors.
    bcast_ker = (c.Wk * c.Wc * p.Nr * p.Ns * c.Wbhw / c.Tbhw
                 if g.Pbhw > 1 else c.Wk * c.Wc * p.Nr * p.Ns)
    bcast_in = (c.Wc * p.sh * p.sw * c.Wbhw * c.Wk / c.Tk
                if g.Pk > 1 else c.Wc * p.sh * p.sw * c.Wbhw)
    reduce_out = c.Wbhw * c.Wk if g.Pc > 1 else 0.0
    # Halo volume: boundary rows/cols of the In partition, exchanged once.
    halo = 0.0
    if g.Ph > 1:
        halo += (p.Nr - 1) * (p.in_w / max(g.Pw, 1)) * (p.Nb / max(g.Pb, 1)) \
            * (p.Nc / max(g.Pc, 1))
    if g.Pw > 1:
        halo += (p.Ns - 1) * (p.in_h / max(g.Ph, 1)) * (p.Nb / max(g.Pb, 1)) \
            * (p.Nc / max(g.Pc, 1))
    return CommVolume(init_in=init_in, init_ker=init_ker, bcast_in=bcast_in,
                      bcast_ker=bcast_ker, reduce_out=reduce_out, halo=halo)


def compare_algorithms(p: ConvProblem, P: int,
                       memories: Dict[str, float]) -> Dict[str, CommVolume]:
    """Paper's central comparison: the same problem under different memory
    budgets lands in different regimes (2D vs 2.5D vs 3D)."""
    out = {}
    for name, M in memories.items():
        g = synthesize(p, P, M)
        out[f"{name}:{g.algo}"] = comm_volume(p, g)
    return out
