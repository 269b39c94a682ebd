"""Closed-form solutions of the paper's tile-size optimization (Tables
1-2) -- the port of ``repro/core/tile_optimizer.py`` (pure Python, a copy
the port keeps).

Given a :class:`ConvProblem`, processor count ``P`` and fast-memory capacity
``M`` (elements), produce the optimal work-partition/tile extents
``(W_bhw, W_k, W_c, T_bhw, T_k)`` minimizing the Eq. 4 data-movement cost,
classified into the paper's regimes:

  Case 1a  ->  2D SUMMA analogue   (W_c = N_c, memory-limited tiles)
  Case 1b  ->  2D, memory-ample    (tile == work partition)
  Case 2a  ->  3D analogue         (W_c < N_c, communication-optimal bound)
  Case 2b  ->  2.5D analogue       (W_c < N_c, memory-saturating tiles)

`solve_closed_form` returns the analytic (real-valued) optimum; `solve`
projects it onto feasible integers and re-evaluates the exact Eq. 3 cost.
`brute_force` is the test oracle.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterable, List, Optional, Tuple

from repro_torch.core import cost_model
from repro_torch.core.cost_model import TileChoice
from repro_torch.core.problem import ConvProblem

CASE_2D_LIMITED = "1a (2D SUMMA, memory-limited)"
CASE_2D_AMPLE = "1b (2D SUMMA, memory-ample)"
CASE_3D = "2a (3D)"
CASE_25D = "2b (2.5D)"

ALGO_2D = "2D-SUMMA"
ALGO_25D = "2.5D"
ALGO_3D = "3D"

_CASE_TO_ALGO = {
    CASE_2D_LIMITED: ALGO_2D,
    CASE_2D_AMPLE: ALGO_2D,
    CASE_3D: ALGO_3D,
    CASE_25D: ALGO_25D,
}


@dataclasses.dataclass(frozen=True)
class Solution:
    case: str
    algo: str
    choice: TileChoice
    cost: float          # Eq. 4 cost at the chosen point
    M_L: float
    P: int

    def distributed_cost(self, p: ConvProblem) -> float:
        return cost_model.cost_distributed_total(p, self.P, self.choice)


def _clamp(x: float, lo: float, hi: float) -> float:
    return max(lo, min(x, hi))


def _best_tiles_given_W(p: ConvProblem, Wbhw: float, Wk: float,
                        M_L: float) -> Tuple[float, float]:
    """Minimize NrNs/Tbhw + sw*sh/Tk  s.t.  Tbhw*Tk <= M_L, T <= W, T >= 1.

    Lagrange point: Tk = sqrt(M_L * sw*sh / (Nr*Ns)),
                    Tbhw = sqrt(M_L * Nr*Ns / (sw*sh));
    clamp to [1, W] and re-saturate the budget with the free variable.
    """
    rho = p.Nr * p.Ns          # weight-tile reuse coefficient
    sig = p.sw * p.sh          # input-tile reuse coefficient
    if Wbhw * Wk <= M_L:       # whole partition fits: no inner tiling needed
        return Wbhw, Wk
    tk = math.sqrt(M_L * sig / rho)
    tbhw = math.sqrt(M_L * rho / sig)
    if tk > Wk:
        tk = Wk
        tbhw = M_L / tk
    elif tbhw > Wbhw:
        tbhw = Wbhw
        tk = M_L / tbhw
    return _clamp(tbhw, 1.0, Wbhw), _clamp(tk, 1.0, Wk)


# --------------------------------------------------------------------------
# Closed forms (Table 1, c-innermost permutation)
# --------------------------------------------------------------------------

def solve_closed_form(p: ConvProblem, P: int, M: float,
                      *, ml_correction: bool = True) -> Solution:
    """Analytic optimum of Eq. 4 per Table 1, with the M -> M_L correction."""
    M_L = cost_model.ml_from_m(p, M) if ml_correction else float(M)
    if M_L <= 1:
        raise ValueError(f"memory too small after M_L correction: {M_L}")

    rho = p.Nr * p.Ns
    sig = p.sw * p.sh
    nkb_over_p = p.Nk * p.Nbhw / P           # N_k * N_bhw / P
    reuse = p.Nk * p.Nc * p.Nbhw / P         # N_k*N_c*N_bhw / P
    three_d_threshold = reuse ** (2.0 / 3.0) * (rho * sig) ** (1.0 / 3.0)

    candidates: List[Solution] = []

    # ---- Case 1 (W_c = N_c): 2D SUMMA analogues ---------------------------
    if M_L <= nkb_over_p:
        # 1a: tiles bounded by memory.
        Tk = math.sqrt(M_L * sig / rho)
        Tbhw = math.sqrt(M_L * rho / sig)
        Wk = math.sqrt(nkb_over_p * sig / rho)
        Wbhw = math.sqrt(nkb_over_p * rho / sig)
        # keep W inside the problem box while preserving Wk*Wbhw product
        if Wk > p.Nk:
            Wk, Wbhw = float(p.Nk), nkb_over_p / p.Nk
        if Wbhw > p.Nbhw:
            Wbhw, Wk = float(p.Nbhw), nkb_over_p / p.Nbhw
        Tbhw, Tk = min(Tbhw, Wbhw), min(Tk, Wk)
        choice = TileChoice(Wbhw=Wbhw, Wk=Wk, Wc=float(p.Nc), Tbhw=Tbhw, Tk=Tk)
        cost = cost_model.cost_simplified(p, P, Wbhw, Wk, Tbhw, Tk)
        candidates.append(
            Solution(CASE_2D_LIMITED, ALGO_2D, choice, cost, M_L, P))
    else:
        # 1b: whole work partition fits in memory.
        Wk = math.sqrt(nkb_over_p * sig / rho)
        Wbhw = math.sqrt(nkb_over_p * rho / sig)
        if Wk > p.Nk:
            Wk, Wbhw = float(p.Nk), nkb_over_p / p.Nk
        if Wbhw > p.Nbhw:
            Wbhw, Wk = float(p.Nbhw), nkb_over_p / p.Nbhw
        choice = TileChoice(Wbhw=Wbhw, Wk=Wk, Wc=float(p.Nc), Tbhw=Wbhw, Tk=Wk)
        cost = cost_model.cost_simplified(p, P, Wbhw, Wk, Wbhw, Wk)
        candidates.append(
            Solution(CASE_2D_AMPLE, ALGO_2D, choice, cost, M_L, P))

        # ---- Case 2 (W_c < N_c): only reachable when memory is ample -----
        if M_L >= three_d_threshold:
            # 2a: 3D analogue, communication-optimal point.
            Tk = (reuse / rho) ** (1.0 / 3.0) * sig ** (2.0 / 3.0)
            Tbhw = (reuse / sig) ** (1.0 / 3.0) * rho ** (2.0 / 3.0)
            # Wc = P*W... derived from P*Wbhw*Wk*Wc = Nbhw*Nk*Nc
            Wc = reuse / (Tk * Tbhw)
            if 1.0 <= Wc <= p.Nc and Tk <= p.Nk and Tbhw <= p.Nbhw:
                choice = TileChoice(Wbhw=Tbhw, Wk=Tk, Wc=Wc, Tbhw=Tbhw, Tk=Tk)
                cost = 3.0 * reuse ** (2.0 / 3.0) * (rho * sig) ** (1.0 / 3.0)
                candidates.append(
                    Solution(CASE_3D, ALGO_3D, choice, cost, M_L, P))
        else:
            # 2b: 2.5D analogue, memory-saturating tiles.
            Tk = math.sqrt(M_L * sig / rho)
            Tbhw = math.sqrt(M_L * rho / sig)
            Wc = reuse / M_L
            if 1.0 <= Wc <= p.Nc and Tk <= p.Nk and Tbhw <= p.Nbhw:
                choice = TileChoice(Wbhw=Tbhw, Wk=Tk, Wc=Wc, Tbhw=Tbhw, Tk=Tk)
                cost = M_L + (2.0 * reuse / math.sqrt(M_L)
                              * math.sqrt(rho * sig))
                candidates.append(
                    Solution(CASE_25D, ALGO_25D, choice, cost, M_L, P))

    best = min(candidates, key=lambda s: s.cost)
    return best


def table1_cost(p: ConvProblem, P: int, M_L: float) -> Tuple[str, float]:
    """The paper's Table 1: optimal Eq. 4 cost as a function of (P, M_L)."""
    rho, sig = p.Nr * p.Ns, p.sw * p.sh
    reuse = p.Nk * p.Nc * p.Nbhw / P
    nkb = p.Nk * p.Nbhw / P
    thresh = reuse ** (2.0 / 3.0) * (rho * sig) ** (1.0 / 3.0)
    if nkb >= M_L:
        return CASE_2D_LIMITED, nkb + 2.0 * reuse * math.sqrt(rho * sig / M_L)
    if M_L >= thresh:
        return CASE_3D, 3.0 * thresh
    return CASE_25D, M_L + 2.0 * reuse / math.sqrt(M_L) * math.sqrt(rho * sig)


def table2_cost(p: ConvProblem, P: int, M_L: float) -> Tuple[str, float]:
    """Table 2: all tile-loop permutations — the resident tensor may be Out,
    Ker, or In, so the first term becomes min over the three slice sizes."""
    rho, sig = p.Nr * p.Ns, p.sw * p.sh
    reuse = p.Nk * p.Nc * p.Nbhw / P
    thresh = reuse ** (2.0 / 3.0) * (rho * sig) ** (1.0 / 3.0)
    resident = min(p.Nk * p.Nbhw / P, p.Nk * p.Nc / P, p.Nc * p.Nbhw / P)
    all_large = (p.Nk * p.Nbhw / P >= M_L
                 and rho * p.Nk * p.Nc / P >= M_L
                 and sig * p.Nc * p.Nbhw / P >= M_L)
    if all_large:
        return (CASE_2D_LIMITED,
                resident + 2.0 * reuse * math.sqrt(rho * sig / M_L))
    if M_L >= thresh:
        return CASE_3D, 3.0 * thresh
    return CASE_25D, M_L + 2.0 * reuse / math.sqrt(M_L) * math.sqrt(rho * sig)


# --------------------------------------------------------------------------
# Integer projection & exact-cost evaluation
# --------------------------------------------------------------------------

def _divisors(n: int) -> List[int]:
    out = []
    i = 1
    while i * i <= n:
        if n % i == 0:
            out.append(i)
            if i != n // i:
                out.append(n // i)
        i += 1
    return sorted(out)


def factor_triples(P: int) -> Iterable[Tuple[int, int, int]]:
    """All (P_bhw, P_k, P_c) with product P."""
    for pb in _divisors(P):
        for pk in _divisors(P // pb):
            yield pb, pk, (P // pb) // pk


def solve(p: ConvProblem, P: int, M: float, *,
          ml_correction: bool = True) -> Solution:
    """Integer-feasible solution: enumerate processor-grid factorizations of
    P, derive W_i = N_i / P_i, pick memory-optimal tiles per factorization,
    and select the factorization minimizing the exact Eq. 3-style cost.

    This is the solver the framework actually uses; `solve_closed_form` is
    the analytic prediction it is validated against.
    """
    M_L = cost_model.ml_from_m(p, M) if ml_correction else float(M)
    if M_L <= 1:
        raise ValueError(f"memory too small after M_L correction: {M_L}")

    best: Optional[Solution] = None
    for pbhw, pk, pc in factor_triples(P):
        if pbhw > p.Nbhw or pk > p.Nk or pc > p.Nc:
            continue
        Wbhw = p.Nbhw / pbhw
        Wk = p.Nk / pk
        Wc = p.Nc / pc
        Tbhw, Tk = _best_tiles_given_W(p, Wbhw, Wk, M_L)
        choice = TileChoice(Wbhw=Wbhw, Wk=Wk, Wc=Wc, Tbhw=Tbhw, Tk=Tk)
        cost = cost_model.cost_global_memory(p, choice)
        if best is None or cost < best.cost:
            case = classify(p, P, M_L, choice)
            best = Solution(case, _CASE_TO_ALGO[case], choice, cost, M_L, P)
    if best is None:
        raise ValueError(f"no feasible grid for P={P} on {p}")
    return best


def classify(p: ConvProblem, P: int, M_L: float, c: TileChoice) -> str:
    """Classify a concrete choice into the paper's regime taxonomy."""
    if c.Wc >= p.Nc - 1e-9:  # no contraction partitioning
        if c.Tbhw * c.Tk >= c.Wbhw * c.Wk - 1e-9:
            return CASE_2D_AMPLE
        return CASE_2D_LIMITED
    reuse = p.Nk * p.Nc * p.Nbhw / P
    thresh = reuse ** (2.0 / 3.0) * (p.Nr * p.Ns * p.sw * p.sh) ** (1.0 / 3.0)
    return CASE_3D if M_L >= thresh else CASE_25D


# --------------------------------------------------------------------------
# Brute-force oracle (tests)
# --------------------------------------------------------------------------

def brute_force(p: ConvProblem, P: int, M: float,
                *, ml_correction: bool = True) -> Tuple[TileChoice, float]:
    """Exhaustive search over divisor grids; small problems only."""
    M_L = cost_model.ml_from_m(p, M) if ml_correction else float(M)
    best_choice, best_cost = None, math.inf
    for pbhw, pk, pc in factor_triples(P):
        if pbhw > p.Nbhw or pk > p.Nk or pc > p.Nc:
            continue
        Wbhw, Wk, Wc = p.Nbhw / pbhw, p.Nk / pk, p.Nc / pc
        for tbhw in _divisors(max(1, int(Wbhw))):
            for tk in _divisors(max(1, int(Wk))):
                if tbhw * tk > M_L:
                    continue
                ch = TileChoice(Wbhw=Wbhw, Wk=Wk, Wc=Wc,
                                Tbhw=float(tbhw), Tk=float(tk))
                cost = cost_model.cost_global_memory(p, ch)
                if cost < best_cost:
                    best_choice, best_cost = ch, cost
    if best_choice is None:
        raise ValueError("no feasible point")
    return best_choice, best_cost
