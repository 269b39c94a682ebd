"""Block sizing by the paper's Eq. 4 optimizer -- the port of
``repro/kernels/tiling.py``.

The paper's two-level model applies twice: across the processor grid,
and inside one chip.  This is the chip level: fast memory is the chip's
on-core memory, slow memory is device memory, and the "processors" are
the sequential grid steps (P = 1).  The optimizer picks ``(T_bhw, T_k)``
minimizing device-memory traffic; the plan then projects them onto
aligned integers (multiples of ``mxu`` on the matmul dims, or the full
extent when smaller).

The defaults are the reference's, for the TPU: a VMEM budget of
:data:`VMEM_ELEMS_BUDGET` elements and 128-wide MXU alignment.  The
contraction block is floored at ``min(N_c, 256)`` (the paper's
``T_c = 1`` is movement-optimal but starves the 128x128 systolic array),
and the Eq. 4 budget is reduced to leave room for it.

On an H100 the same function runs at the card's budget: the 227 KB of
shared memory a block may hold (``kernels/_plan.py::SMEM_PER_BLOCK``) in
float32 elements, ``vmem_elems=SMEM_PER_BLOCK // 4``, aligned to the tile
core's 64-wide tiles, ``mxu=64``.  There the plan is a model, not the
kernel's shared memory: the hand-written kernels stream the reduction
in ``BK``-deep slabs through a ring (``csrc/tile_gemm.cuh``), so they
never hold a ``block_c``-deep slab, and the footprint reported here
(``vmem_elems``) may exceed the budget where the TPU's contraction floor
alone does.  ``hbm_traffic`` is the modeled device-memory traffic of the
planned tiling, the quantity Eq. 4 minimizes.

Pure Python on ``repro_torch.core``: importing it imports no torch.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

from repro_torch.core import cost_model, tile_optimizer
from repro_torch.core.problem import ConvProblem

# the reference's v5e-ish VMEM budget in elements (bf16): ~128 MB in all,
# half kept for double-buffering and the compiler
VMEM_ELEMS_BUDGET = 16 * 1024 * 1024


def _align(x: float, mult: int, hi: int) -> int:
    """Round to a multiple of ``mult``, clamped to [mult, hi] (or hi if the
    extent itself is smaller than one multiple)."""
    if hi <= mult:
        return hi
    v = int(max(mult, round(x / mult) * mult))
    return min(v, (hi // mult) * mult)


@dataclasses.dataclass(frozen=True)
class BlockPlan:
    block_bhw: int     # rows of the (bhw) x k output tile
    block_k: int       # output-feature block
    block_c: int       # contraction block (the TPU floor, see module doc)
    vmem_elems: float  # modeled footprint
    hbm_traffic: float # modeled slow<->fast memory elements moved (Eq. 4)


def plan_blocks(p: ConvProblem, *, vmem_elems: int = VMEM_ELEMS_BUDGET,
                mxu: int = 128) -> BlockPlan:
    """Block sizes for the conv/matmul kernels from the paper's model."""
    block_c = min(p.Nc, 256)
    # Budget left for the (bhw, k) tiles after the contraction slabs
    # (In tile scales with block_c, Ker tile with block_c * stencil).
    # Solve Eq. 4 with P=1 on the reduced budget.
    sol = tile_optimizer.solve_closed_form(
        p, P=1, M=max(4 * mxu * mxu, vmem_elems // max(1, 2 * block_c // 128)),
        ml_correction=True)
    tbhw = _align(sol.choice.Tbhw, mxu, p.Nbhw)
    tk = _align(sol.choice.Tk, mxu, p.Nk)
    in_tile = p.sh * p.sw * tbhw * block_c
    ker_tile = p.Nr * p.Ns * tk * block_c
    out_tile = tbhw * tk
    foot = in_tile + ker_tile + out_tile
    # shrink until the true footprint fits
    while foot > vmem_elems and (tbhw > mxu or tk > mxu):
        if tbhw >= tk and tbhw > mxu:
            tbhw = max(mxu, tbhw // 2)
        elif tk > mxu:
            tk = max(mxu, tk // 2)
        else:
            break
        foot = (p.sh * p.sw * tbhw * block_c + p.Nr * p.Ns * tk * block_c
                + tbhw * tk)
    cost = cost_model.cost_simplified(p, 1, p.Nbhw, p.Nk, tbhw, tk)
    return BlockPlan(block_bhw=tbhw, block_k=tk, block_c=block_c,
                     vmem_elems=foot, hbm_traffic=cost)


def matmul_blocks(m: int, n: int, k: int, *,
                  vmem_elems: int = VMEM_ELEMS_BUDGET) -> Tuple[int, int, int]:
    plan = plan_blocks(ConvProblem.from_matmul(m, n, k), vmem_elems=vmem_elems)
    return plan.block_bhw, plan.block_k, plan.block_c
