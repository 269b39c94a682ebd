"""The launch plans of the hand-written kernels: first the tile GEMM core
(``csrc/tile_gemm.cuh``), shared by both of its wrappers:
``matmul.launch_gemm`` (``[M,K] @ [K,N]``) and ``conv2d.conv2d`` (the
implicit GEMM with ``M = N*Ho*Wo`` rows, ``K`` columns and a reduction of
``R = C*kh*kw``).

One pure function, :func:`gemm_plan`, picks the tile and cuts the
reduction:

* the 128x128 tile (8x8 outputs per thread) where the output holds at
  least one wave of such tiles, one per SM, and both extents reach 128;
  the 64x64 tile (4x4 per thread) everywhere else;
* ``splits``: the reduction is cut into chunks of whole slabs (the
  tile's ``BK``-deep unit of staging) until the card has about
  :data:`BLOCKS_PER_SM` blocks per SM, but no chunk shorter than
  :data:`MIN_SLABS` slabs.  A product whose tiles already reach that
  many blocks is not split.  The partial tiles are summed in split
  order: up to :data:`MAX_CLUSTER` splits as one thread-block cluster
  through distributed shared memory (no scratch, one launch), more
  through a scratch buffer and a second kernel.  A product of at most
  :data:`LAUNCH_BOUND_FMAS` multiply-adds (the classifier head's) is
  bound by launches, not FMAs, so it takes no more splits than one
  cluster holds: a second launch and a scratch allocation cost it more
  host time than the extra splits save on the card.

Both constants come from ``tools/split_sweep.py`` on an H100: four
blocks per SM beat two by 15% on the long dKer reductions (a 64x64
block holds 63 registers a thread, so four fit an SM), and the chunk
floor moved no shape by more than the run-to-run spread.

The SM count comes from the card (``sm_count``); the CPU tests pass the
H100's 132.

The second GEMM of ``matmul_pallas``'s port, ``csrc/skinny_gemm.cu``,
has its own plan, :func:`skinny_plan`: strips of :data:`SKINNY_STRIP`
output columns, up to 64 rows of ``x`` per block, and the reduction cut
into whole slabs until the card has about :data:`SKINNY_BLOCKS_PER_SM`
blocks per SM, no chunk shorter than :data:`SKINNY_MIN_SLABS` slabs; a
product whose weight is at most :data:`SKINNY_LAUNCH_BOUND_BYTES` takes
no more splits than one cluster holds, as the core's launch-bound
products do: the scratch and the second kernel of more splits cost the
host ~10 us a call (llama's and granite-moe's decode products, served on
an H100) and saved the card at most 2 us at those shapes.
:func:`skinny_route` says which products take it: every bfloat16
product, and the float32 ones with at most :data:`SKINNY_M` rows whose
rows are whole float4s (N and K multiples of 4).  The constants come
from ``tools/skinny_sweep.py`` on an H100: over a llama3.2-1b decode
step's products (device time) the split rules with one or two blocks per
SM and chunks of one to four slabs came within 4% of each other, four
blocks per SM lost 10-20% in bfloat16, and a two-slab floor was best for
granite-moe's small expert products; the float32 skinny route beat the
tile core at every llama width at M = 8, 16 and 32, and lost at two of
four at M = 64.

Winograd's tile GEMM, ``csrc/wino_gemm.cu``, has the third,
:func:`wino_plan`: one tile of 128 x 64 (two blocks per SM), the
reduction cut into whole slabs until the card holds at most
:data:`WINO_BLOCKS_PER_SM` blocks per SM, no chunk shorter than
:data:`WINO_MIN_SLABS` slabs.  The constants come from
``tools/wino_sweep.py`` on an H100: over du's seven products (the only
ones that split) four blocks per SM -- two waves of the two that fit
an SM -- beat two by 8% in float32 and tied in bfloat16; the chunk
floor moved nothing beyond the spread; and a 128 x 128 tile of 16 warps
lost to 128 x 64 over the step's products in both dtypes.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

# (rows, columns) of a block tile -> the depth of one slab of its
# configuration, in the order the plan tries them (tile_gemm.cuh: Big,
# Small)
TILES = {(128, 128): 8, (64, 64): 16}
BLOCKS_PER_SM = 4
MIN_SLABS = 4
MAX_CLUSTER = 8  # the portable thread-block cluster size
LAUNCH_BOUND_FMAS = 1 << 26  # ~2 us of the H100's f32 FFMA peak
GRID_YZ_MAX = 65535


class GemmPlan(NamedTuple):
    tile: tuple   # (rows, columns) of the block tile, a key of TILES
    slab: int     # reduction indices per slab of that tile
    splits: int   # reduction chunks, each non-empty
    chunk: int    # reduction indices per chunk, whole slabs
    grid: tuple   # (M tiles, N tiles, T * splits)
    scratch: int  # floats of split scratch: 0 for one split or a cluster


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def block_tile(block_m: int, block_n: int):
    """The tile a block plan's ``(block_m, block_n)`` launches: itself
    where the core compiles that tile (a key of :data:`TILES`), else
    ``None`` (:func:`gemm_plan` picks)."""
    return (block_m, block_n) if (block_m, block_n) in TILES else None


@functools.lru_cache(maxsize=4096)
def gemm_plan(t: int, m: int, n: int, r: int, sms: int = 132,
              tile=None) -> GemmPlan:
    """The launch of ``[t, m, r] @ [t, r, n]`` on a card with ``sms`` SMs;
    ``tile`` (a key of :data:`TILES`) fixes the block tile, whose split
    is then cut by the same rule."""
    if tile is not None and tuple(tile) not in TILES:
        raise ValueError(f"the tile core compiles the tiles {list(TILES)}, "
                         f"not {tile}")
    tile = tuple(tile) if tile is not None else next(
        ((tm, tn) for tm, tn in TILES
         if m >= tm and n >= tn
         and t * _cdiv(m, tm) * _cdiv(n, tn) >= sms), (64, 64))
    tm, tn = tile
    slab = TILES[tile]
    tiles = t * _cdiv(m, tm) * _cdiv(n, tn)
    slabs = max(1, _cdiv(r, slab))
    cap = MAX_CLUSTER if t * m * n * r <= LAUNCH_BOUND_FMAS else slabs
    splits = max(1, min(_cdiv(BLOCKS_PER_SM * sms, tiles),
                        slabs // MIN_SLABS, cap, GRID_YZ_MAX // t))
    per = _cdiv(slabs, splits)
    splits = _cdiv(slabs, per)  # every chunk non-empty
    return GemmPlan(tile, slab, splits, per * slab,
                    (_cdiv(m, tm), _cdiv(n, tn), t * splits),
                    t * m * n * splits if splits > MAX_CLUSTER else 0)


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The number of SMs of card ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


# ---- the skinny GEMM (csrc/skinny_gemm.cu) --------------------------------

SKINNY_M = 32        # float32 products of at most this many rows go skinny
SKINNY_STRIP = 128   # output columns per block (skinny_gemm.cu: kStrip)
# reduction indices per slab, and the x rows a block can take, per dtype
SKINNY_SLAB = {torch.bfloat16: 64, torch.float32: 32}
SKINNY_ROWS = {torch.bfloat16: (8, 16, 32, 64), torch.float32: (8, 16)}
SKINNY_BLOCKS_PER_SM = 1
SKINNY_MIN_SLABS = 2
SKINNY_LAUNCH_BOUND_BYTES = 64 << 20  # ~20 us of the H100's HBM rate


class SkinnyPlan(NamedTuple):
    strip: int    # output columns per block
    slab: int     # reduction indices per slab
    rows: int     # rows of x per block, a value of SKINNY_ROWS[dtype]
    splits: int   # reduction chunks, each non-empty
    chunk: int    # reduction indices per chunk, whole slabs
    grid: tuple   # (strips, row chunks, splits)
    scratch: int  # floats of split scratch: 0 for one split or a cluster


def skinny_route(m: int, n: int, k: int, dtype) -> bool:
    """Whether ``[m, k] @ [k, n]`` in ``dtype`` takes the skinny GEMM
    (else the tile core): every bfloat16 product, and float32 ones with at
    most :data:`SKINNY_M` rows whose rows are whole float4s."""
    if dtype == torch.bfloat16:
        return True
    return (dtype == torch.float32 and m <= SKINNY_M and n % 4 == 0
            and k % 4 == 0)


@functools.lru_cache(maxsize=4096)
def skinny_plan(m: int, n: int, k: int, dtype, sms: int = 132) -> SkinnyPlan:
    """The launch of the skinny GEMM ``[m, k] @ [k, n]`` in ``dtype`` on a
    card with ``sms`` SMs."""
    choices = SKINNY_ROWS[dtype]
    rows = next((r for r in choices if r >= m), choices[-1])
    slab = SKINNY_SLAB[dtype]
    blocks = _cdiv(n, SKINNY_STRIP) * _cdiv(m, rows)
    slabs = max(1, _cdiv(k, slab))
    small = k * n * dtype.itemsize <= SKINNY_LAUNCH_BOUND_BYTES
    splits = max(1, min(_cdiv(SKINNY_BLOCKS_PER_SM * sms, blocks),
                        slabs // SKINNY_MIN_SLABS, GRID_YZ_MAX,
                        MAX_CLUSTER if small else GRID_YZ_MAX))
    per = _cdiv(slabs, splits)
    splits = _cdiv(slabs, per)  # every chunk non-empty
    return SkinnyPlan(SKINNY_STRIP, slab, rows, splits, per * slab,
                      (_cdiv(n, SKINNY_STRIP), _cdiv(m, rows), splits),
                      m * n * splits if splits > MAX_CLUSTER else 0)


# ---- Winograd's batched tile GEMM (csrc/wino_gemm.cu) ---------------------

WINO_TILE = (128, 64)    # rows, columns of a block (wino_gemm.cu: Tile)
WINO_STAGES = 3          # slabs in its ring
WINO_SLAB_BYTES = 128    # reduction bytes per slab row: 32 f32, 64 bf16
WINO_BLOCKS_PER_SM = 4
WINO_MIN_SLABS = 4
SMEM_PER_BLOCK = 227 * 1024  # the H100's shared memory per block


class WinoPlan(NamedTuple):
    tile: tuple   # (rows, columns) of the block tile: WINO_TILE
    slab: int     # reduction indices per slab
    splits: int   # reduction chunks, each non-empty
    chunk: int    # reduction indices per chunk, whole slabs
    grid: tuple   # (M tiles, N tiles, T * splits)
    scratch: int  # floats of split scratch: 0 for one split or a cluster
    smem: int     # bytes of dynamic shared memory per block


def wino_smem_bytes(dtype) -> int:
    """A block's dynamic shared memory in ``wino_gemm.cu`` (``Cfg``): the
    ring of ``[BM][BK + 16 bytes]`` and ``[BK][BN + 8]`` slabs, or the
    ``[BM][BN + 8]`` float32 output tile if larger."""
    bm, bn = WINO_TILE
    size = dtype.itemsize
    bk = WINO_SLAB_BYTES // size
    stage = (bm * (bk + 16 // size) + bk * (bn + 8)) * size
    return max(WINO_STAGES * stage, bm * (bn + 8) * 4)


@functools.lru_cache(maxsize=4096)
def wino_plan(t: int, m: int, n: int, r: int, dtype,
              sms: int = 132) -> WinoPlan:
    """The launch of ``wino_gemm.cu`` for ``[t, m, r] @ [t, r, n]`` in
    ``dtype`` (float32 or bfloat16) on a card with ``sms`` SMs: 128 x 64
    tiles, the reduction cut into chunks of whole slabs until the card
    has at most :data:`WINO_BLOCKS_PER_SM` blocks per SM, no chunk
    shorter than :data:`WINO_MIN_SLABS` slabs."""
    tm, tn = WINO_TILE
    slab = WINO_SLAB_BYTES // dtype.itemsize
    slabs = max(1, _cdiv(r, slab))
    tiles = t * _cdiv(m, tm) * _cdiv(n, tn)
    splits = max(1, min(WINO_BLOCKS_PER_SM * sms // tiles,
                        slabs // WINO_MIN_SLABS, GRID_YZ_MAX // t))
    per = _cdiv(slabs, splits)
    splits = _cdiv(slabs, per)  # every chunk non-empty
    return WinoPlan(WINO_TILE, slab, splits, per * slab,
                    (_cdiv(m, tm), _cdiv(n, tn), t * splits),
                    t * m * n * splits if splits > MAX_CLUSTER else 0,
                    wino_smem_bytes(dtype))
