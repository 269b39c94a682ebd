// The block-tile f32 GEMM core shared by csrc/gemm.cu and csrc/conv2d.cu
// (Hopper, sm_90a):
//
//   out[t][row, col] = sum_{k < R} A[t][row, k] * B[t][k, col]
//
// The core owns everything but the operands' addressing: the staging
// ring, the FFMA register tile, the split of the reduction and the sum
// of the splits.  An op (`Op`) supplies its two
// operand loaders and where an output element lives:
//
//   Op::Params                  kernel arguments; first member `Problem g`
//   Op::A<Cfg>, Op::B<Cfg>      loaders: constructed per block with
//                               (params, batch entry, tile row / col 0,
//                               k_begin, k_end); load(stage) issues the
//                               cp.async copies of the next BK-deep slab
//                               into the stage and moves on one slab
//   Op::row_offset(p, t, row)   output offset of a row of batch entry t
//   Op::col_offset(p, col)      plus that of a column
//
// Shared memory holds A k-major ([BK][BM + 4]) and B k-major
// ([BK][BN + 4]), so a thread reads its rows and columns of one k as
// float4s.  A thread owns TM x TN outputs, as TM/4 x TN/4 groups of 4x4
// that sit BM/2 (BN/2) apart for TM = 8: the 8 threads of a quarter warp
// then read 8 consecutive float4s of B (no bank conflict) and a warp's
// reads of A are 2 broadcasts.  The +4 pad keeps every row 16-byte
// aligned and spreads a loader's 4-byte stores of 8 consecutive k over
// the banks.
//
// Staging: a ring of STAGES slabs in dynamic shared memory, filled with
// cp.async (commit_group / wait_group): while the block computes slab i
// the copies of slabs i+1 .. i+STAGES-1 are in flight.  A copy past an
// edge (ragged M, N or R, SAME padding, a gathered index outside the
// image) is a cp.async whose src-size operand is 0: the hardware writes
// zeros and reads nothing, so the loaders have no branch around a copy.
//
// Split reduction: block z = batch entry * splits + split covers
// reduction indices [split * chunk, min(R, (split + 1) * chunk)), chunk a
// whole number of slabs.  The partial tiles are summed in split order --
// deterministic, no atomics -- in one of two ways:
//
// * at most 8 splits: the splits of a tile form one thread-block cluster
//   (Hopper) and sum through distributed shared memory before one store:
//   no scratch, no second launch;
// * more: each block writes its partial tile into split's slice of a
//   scratch buffer the wrapper allocated ([splits][t * M * N], laid out
//   as the output), and a second kernel, sum_splits, adds the slices.
//
// The launch plan (tile, splits, chunk, and whether to use scratch) is
// computed in Python (kernels/_plan.py).

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace tile {

// ---- cp.async ------------------------------------------------------------

// 4-byte copy; zero-fills the word and reads nothing unless `valid`
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// 16-byte copy of `src_bytes` (0..16) bytes, the rest zero-filled; both
// addresses 16-byte aligned
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---- tile configurations ---------------------------------------------------

template <int BM_, int BN_, int BK_, int TM_, int TN_, int STAGES_>
struct Cfg {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, TM = TM_, TN = TN_;
  static constexpr int STAGES = STAGES_;
  static constexpr int kThreads = (BM / TM) * (BN / TN);
  static constexpr int LDA = BM + 4, LDB = BN + 4;
  static constexpr int kASize = BK * LDA, kBSize = BK * LDB;
  static constexpr int kSmemBytes =
      STAGES * (kASize + kBSize) * static_cast<int>(sizeof(float));
  // A elements each thread copies per slab
  static constexpr int kPerThread = BM * BK / kThreads;
  static_assert(TM % 4 == 0 && TN % 4 == 0, "4x4 groups per thread");
  static_assert(BM * BK % kThreads == 0 && BN * BK % kThreads == 0,
                "A and B slabs split evenly over the threads");
  static_assert(kThreads % BK == 0 && kThreads % BM == 0 &&
                    kThreads % BN == 0,
                "loader layouts");
  static_assert(STAGES >= 2, "a ring of at least two slabs");
};

// 128x128 tile, 8x8 outputs per thread; the plan (kernels/_plan.py)
// takes it where the output has at least one wave of such tiles
using Big = Cfg<128, 128, 8, 8, 8, 4>;
// 64x64 tile, 4x4 outputs per thread; everywhere else
using Small = Cfg<64, 64, 16, 4, 4, 4>;

struct Problem {
  int t, m, n, r;   // batch entries, rows, cols, reduction length
  int chunk;        // reduction indices per split, whole slabs
  int splits;       // set by launch
  float* out;       // the output, or the split scratch
  size_t out_len;   // elements of one split's slice (t * m * n)
};

// ---- generic operand loaders ---------------------------------------------

// A [rows][R] row-major operand (row stride ld) as the tile dimension TD
// (BM for A, BN for B) x BK slab: consecutive threads take consecutive k,
// so a warp reads whole 32-byte sectors; 4-byte copies (a k-major smem
// layout needs a transpose, which a 16-byte copy cannot do).
template <class C, int TD, int LD>
struct KContiguous {
  static constexpr int kRowStep = C::kThreads / C::BK;
  static constexpr int kCount = TD * C::BK / C::kThreads;
  const float* base;  // a valid address for the zero-fill copies
  const float* src;   // this thread's first row at its current k
  size_t row_step;
  int k, k_end, dst;
  unsigned rows_ok;

  __device__ KContiguous(const float* base_, size_t ld, int rows, int row0,
                         int k_begin, int k_end_)
      : base(base_), k_end(k_end_) {
    const int kk = threadIdx.x % C::BK;
    const int rr = threadIdx.x / C::BK;
    k = k_begin + kk;
    src = base_ + (size_t)(row0 + rr) * ld + k;
    row_step = (size_t)kRowStep * ld;
    dst = kk * LD + rr;
    rows_ok = 0;
#pragma unroll
    for (int j = 0; j < kCount; ++j)
      if (row0 + rr + j * kRowStep < rows) rows_ok |= 1u << j;
  }

  __device__ __forceinline__ void load(float* s) {
    const bool kin = k < k_end;
#pragma unroll
    for (int j = 0; j < kCount; ++j) {
      const bool ok = kin && ((rows_ok >> j) & 1u);
      cp_async4(s + dst + j * kRowStep, ok ? src + j * row_step : base, ok);
    }
    src += C::BK;
    k += C::BK;
  }
};

// A [R][cols] row-major operand (row stride ld) as a BK x TD slab, k-major
// in shared memory like the source.  kVec: one 16-byte copy per thread
// (cols % 4 == 0 and a 16-byte aligned base); else 4-byte copies, with
// consecutive threads on consecutive columns.
template <class C, int TD, int LD, bool kVec>
struct TileContiguous;

template <class C, int TD, int LD>
struct TileContiguous<C, TD, LD, true> {
  static constexpr int kKStep = C::kThreads / (TD / 4);
  static constexpr int kCount = C::BK / kKStep;  // float4s per thread
  static_assert(kCount * kKStep == C::BK, "whole float4s per thread");
  const float* base;
  const float* src;
  size_t ld, slab_step;
  int k, k_end, dst, bytes;

  __device__ TileContiguous(const float* base_, size_t ld_, int cols,
                            int col0, int k_begin, int k_end_)
      : base(base_), ld(ld_), k_end(k_end_) {
    const int q = threadIdx.x % (TD / 4);
    const int kk = threadIdx.x / (TD / 4);
    const int col = col0 + 4 * q;
    k = k_begin + kk;
    src = base_ + (size_t)k * ld_ + col;
    slab_step = (size_t)C::BK * ld_;
    dst = kk * LD + 4 * q;
    const int left = cols - col;
    bytes = 4 * (left < 0 ? 0 : (left > 4 ? 4 : left));
  }

  __device__ __forceinline__ void load(float* s) {
#pragma unroll
    for (int j = 0; j < kCount; ++j) {
      const bool ok = k + j * kKStep < k_end && bytes > 0;
      cp_async16(s + dst + j * kKStep * LD,
                 ok ? src + (size_t)(j * kKStep) * ld : base, ok ? bytes : 0);
    }
    src += slab_step;
    k += C::BK;
  }
};

template <class C, int TD, int LD>
struct TileContiguous<C, TD, LD, false> {
  static constexpr int kKStep = C::kThreads / TD;
  static constexpr int kCount = TD * C::BK / C::kThreads;
  const float* base;
  const float* src;
  size_t ld, slab_step;
  int k, k_end, dst;
  bool col_ok;

  __device__ TileContiguous(const float* base_, size_t ld_, int cols,
                            int col0, int k_begin, int k_end_)
      : base(base_), ld(ld_), k_end(k_end_) {
    const int cc = threadIdx.x % TD;
    const int kk = threadIdx.x / TD;
    k = k_begin + kk;
    src = base_ + (size_t)k * ld_ + col0 + cc;
    slab_step = (size_t)C::BK * ld_;
    dst = kk * LD + cc;
    col_ok = col0 + cc < cols;
  }

  __device__ __forceinline__ void load(float* s) {
#pragma unroll
    for (int j = 0; j < kCount; ++j) {
      const bool ok = col_ok && k + j * kKStep < k_end;
      cp_async4(s + dst + j * kKStep * LD,
                ok ? src + (size_t)(j * kKStep) * ld : base, ok);
    }
    src += slab_step;
    k += C::BK;
  }
};

// ---- the kernel -----------------------------------------------------------

constexpr int kMaxCluster = 8;  // the portable cluster size

// The splits of one output tile, launched as one cluster (block rank =
// split), each put their partial tile in their own shared memory; block q
// then takes every S-th run of kThreads elements of the tile, sums each
// element over the S partials in split order, read through distributed
// shared memory, and stores it: the result of sum_splits, bit for bit,
// with no scratch and no second launch.
template <class C, class Op>
__device__ __forceinline__ void reduce_in_cluster(
    const typename Op::Params& p, const float (&acc)[C::TM][C::TN],
    float* red, int batch, int row0, int col0, int tx, int ty) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  constexpr int kRowGap = C::BM * 4 / C::TM;
  constexpr int kColGap = C::BN * 4 / C::TN;
  __syncthreads();  // the staging ring is free: red reuses it
#pragma unroll
  for (int i = 0; i < C::TM; ++i)
#pragma unroll
    for (int h = 0; h < C::TN / 4; ++h)
      *reinterpret_cast<float4*>(
          red + ((i / 4) * kRowGap + ty * 4 + (i % 4)) * C::BN +
          h * kColGap + tx * 4) =
          make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                      acc[i][4 * h + 3]);
  cluster.sync();
  const int q = (int)cluster.block_rank();
  const int splits = (int)cluster.num_blocks();
  const float* part[kMaxCluster];
#pragma unroll
  for (int j = 0; j < kMaxCluster; ++j)
    part[j] = cluster.map_shared_rank(red, j < splits ? j : 0);
  for (int e = threadIdx.x + q * C::kThreads; e < C::BM * C::BN;
       e += splits * C::kThreads) {
    // all loads first (they are independent), then the adds in order
    float v[kMaxCluster];
#pragma unroll
    for (int j = 0; j < kMaxCluster; ++j) v[j] = j < splits ? part[j][e] : 0.f;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxCluster; ++j)
      if (j < splits) sum += v[j];
    const int row = row0 + e / C::BN, col = col0 + e % C::BN;
    if (row < p.g.m && col < p.g.n)
      p.g.out[Op::row_offset(p, batch, row) + Op::col_offset(p, col)] = sum;
  }
  cluster.sync();  // no block leaves while another reads its tile
}

// kCluster: the splits of one output tile are one thread-block cluster
// and sum their partial tiles through distributed shared memory (see
// reduce_in_cluster); otherwise each block writes its partial tile to
// split's slice of g.out.
template <class C, class Op, bool kCluster>
__global__ void __launch_bounds__(C::kThreads)
tile_gemm(const __grid_constant__ typename Op::Params p) {
  extern __shared__ float4 tile_smem4[];
  float* as = reinterpret_cast<float*>(tile_smem4);
  float* bs = as + C::STAGES * C::kASize;
  const Problem& g = p.g;
  const int batch = blockIdx.z / g.splits;
  const int split = blockIdx.z % g.splits;
  const int row0 = blockIdx.x * C::BM;
  const int col0 = blockIdx.y * C::BN;
  const int k_begin = split * g.chunk;
  const int k_end = min(g.r, k_begin + g.chunk);
  const int slabs = k_end > k_begin ? (k_end - k_begin + C::BK - 1) / C::BK
                                    : 0;
  typename Op::template A<C> la(p, batch, row0, k_begin, k_end);
  typename Op::template B<C> lb(p, batch, col0, k_begin, k_end);

  const int tx = threadIdx.x % (C::BN / C::TN);
  const int ty = threadIdx.x / (C::BN / C::TN);
  constexpr int kRowGap = C::BM * 4 / C::TM;  // between 4-row groups
  constexpr int kColGap = C::BN * 4 / C::TN;

  float acc[C::TM][C::TN];
#pragma unroll
  for (int i = 0; i < C::TM; ++i)
#pragma unroll
    for (int j = 0; j < C::TN; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) {
    if (s < slabs) {
      la.load(as + s * C::kASize);
      lb.load(bs + s * C::kBSize);
    }
    cp_async_commit();
  }
  for (int i = 0; i < slabs; ++i) {
    // slab i has landed, and every thread is done with slab i - 1, whose
    // stage the next copies overwrite
    cp_async_wait<C::STAGES - 2>();
    __syncthreads();
    const int next = i + C::STAGES - 1;
    if (next < slabs) {
      const int st = next % C::STAGES;
      la.load(as + st * C::kASize);
      lb.load(bs + st * C::kBSize);
    }
    cp_async_commit();
    const float* a = as + (i % C::STAGES) * C::kASize + ty * 4;
    const float* b = bs + (i % C::STAGES) * C::kBSize + tx * 4;
#pragma unroll
    for (int kk = 0; kk < C::BK; ++kk) {
      float av[C::TM], bv[C::TN];
#pragma unroll
      for (int h = 0; h < C::TM / 4; ++h) {
        const float4 v =
            *reinterpret_cast<const float4*>(a + kk * C::LDA + h * kRowGap);
        av[4 * h] = v.x;
        av[4 * h + 1] = v.y;
        av[4 * h + 2] = v.z;
        av[4 * h + 3] = v.w;
      }
#pragma unroll
      for (int h = 0; h < C::TN / 4; ++h) {
        const float4 v =
            *reinterpret_cast<const float4*>(b + kk * C::LDB + h * kColGap);
        bv[4 * h] = v.x;
        bv[4 * h + 1] = v.y;
        bv[4 * h + 2] = v.z;
        bv[4 * h + 3] = v.w;
      }
#pragma unroll
      for (int ii = 0; ii < C::TM; ++ii)
#pragma unroll
        for (int jj = 0; jj < C::TN; ++jj)
          acc[ii][jj] = fmaf(av[ii], bv[jj], acc[ii][jj]);
    }
  }
  cp_async_wait<0>();

  if constexpr (kCluster) {
    reduce_in_cluster<C, Op>(p, acc, as, batch, row0, col0, tx, ty);
    return;
  }
  float* out = g.out + (size_t)split * g.out_len;
#pragma unroll
  for (int i = 0; i < C::TM; ++i) {
    const int row = row0 + (i / 4) * kRowGap + ty * 4 + (i % 4);
    if (row >= g.m) continue;
    const size_t ro = Op::row_offset(p, batch, row);
#pragma unroll
    for (int j = 0; j < C::TN; ++j) {
      const int col = col0 + (j / 4) * kColGap + tx * 4 + (j % 4);
      if (col < g.n) out[ro + Op::col_offset(p, col)] = acc[i][j];
    }
  }
}

// out[i] = the sum over the splits of parts[split][i], in split order,
// converted once to T (float, or a narrower type such as bfloat16).
// static: each source that includes this header gets its own copy
template <class T>
static __global__ void sum_splits(const float* __restrict__ parts,
                                  T* __restrict__ out, size_t len,
                                  int splits) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < len;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int j = 0; j < splits; ++j) s += parts[(size_t)j * len + i];
    out[i] = T(s);
  }
}

// Adds the partial slices of `parts` ([splits][len]) into `out`.
template <class T>
void launch_sum_splits(const float* parts, T* out, size_t len, int splits,
                       cudaStream_t stream) {
  const size_t blocks = (len + 255) / 256 < 4096 ? (len + 255) / 256 : 4096;
  sum_splits<T><<<(unsigned)blocks, 256, 0, stream>>>(parts, out, len,
                                                      splits);
}

// Launches `kernel(p)` on `grid` with `smem` bytes of dynamic shared
// memory (raising the kernel's limit past the default 48 KB), as
// thread-block clusters of 1 x 1 x `cluster_z` blocks when cluster_z > 1;
// returns the launch's error.
template <class P>
int launch_kernel(void (*kernel)(P), dim3 grid, int threads, int smem,
                  int cluster_z, cudaStream_t stream, const P& p) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (cluster_z <= 1) {
    kernel<<<grid, threads, smem, stream>>>(p);
    return (int)cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = cluster_z;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Launches the tile GEMM of `p` (p.g.out is ignored) and returns
// cudaGetLastError().  One split: the blocks write `out`.  Several, with
// `scratch`: the blocks write their slices of it and sum_splits adds them
// into `out`.  Several (at most kMaxCluster) without `scratch`: each
// tile's splits run as one cluster and write `out`.
template <class C, class Op>
int launch(typename Op::Params p, float* out, float* scratch, int splits,
           cudaStream_t stream) {
  Problem& g = p.g;
  const bool cluster = splits > 1 && scratch == nullptr;
  if (g.t <= 0 || g.m <= 0 || g.n <= 0 || g.r < 0 || splits <= 0 ||
      g.chunk <= 0 || g.chunk % C::BK != 0 ||
      (size_t)splits * g.chunk < (size_t)g.r ||
      (splits > 1 && (size_t)(splits - 1) * g.chunk >= (size_t)g.r) ||
      (cluster && splits > kMaxCluster))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((g.m + C::BM - 1) / C::BM, (g.n + C::BN - 1) / C::BN,
                  (unsigned)g.t * splits);
  if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
  g.splits = splits;
  g.out_len = (size_t)g.t * g.m * g.n;
  g.out = splits > 1 && !cluster ? scratch : out;
  if (cluster) {
    constexpr int kRed = C::BM * C::BN * (int)sizeof(float);
    constexpr int kSmem = kRed > C::kSmemBytes ? kRed : C::kSmemBytes;
    return launch_kernel(tile_gemm<C, Op, true>, grid, C::kThreads, kSmem,
                         splits, stream, p);
  }
  const int err = launch_kernel(tile_gemm<C, Op, false>, grid, C::kThreads,
                                C::kSmemBytes, 1, stream, p);
  if (err || splits == 1) return err;
  launch_sum_splits(scratch, out, g.out_len, splits, stream);
  return (int)cudaGetLastError();
}

// The plan's tile (rows x columns) to its configuration.
template <class Op>
int launch_tile(int tile_m, int tile_n, const typename Op::Params& p,
                float* out, float* scratch, int splits,
                cudaStream_t stream) {
  if (tile_m == Big::BM && tile_n == Big::BN)
    return launch<Big, Op>(p, out, scratch, splits, stream);
  if (tile_m == Small::BM && tile_n == Small::BN)
    return launch<Small, Op>(p, out, scratch, splits, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace tile
