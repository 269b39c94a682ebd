// GEMM for products with few rows, on Hopper (sm_90a):
//
//   out[M,N] = x[M,K] @ w[K,N]    row-major, f32 accumulation, out in x's
//                                 dtype (bfloat16 or float32)
//
// Replaces: src/repro/kernels/matmul.py::matmul_pallas (kernel body
// _matmul_kernel), as the second CUDA route of that Pallas kernel beside
// csrc/gemm.cu (the tile core).  kernels/matmul.py::matmul sends every
// bfloat16 product here, and every float32 product with M <= SKINNY_M
// rows (kernels/_plan.py); the tile core takes the other float32 ones.
//
// What bounds it on this card: a decode step's products have M = 8 rows
// (the serving slots) against weights of 0.5 to 262 M elements.  In
// bfloat16 such a product does 2*M FLOPs per 2 bytes of w, 8 FLOPs a byte
// at M = 8, far below the ~295 a byte at which the tensor cores (989
// TFLOP/s) would become the limit: the bytes of w over 3.35 TB/s bound
// it, and the bytes of x and out are a rounding error beside them.  A
// float32 product at M = 8 needs ~13 TFLOP/s of FFMA to keep up with the
// memory, a fifth of the 67 TFLOP/s peak.  So the design streams w once,
// at full width, and pads nothing: the 64-row tile of the core spends 7/8
// of its FFMAs on zero rows at M = 8.  The small products carry a launch
// floor: [8,2048] @ [2048,512] is 2 MB in bf16, a 0.6 us byte bound,
// and takes ~6 us on an H100, as do granite-moe's expert products.
//
// The design, as out^T = w^T x^T:
//
// * A block owns a strip of kStrip = 128 output columns, up to 64 rows of
//   x (gridDim.y walks the rest, so every M works) and one chunk of the
//   reduction (split-K, gridDim.z).  w streams through a ring of kStages
//   slabs in shared memory, filled by 16-byte cp.async copies (the tile
//   core's helpers) that zero-fill past K and N; the x rows of each slab
//   ride along in the same stage.  TMA would need a tensor map encoded on
//   the host and the library linked against libcuda; cp.async keeps
//   enough bytes in flight (three 16-24 KB slabs per block) to cover the
//   memory's latency.
// * bfloat16 runs on the tensor cores, mma.sync m16n8k16 with f32
//   accumulators: A is a 16-column x 16-k fragment of w^T, read from the
//   [k][n] slab by ldmatrix.trans; B is the 16-k x 8-row fragment of x^T,
//   two 32-bit shared-memory loads.  M = 8 fills the n = 8 of the
//   instruction exactly; M = 64 takes 8 fragments that reuse each A
//   fragment.  Rows of the w slab are padded by 16 bytes, so the 8 rows an
//   ldmatrix reads start on 8 different 4-bank groups; rows of x by 16
//   bytes, so a warp's B loads hit 32 different banks.  Each warp owns 32
//   columns of the strip.
// * float32 runs on IEEE FFMA (no TF32, so float32 keeps the 1e-4 parity
//   of the tile core): each thread owns 4 columns (one float4 of a w row)
//   for all 8 or 16 rows, and each of the 8 warps a quarter of every
//   32-deep slab; the warps' partial sums are added in warp order at the
//   end.
// * The splits of a strip are summed in split order, as the tile core
//   does -- deterministic, no atomics: up to tile::kMaxCluster as one
//   thread-block cluster through distributed shared memory (one launch,
//   no scratch), more through a float32 scratch and a second kernel.  The
//   f32 sums are narrowed to the output dtype once, at the store.
//
// The plan (strip, slab, rows per block, splits, chunk, scratch) is
// computed in Python (kernels/_plan.py::skinny_plan) and checked here.
// Alignment: the 16-byte copies need 16-byte aligned x, w and rows, so N
// and K are multiples of 8 (bfloat16) or 4 (float32); the wrapper checks
// the pointers and the launch refuses anything else.

#include <cuda_bf16.h>

#include <cstdint>

#include "tile_gemm.cuh"

namespace {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

constexpr int kStrip = 128;  // output columns per block
constexpr int kStages = 4;   // slabs in the ring

struct Params {
  const void* x;
  const void* w;
  void* out;
  float* scratch;  // [splits][M][N] partial sums, or null
  int m, n, k;
  int chunk;       // reduction indices per split, whole slabs
  int splits;
};

__device__ __forceinline__ void copy16(void* dst, const void* src,
                                       bool valid) {
  tile::cp_async16(static_cast<float*>(dst), static_cast<const float*>(src),
                   valid ? 16 : 0);
}

// ---- bfloat16: tensor cores ------------------------------------------------

template <int kFrags>  // 8-row fragments of x per block: rows = 8 * kFrags
struct Bf16 {
  using T = bf16;
  static constexpr int kRows = 8 * kFrags;
  static constexpr int kThreads = 128;  // 4 warps, 32 columns each
  static constexpr int BK = 64;         // reduction indices per slab
  static constexpr int kVec = 8;        // elements per 16-byte copy
  static constexpr int LDW = kStrip + 8;
  static constexpr int LDX = BK + 8;
  static constexpr int kWStage = BK * LDW;    // elements
  static constexpr int kXStage = kRows * LDX;
  static constexpr int kStageBytes = (kWStage + kXStage) * 2;
  static constexpr int kRedBytes = kRows * kStrip * 4;
  static constexpr int kRingBytes = kStages * kStageBytes;
  static constexpr int kSmemBytes =
      kRingBytes > kRedBytes ? kRingBytes : kRedBytes;
  static_assert(kStageBytes % 16 == 0, "16-byte aligned stages");

  float acc[2][kFrags][4];

  __device__ void zero() {
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int f = 0; f < kFrags; ++f)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[c][f][e] = 0.f;
  }

  // the 16-byte copies of one slab: w rows [k0, k0 + BK) of the strip and
  // x rows [row0, row0 + kRows) at the same k
  __device__ static void load(const Params& p, char* stage, int row0,
                              int col0, int k0, int k_end) {
    bf16* ws = reinterpret_cast<bf16*>(stage);
    bf16* xs = ws + kWStage;
    const bf16* w = static_cast<const bf16*>(p.w);
    const bf16* x = static_cast<const bf16*>(p.x);
    constexpr int kPerRow = kStrip / kVec;
#pragma unroll
    for (int i = 0; i < BK * kPerRow / kThreads; ++i) {
      const int c = threadIdx.x + i * kThreads;
      const int r = c / kPerRow, q = c % kPerRow;
      const int kk = k0 + r, col = col0 + q * kVec;
      const bool ok = kk < k_end && col < p.n;
      copy16(ws + r * LDW + q * kVec,
             ok ? w + (size_t)kk * p.n + col : w, ok);
    }
    constexpr int kXPerRow = BK / kVec;
    for (int c = threadIdx.x; c < kRows * kXPerRow; c += kThreads) {
      const int r = c / kXPerRow, q = c % kXPerRow;
      const int row = row0 + r, kk = k0 + q * kVec;
      const bool ok = row < p.m && kk < k_end;
      copy16(xs + r * LDX + q * kVec,
             ok ? x + (size_t)row * p.k + kk : x, ok);
    }
  }

  __device__ void compute(const char* stage) {
    const bf16* ws = reinterpret_cast<const bf16*>(stage);
    const bf16* xs = ws + kWStage;
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const int g = lane / 4, t = lane % 4;
    // ldmatrix.x4.trans: lanes 8j..8j+7 give the rows of matrix j, which
    // is a_j of the A fragment: (columns +0/+8) x (k +0/+8)
    const int j = lane / 8;
    const int a_row = lane % 8 + (j >> 1) * 8;
    const int a_col = warp * 32 + (j & 1) * 8;
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      uint32_t b[kFrags][2];
#pragma unroll
      for (int f = 0; f < kFrags; ++f) {
        const bf16* xr = xs + (f * 8 + g) * LDX + ks * 16 + 2 * t;
        b[f][0] = *reinterpret_cast<const uint32_t*>(xr);
        b[f][1] = *reinterpret_cast<const uint32_t*>(xr + 8);
      }
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        uint32_t a[4];
        const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(
            ws + (ks * 16 + a_row) * LDW + a_col + c * 16));
        asm volatile(
            "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
            "{%0,%1,%2,%3}, [%4];\n"
            : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
            : "r"(addr));
#pragma unroll
        for (int f = 0; f < kFrags; ++f)
          asm volatile(
              "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
              "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
              : "+f"(acc[c][f][0]), "+f"(acc[c][f][1]), "+f"(acc[c][f][2]),
                "+f"(acc[c][f][3])
              : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[f][0]),
                "r"(b[f][1]));
      }
    }
  }

  // the block's partial tile into red[kRows][kStrip]: accumulator e of
  // fragment (c, f) is row 8f + 2t + (e & 1), column 32 warp + 16c + g +
  // 8 (e >> 1)
  __device__ void spill(float* red) const {
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const int g = lane / 4, t = lane % 4;
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int f = 0; f < kFrags; ++f)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          red[(f * 8 + 2 * t + (e & 1)) * kStrip + warp * 32 + c * 16 + g +
              8 * (e >> 1)] = acc[c][f][e];
  }
};

// ---- float32: FFMA ---------------------------------------------------------

template <int kRows_>  // rows of x per block: 8 or 16
struct F32 {
  using T = float;
  static constexpr int kRows = kRows_;
  static constexpr int kThreads = 256;  // 8 warps, one k quad each a slab
  static constexpr int kWarps = kThreads / 32;
  static constexpr int BK = 4 * kWarps;  // 32
  static constexpr int kVec = 4;
  static constexpr int kWStage = BK * kStrip;  // elements, no padding:
  static constexpr int kXStage = kRows * BK;   // float4 reads, no conflict
  static constexpr int kStageBytes = (kWStage + kXStage) * 4;
  static constexpr int kRedBytes = kWarps * kRows * kStrip * 4;
  static constexpr int kRingBytes = kStages * kStageBytes;
  static constexpr int kSmemBytes =
      kRingBytes > kRedBytes ? kRingBytes : kRedBytes;
  static_assert(kStrip == 4 * 32, "a warp covers the strip in float4s");

  float acc[kRows][4];

  __device__ void zero() {
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][e] = 0.f;
  }

  __device__ static void load(const Params& p, char* stage, int row0,
                              int col0, int k0, int k_end) {
    float* ws = reinterpret_cast<float*>(stage);
    float* xs = ws + kWStage;
    const float* w = static_cast<const float*>(p.w);
    const float* x = static_cast<const float*>(p.x);
    constexpr int kPerRow = kStrip / kVec;
#pragma unroll
    for (int i = 0; i < BK * kPerRow / kThreads; ++i) {
      const int c = threadIdx.x + i * kThreads;
      const int r = c / kPerRow, q = c % kPerRow;
      const int kk = k0 + r, col = col0 + q * kVec;
      const bool ok = kk < k_end && col < p.n;
      copy16(ws + r * kStrip + q * kVec,
             ok ? w + (size_t)kk * p.n + col : w, ok);
    }
    constexpr int kXPerRow = BK / kVec;
    for (int c = threadIdx.x; c < kRows * kXPerRow; c += kThreads) {
      const int r = c / kXPerRow, q = c % kXPerRow;
      const int row = row0 + r, kk = k0 + q * kVec;
      const bool ok = row < p.m && kk < k_end;
      copy16(xs + r * BK + q * kVec, ok ? x + (size_t)row * p.k + kk : x,
             ok);
    }
  }

  __device__ void compute(const char* stage) {
    const float* ws = reinterpret_cast<const float*>(stage);
    const float* xs = ws + kWStage;
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    float4 wv[4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wv[kk] = *reinterpret_cast<const float4*>(
          ws + (warp * 4 + kk) * kStrip + lane * 4);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float4 xq =
          *reinterpret_cast<const float4*>(xs + r * BK + warp * 4);
      const float xv[4] = {xq.x, xq.y, xq.z, xq.w};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        acc[r][0] = fmaf(xv[kk], wv[kk].x, acc[r][0]);
        acc[r][1] = fmaf(xv[kk], wv[kk].y, acc[r][1]);
        acc[r][2] = fmaf(xv[kk], wv[kk].z, acc[r][2]);
        acc[r][3] = fmaf(xv[kk], wv[kk].w, acc[r][3]);
      }
    }
  }

  // every warp's partial tile, then their sum in warp order into
  // red[kRows][kStrip] (the first warp's slice)
  __device__ void spill(float* red) const {
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      *reinterpret_cast<float4*>(red + (warp * kRows + r) * kStrip +
                                 lane * 4) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    __syncthreads();
    constexpr int kPer = kRows * kStrip / kThreads;
    float sum[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = threadIdx.x + i * kThreads;
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < kWarps; ++q) s += red[q * kRows * kStrip + e];
      sum[i] = s;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kPer; ++i) red[threadIdx.x + i * kThreads] = sum[i];
  }
};

// ---- the kernel --------------------------------------------------------------

// blockIdx.x: the strip of columns, blockIdx.y: the chunk of rows,
// blockIdx.z: the split of the reduction.  kCluster: the splits of a strip
// are one cluster and sum through distributed shared memory; otherwise one
// split writes out, several write their slices of p.scratch.
template <class K, bool kCluster>
__global__ void __launch_bounds__(K::kThreads)
skinny_gemm(const __grid_constant__ Params p) {
  extern __shared__ float4 skinny_smem4[];
  char* smem = reinterpret_cast<char*>(skinny_smem4);
  const int col0 = blockIdx.x * kStrip;
  const int row0 = blockIdx.y * K::kRows;
  const int split = blockIdx.z;
  const int k_begin = split * p.chunk;
  const int k_end = min(p.k, k_begin + p.chunk);
  const int slabs = k_end > k_begin ? (k_end - k_begin + K::BK - 1) / K::BK
                                    : 0;
  K op;
  op.zero();
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < slabs)
      K::load(p, smem + s * K::kStageBytes, row0, col0, k_begin + s * K::BK,
              k_end);
    tile::cp_async_commit();
  }
  for (int i = 0; i < slabs; ++i) {
    // slab i has landed, and every thread is done with slab i - 1, whose
    // stage the next copies overwrite
    tile::cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = i + kStages - 1;
    if (next < slabs)
      K::load(p, smem + (next % kStages) * K::kStageBytes, row0, col0,
              k_begin + next * K::BK, k_end);
    tile::cp_async_commit();
    op.compute(smem + (i % kStages) * K::kStageBytes);
  }
  tile::cp_async_wait<0>();
  __syncthreads();  // the ring is free: red reuses it
  float* red = reinterpret_cast<float*>(smem);
  op.spill(red);
  __syncthreads();

  constexpr int kTile = K::kRows * kStrip;
  if constexpr (kCluster) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    const int q = (int)cluster.block_rank();
    const int splits = (int)cluster.num_blocks();
    const float* part[tile::kMaxCluster];
#pragma unroll
    for (int j = 0; j < tile::kMaxCluster; ++j)
      part[j] = cluster.map_shared_rank(red, j < splits ? j : 0);
    typename K::T* out = static_cast<typename K::T*>(p.out);
    for (int e = threadIdx.x + q * K::kThreads; e < kTile;
         e += splits * K::kThreads) {
      float v[tile::kMaxCluster];
#pragma unroll
      for (int j = 0; j < tile::kMaxCluster; ++j)
        v[j] = j < splits ? part[j][e] : 0.f;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < tile::kMaxCluster; ++j)
        if (j < splits) sum += v[j];
      const int row = row0 + e / kStrip, col = col0 + e % kStrip;
      if (row < p.m && col < p.n)
        out[(size_t)row * p.n + col] = typename K::T(sum);
    }
    cluster.sync();  // no block leaves while another reads its tile
  } else {
    for (int e = threadIdx.x; e < kTile; e += K::kThreads) {
      const int row = row0 + e / kStrip, col = col0 + e % kStrip;
      if (row >= p.m || col >= p.n) continue;
      const size_t at = (size_t)row * p.n + col;
      if (p.splits == 1)
        static_cast<typename K::T*>(p.out)[at] = typename K::T(red[e]);
      else
        p.scratch[(size_t)split * p.m * p.n + at] = red[e];
    }
  }
}

template <class K>
int launch(Params p, cudaStream_t stream) {
  const bool cluster = p.splits > 1 && p.scratch == nullptr;
  const dim3 grid((p.n + kStrip - 1) / kStrip,
                  (p.m + K::kRows - 1) / K::kRows, (unsigned)p.splits);
  if (grid.y > 65535 || grid.z > 65535 ||
      (cluster && p.splits > tile::kMaxCluster))
    return (int)cudaErrorInvalidValue;
  if (cluster)
    return tile::launch_kernel(skinny_gemm<K, true>, grid, K::kThreads,
                               K::kSmemBytes, p.splits, stream, p);
  const int err = tile::launch_kernel(skinny_gemm<K, false>, grid,
                                      K::kThreads, K::kSmemBytes, 1, stream,
                                      p);
  if (err || p.splits == 1) return err;
  tile::launch_sum_splits(p.scratch, static_cast<typename K::T*>(p.out),
                          (size_t)p.m * p.n, p.splits, stream);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// `bf16`: x, w and out are bfloat16 (else float32).  The plan
// (kernels/_plan.py::skinny_plan) gives `strip` and `slab` (which must be
// this build's), `rows` (x rows per block: 8, 16, 32 or 64 in bfloat16,
// 8 or 16 in float32), `splits` and `chunk` (reduction indices per split,
// whole slabs); `scratch` holds splits * m * n floats when the plan sums
// more than tile::kMaxCluster splits through it, and is null otherwise.
extern "C" int repro_skinny_gemm(const void* x, const void* w, void* out,
                                 float* scratch, int bf16, int m, int n,
                                 int k, int strip, int slab, int rows,
                                 int splits, int chunk, cudaStream_t stream) {
  const int vec = bf16 ? 8 : 4;
  const auto aligned = [](const void* ptr) {
    return reinterpret_cast<size_t>(ptr) % 16 == 0;
  };
  if (m <= 0 || n <= 0 || k < 0 || strip != kStrip || splits <= 0 ||
      chunk <= 0 || chunk % slab != 0 || n % vec != 0 || k % vec != 0 ||
      !aligned(x) || !aligned(w) ||
      (size_t)splits * chunk < (size_t)k ||
      (splits > 1 && (size_t)(splits - 1) * chunk >= (size_t)k) ||
      (splits > tile::kMaxCluster && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  const Params p{x, w, out, splits > tile::kMaxCluster ? scratch : nullptr,
                 m, n, k, chunk, splits};
  if (bf16) {
    if (slab != Bf16<1>::BK) return (int)cudaErrorInvalidValue;
    switch (rows) {
      case 8: return launch<Bf16<1>>(p, stream);
      case 16: return launch<Bf16<2>>(p, stream);
      case 32: return launch<Bf16<4>>(p, stream);
      case 64: return launch<Bf16<8>>(p, stream);
    }
    return (int)cudaErrorInvalidValue;
  }
  if (slab != F32<8>::BK) return (int)cudaErrorInvalidValue;
  switch (rows) {
    case 8: return launch<F32<8>>(p, stream);
    case 16: return launch<F32<16>>(p, stream);
  }
  return (int)cudaErrorInvalidValue;
}
