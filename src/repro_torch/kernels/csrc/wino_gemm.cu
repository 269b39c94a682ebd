// Winograd's batched tile GEMM on Hopper's tensor cores (sm_90a):
//
//   out[t] = v[t] @ u[t]    v [T,M,R], u [T,R,N], out [T,M,N], row-major,
//
// float32 or bfloat16 operands (both alike), f32 accumulation, the output
// in the operands' dtype, rounded once.
//
// Replaces: src/repro/kernels/winograd.py::wino_gemm_pallas (kernel body
// _wino_gemm_kernel), through kernels/winograd.py::wino_gemm.  T = 16
// frequencies of F(2x2,3x3).  The shapes a train step gives it are the
// forward [16,P,C] @ [16,C,K] and the dIn forward [16,P',K] @ [16,K,C];
// autograd's backward adds dv [16,P,K] @ [16,K,C] and du [16,C,P] @
// [16,P,K] (P = 64 ceil(H/2)^2 at batch 64, C and K in 64..512).  The
// Pallas kernel walks (16, P/bp, K/bk, C/bc) in order on one TPU core and
// keeps the output block in a VMEM f32 scratch while the C slabs stream
// past; here the output tile is blockIdx.(x, y), the batch entry and the
// reduction split blockIdx.z, and the reduction a loop inside the block.
// Ragged M, N and R are zero-filled by the copies, so the Pallas rule that
// blocks divide the extents is gone.
//
// What bounds it on this card (H100 SXM, 700 W): the 64-wide layers do
// 16 FLOPs per byte ([16,50176,64] @ [16,64,64]: 0.123 ms of HBM at 3.35
// TB/s), the 512-wide ones ~100.  On f32 FFMA (67 TFLOP/s) the ridge is
// at 20 FLOPs a byte, so an FFMA kernel must run at ~80% of peak before
// the bytes limit it; the FFMA tile core this kernel replaces
// (csrc/tile_gemm.cuh through csrc/gemm.cu) reached 35-46%.  On the
// tensor cores as 3xTF32 (495 TFLOP/s of TF32, three products per f32
// product: 165 effective) the ridge is at 49 FLOPs a byte: the step's
// products are bound by their bytes, or close to it, and the 512-wide
// ones by 3xTF32 operations.  bfloat16 halves the bytes and needs one
// product.
//
// The design:
//
// * float32 as 3xTF32 on mma.sync.m16n8k8 (tf32 in, f32 accumulators).
//   Each operand element x is split once per fragment, in registers:
//   hi = tf32(x), rounded to nearest with ties away from zero (cvt.rna's
//   rounding, done as an integer add and mask: tools/wino_sweep.py's
//   `cvt` variant, the instruction itself, is ~10% slower over a step),
//   and lo = x - hi, exact in f32, which the tensor core reads as TF32 by
//   dropping its low 13 bits (rounding lo first costs ~4%: variant
//   `lo_rounded`).  A product is lo_a*hi_b + hi_a*lo_b + hi_a*hi_b, the
//   small terms first.
// * Tolerance: a TF32 product is exact in f32 (11 x 11 significant
//   bits); |lo| <= 2^-11 |x|, so dropping lo_a*lo_b costs <= 2^-22 of
//   |a b| and each truncated lo <= 2^-21: each product is within ~2^-20
//   of the f32 one, far inside the f32 kernels' gate of 1e-4 of
//   max|plain|.  The tensor core adds inside one mma by truncation, which
//   over a long reduction biases a sum toward zero by up to an ulp per
//   mma: so each block sums one slab (32 reduction indices, 12 mma) in
//   fresh accumulators and adds them to its running f32 sums with FADD
//   (round to nearest), slab after slab (~2% of the time: variant
//   `one_level`).
// * bfloat16 natively: mma.sync.m16n8k16 with f32 accumulators (as
//   csrc/skinny_gemm.cu), one product, no widening anywhere.
// * Staging: v in its row-major [M][R] layout and u as [R][N], both by
//   16-byte cp.async copies (tile_gemm.cuh's helpers; src-size 0
//   zero-fills past an edge), in a ring of 3 slabs of 128 bytes of
//   reduction per row (32 f32, 64 bf16).  The A fragments come by
//   ldmatrix.x4 from the [m][k] slab (a TF32 fragment is four 8 x 4
//   matrices of 32-bit words, which ldmatrix's b16 view loads whole);
//   the B fragments by 32-bit loads from the [k][n] slab in f32 and by
//   ldmatrix.x4.trans in bf16.  Rows are padded so that every ldmatrix
//   phase and every fragment load hits distinct banks: A rows 144 bytes,
//   B rows 8 elements longer than the tile.
// * The tile: 128 rows x 64 columns, 8 warps of 32 x 32 outputs, two
//   blocks per SM (83 KB of shared memory, <= 128 registers each).  N = 64
//   -- the 64-wide layers, byte-bound -- fills it, and at R = 64 a
//   block's whole slice of u[t] is two slabs of the ring: u (16 KB,
//   L2-resident) rides beside v, which streams through once.  A 128 x 128
//   tile of 16 warps (one block per SM) lost to it over the step's
//   products in both dtypes (tools/wino_sweep.py, this kernel's first
//   sweeps).
// * The output leaves through shared memory: the accumulators are staged
//   as a [128][64 + 8] f32 tile and stored as 16-byte rows (4 f32 or 8
//   bf16 per thread), rounded to the output dtype once.
// * Split reduction (du's reduction of up to 53,824 over an output of
//   64 x 64 to 512 x 512): block z = batch * splits + split covers a
//   chunk of whole slabs; up to tile::kMaxCluster splits sum in split
//   order through distributed shared memory in one thread-block cluster,
//   more through a float32 scratch and tile::sum_splits -- deterministic,
//   no atomics, as the tile core does.
// * float32 operands whose rows are not whole 16-byte vectors (R or N not
//   a multiple of 4, or a base not 16-byte aligned) take 4-byte copies and
//   element stores; bfloat16 needs R and N multiples of 8 and aligned
//   bases (the wrapper refuses anything else).
//
// Where it stands: the 64-wide products reach ~75% of their byte bound;
// the wider ones run at ~50 TFLOP/s of f32 work (~150 of TF32 mma.sync,
// a third of the TF32 peak; bf16 ~170), short of their bounds, and
// whether mma.sync's issue rate or the L2 holds them is not measured
// (not profiled).  The launch plan (splits, chunk, scratch) is computed
// in Python (kernels/_plan.py::wino_plan) and checked here.
// Left for a later PR: wgmma (tf32 wgmma takes both operands K-major
// from shared memory, so u would be transposed first) with TMA staging
// and an mbarrier ring, and the Winograd transforms fused into the
// loaders.

#include <cuda_bf16.h>

#include <cstdint>
#include <type_traits>

#include "tile_gemm.cuh"

namespace {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

struct Params {
  const void* v;   // [T][M][R]
  const void* u;   // [T][R][N]
  void* out;       // [T][M][N], the operands' dtype
  float* scratch;  // [splits][T * M * N] partial sums, or null
  int t, m, n, r;
  int chunk;       // reduction indices per split, whole slabs
  int splits;
  int cluster;     // 1: the splits of a tile form one cluster
};

// T: the operands' type; BM x BN: the block tile; kVec: 16-byte copies
// and stores (else 4-byte, float32 only)
template <class T_, int BM_, int BN_, int STAGES_, bool kVec_>
struct Cfg {
  using T = T_;
  static constexpr bool kBf16 = std::is_same<T, bf16>::value;
  static constexpr bool kVec = kVec_;
  static constexpr int BM = BM_, BN = BN_, STAGES = STAGES_;
  static constexpr int WM = 32, WN = 32;            // a warp's outputs
  static constexpr int MF = WM / 16, NF = WN / 8;   // its mma tiles
  static constexpr int kWarpsN = BN / WN;
  static constexpr int kThreads = 32 * (BM / WM) * kWarpsN;
  static constexpr int kMinBlocks = 2;  // two per SM: <= 128 registers
  static constexpr int kVecElems = 16 / (int)sizeof(T);
  static constexpr int BK = 128 / (int)sizeof(T);   // 128 bytes of k
  static constexpr int MMA_K = kBf16 ? 16 : 8;
  static constexpr int LDA = BK + kVecElems;  // [BM][LDA]: 144-byte rows
  static constexpr int LDB = BN + 8;          // [BK][LDB]
  static constexpr int LDO = BN + 8;          // [BM][LDO] f32 staging
  static constexpr int kAStage = BM * LDA, kBStage = BK * LDB;  // elements
  static constexpr int kStageBytes = (kAStage + kBStage) * (int)sizeof(T);
  static constexpr int kRingBytes = STAGES * kStageBytes;
  static constexpr int kOutBytes = BM * LDO * 4;
  static constexpr int kSmemBytes =
      kRingBytes > kOutBytes ? kRingBytes : kOutBytes;
  // outputs per store: a 16-byte vector, or one element
  static constexpr int kOutVec = kVec ? kVecElems : 1;
  static_assert(kVec || !kBf16, "bfloat16 takes 16-byte copies only");
  static_assert((kAStage * (int)sizeof(T)) % 16 == 0 &&
                    kStageBytes % 16 == 0,
                "16-byte aligned stages");
  static_assert(BM * BK % (kVecElems * kThreads) == 0 &&
                    BK * BN % (kVecElems * kThreads) == 0 &&
                    BM * BN % (kOutVec * kThreads) == 0,
                "copies and stores split evenly over the threads");
  static_assert(kSmemBytes <= 227 * 1024, "a block's shared memory");
};

// the tile: 8 warps, two blocks per SM
template <class T, bool kVec>
using Tile = Cfg<T, 128, 64, 3, kVec>;

// ---- loads -----------------------------------------------------------------

__device__ __forceinline__ void copy16(void* dst, const void* src,
                                       bool valid) {
  tile::cp_async16(static_cast<float*>(dst), static_cast<const float*>(src),
                   valid ? 16 : 0);
}

// The copies of one slab: v rows [row0, row0 + BM) x k [k0, k0 + BK) into
// as ([BM][LDA]) and u k [k0, k0 + BK) x columns [col0, col0 + BN) into bs
// ([BK][LDB]); zero past M, N and k_end.
template <class C>
__device__ __forceinline__ void load_slab(const Params& p,
                                          typename C::T* as,
                                          typename C::T* bs, int batch,
                                          int row0, int col0, int k0,
                                          int k_end) {
  using T = typename C::T;
  const T* v = static_cast<const T*>(p.v);
  const T* u = static_cast<const T*>(p.u);
  const T* vb = v + (size_t)batch * p.m * p.r;
  const T* ub = u + (size_t)batch * p.r * p.n;
  if constexpr (C::kVec) {
    constexpr int kV = C::kVecElems;
    constexpr int kPerRowA = C::BK / kV;
#pragma unroll
    for (int i = 0; i < C::BM * kPerRowA / C::kThreads; ++i) {
      const int c = threadIdx.x + i * C::kThreads;
      const int row = c / kPerRowA, q = c % kPerRowA;
      const int gr = row0 + row, gk = k0 + q * kV;
      const bool ok = gr < p.m && gk < k_end;
      copy16(as + row * C::LDA + q * kV,
             ok ? vb + (size_t)gr * p.r + gk : v, ok);
    }
    constexpr int kPerRowB = C::BN / kV;
#pragma unroll
    for (int i = 0; i < C::BK * kPerRowB / C::kThreads; ++i) {
      const int c = threadIdx.x + i * C::kThreads;
      const int kr = c / kPerRowB, q = c % kPerRowB;
      const int gk = k0 + kr, gc = col0 + q * kV;
      const bool ok = gk < k_end && gc < p.n;
      copy16(bs + kr * C::LDB + q * kV,
             ok ? ub + (size_t)gk * p.n + gc : u, ok);
    }
  } else {  // float32, 4-byte copies: consecutive threads, consecutive k
#pragma unroll
    for (int i = 0; i < C::BM * C::BK / C::kThreads; ++i) {
      const int e = threadIdx.x + i * C::kThreads;
      const int row = e / C::BK, kk = e % C::BK;
      const int gr = row0 + row, gk = k0 + kk;
      const bool ok = gr < p.m && gk < k_end;
      tile::cp_async4(as + row * C::LDA + kk,
                      ok ? vb + (size_t)gr * p.r + gk : v, ok);
    }
#pragma unroll
    for (int i = 0; i < C::BK * C::BN / C::kThreads; ++i) {
      const int e = threadIdx.x + i * C::kThreads;
      const int kr = e / C::BN, cc = e % C::BN;
      const int gk = k0 + kr, gc = col0 + cc;
      const bool ok = gk < k_end && gc < p.n;
      tile::cp_async4(bs + kr * C::LDB + cc,
                      ok ? ub + (size_t)gk * p.n + gc : u, ok);
    }
  }
}

// ---- tensor-core fragments -------------------------------------------------

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* ptr) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(ptr));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* ptr) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(ptr));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// The TF32 of an f32 bit pattern, rounded to nearest with ties away from
// zero, its low 13 bits zero: cvt.rna.tf32.f32 for every finite x and
// for infinities, as an integer add (half a TF32 ulp, carrying into the
// exponent) and a mask.  The conversion instruction itself issues on a
// slower pipe and bound the split (tools/wino_sweep.py).
__device__ __forceinline__ uint32_t to_tf32(uint32_t x) {
  return (x + 0x1000u) & 0xffffe000u;
}

// x = hi + lo exactly, hi TF32; the tensor core reads the top 19 bits of
// lo (its TF32 truncation), so lo is not rounded here
__device__ __forceinline__ void split_tf32(uint32_t x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = __float_as_uint(__uint_as_float(x) - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One slab's products, summed in fresh accumulators and then added to
// acc.  Warp w owns rows wm + [0, 32) and columns wn + [0, 32) of the
// tile; mma tile (i, j) is rows wm + 16 i + [0, 16), columns wn + 8 j +
// [0, 8).  Accumulator e of a tile is row g + 8 (e >> 1), column
// 2 t + (e & 1) (g = lane / 4, t = lane % 4).
template <class C>
__device__ __forceinline__ void compute_slab(
    const typename C::T* as, const typename C::T* bs,
    float (&acc)[C::MF][C::NF][4]) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wm = (warp / C::kWarpsN) * C::WM;
  const int wn = (warp % C::kWarpsN) * C::WN;
  const int g = lane / 4, t = lane % 4;
  // ldmatrix: lanes 8j .. 8j+7 address the rows of matrix j; matrices 0-3
  // are (rows +0, k +0), (+8, +0), (+0, +MMA_K/2), (+8, +MMA_K/2)
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int lhalf = lane >> 4;
  float s[C::MF][C::NF][4];
#pragma unroll
  for (int i = 0; i < C::MF; ++i)
#pragma unroll
    for (int j = 0; j < C::NF; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][j][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < C::BK / C::MMA_K; ++ks) {
    uint32_t a[C::MF][4];
#pragma unroll
    for (int i = 0; i < C::MF; ++i)
      ldsm_x4(a[i], as + (wm + i * 16 + lrow) * C::LDA + ks * C::MMA_K +
                        lhalf * (C::MMA_K / 2));
    uint32_t b[C::NF][2];
    if constexpr (C::kBf16) {
      // matrices (k +0, n +0), (+8, +0), (+0, +8), (+8, +8), transposed:
      // b[j] = {k 2t..2t+1, k 2t+8..2t+9} at column g
#pragma unroll
      for (int j = 0; j < C::NF; j += 2) {
        uint32_t r[4];
        ldsm_x4_trans(r, bs + (ks * 16 + lrow) * C::LDB + wn + j * 8 +
                             lhalf * 8);
        b[j][0] = r[0];
        b[j][1] = r[1];
        b[j + 1][0] = r[2];
        b[j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < C::MF; ++i)
#pragma unroll
        for (int j = 0; j < C::NF; ++j) mma_bf16(s[i][j], a[i], b[j]);
    } else {
      // b[j] = {k t, k t + 4} at column g
#pragma unroll
      for (int j = 0; j < C::NF; ++j) {
        const float* col = bs + (ks * 8 + t) * C::LDB + wn + j * 8 + g;
        b[j][0] = __float_as_uint(col[0]);
        b[j][1] = __float_as_uint(col[4 * C::LDB]);
      }
      uint32_t ahi[C::MF][4], alo[C::MF][4], bhi[C::NF][2], blo[C::NF][2];
#pragma unroll
      for (int i = 0; i < C::MF; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(a[i][e], ahi[i][e], alo[i][e]);
#pragma unroll
      for (int j = 0; j < C::NF; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) split_tf32(b[j][e], bhi[j][e], blo[j][e]);
#pragma unroll
      for (int i = 0; i < C::MF; ++i)
#pragma unroll
        for (int j = 0; j < C::NF; ++j) {
          mma_tf32(s[i][j], alo[i], bhi[j]);
          mma_tf32(s[i][j], ahi[i], blo[j]);
          mma_tf32(s[i][j], ahi[i], bhi[j]);
        }
    }
  }
#pragma unroll
  for (int i = 0; i < C::MF; ++i)
#pragma unroll
    for (int j = 0; j < C::NF; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] += s[i][j][e];
}

// ---- stores ----------------------------------------------------------------

// kOutVec f32 values from shared memory (16-byte aligned when a vector)
template <class C>
__device__ __forceinline__ void load_vals(const float* src,
                                          float (&x)[C::kOutVec]) {
  if constexpr (C::kOutVec % 4 == 0) {
#pragma unroll
    for (int q = 0; q < C::kOutVec / 4; ++q) {
      const float4 f = reinterpret_cast<const float4*>(src)[q];
      x[4 * q] = f.x;
      x[4 * q + 1] = f.y;
      x[4 * q + 2] = f.z;
      x[4 * q + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int q = 0; q < C::kOutVec; ++q) x[q] = src[q];
  }
}

// the outputs at (row, col .. col + kOutVec) of batch entry `batch`,
// rounded once to the output dtype; with vectors, col < n means the
// whole vector is inside (n and col are multiples of it)
template <class C>
__device__ __forceinline__ void store_out(const Params& p, int batch,
                                          int row, int col,
                                          const float (&x)[C::kOutVec]) {
  using T = typename C::T;
  if (row >= p.m || col >= p.n) return;
  T* out = static_cast<T*>(p.out) + ((size_t)batch * p.m + row) * p.n + col;
  if constexpr (!C::kVec) {
    out[0] = T(x[0]);
  } else if constexpr (C::kBf16) {
    uint32_t w[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(x[2 * q], x[2 * q + 1]);
      w[q] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(out) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
    *reinterpret_cast<float4*>(out) = make_float4(x[0], x[1], x[2], x[3]);
  }
}

// the same into split's float32 slice of the scratch
template <class C>
__device__ __forceinline__ void store_part(const Params& p, int batch,
                                           int split, int row, int col,
                                           const float (&x)[C::kOutVec]) {
  if (row >= p.m || col >= p.n) return;
  float* dst = p.scratch + (size_t)split * p.t * p.m * p.n +
               ((size_t)batch * p.m + row) * p.n + col;
  if constexpr (C::kOutVec % 4 == 0) {
#pragma unroll
    for (int q = 0; q < C::kOutVec / 4; ++q)
      reinterpret_cast<float4*>(dst)[q] = make_float4(
          x[4 * q], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]);
  } else {
    dst[0] = x[0];
  }
}

// ---- the kernel --------------------------------------------------------------

template <class C>
__global__ void __launch_bounds__(C::kThreads, C::kMinBlocks)
wino_gemm(const __grid_constant__ Params p) {
  using T = typename C::T;
  extern __shared__ float4 wino_smem4[];
  char* smem = reinterpret_cast<char*>(wino_smem4);
  const int batch = blockIdx.z / p.splits;
  const int split = blockIdx.z % p.splits;
  const int row0 = blockIdx.x * C::BM;
  const int col0 = blockIdx.y * C::BN;
  const int k_begin = split * p.chunk;
  const int k_end = min(p.r, k_begin + p.chunk);
  const int slabs = k_end > k_begin ? (k_end - k_begin + C::BK - 1) / C::BK
                                    : 0;
  const auto stage = [&](int s) {
    return reinterpret_cast<T*>(smem + s * C::kStageBytes);
  };

  float acc[C::MF][C::NF][4];
#pragma unroll
  for (int i = 0; i < C::MF; ++i)
#pragma unroll
    for (int j = 0; j < C::NF; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) {
    if (s < slabs)
      load_slab<C>(p, stage(s), stage(s) + C::kAStage, batch, row0, col0,
                   k_begin + s * C::BK, k_end);
    tile::cp_async_commit();
  }
  for (int i = 0; i < slabs; ++i) {
    // slab i has landed, and every thread is done with slab i - 1, whose
    // stage the next copies overwrite
    tile::cp_async_wait<C::STAGES - 2>();
    __syncthreads();
    const int next = i + C::STAGES - 1;
    if (next < slabs) {
      T* st = stage(next % C::STAGES);
      load_slab<C>(p, st, st + C::kAStage, batch, row0, col0,
                   k_begin + next * C::BK, k_end);
    }
    tile::cp_async_commit();
    const T* st = stage(i % C::STAGES);
    compute_slab<C>(st, st + C::kAStage, acc);
  }
  tile::cp_async_wait<0>();
  __syncthreads();  // the ring is free: the staging tile reuses it

  float* red = reinterpret_cast<float*>(smem);
  {
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const int wm = (warp / C::kWarpsN) * C::WM;
    const int wn = (warp % C::kWarpsN) * C::WN;
    const int g = lane / 4, t = lane % 4;
#pragma unroll
    for (int i = 0; i < C::MF; ++i)
#pragma unroll
      for (int j = 0; j < C::NF; ++j) {
        float* at = red + (wm + i * 16 + g) * C::LDO + wn + j * 8 + 2 * t;
        *reinterpret_cast<float2*>(at) =
            make_float2(acc[i][j][0], acc[i][j][1]);
        *reinterpret_cast<float2*>(at + 8 * C::LDO) =
            make_float2(acc[i][j][2], acc[i][j][3]);
      }
  }
  __syncthreads();

  constexpr int kPerRow = C::BN / C::kOutVec;
  constexpr int kItems = C::BM * kPerRow;
  if (p.cluster) {
    // block q sums every splits-th run of kThreads items over the
    // cluster's partial tiles, in split order, and stores them
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    const int q = (int)cluster.block_rank();
    const int splits = (int)cluster.num_blocks();
    const float* part[tile::kMaxCluster];
#pragma unroll
    for (int j = 0; j < tile::kMaxCluster; ++j)
      part[j] = cluster.map_shared_rank(red, j < splits ? j : 0);
    for (int e = threadIdx.x + q * C::kThreads; e < kItems;
         e += splits * C::kThreads) {
      const int row = e / kPerRow, col = (e % kPerRow) * C::kOutVec;
      float sum[C::kOutVec], x[C::kOutVec];
#pragma unroll
      for (int c = 0; c < C::kOutVec; ++c) sum[c] = 0.f;
      for (int j = 0; j < splits; ++j) {
        load_vals<C>(part[j] + row * C::LDO + col, x);
#pragma unroll
        for (int c = 0; c < C::kOutVec; ++c) sum[c] += x[c];
      }
      store_out<C>(p, batch, row0 + row, col0 + col, sum);
    }
    cluster.sync();  // no block leaves while another reads its tile
    return;
  }
#pragma unroll
  for (int i = 0; i < kItems / C::kThreads; ++i) {
    const int e = threadIdx.x + i * C::kThreads;
    const int row = e / kPerRow, col = (e % kPerRow) * C::kOutVec;
    float x[C::kOutVec];
    load_vals<C>(red + row * C::LDO + col, x);
    if (p.splits == 1)
      store_out<C>(p, batch, row0 + row, col0 + col, x);
    else
      store_part<C>(p, batch, split, row0 + row, col0 + col, x);
  }
}

template <class C>
int launch(const Params& p, cudaStream_t stream) {
  const dim3 grid((p.m + C::BM - 1) / C::BM, (p.n + C::BN - 1) / C::BN,
                  (unsigned)p.t * p.splits);
  if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
  const int err = tile::launch_kernel(wino_gemm<C>, grid, C::kThreads,
                                      C::kSmemBytes,
                                      p.cluster ? p.splits : 1, stream, p);
  if (err || p.splits == 1 || p.cluster) return err;
  tile::launch_sum_splits(p.scratch, static_cast<typename C::T*>(p.out),
                          (size_t)p.t * p.m * p.n, p.splits, stream);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// `bfloat16`: v, u and out are bfloat16 (else float32).  The plan
// (kernels/_plan.py::wino_plan) gives the tile (tile_m x tile_n, which
// must be this build's),
// `splits` and `chunk` (reduction indices per split, whole slabs of 32
// float32 or 64 bfloat16); `scratch` holds splits * t * m * n floats
// when the plan sums more than tile::kMaxCluster splits through it, and
// is null otherwise (the splits of a tile then form one cluster).
extern "C" int repro_wino_gemm(const void* v, const void* u, void* out,
                               float* scratch, int bfloat16, int t, int m,
                               int n, int r, int tile_m, int tile_n,
                               int splits, int chunk, cudaStream_t stream) {
  const int vec = bfloat16 ? 8 : 4;
  const int slab = bfloat16 ? 64 : 32;
  const auto aligned = [](const void* ptr) {
    return reinterpret_cast<size_t>(ptr) % 16 == 0;
  };
  const bool vec_ok = r % vec == 0 && n % vec == 0 && aligned(v) &&
                      aligned(u) && aligned(out);
  const bool cluster = splits > 1 && scratch == nullptr;
  if (t <= 0 || m <= 0 || n <= 0 || r < 0 || splits <= 0 || chunk <= 0 ||
      chunk % slab != 0 || (size_t)splits * chunk < (size_t)r ||
      (splits > 1 && (size_t)(splits - 1) * chunk >= (size_t)r) ||
      (cluster && splits > tile::kMaxCluster) || (bfloat16 && !vec_ok) ||
      tile_m != Tile<float, true>::BM || tile_n != Tile<float, true>::BN)
    return (int)cudaErrorInvalidValue;
  const Params p{v,    u,     out,    cluster ? nullptr : scratch,
                 t,    m,     n,      r,
                 chunk, splits, cluster ? 1 : 0};
  if (bfloat16) return launch<Tile<bf16, true>>(p, stream);
  if (vec_ok) return launch<Tile<float, true>>(p, stream);
  return launch<Tile<float, false>>(p, stream);
}
