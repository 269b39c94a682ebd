// Batched float32 GEMM for Hopper (sm_90a):
//
//   out[t] = a[t] @ b[t]    a [T,M,K], b [T,K,N], out [T,M,N], row-major,
//
// f32 accumulation in registers, IEEE FFMA (no TF32), result in f32.  One
// kernel replaces two Pallas kernels, each through its own wrapper:
//
// * src/repro/kernels/winograd.py::wino_gemm_pallas (kernel body
//   _wino_gemm_kernel), T = 16 frequencies of Winograd F(2x2,3x3)
//   (kernels/winograd.py::wino_gemm);
// * src/repro/kernels/matmul.py::matmul_pallas (kernel body
//   _matmul_kernel), T = 1 (kernels/matmul.py::matmul).
//
// The Pallas kernels walk their grids -- (16, P/bp, K/bk, C/bc) and
// (M/bm, N/bn, K/bk) -- in order on one TPU core and keep each output
// block in a VMEM f32 scratch while the reduction blocks stream past it.
// Blocks on a GPU run in parallel and in no order, so here the batch entry
// is blockIdx.z, the output tile blockIdx.(y, x), and the sequential
// reduction axis a loop inside the block.  The Pallas blocks must divide
// the extents; here ragged edges are masked, so any M, N, K work (the
// 1000-class head included).
//
// tile_64x64: one 64x64 output tile over a K range.  256 threads each own
// a 4x4 register micro-tile; the K loop stages a 64x16 slab of A
// (transposed, padded against bank conflicts) and a 16x64 slab of B in
// shared memory, zero-filled past the edges.
//
// Split reductions: a long K over few output tiles -- Winograd's dU
// product [16, C, P] @ [16, P, K] (a 64x64 output per frequency over up to
// 50176), the im2col candidate's dKer product [9C, N*H*W] @ [N*H*W, K] --
// would leave most of the 132 SMs idle.  With splits > 1 (chosen by the
// wrapper) the reduction is cut into `splits` chunks of whole 16-wide
// slabs, blockIdx.z runs over (split, t), each block writes its partial
// tile to a scratch [splits, T, M, N] the wrapper allocated, and a second
// kernel sums the splits in a fixed order (deterministic, no atomics).
//
// What bounds it on this card: the Winograd forward shapes
// ([16, 64*ceil(Ho/2)^2, C] @ [16, C, K], C, K in 64..512) do 2*16*P*C*K
// FLOPs on 4*16*(PC + CK + PK) bytes: the 64 -> 64 layer at 56x56 is bound
// by bytes (0.12 ms at 3.35 TB/s), the wider ones by f32 FFMA
// (67 TFLOP/s), so the limit to approach is the FFMA issue rate with each
// shared-memory load feeding 4 FMAs.  The classifier head, [64,512] @
// [512,1000], is 65.5 MFLOP -- about 1 us of FFMA work; at that size
// launch latency and the 16 output tiles for 132 SMs bound it in
// practice.  It stays in IEEE f32 for parity with the f32 reference;
// wgmma/TMA pipelining is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 16;
constexpr int kTM = 4;
constexpr int kTN = 4;
constexpr int kThreads = (kBM / kTM) * (kBN / kTN);  // 256

__device__ __forceinline__ void tile_64x64(
    const float* __restrict__ a, const float* __restrict__ b,
    float* __restrict__ c, int m, int n, int k, int k_begin, int k_end,
    int row0, int col0) {
  __shared__ float as[kBK][kBM + 1];  // A slab stored k-major
  __shared__ float bs[kBK][kBN];
  const int tid = threadIdx.x;
  const int tx = tid % (kBN / kTN);  // column group of the micro-tile
  const int ty = tid / (kBN / kTN);  // row group of the micro-tile

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    for (int i = tid; i < kBM * kBK; i += kThreads) {
      const int r = i / kBK, kk = i % kBK;
      const int gr = row0 + r, gk = k0 + kk;
      as[kk][r] = (gr < m && gk < k_end) ? a[(size_t)gr * k + gk] : 0.f;
    }
    for (int i = tid; i < kBK * kBN; i += kThreads) {
      const int kk = i / kBN, cc = i % kBN;
      const int gk = k0 + kk, gc = col0 + cc;
      bs[kk][cc] = (gk < k_end && gc < n) ? b[(size_t)gk * n + gc] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float av[kTM], bv[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) av[i] = as[kk][ty * kTM + i];
#pragma unroll
      for (int j = 0; j < kTN; ++j) bv[j] = bs[kk][tx * kTN + j];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int gr = row0 + ty * kTM + i;
    if (gr >= m) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int gc = col0 + tx * kTN + j;
      if (gc < n) c[(size_t)gr * n + gc] = acc[i][j];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
gemm_tiled(const float* __restrict__ a, const float* __restrict__ b,
           float* __restrict__ out, int t, int m, int n, int k,
           int k_chunk) {
  const int f = blockIdx.z % t;      // batch entry
  const int split = blockIdx.z / t;  // reduction chunk
  const int k_begin = split * k_chunk;
  const int k_end = min(k, k_begin + k_chunk);
  tile_64x64(a + (size_t)f * m * k, b + (size_t)f * k * n,
             out + (size_t)blockIdx.z * m * n, m, n, k, k_begin, k_end,
             blockIdx.y * kBM, blockIdx.x * kBN);
}

__global__ void sum_splits(const float* __restrict__ parts,
                           float* __restrict__ out, size_t len, int splits) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < len;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int j = 0; j < splits; ++j) s += parts[(size_t)j * len + i];
    out[i] = s;
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// `scratch` holds splits * t * m * n floats when splits > 1 (unused else).
extern "C" int repro_gemm_f32(const float* a, const float* b, float* out,
                              float* scratch, int t, int m, int n, int k,
                              int splits, cudaStream_t stream) {
  if (t <= 0 || m <= 0 || n <= 0 || k < 0 || splits <= 0)
    return (int)cudaErrorInvalidValue;
  if (splits > 1 && scratch == nullptr) return (int)cudaErrorInvalidValue;
  const int k_chunk = ((k + splits - 1) / splits + kBK - 1) / kBK * kBK;
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM, t * splits);
  if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
  gemm_tiled<<<grid, kThreads, 0, stream>>>(
      a, b, splits > 1 ? scratch : out, t, m, n, k, k_chunk);
  if (splits > 1) {
    const size_t len = (size_t)t * m * n;
    const size_t blocks = (len + 255) / 256 < 4096 ? (len + 255) / 256 : 4096;
    sum_splits<<<(int)blocks, 256, 0, stream>>>(scratch, out, len, splits);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
