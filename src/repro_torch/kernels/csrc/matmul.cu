// Tiled float32 GEMM for Hopper (sm_90a): C[M,N] = A[M,K] @ B[K,N],
// all row-major, f32 accumulation, result in f32.
//
// Replaces: src/repro/kernels/matmul.py::matmul_pallas (kernel body
// _matmul_kernel).  The Pallas kernel walks the grid (M/bm, N/bn, K/bk) in
// order on one TPU core and keeps the output block resident in a VMEM f32
// scratch while the K blocks stream past it.  Blocks on a GPU run in
// parallel and in no order, so the sequential K grid axis becomes a loop
// inside the block and the output tile lives in registers.  The Pallas
// blocks must divide the extents; here ragged edges are masked, so any
// M, N, K work (the 1000-class head included).
//
// What bounds it on this card: the classifier head on its path,
// [64,512] @ [512,1000], is 65.5 MFLOP over 2.4 MB -- about 1 us of f32
// FFMA work at the H100's 67 TFLOP/s (operations bound it ahead of the
// 0.7 us of HBM traffic).  At that size the kernel is bound in practice by
// launch latency and by filling the card: a 64x64 output tile gives only
// 16 blocks for 132 SMs.  The simple design does nothing about that yet
// (split-K or smaller tiles are later work); it stays in IEEE float32 FFMA,
// with no TF32 tensor cores, so that it keeps parity with the f32
// reference.
//
// Design: 64x64 output tile per block, 256 threads, each thread owns a
// 4x4 register micro-tile; the K loop stages a 64x16 slab of A
// (transposed, padded against bank conflicts) and a 16x64 slab of B in
// shared memory, zero-filled past the edges.

#include <cuda_runtime.h>

namespace {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 16;
constexpr int kTM = 4;
constexpr int kTN = 4;
constexpr int kThreads = (kBM / kTM) * (kBN / kTN);  // 256

__global__ void __launch_bounds__(kThreads)
sgemm_tiled(const float* __restrict__ a, const float* __restrict__ b,
            float* __restrict__ c, int m, int n, int k) {
  __shared__ float as[kBK][kBM + 1];  // A slab stored k-major
  __shared__ float bs[kBK][kBN];
  const int tid = threadIdx.x;
  const int tx = tid % (kBN / kTN);  // column group of the micro-tile
  const int ty = tid / (kBN / kTN);  // row group of the micro-tile
  const int row0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < k; k0 += kBK) {
    for (int i = tid; i < kBM * kBK; i += kThreads) {
      const int r = i / kBK, kk = i % kBK;
      const int gr = row0 + r, gk = k0 + kk;
      as[kk][r] = (gr < m && gk < k) ? a[(size_t)gr * k + gk] : 0.f;
    }
    for (int i = tid; i < kBK * kBN; i += kThreads) {
      const int kk = i / kBN, cc = i % kBN;
      const int gk = k0 + kk, gc = col0 + cc;
      bs[kk][cc] = (gk < k && gc < n) ? b[(size_t)gk * n + gc] : 0.f;
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

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int repro_matmul_f32(const float* a, const float* b, float* c,
                                int m, int n, int k, cudaStream_t stream) {
  if (m <= 0 || n <= 0 || k < 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  sgemm_tiled<<<grid, kThreads, 0, stream>>>(a, b, c, m, n, k);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
