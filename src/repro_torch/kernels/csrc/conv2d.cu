// Direct float32 convolution for Hopper (sm_90a): stride 1, NCHW input,
// OIHW kernel, SAME or VALID, f32 accumulation.
//
//   out[n,k,y,x] = sum_{c,r,s} in[n,c,y+r-pad_h,x+s-pad_w] * ker[k,c,r,s]
//
// with zeros outside the input (SAME: pad = (kh-1)/2; VALID: pad = 0 and
// out extent = in extent - kernel extent + 1).
//
// Replaces: src/repro/kernels/conv2d.py::conv2d_pallas (kernel body
// _conv_kernel).  The Pallas kernel holds a whole padded H x W plane of a
// (batch, C-slab) block in VMEM and runs the stencil as kh*kw shifted-window
// matmuls, with the Out tile resident across the sequential C grid axis.
// A 56x56 plane of 64+ channels does not fit the 227 KB of shared memory a
// Hopper block may use, so this kernel tiles the output pixels as well:
// each block owns an 8x16 tile of output pixels of one image times 32
// output channels, and loops over C inside the block (the sequential grid
// axis of the TPU kernel).  Per C step of 8 channels it stages the input
// tile plus its (kh-1) x (kw-1) halo and the matching kernel slice in
// shared memory, with masked loads: zeros past the image edge (SAME) or
// past the window edge (VALID), and zeros past C and K, so C = 3 and
// ragged K work.
//
// What bounds it on this card: at the CNN's shapes (C, K in 64..512,
// 3x3, batch 64) the conv does 2*N*K*C*H*W*9 FLOPs on a few tens of MB:
// 0.1-0.2 ms of f32 FFMA work at 67 TFLOP/s against ~0.01-0.03 ms of HBM
// traffic, so operations bound it, and the limit to approach is the FFMA
// issue rate.  The simple design keeps each thread on a 4-pixel x
// 4-channel register tile so every shared-memory load feeds several FMAs;
// for 3x3 the stencil loops are unrolled at compile time so the six input
// values a row of the micro-tile needs are loaded once per (c, r).  It
// stays in IEEE f32 (no TF32 tensor cores).  Implicit GEMM on wgmma, TMA
// staging and multi-stage pipelining are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kTH = 8;    // output rows per block tile
constexpr int kTW = 16;   // output cols per block tile
constexpr int kBK = 32;   // output channels per block
constexpr int kBC = 8;    // input channels staged per C step
constexpr int kPX = 4;    // adjacent output pixels per thread
constexpr int kKX = 4;    // output channels per thread
constexpr int kThreads = (kTH * kTW / kPX) * (kBK / kKX);  // 256

// KS > 0: a KS x KS kernel known at compile time; KS == 0: kh, kw at run time.
template <int KS>
__global__ void __launch_bounds__(kThreads)
conv2d_direct(const float* __restrict__ x, const float* __restrict__ w,
              float* __restrict__ out, int C, int H, int W, int K,
              int kh_rt, int kw_rt, int Ho, int Wo, int pad_h, int pad_w,
              int tiles_w) {
  const int kh = KS > 0 ? KS : kh_rt;
  const int kw = KS > 0 ? KS : kw_rt;
  const int tih = kTH + kh - 1;
  const int tiw = kTW + kw - 1;
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);  // [kBC][kh][kw][kBK]
  float* xs = ws + kBC * kh * kw * kBK;         // [kBC][tih][tiw]

  const int n = blockIdx.z;
  const int k0 = blockIdx.y * kBK;
  const int oy0 = (blockIdx.x / tiles_w) * kTH;
  const int ox0 = (blockIdx.x % tiles_w) * kTW;
  const int tid = threadIdx.x;
  const int kg = tid / 32;  // a warp shares its 4 output channels
  const int pg = tid % 32;
  const int py = pg / (kTW / kPX);
  const int px0 = (pg % (kTW / kPX)) * kPX;

  float acc[kPX][kKX];
#pragma unroll
  for (int i = 0; i < kPX; ++i)
#pragma unroll
    for (int j = 0; j < kKX; ++j) acc[i][j] = 0.f;

  const float* xn = x + (size_t)n * C * H * W;
  const int khw = kh * kw;
  for (int c0 = 0; c0 < C; c0 += kBC) {
    // kernel slice: global reads run along (c, r, s) of one k, shared
    // memory holds it k-minor so a thread reads its 4 channels as a float4
    for (int i = tid; i < kBK * kBC * khw; i += kThreads) {
      const int rs = i % khw;
      const int cc = (i / khw) % kBC;
      const int kk = i / (khw * kBC);
      const int gk = k0 + kk, gc = c0 + cc;
      ws[(cc * khw + rs) * kBK + kk] =
          (gk < K && gc < C) ? w[((size_t)gk * C + gc) * khw + rs] : 0.f;
    }
    // input tile plus halo, zero past the image / window / C edge
    for (int i = tid; i < kBC * tih * tiw; i += kThreads) {
      const int xx = i % tiw;
      const int yy = (i / tiw) % tih;
      const int cc = i / (tiw * tih);
      const int gy = oy0 + yy - pad_h, gx = ox0 + xx - pad_w, gc = c0 + cc;
      xs[i] = (gc < C && gy >= 0 && gy < H && gx >= 0 && gx < W)
                  ? xn[((size_t)gc * H + gy) * W + gx]
                  : 0.f;
    }
    __syncthreads();
    for (int cc = 0; cc < kBC; ++cc) {
      // kh, kw are compile-time constants when KS > 0: these loops unroll
      // and the overlapping xrow loads across s are loaded once
#pragma unroll
      for (int r = 0; r < kh; ++r) {
        const float* xrow = xs + (cc * tih + py + r) * tiw + px0;
        const float* wrow = ws + (cc * khw + r * kw) * kBK + kg * kKX;
#pragma unroll
        for (int s = 0; s < kw; ++s) {
          const float4 wv = *reinterpret_cast<const float4*>(wrow + s * kBK);
#pragma unroll
          for (int i = 0; i < kPX; ++i) {
            const float a = xrow[s + i];
            acc[i][0] = fmaf(a, wv.x, acc[i][0]);
            acc[i][1] = fmaf(a, wv.y, acc[i][1]);
            acc[i][2] = fmaf(a, wv.z, acc[i][2]);
            acc[i][3] = fmaf(a, wv.w, acc[i][3]);
          }
        }
      }
    }
    __syncthreads();
  }

  const int oy = oy0 + py;
  if (oy >= Ho) return;
#pragma unroll
  for (int j = 0; j < kKX; ++j) {
    const int gk = k0 + kg * kKX + j;
    if (gk >= K) continue;
    float* orow = out + (((size_t)n * K + gk) * Ho + oy) * Wo;
#pragma unroll
    for (int i = 0; i < kPX; ++i) {
      const int ox = ox0 + px0 + i;
      if (ox < Wo) orow[ox] = acc[i][j];
    }
  }
}

template <int KS>
int launch(const float* x, const float* w, float* out, int n, int c, int h,
           int wd, int k, int kh, int kw, int ho, int wo, int pad_h,
           int pad_w, cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      ((size_t)kBC * kh * kw * kBK + (size_t)kBC * (kTH + kh - 1) * (kTW + kw - 1));
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        conv2d_direct<KS>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int tiles_w = (wo + kTW - 1) / kTW;
  const int tiles_h = (ho + kTH - 1) / kTH;
  const dim3 grid(tiles_w * tiles_h, (k + kBK - 1) / kBK, n);
  if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
  conv2d_direct<KS><<<grid, kThreads, smem, stream>>>(
      x, w, out, c, h, wd, k, kh, kw, ho, wo, pad_h, pad_w, tiles_w);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int repro_conv2d_f32(const float* x, const float* w, float* out,
                                int n, int c, int h, int wd, int k, int kh,
                                int kw, int ho, int wo, int pad_h, int pad_w,
                                cudaStream_t stream) {
  if (n <= 0 || c <= 0 || k <= 0 || ho <= 0 || wo <= 0 || kh <= 0 || kw <= 0)
    return (int)cudaErrorInvalidValue;
  if (kh == 3 && kw == 3)
    return launch<3>(x, w, out, n, c, h, wd, k, kh, kw, ho, wo, pad_h, pad_w, stream);
  return launch<0>(x, w, out, n, c, h, wd, k, kh, kw, ho, wo, pad_h, pad_w, stream);
}
