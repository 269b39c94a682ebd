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
//
// Here the conv is an implicit GEMM on the shared tile core
// (csrc/tile_gemm.cuh):
//
//   out[(n,y,x), k] = sum_{(c,r,s)} x[n, c, y+r-p, x+s-p] * w[k, (c,r,s)]
//
// rows M = N*Ho*Wo, columns K, reduction R = C*kh*kw.  Nothing is staged
// per tap: the A loader gathers the (row, reduction index) elements of
// each slab straight from x with 4-byte cp.async copies, zero-filled past
// the image (SAME), past M and past R, so C = 3, ragged K and C, and any
// kh, kw need no branch.  Each thread works out its rows' (n, y, x) once
// per tile and walks its reduction indices (c, r, s) a slab at a time by
// adding the slab's own (c, r, s) decomposition with carries: no division
// in the reduction loop.  The B loader reads w as [K, R] along R.  The
// output tile is scattered back to NCHW.
//
// Two A loaders, because x is contiguous in different directions:
//
// * along the rows (Ho = H-ish planes: the forward, and dIn, which is the
//   VALID conv of the padded cotangent with the flipped kernel):
//   consecutive threads take consecutive rows (x), one reduction index
//   each;
// * along the reduction (kw > Wo: dKer, the N/C-transposed VALID conv
//   whose "kernel" is the cotangent, as wide as the plane, with a 3x3
//   output): consecutive threads take consecutive reduction indices (s).
//
// What bounds it on this card: at the CNN's shapes (C, K in 64..512, 3x3,
// batch 64) the forward and dIn do 2*N*K*C*H*W*9 FLOPs on a few tens of
// MB, so f32 FFMA (67 TFLOP/s) bounds them, and the 8x8 register tile
// feeds 64 FMAs per 4 shared-memory float4 loads.  dKer has the same
// FLOPs but a 3x3 output: M = 9C rows (27 to 4608) over a reduction of
// N*H*W (3136 to 200704).  The launch plan (kernels/_plan.py) splits that
// reduction into whole-slab chunks until the card has about four blocks
// per SM (up to 523 splits at C = 3), and the tile core sums the partial
// tiles in a fixed order.
// bfloat16: the wrapper (kernels/conv2d.py) widens bf16 operands to f32,
// which is exact, runs this kernel, and narrows the output once -- the
// reference's arithmetic (bf16 products exact in f32, f32 sums, one
// rounding), for the price of the copies (13% of a bf16 conv at the
// 64 -> 64 layer on an H100).  Native bf16 loaders would need another
// layout: the loaders' 4- and 16-byte copies of floats into a k-major
// slab cannot transpose a 2-byte element.
// Left for a later PR: 3xTF32 on the tensor cores (wgmma fed by TMA or
// by the gathers through an mbarrier ring), which changes the IEEE f32
// contract; an output tile staged through shared memory for coalesced
// NCHW stores; native bf16 loaders.

#include <type_traits>

#include "tile_gemm.cuh"

namespace {

struct ConvParams {
  tile::Problem g;  // m = N*Ho*Wo, n = K, r = C*kh*kw
  const float* x;
  const float* w;
  int c, h, w_in, kh, kw, wo, howo, pad_h, pad_w;
};

// The (c, r, s) decomposition of a reduction index, and of one slab, as
// an offset into one image's [C, H, W] planes.
struct Tap {
  int r, s, off;  // off = c*H*W + r*W + s
};

__device__ __forceinline__ Tap tap_of(const ConvParams& p, int k) {
  const int khw = p.kh * p.kw;
  const int c = k / khw;
  const int rem = k - c * khw;
  const int r = rem / p.kw;
  const int s = rem - r * p.kw;
  return {r, s, (c * p.h + r) * p.w_in + s};
}

// t += d, both decompositions: one carry from s into r, one from r into c
__device__ __forceinline__ void advance(Tap& t, const Tap& d,
                                        const ConvParams& p) {
  t.s += d.s;
  t.r += d.r;
  t.off += d.off;
  if (t.s >= p.kw) {
    t.s -= p.kw;
    t.r += 1;
    t.off += p.w_in - p.kw;
  }
  if (t.r >= p.kh) {
    t.r -= p.kh;
    t.off += (p.h - p.kh) * p.w_in;
  }
}

// A row (n, y, x) of the implicit GEMM: its image's base offset and the
// top-left input pixel of its window (iy0 far out of range for a row
// past M, so its copies zero-fill)
struct Row {
  long long base;
  int iy0, ix0;
};

__device__ __forceinline__ Row row_of(const ConvParams& p, int m) {
  if (m >= p.g.m) return {0, -(1 << 30), 0};
  const int img = m / p.howo;
  const int yx = m - img * p.howo;
  const int y = yx / p.wo;
  const int x = yx - y * p.wo;
  const int iy0 = y - p.pad_h, ix0 = x - p.pad_w;
  return {(long long)img * p.c * p.h * p.w_in + (long long)iy0 * p.w_in +
              ix0,
          iy0, ix0};
}

__device__ __forceinline__ bool inside(const ConvParams& p, const Row& row,
                                       const Tap& t) {
  return (unsigned)(row.iy0 + t.r) < (unsigned)p.h &&
         (unsigned)(row.ix0 + t.s) < (unsigned)p.w_in;
}

// consecutive threads on consecutive rows; each thread one row and
// kCount reduction indices kKStep apart
template <class C>
struct GatherAlongRows {
  static constexpr int kKStep = C::kThreads / C::BM;
  static constexpr int kCount = C::kPerThread;
  const ConvParams& p;
  Row row;
  Tap tap[kCount];
  Tap slab;
  int k, k_end, dst;

  __device__ GatherAlongRows(const ConvParams& p_, int, int row0,
                             int k_begin, int k_end_)
      : p(p_), k_end(k_end_) {
    const int mm = threadIdx.x % C::BM;
    const int kq = threadIdx.x / C::BM;
    row = row_of(p, row0 + mm);
    k = k_begin + kq;
#pragma unroll
    for (int j = 0; j < kCount; ++j) tap[j] = tap_of(p, k + j * kKStep);
    slab = tap_of(p, C::BK);
    dst = kq * C::LDA + mm;
  }

  __device__ __forceinline__ void load(float* s) {
#pragma unroll
    for (int j = 0; j < kCount; ++j) {
      const bool ok = k + j * kKStep < k_end && inside(p, row, tap[j]);
      tile::cp_async4(s + dst + j * kKStep * C::LDA,
                      ok ? p.x + (row.base + tap[j].off) : p.x, ok);
      advance(tap[j], slab, p);
    }
    k += C::BK;
  }
};

// consecutive threads on consecutive reduction indices; each thread one
// index and kCount rows kRowStep apart
template <class C>
struct GatherAlongK {
  static constexpr int kRowStep = C::kThreads / C::BK;
  static constexpr int kCount = C::kPerThread;
  const ConvParams& p;
  Row row[kCount];
  Tap tap, slab;
  int k, k_end, dst;

  __device__ GatherAlongK(const ConvParams& p_, int, int row0, int k_begin,
                          int k_end_)
      : p(p_), k_end(k_end_) {
    const int kk = threadIdx.x % C::BK;
    const int rr = threadIdx.x / C::BK;
#pragma unroll
    for (int j = 0; j < kCount; ++j)
      row[j] = row_of(p, row0 + rr + j * kRowStep);
    k = k_begin + kk;
    tap = tap_of(p, k);
    slab = tap_of(p, C::BK);
    dst = kk * C::LDA + rr;
  }

  __device__ __forceinline__ void load(float* s) {
    const bool kin = k < k_end;
#pragma unroll
    for (int j = 0; j < kCount; ++j) {
      const bool ok = kin && inside(p, row[j], tap);
      tile::cp_async4(s + dst + j * kRowStep,
                      ok ? p.x + (row[j].base + tap.off) : p.x, ok);
    }
    advance(tap, slab, p);
    k += C::BK;
  }
};

template <bool kAlongK>
struct ConvOp {
  using Params = ConvParams;

  template <class C>
  struct A : std::conditional<kAlongK, GatherAlongK<C>,
                              GatherAlongRows<C>>::type {
    using Base = typename std::conditional<kAlongK, GatherAlongK<C>,
                                           GatherAlongRows<C>>::type;
    __device__ A(const Params& p, int batch, int row0, int k_begin,
                 int k_end)
        : Base(p, batch, row0, k_begin, k_end) {}
  };

  // w as [K, R]: B[k][col] = w[col * R + k]
  template <class C>
  struct B : tile::KContiguous<C, C::BN, C::LDB> {
    __device__ B(const Params& p, int, int col0, int k_begin, int k_end)
        : tile::KContiguous<C, C::BN, C::LDB>(p.w, p.g.r, p.g.n, col0,
                                              k_begin, k_end) {}
  };

  __device__ static size_t row_offset(const Params& p, int, int row) {
    const int img = row / p.howo;
    return (size_t)img * p.g.n * p.howo + (row - img * p.howo);
  }
  __device__ static size_t col_offset(const Params& p, int col) {
    return (size_t)col * p.howo;
  }
};

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// The plan (kernels/_plan.py::gemm_plan with m = n*ho*wo, n = k,
// r = c*kh*kw) gives the tile, `splits` and `chunk`; `scratch` holds
// splits * n*k*ho*wo floats when the plan sums the splits through it, and
// is null when it sums them in a cluster (or splits = 1).  The A loader
// runs along the reduction when the window is wider than the output.
extern "C" int repro_conv2d_f32(const float* x, const float* w, float* out,
                                float* scratch, int n, int c, int h, int wd,
                                int k, int kh, int kw, int ho, int wo,
                                int pad_h, int pad_w, int tile_m, int tile_n,
                                int splits, int chunk, cudaStream_t stream) {
  if (n <= 0 || c <= 0 || k <= 0 || ho <= 0 || wo <= 0 || kh <= 0 || kw <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t limit = (size_t)1 << 31;
  if ((size_t)n * ho * wo >= limit || (size_t)c * kh * kw >= limit ||
      (size_t)c * h * wd >= limit)
    return (int)cudaErrorInvalidValue;
  const tile::Problem g{1, n * ho * wo, k, c * kh * kw, chunk, 1, nullptr,
                        0};
  const ConvParams p{g, x, w, c, h, wd, kh, kw, wo, ho * wo, pad_h, pad_w};
  if (kw > wo)
    return tile::launch_tile<ConvOp<true>>(tile_m, tile_n, p, out, scratch,
                                           splits, stream);
  return tile::launch_tile<ConvOp<false>>(tile_m, tile_n, p, out, scratch,
                                          splits, stream);
}
