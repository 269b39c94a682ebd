// Batched float32 GEMM for Hopper (sm_90a):
//
//   out[t] = a[t] @ b[t]    a [T,M,K], b [T,K,N], out [T,M,N], row-major,
//
// f32 accumulation in registers, IEEE FFMA (no TF32), result in f32.
//
// Replaces: src/repro/kernels/matmul.py::matmul_pallas (kernel body
// _matmul_kernel), as the float32 route of kernels/matmul.py::matmul for
// products of more than _plan.SKINNY_M rows, at T = 1 (csrc/skinny_gemm.cu
// is the other route).  The C entry takes T batch entries; Winograd's
// batched tile GEMM is csrc/wino_gemm.cu.
//
// The Pallas kernel walks its grid (M/bm, N/bn, K/bk) in order on one TPU
// core and keeps each output block in a VMEM f32 scratch while the
// reduction blocks stream past it.  Blocks on a GPU run in parallel and
// in no order: here the output tile is blockIdx.(x, y), the batch entry
// and the reduction split blockIdx.z, and the sequential reduction axis a
// loop inside the block.  The Pallas blocks must divide the extents; here
// ragged edges are zero-filled by the copies, so any M, N, K work (the
// 1000-class head included).
//
// The main loop is the shared tile core (csrc/tile_gemm.cuh): a 4-slab
// cp.async ring, a 128x128 tile with 8x8 outputs per thread or a 64x64
// tile with 4x4.  This file only says where the operands and outputs
// live: A through 4-byte copies along k (shared memory holds A k-major,
// which a 16-byte copy of a row of A cannot fill), B through 16-byte
// copies when its rows are 16-byte aligned (N % 4 == 0), else 4-byte
// copies.
//
// What bounds it on this card: the classifier head, [64,512] @
// [512,1000], is 65.5 MFLOP, about 1 us of FFMA work over 16 output tiles
// of 64x64: launch latency and the host's time per call bound it.  The
// plan (kernels/_plan.py) splits its reduction 8 ways, and the 8 splits
// of a tile sum in a thread-block cluster: one launch, no scratch.  Long
// thin products -- the im2col candidate's dKer product [9C, N*H*W] @
// [N*H*W, K] -- split until the card has about four blocks per SM and
// sum through scratch.  The LM prefill products (M = 64 rows against
// weights of 0.5-16 M elements) are bound by f32 FFMA (67 TFLOP/s).
// bfloat16 products take csrc/skinny_gemm.cu.  Left for a later PR:
// 3xTF32 on the tensor cores for this route too (csrc/wino_gemm.cu's
// arithmetic, which wins the im2col dKer product at T = 1:
// tools/wino_sweep.py).

#include "tile_gemm.cuh"

namespace {

template <bool kVecB>
struct GemmOp {
  struct Params {
    tile::Problem g;
    const float* a;
    const float* b;
  };

  template <class C>
  struct A : tile::KContiguous<C, C::BM, C::LDA> {
    __device__ A(const Params& p, int batch, int row0, int k_begin,
                 int k_end)
        : tile::KContiguous<C, C::BM, C::LDA>(
              p.a + (size_t)batch * p.g.m * p.g.r, p.g.r, p.g.m, row0,
              k_begin, k_end) {}
  };

  template <class C>
  struct B : tile::TileContiguous<C, C::BN, C::LDB, kVecB> {
    __device__ B(const Params& p, int batch, int col0, int k_begin,
                 int k_end)
        : tile::TileContiguous<C, C::BN, C::LDB, kVecB>(
              p.b + (size_t)batch * p.g.r * p.g.n, p.g.n, p.g.n, col0,
              k_begin, k_end) {}
  };

  __device__ static size_t row_offset(const Params& p, int batch, int row) {
    return ((size_t)batch * p.g.m + row) * p.g.n;
  }
  __device__ static size_t col_offset(const Params&, int col) {
    return (size_t)col;
  }
};

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// The plan (kernels/_plan.py::gemm_plan) gives the tile (tile_m x tile_n),
// `splits` and `chunk` (reduction indices per split, whole slabs);
// `scratch` holds splits * t * m * n floats when the plan sums the splits
// through it, and is null when it sums them in a cluster (or splits = 1).
extern "C" int repro_gemm_f32(const float* a, const float* b, float* out,
                              float* scratch, int t, int m, int n, int k,
                              int tile_m, int tile_n, int splits, int chunk,
                              cudaStream_t stream) {
  const tile::Problem g{t, m, n, k, chunk, 1, nullptr, 0};
  const bool vec_b = n % 4 == 0 && reinterpret_cast<size_t>(b) % 16 == 0;
  if (vec_b)
    return tile::launch_tile<GemmOp<true>>(tile_m, tile_n,
                                           GemmOp<true>::Params{g, a, b},
                                           out, scratch, splits, stream);
  return tile::launch_tile<GemmOp<false>>(tile_m, tile_n,
                                          GemmOp<false>::Params{g, a, b},
                                          out, scratch, splits, stream);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
