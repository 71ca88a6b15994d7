// Tile-wise fp8 GEMM for Hopper (sm_90a).
//
// Replaces TPU kernel #11, xtuner_tpu/ops/fp8_gemm.py::_gemm_kernel
// (pallas_call in fp8_gemm_tilewise):
//   y[m, n] = sum_t (sum_{k in tile t} xq[m, k] wq[k, n]) * sx[m, t] * sw[t, n / 128]
// xq (M, K) e4m3 or e5m2, sx (M, K/128) f32, wq given K-major as wt (N, K),
// sw (K/128, N/128) f32; f32 accumulation, y (M, N) bf16 or f32.
//
// What bounds it on the H100: at the attention projections of the
// moe_heavy step (M = 16384, K, N in 1024..2048) a product does 2 M K N
// operations on M K + K N + 2 M N bytes, ~800 per byte, far above the
// card's 590 fp8 operations per byte of bandwidth: the tensor cores bound
// it (1,979 TFLOP/s dense fp8). This first version issues mma.sync
// m16n8k32 fp8 from shared memory, which reaches a fraction of that
// (wgmma, TMA and a persistent scheduler come later).
//
// Design: one CTA per 128 x 128 output tile walks K in 128-deep scale
// tiles (fp8_tile.cuh): each tile's products go to a fresh fragment, which
// is scaled by sx[row, t] * sw[t, block] and added into the f32
// accumulator. K and N are 128 multiples (the wrapper's quantisers pad
// them); M is not padded: rows past M are zero-filled and not stored.

#include "fp8_tile.cuh"

namespace {

using namespace xt_fp8;

template <int TA, int TB, typename OutT>
__global__ void __launch_bounds__(NTHREADS)
fp8_gemm_kernel(const uint8_t* __restrict__ x, const float* __restrict__ sx,
                const uint8_t* __restrict__ wt, const float* __restrict__ sw,
                OutT* __restrict__ out, int M, int K, int N) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int n0 = blockIdx.x * TILE;
  const int m0 = blockIdx.y * TILE;
  // sw (K/128, N/128): this CTA's column block, one scale per K tile
  scaled_tile<TA, TB, OutT>(x, sx, wt, sw + blockIdx.x, N / TILE, out, K, N, m0, n0, m0,
                            min(m0 + TILE, M), smem);
}

template <int TA, int TB, typename OutT>
int launch(const void* x, const void* sx, const void* wt, const void* sw, void* out, int M,
           int K, int N, cudaStream_t stream) {
  auto kern = fp8_gemm_kernel<TA, TB, OutT>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(N / TILE, (M + TILE - 1) / TILE);
  kern<<<grid, NTHREADS, SMEM_BYTES, stream>>>(
      static_cast<const uint8_t*>(x), static_cast<const float*>(sx),
      static_cast<const uint8_t*>(wt), static_cast<const float*>(sw), static_cast<OutT*>(out),
      M, K, N);
  return (int)cudaGetLastError();
}

template <typename OutT>
int dispatch(const void* x, const void* sx, const void* wt, const void* sw, void* out, int M,
             int K, int N, int ta, int tb, cudaStream_t s) {
  if (ta == E4M3 && tb == E4M3) return launch<E4M3, E4M3, OutT>(x, sx, wt, sw, out, M, K, N, s);
  if (ta == E5M2 && tb == E4M3) return launch<E5M2, E4M3, OutT>(x, sx, wt, sw, out, M, K, N, s);
  if (ta == E4M3 && tb == E5M2) return launch<E4M3, E5M2, OutT>(x, sx, wt, sw, out, M, K, N, s);
  return (int)cudaErrorInvalidValue;  // e5m2 x e5m2: no caller
}

}  // namespace

// xq (M, K), sx (M, K/128) f32, wt (N, K) = wq^T, sw (K/128, N/128) f32 ->
// out (M, N); a_type / b_type 0 = e4m3, 1 = e5m2; out_f32 0 = bf16, 1 = f32
extern "C" int xt_fp8_gemm(const void* xq, const void* sx, const void* wt, const void* sw,
                           void* out, int M, int K, int N, int a_type, int b_type,
                           int out_f32, void* stream) {
  if (M < 0 || K <= 0 || N <= 0 || K % TILE || N % TILE) return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return out_f32 ? dispatch<float>(xq, sx, wt, sw, out, M, K, N, a_type, b_type, s)
                 : dispatch<__nv_bfloat16>(xq, sx, wt, sw, out, M, K, N, a_type, b_type, s);
}
