// The C entry of the tile-wise fp8 GEMM of the attention projections (#11),
// for Hopper (sm_90a): fp8_grouped.cuh's persistent wgmma/TMA kernel in
// mode DENSE, #12's walk with one group of all M rows.
//
// Replaces TPU kernel #11, xtuner_tpu/ops/fp8_gemm.py::_gemm_kernel
// (pallas_call in fp8_gemm_tilewise):
//   y[m, n] = sum_t (sum_{k in tile t} xq[m, k] wq[k, n]) * sx[m, t] * sw[t, n / 128]
// xq (M, K) e4m3 or e5m2, sx (M, K/128) f32, wq given K-major as wt (N, K)
// in e4m3 or e5m2 (not both e5m2), sw (K/128, N/128) f32; f32 accumulation
// promoted once per 128-deep scale step, y (M, N) bf16 or f32. K and N are
// 128 multiples (the wrapper's quantisers pad them); M is any: rows past M
// read as zeros and are not stored. Its design, and what bounds it, are
// the kernel's (fp8_grouped.cuh).

#include "fp8_grouped.cuh"

namespace {

template <typename OutT>
int launch_dense(const CUtensorMap& tx, const CUtensorMap& tw, const CUtensorMap& tout,
                 const Args& a, int64_t items, int a_type, int b_type, cudaStream_t s) {
  if (a_type == E4M3 && b_type == E4M3)
    return launch<DENSE, E4M3, E4M3, OutT>(tx, tw, tout, a, items, s);
  if (a_type == E5M2 && b_type == E4M3)
    return launch<DENSE, E5M2, E4M3, OutT>(tx, tw, tout, a, items, s);
  return launch<DENSE, E4M3, E5M2, OutT>(tx, tw, tout, a, items, s);
}

}  // namespace

// xq (M, K), sx (M, K/128) f32, wt (N, K) = wq^T, sw (K/128, N/128) f32 ->
// out (M, N); a_type / b_type 0 = e4m3, 1 = e5m2 (not both 1); out_f32 0 =
// bf16, 1 = f32
extern "C" int xt_fp8_gemm(const void* xq, const void* sx, const void* wt, const void* sw,
                           void* out, int M, int K, int N, int a_type, int b_type,
                           int out_f32, void* stream) {
  if (M < 0 || K <= 0 || N <= 0 || K % TILE || N % TILE || a_type < E4M3 || a_type > E5M2 ||
      b_type < E4M3 || b_type > E5M2 || (a_type == E5M2 && b_type == E5M2))
    return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t dx[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t dwt[3] = {(cuuint64_t)K, (cuuint64_t)N, 1};
  const cuuint64_t dout[2] = {(cuuint64_t)N, (cuuint64_t)M};
  const cuuint32_t bx[2] = {TILE, TILE}, bw[3] = {TILE, TILE, 1};
  const cuuint32_t bout[2] = {out_f32 ? 32u : 64u, 64u};
  CUtensorMap tx, tw, tout;
  if (!make_map_u8(&tx, encode, xq, 2, dx, bx) || !make_map_u8(&tw, encode, wt, 3, dwt, bw) ||
      !make_map_nd(&tout, encode, out, 2, dout, bout, out_f32 != 0))
    return (int)cudaErrorInvalidValue;
  const Args a{nullptr, static_cast<const float*>(sx), static_cast<const float*>(sw), out,
               nullptr, M, 1, K, N};
  const int64_t items = ((int64_t)M + TILE - 1) / TILE * (N / TILE);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return out_f32 ? launch_dense<float>(tx, tw, tout, a, items, a_type, b_type, s)
                 : launch_dense<__nv_bfloat16>(tx, tw, tout, a, items, a_type, b_type, s);
}
