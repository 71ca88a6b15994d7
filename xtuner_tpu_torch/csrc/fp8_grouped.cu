// The C entries of the fp8 grouped GEMMs of the MoE expert path, #12
// (forward and dgrad) and #13 (wgrad), for Hopper (sm_90a). The kernel,
// its design and what bounds it: fp8_grouped.cuh.

#include "fp8_grouped.cuh"

// xq (M, K) codes, sx (M, K/128) f32, wt (E, N, K) = W^T per expert, sw (E,
// K/128, N/128) f32, group_sizes (E,) int32 -> out (M, N); a_type / b_type
// 0 = e4m3, 1 = e5m2 (b must be e4m3); out_f32 0 = bf16, 1 = f32; counts:
// device uint64 [items with products, zero items, steps] or null.
extern "C" int xt_fp8_grouped_gemm(const void* xq, const void* sx, const void* wt,
                                   const void* sw, const void* group_sizes, void* out,
                                   void* counts, int M, int K, int N, int E, int a_type,
                                   int b_type, int out_f32, void* stream) {
  if (M < 0 || E <= 0 || E > MAX_E || K <= 0 || N <= 0 || K % TILE || N % TILE ||
      b_type != E4M3 || (a_type != E4M3 && a_type != E5M2))
    return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t dx[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t dwt[3] = {(cuuint64_t)K, (cuuint64_t)N, (cuuint64_t)E};
  const cuuint64_t dout[2] = {(cuuint64_t)N, (cuuint64_t)M};
  const cuuint32_t bx[2] = {TILE, TILE}, bw[3] = {TILE, TILE, 1};
  const cuuint32_t bout[2] = {out_f32 ? 32u : 64u, 64u};
  CUtensorMap tx, tw, tout;
  if (!make_map_u8(&tx, encode, xq, 2, dx, bx) || !make_map_u8(&tw, encode, wt, 3, dwt, bw) ||
      !make_map_nd(&tout, encode, out, 2, dout, bout, out_f32 != 0))
    return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const int*>(group_sizes), static_cast<const float*>(sx),
               static_cast<const float*>(sw), out, static_cast<unsigned long long*>(counts),
               M, E, K, N};
  // tiles: at most ceil(n_e / 128) per expert and ceil(tail / 128)
  const int64_t items = ((int64_t)M / TILE + E + 1) * (N / TILE);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_f32)
    return a_type == E4M3 ? launch<GG, E4M3, E4M3, float>(tx, tw, tout, a, items, s)
                          : launch<GG, E5M2, E4M3, float>(tx, tw, tout, a, items, s);
  return a_type == E4M3 ? launch<GG, E4M3, E4M3, __nv_bfloat16>(tx, tw, tout, a, items, s)
                        : launch<GG, E5M2, E4M3, __nv_bfloat16>(tx, tw, tout, a, items, s);
}

// xt (Mp/128, K, 128) codes, sx (Mp/128) f32, yt (Mp/128, N, 128), sy (Mp/128)
// f32, group_sizes (E,) int32 -> dw (E, K, N) f32; x_type must be e4m3,
// y_type 0 = e4m3, 1 = e5m2; counts as above
extern "C" int xt_fp8_grouped_dw(const void* xt, const void* sx, const void* yt,
                                 const void* sy, const void* group_sizes, void* dw,
                                 void* counts, int Mp, int K, int N, int E, int x_type,
                                 int y_type, void* stream) {
  if (Mp < 0 || E <= 0 || E > MAX_E || K <= 0 || N <= 0 || Mp % TILE || K % TILE ||
      N % TILE || x_type != E4M3 || (y_type != E4M3 && y_type != E5M2))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Mp == 0)  // no rows: every expert is empty
    return (int)cudaMemsetAsync(dw, 0, (size_t)E * K * N * 4, s);
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t dxt[3] = {(cuuint64_t)TILE, (cuuint64_t)K, (cuuint64_t)(Mp / TILE)};
  const cuuint64_t dyt[3] = {(cuuint64_t)TILE, (cuuint64_t)N, (cuuint64_t)(Mp / TILE)};
  const cuuint64_t ddw[3] = {(cuuint64_t)N, (cuuint64_t)K, (cuuint64_t)E};
  const cuuint32_t box[3] = {TILE, TILE, 1}, bdw[3] = {32, 64, 1};
  CUtensorMap tx, ty, tdw;
  if (!make_map_u8(&tx, encode, xt, 3, dxt, box) || !make_map_u8(&ty, encode, yt, 3, dyt, box) ||
      !make_map_nd(&tdw, encode, dw, 3, ddw, bdw, true))
    return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const int*>(group_sizes), static_cast<const float*>(sx),
               static_cast<const float*>(sy), dw, static_cast<unsigned long long*>(counts),
               Mp, E, K, N};
  const int64_t items = (int64_t)E * (K / TILE) * (N / TILE);
  return y_type == E4M3 ? launch<DW, E4M3, E4M3, float>(tx, ty, tdw, a, items, s)
                        : launch<DW, E4M3, E5M2, float>(tx, ty, tdw, a, items, s);
}

// the dynamic shared memory of one CTA (bytes): out_f32 0 (#12 in bf16) or
// 1 (#12 in f32, and #13)
extern "C" int xt_fp8_grouped_smem_bytes(int out_f32) {
  return out_f32 ? (int)Layout<float>::BYTES : (int)Layout<__nv_bfloat16>::BYTES;
}
