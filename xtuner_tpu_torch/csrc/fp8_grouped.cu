// Tile-wise fp8 grouped GEMMs of the MoE expert path, for Hopper (sm_90a).
//
// Replaces two TPU kernels of xtuner_tpu/ops/fp8_grouped.py:
// - #12 _gg_kernel (pallas_call in fp8_grouped_gemm), forward and dgrad:
//     out[m, n] = sum_t (xq[m, t] . W[e(m)][t, n]) sx[m, t] sw[e(m), t, n / 128]
//   rows sorted by expert, e(m) the expert whose row range holds m (offsets
//   = exclusive cumsum of group_sizes, on the device); rows past the last
//   group get zeros. W[e] arrives K-major as wt (E, N, K).
// - #13 _dw_kernel (pallas_call in fp8_grouped_gemm_dw), the wgrad:
//     dW[e] = sum over 128-row tiles r of (xq_r^T dyq_r) sx[r] sy[r]
//   over expert e's rows only (rows of other experts in a straddling tile
//   are zeroed before the product), f32, zero for an empty expert. Both
//   operands contract over rows and arrive row-contiguous in 128-row
//   tiles: xt (Mp/128, K, 128), yt (Mp/128, N, 128), Mp a 128 multiple, so
//   that one tile of one operand is 16 KB in one piece.
//
// What bounds them on the H100: at the moe_heavy step (M = 131072 routed
// rows, 16 experts, K, N in 768..1024) the forward and dgrad do 540-590
// fp8 operations per byte of operands and bf16 output, at the card's ridge
// (1,979 TFLOP/s over 3.35 TB/s = 590): bytes and operations bound them
// about equally; the wgrad (~730 per byte, E K N f32 out) is bound by its
// operations. This first version issues mma.sync m16n8k32 fp8 from shared
// memory and reaches a fraction of either bound.
//
// Design (simple and right first; wgmma/TMA and persistence later):
// - #12: one CTA per (128-row M tile, 128-col N tile). It finds the experts
//   its rows belong to from the device offsets (binary search) and runs
//   one scaled tile product per expert that overlaps the tile
//   (fp8_tile.cuh), loading only that expert's rows (others zero-filled)
//   and storing only them. Group sizes need no alignment and never reach
//   the host; the TPU kernel's 256-row padding and visit table are not
//   needed, and any 128-multiple K works (the TPU kernel asserts
//   K % 512 == 0 above 512).
// - #13: one CTA per (128-row K tile, 128-col N tile, expert) walks the
//   128-row tiles that overlap the expert's rows [rs, re). Each tile is
//   one scale step: a fresh fragment, scaled by sx[r] sy[r], added into
//   the accumulator. Row chunks wholly inside [rs, re) move by cp.async;
//   a 16-row chunk that straddles rs or re is read, masked byte by byte
//   and stored by the thread; chunks outside are zero-filled. Every
//   expert's dW is written, zeros where it has no rows.

#include "fp8_tile.cuh"

namespace {

using namespace xt_fp8;

// first expert whose row range ends past row m (offs has E + 1 entries)
__device__ __forceinline__ int first_expert(const int* offs, int E, int m) {
  int lo = 0, hi = E;  // answer in [0, E]
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (offs[mid + 1] > m) hi = mid; else lo = mid + 1;
  }
  return lo;
}

template <int TA, int TB, typename OutT>
__global__ void __launch_bounds__(NTHREADS)
fp8_grouped_kernel(const uint8_t* __restrict__ x, const float* __restrict__ sx,
                   const uint8_t* __restrict__ wt, const float* __restrict__ sw,
                   const int* __restrict__ offs, OutT* __restrict__ out, int M, int K, int N,
                   int E) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int n0 = blockIdx.x * TILE;
  const int m0 = blockIdx.y * TILE;
  const int mend = min(m0 + TILE, M);
  const int KT = K / TILE, NT = N / TILE;
  for (int e = first_expert(offs, E, m0); e < E && offs[e] < mend; ++e) {
    const int rs = max(offs[e], m0);
    const int re = min(offs[e + 1], mend);
    if (rs >= re) continue;  // empty expert
    scaled_tile<TA, TB, OutT>(x, sx, wt + (int64_t)e * N * K,
                              sw + (int64_t)e * KT * NT + blockIdx.x, NT, out, K, N, m0, n0,
                              rs, re, smem);
    __syncthreads();  // the ring is reused by the next expert's tile
  }
  // rows past the last group (none when the sizes sum to M) get zeros
  const int tail = max(min(offs[E], mend), m0);
  for (int i = threadIdx.x; i < (mend - tail) * (TILE / 2); i += NTHREADS) {
    const int row = tail + i / (TILE / 2);
    const int col = n0 + (i % (TILE / 2)) * 2;
    store2<OutT>(out + (int64_t)row * N + col, 0.f, 0.f);
  }
}

// Load a 128-row x 128-byte tile of a (Mp/128, rows, 128) operand: rows
// row0.. of M tile col0 / 128, bytes (= M positions) col0..col0+127,
// keeping only M positions in [lo, hi).
__device__ __forceinline__ void load_cols(uint8_t* s, const uint8_t* g, int rows, int row0,
                                          int col0, int lo, int hi) {
#pragma unroll
  for (int t = 0; t < TILE * 8 / NTHREADS; ++t) {
    const int idx = threadIdx.x + t * NTHREADS;
    const int row = idx >> 3, ch = idx & 7;
    const int c0 = col0 + ch * 16;
    const uint8_t* src = g + ((int64_t)(col0 / TILE) * rows + row0 + row) * TILE + ch * 16;
    if (c0 >= lo && c0 + 16 <= hi) {
      cp_async16(s + swz(row, ch), src, true);
    } else if (c0 + 16 <= lo || c0 >= hi) {
      cp_async16(s + swz(row, ch), g, false);
    } else {  // straddles an expert boundary: mask byte by byte
      uint4 v = *reinterpret_cast<const uint4*>(src);
      uint8_t* b = reinterpret_cast<uint8_t*>(&v);
#pragma unroll
      for (int j = 0; j < 16; ++j)
        if (c0 + j < lo || c0 + j >= hi) b[j] = 0;
      *reinterpret_cast<uint4*>(s + swz(row, ch)) = v;
    }
  }
}

template <int TX, int TY>
__global__ void __launch_bounds__(NTHREADS)
fp8_dw_kernel(const uint8_t* __restrict__ xt, const float* __restrict__ sx,
              const uint8_t* __restrict__ yt, const float* __restrict__ sy,
              const int* __restrict__ offs, float* __restrict__ dw, int K, int N) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int n0 = blockIdx.x * TILE;
  const int k0 = blockIdx.y * TILE;
  const int e = blockIdx.z;
  const int rs = offs[e], re = offs[e + 1];
  uint8_t* sA = smem;
  uint8_t* sB = smem + 2 * TILE_BYTES;
  Frag acc, part;
  zero(acc);

  if (rs < re) {
    const int r_lo = rs / TILE, r_hi = (re - 1) / TILE;
    load_cols(sA, xt, K, k0, r_lo * TILE, rs, re);
    load_cols(sB, yt, N, n0, r_lo * TILE, rs, re);
    cp_async_commit();
    for (int r = r_lo; r <= r_hi; ++r) {
      const int st = (r - r_lo) & 1;
      if (r < r_hi) {
        load_cols(sA + (st ^ 1) * TILE_BYTES, xt, K, k0, (r + 1) * TILE, rs, re);
        load_cols(sB + (st ^ 1) * TILE_BYTES, yt, N, n0, (r + 1) * TILE, rs, re);
        cp_async_commit();
      }
      const float scale = __ldg(sx + r) * __ldg(sy + r);
      if (r < r_hi) cp_async_wait<1>(); else cp_async_wait<0>();
      __syncthreads();
      mma_step<TX, TY>(part, sA + st * TILE_BYTES, sB + st * TILE_BYTES);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc.v[i][j][c] += part.v[i][j][c] * scale;
      __syncthreads();
    }
  }

  float* dwe = dw + (int64_t)e * K * N;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kr = k0 + frag_row(i, 2 * h);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        store2<float>(dwe + (int64_t)kr * N + n0 + frag_col(j, 0), acc.v[i][j][2 * h],
                      acc.v[i][j][2 * h + 1]);
    }
}

template <int TA, int TB, typename OutT>
int launch_gg(const void* x, const void* sx, const void* wt, const void* sw, const void* offs,
              void* out, int M, int K, int N, int E, cudaStream_t stream) {
  auto kern = fp8_grouped_kernel<TA, TB, OutT>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(N / TILE, (M + TILE - 1) / TILE);
  kern<<<grid, NTHREADS, SMEM_BYTES, stream>>>(
      static_cast<const uint8_t*>(x), static_cast<const float*>(sx),
      static_cast<const uint8_t*>(wt), static_cast<const float*>(sw),
      static_cast<const int*>(offs), static_cast<OutT*>(out), M, K, N, E);
  return (int)cudaGetLastError();
}

template <typename OutT>
int dispatch_gg(const void* x, const void* sx, const void* wt, const void* sw,
                const void* offs, void* out, int M, int K, int N, int E, int ta, int tb,
                cudaStream_t s) {
  if (tb != E4M3) return (int)cudaErrorInvalidValue;  // weights are always e4m3
  if (ta == E4M3) return launch_gg<E4M3, E4M3, OutT>(x, sx, wt, sw, offs, out, M, K, N, E, s);
  return launch_gg<E5M2, E4M3, OutT>(x, sx, wt, sw, offs, out, M, K, N, E, s);
}

template <int TX, int TY>
int launch_dw(const void* xt, const void* sx, const void* yt, const void* sy, const void* offs,
              void* dw, int K, int N, int E, cudaStream_t stream) {
  auto kern = fp8_dw_kernel<TX, TY>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(N / TILE, K / TILE, E);
  kern<<<grid, NTHREADS, SMEM_BYTES, stream>>>(
      static_cast<const uint8_t*>(xt), static_cast<const float*>(sx),
      static_cast<const uint8_t*>(yt), static_cast<const float*>(sy),
      static_cast<const int*>(offs), static_cast<float*>(dw), K, N);
  return (int)cudaGetLastError();
}

}  // namespace

// xq (M, K), sx (M, K/128) f32, wt (E, N, K) = W^T per expert, sw (E, K/128,
// N/128) f32, offs (E + 1) int32 -> out (M, N); a_type / b_type 0 = e4m3,
// 1 = e5m2 (b must be e4m3); out_f32 0 = bf16, 1 = f32
extern "C" int xt_fp8_grouped_gemm(const void* xq, const void* sx, const void* wt,
                                   const void* sw, const void* offs, void* out, int M, int K,
                                   int N, int E, int a_type, int b_type, int out_f32,
                                   void* stream) {
  if (M < 0 || E <= 0 || K <= 0 || N <= 0 || K % TILE || N % TILE)
    return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return out_f32
             ? dispatch_gg<float>(xq, sx, wt, sw, offs, out, M, K, N, E, a_type, b_type, s)
             : dispatch_gg<__nv_bfloat16>(xq, sx, wt, sw, offs, out, M, K, N, E, a_type,
                                          b_type, s);
}

// xt (Mp/128, K, 128), sx (Mp/128) f32, yt (Mp/128, N, 128), sy (Mp/128) f32, offs (E + 1)
// int32 -> dw (E, K, N) f32; x_type must be e4m3, y_type 0 = e4m3, 1 = e5m2
extern "C" int xt_fp8_grouped_dw(const void* xt, const void* sx, const void* yt,
                                 const void* sy, const void* offs, void* dw, int Mp, int K,
                                 int N, int E, int x_type, int y_type, void* stream) {
  if (Mp < 0 || E <= 0 || K <= 0 || N <= 0 || Mp % TILE || K % TILE || N % TILE ||
      x_type != E4M3)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (y_type == E4M3) return launch_dw<E4M3, E4M3>(xt, sx, yt, sy, offs, dw, K, N, E, s);
  return launch_dw<E4M3, E5M2>(xt, sx, yt, sy, offs, dw, K, N, E, s);
}
