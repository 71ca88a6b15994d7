// Causal GQA flash-attention backward over packed rows, for Hopper (sm_90a).
//
// Replaces three TPU kernels of xtuner_tpu/ops/attention/flash.py:
// - _dq_kernel (pallas_call in _flash_bwd_rule): dq from q, k, v, do, lse
//   and delta = rowsum(do * out);
// - _dkv_grouped_kernel (pallas_call in _grouped_dkv): dk and dv of one kv
//   head, summed over its whole q-head group;
// - _dkv_kernel (the two-pass pallas_call in _flash_bwd_rule,
//   XTUNER_ATTN_BWD=two_pass): dk_h and dv_h of one q head, (B, L, Hq, D);
//   the wrapper sums each group afterwards, as JAX does outside its kernel.
// Layouts as the forward (csrc/flash_fwd.cu): q, do, dq (B, L, Hq, D);
// k, v, dk, dv (B, L, Hkv, D), all bf16; lse, delta (B, Hq, L) f32;
// segment_ids (B, L) int32, 0 = padding. Key m is visible to query l iff
// seg[l] == seg[m] != 0 and m <= l. For every visible pair:
//   p  = exp2(s * scale * log2e - lse * log2e)     (s = q.k)
//   dp = do . v;  ds = p * (dp - delta)
//   dq += ds k;   dk += ds q;   dv += p do;   dq, dk scaled by `scale` at the end.
// Padding rows have lse = 1e30 and are masked, so p = 0 for them.
//
// What bounds it on the H100: 2.5x the forward's FLOPs (five L^2-sized
// products instead of two) with the same WMMA tiles, so issue and
// shared-memory traffic bound it as they bound the forward; HBM traffic is
// small (each q/do tile is re-read once per k tile and vice versa).
//
// Design (simple and right first; wgmma/TMA later):
// - dq: one CTA of 4 warps per (64-row q tile, q head, batch row), kv head
//   h / (Hq / Hkv). It walks the k tiles up to the causal limit, skipping
//   tiles whose segment range cannot meet the q tile's; each warp owns 16 q
//   rows and keeps its 16 x 128 dq in WMMA accumulators (registers).
// - dk/dv: one CTA per (64-row k tile, kv head, batch row). A loop inside
//   the CTA replaces the TPU's sequential grid axes (g, i): it walks the
//   `ratio` q heads of the group and, for each, the q tiles from the
//   causal start to the end. dk and dv accumulate in registers (each warp
//   owns 16 key rows) and are written once: no atomics and no
//   (B, Hq, L, D) temporaries.
// - two-pass dk/dv: the same kernel body (a template flag) with the group
//   loop lifted into the grid: one CTA per (64-row k tile, q head, batch
//   row) walks that head's q tiles and writes its own dk_h, dv_h. It does
//   the grouped kernel's arithmetic on `ratio` times as many CTAs; what it
//   adds is traffic: k and v are read once per q head, and 2 (B, L, Hq, D)
//   bf16 partials are written (and read back by the group sum). The TPU
//   kernel's index-map clamps (jnp.maximum(i, j)) only kept its DMA in
//   range on skipped grid steps; here the loop starts at the causal tile.
// - The causal work is uneven (k tile 0 sees every q tile, the last k tile
//   one; q tile i sees i + 1 k tiles). The 1-D grid puts the longest CTAs
//   first, so the short ones fill in behind them.
// - head_dim 128 only (the wrapper raises on any other).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int D = 128;
constexpr int BT = 64;  // q tile rows == k tile rows
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
// padded leading dimensions (elements); every 16-row fragment start stays
// 32-byte aligned, as WMMA loads require
constexpr int LDH = D + 8;   // bf16 q/k/v/do tiles
constexpr int LDS = BT + 4;  // f32 score tiles
constexpr int LDP = BT + 8;  // bf16 p / ds tiles
constexpr int LDO = D + 4;   // f32 staging of the outputs
constexpr float LOG2E = 1.4426950408889634f;

constexpr size_t H_TILE = sizeof(__nv_bfloat16) * BT * LDH;
constexpr size_t S_TILE = sizeof(float) * BT * LDS;
constexpr size_t P_TILE = sizeof(__nv_bfloat16) * BT * LDP;
static_assert(2 * S_TILE >= sizeof(float) * BT * LDO, "staging fits the score tiles");

// shared layout, both kernels: four bf16 tiles, two f32 score tiles (also
// the output staging at the end), two bf16 p/ds tiles, per-row vectors
constexpr size_t OFF_T0 = 0;
constexpr size_t OFF_T1 = OFF_T0 + H_TILE;
constexpr size_t OFF_T2 = OFF_T1 + H_TILE;
constexpr size_t OFF_T3 = OFF_T2 + H_TILE;
constexpr size_t OFF_S = OFF_T3 + H_TILE;
constexpr size_t OFF_DP = OFF_S + S_TILE;
constexpr size_t OFF_P = OFF_DP + S_TILE;
constexpr size_t OFF_DS = OFF_P + P_TILE;
constexpr size_t OFF_LSE = OFF_DS + P_TILE;
constexpr size_t OFF_DELTA = OFF_LSE + sizeof(float) * BT;
constexpr size_t OFF_SEGA = OFF_DELTA + sizeof(float) * BT;
constexpr size_t OFF_SEGB = OFF_SEGA + sizeof(int) * BT;
constexpr size_t OFF_FLAG = OFF_SEGB + sizeof(int) * BT;
constexpr size_t SMEM_BYTES = OFF_FLAG + 16;

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragBc = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major>;
using FragBr = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// rows [row0, row0 + 64) of one head of a (B, L, H, D) tensor -> smem tile;
// rows past L are zero
__device__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src, int b,
                          int row0, int h, int L, int H) {
  constexpr int VEC = 8;            // bf16 per 16-byte load
  constexpr int PER_ROW = D / VEC;  // 16
  for (int i = threadIdx.x; i < BT * PER_ROW; i += NTHREADS) {
    int r = i / PER_ROW, c = (i % PER_ROW) * VEC;
    int row = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < L) {
      const __nv_bfloat16* p = src + (((int64_t)b * L + row) * H + h) * D + c;
      val = *reinterpret_cast<const uint4*>(p);
    }
    *reinterpret_cast<uint4*>(dst + r * LDH + c) = val;
  }
}

// (warp's 16 rows of A) x (64 rows of B)^T -> f32 tile rows of this warp:
// out[r][c] = sum_d A[r][d] * B[c][d], A and B row-major (rows, D) tiles
__device__ __forceinline__ void rows_times_rows_t(float* out, const __nv_bfloat16* A,
                                                  const __nv_bfloat16* B, int warp) {
  FragA fa;
  FragBc fb;
  FragC fc;
#pragma unroll
  for (int n = 0; n < BT / 16; ++n) {
    wmma::fill_fragment(fc, 0.f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wmma::load_matrix_sync(fa, A + (warp * 16) * LDH + kk * 16, LDH);
      // B^T as a col-major operand: element (d, c) sits at B[c * LDH + d]
      wmma::load_matrix_sync(fb, B + (n * 16) * LDH + kk * 16, LDH);
      wmma::mma_sync(fc, fa, fb, fc);
    }
    wmma::store_matrix_sync(out + (warp * 16) * LDS + n * 16, fc, LDS,
                            wmma::mem_row_major);
  }
}

// acc[n] += (warp's 16 rows of the bf16 64-wide tile P) x (64 x 128 tile B)
__device__ __forceinline__ void accumulate_pv(FragC (&acc)[D / 16],
                                              const __nv_bfloat16* P,
                                              const __nv_bfloat16* B, int warp) {
  FragA fa;
  FragBr fb;
#pragma unroll
  for (int kk = 0; kk < BT / 16; ++kk) {
    wmma::load_matrix_sync(fa, P + (warp * 16) * LDP + kk * 16, LDP);
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      wmma::load_matrix_sync(fb, B + (kk * 16) * LDH + n * 16, LDH);
      wmma::mma_sync(acc[n], fa, fb, acc[n]);
    }
  }
}

// write this warp's accumulators, times `mul`, to rows [row0, row0 + 64)
// of head h of a (B, L, H, D) bf16 tensor through the f32 staging tile
__device__ __forceinline__ void store_rows(FragC (&acc)[D / 16], float* stage,
                                           __nv_bfloat16* dst, int b, int row0,
                                           int h, int L, int H, float mul,
                                           int warp, int lane) {
#pragma unroll
  for (int n = 0; n < D / 16; ++n)
    wmma::store_matrix_sync(stage + (warp * 16) * LDO + n * 16, acc[n], LDO,
                            wmma::mem_row_major);
  __syncwarp();
  const int r = warp * 16 + lane / 2;
  const int half = lane % 2;
  const int row = row0 + r;
  if (row < L) {
    const float* src = stage + r * LDO + half * 64;
    __nv_bfloat16* out = dst + (((int64_t)b * L + row) * H + h) * D + half * 64;
    for (int c = 0; c < 64; c += 2)
      *reinterpret_cast<__nv_bfloat162*>(out + c) =
          __floats2bfloat162_rn(src[c] * mul, src[c + 1] * mul);
  }
  __syncwarp();
}

__device__ __forceinline__ void seg_range(const int* s, int& lo, int& hi) {
  lo = 0x7fffffff;
  hi = 0;
  for (int i = 0; i < BT; ++i) {
    int v = s[i];
    if (v != 0) { lo = min(lo, v); hi = max(hi, v); }
  }
}

__global__ void __launch_bounds__(NTHREADS)
flash_dq_kernel(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                const __nv_bfloat16* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                const int* __restrict__ seg, __nv_bfloat16* __restrict__ dq,
                int B, int L, int Hq, int Hkv, float scale_log2e, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem + OFF_T0);
  __nv_bfloat16* sDO = reinterpret_cast<__nv_bfloat16*>(smem + OFF_T1);
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem + OFF_T2);
  __nv_bfloat16* sV = reinterpret_cast<__nv_bfloat16*>(smem + OFF_T3);
  float* sS = reinterpret_cast<float*>(smem + OFF_S);
  float* sDP = reinterpret_cast<float*>(smem + OFF_DP);
  __nv_bfloat16* sDS = reinterpret_cast<__nv_bfloat16*>(smem + OFF_DS);
  float* sLse = reinterpret_cast<float*>(smem + OFF_LSE);
  float* sDelta = reinterpret_cast<float*>(smem + OFF_DELTA);
  int* sSegQ = reinterpret_cast<int*>(smem + OFF_SEGA);
  int* sSegK = reinterpret_cast<int*>(smem + OFF_SEGB);
  int* sFlag = reinterpret_cast<int*>(smem + OFF_FLAG);

  // longest first: the last q tiles see the most k tiles
  const int nq = (L + BT - 1) / BT;
  const int per_tile = Hq * B;
  const int qt = nq - 1 - (int)(blockIdx.x / per_tile);
  const int h = (int)(blockIdx.x % per_tile) % Hq;
  const int b = (int)(blockIdx.x % per_tile) / Hq;
  const int g = h / (Hq / Hkv);
  const int q0 = qt * BT;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  load_tile(sQ, q, b, q0, h, L, Hq);
  load_tile(sDO, dout, b, q0, h, L, Hq);
  for (int i = threadIdx.x; i < BT; i += NTHREADS) {
    const int row = q0 + i;
    const bool in = row < L;
    sSegQ[i] = in ? seg[(int64_t)b * L + row] : 0;
    sLse[i] = in ? lse[((int64_t)b * Hq + h) * L + row] : 0.f;
    sDelta[i] = in ? delta[((int64_t)b * Hq + h) * L + row] : 0.f;
  }
  __syncthreads();
  int qmin, qmax;
  seg_range(sSegQ, qmin, qmax);

  const int r = warp * 16 + lane / 2;  // the row this lane pair works on
  const int half = lane % 2;
  const int qpos = q0 + r;
  const int qseg = sSegQ[r];
  const float lse2 = sLse[r] * LOG2E;
  const float dl = sDelta[r];

  FragC acc[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) wmma::fill_fragment(acc[n], 0.f);

  const int last = min(q0 + BT - 1, L - 1);
  const int n_kt = (qmax == 0) ? 0 : last / BT + 1;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BT;
    __syncthreads();  // every warp is done with the previous K/V tile
    for (int i = threadIdx.x; i < BT; i += NTHREADS)
      sSegK[i] = (k0 + i < L) ? seg[(int64_t)b * L + k0 + i] : 0;
    __syncthreads();
    if (threadIdx.x == 0) {
      int kmin, kmax;
      seg_range(sSegK, kmin, kmax);
      *sFlag = (kmax != 0) && (kmax >= qmin) && (kmin <= qmax);
    }
    __syncthreads();
    if (!*sFlag) continue;  // uniform across the CTA
    load_tile(sK, k, b, k0, g, L, Hkv);
    load_tile(sV, v, b, k0, g, L, Hkv);
    __syncthreads();

    rows_times_rows_t(sS, sQ, sK, warp);    // s = q k^T
    rows_times_rows_t(sDP, sDO, sV, warp);  // dp = do v^T
    __syncwarp();

    {
      const float* srow = sS + r * LDS + half * 32;
      const float* dprow = sDP + r * LDS + half * 32;
      __nv_bfloat16* dsrow = sDS + r * LDP + half * 32;
      for (int c = 0; c < 32; ++c) {
        const int kpos = k0 + half * 32 + c;
        const bool ok = qseg != 0 && kpos <= qpos && sSegK[half * 32 + c] == qseg;
        const float p = ok ? exp2f(srow[c] * scale_log2e - lse2) : 0.f;
        dsrow[c] = __float2bfloat16(p * (dprow[c] - dl));
      }
    }
    __syncwarp();
    accumulate_pv(acc, sDS, sK, warp);  // dq += ds k
  }
  __syncthreads();  // the score tiles become the staging tile
  store_rows(acc, sS, dq, b, q0, h, L, Hq, scale, warp, lane);
}

// TWO_PASS = false (#3): heads = Hkv; a CTA sums dk/dv over the `ratio`
// q heads of its kv head and writes (B, L, Hkv, D).
// TWO_PASS = true (#4): heads = Hq; a CTA takes one q head and writes its
// dk_h/dv_h to (B, L, Hq, D).
template <bool TWO_PASS>
__global__ void __launch_bounds__(NTHREADS)
flash_dkv_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const __nv_bfloat16* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 const int* __restrict__ seg, __nv_bfloat16* __restrict__ dk,
                 __nv_bfloat16* __restrict__ dv, int B, int L, int Hq, int Hkv,
                 float scale_log2e, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem + OFF_T0);
  __nv_bfloat16* sV = reinterpret_cast<__nv_bfloat16*>(smem + OFF_T1);
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem + OFF_T2);
  __nv_bfloat16* sDO = reinterpret_cast<__nv_bfloat16*>(smem + OFF_T3);
  float* sS = reinterpret_cast<float*>(smem + OFF_S);
  float* sDP = reinterpret_cast<float*>(smem + OFF_DP);
  __nv_bfloat16* sP = reinterpret_cast<__nv_bfloat16*>(smem + OFF_P);
  __nv_bfloat16* sDS = reinterpret_cast<__nv_bfloat16*>(smem + OFF_DS);
  float* sLse = reinterpret_cast<float*>(smem + OFF_LSE);
  float* sDelta = reinterpret_cast<float*>(smem + OFF_DELTA);
  int* sSegK = reinterpret_cast<int*>(smem + OFF_SEGA);
  int* sSegQ = reinterpret_cast<int*>(smem + OFF_SEGB);
  int* sFlag = reinterpret_cast<int*>(smem + OFF_FLAG);

  // longest first: k tile 0 sees every q tile
  const int nq = (L + BT - 1) / BT;
  const int ratio = Hq / Hkv;
  const int heads = TWO_PASS ? Hq : Hkv;  // the output's heads
  const int per_tile = heads * B;
  const int kt = (int)(blockIdx.x / per_tile);
  const int ho = (int)(blockIdx.x % per_tile) % heads;  // the output head
  const int b = (int)(blockIdx.x % per_tile) / heads;
  const int g = TWO_PASS ? ho / ratio : ho;  // the kv head
  const int h_first = TWO_PASS ? ho : g * ratio;
  const int n_heads = TWO_PASS ? 1 : ratio;  // q heads this CTA walks
  const int k0 = kt * BT;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  load_tile(sK, k, b, k0, g, L, Hkv);
  load_tile(sV, v, b, k0, g, L, Hkv);
  for (int i = threadIdx.x; i < BT; i += NTHREADS)
    sSegK[i] = (k0 + i < L) ? seg[(int64_t)b * L + k0 + i] : 0;
  __syncthreads();
  int kmin, kmax;
  seg_range(sSegK, kmin, kmax);

  const int r = warp * 16 + lane / 2;  // the key row this lane pair works on
  const int half = lane % 2;
  const int kpos = k0 + r;
  const int kseg = sSegK[r];

  FragC acc_dk[D / 16], acc_dv[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    wmma::fill_fragment(acc_dk[n], 0.f);
    wmma::fill_fragment(acc_dv[n], 0.f);
  }

  const int n_qt = (kmax == 0) ? 0 : nq;  // a padding-only k tile gets zeros
  for (int gi = 0; gi < n_heads; ++gi) {
    const int h = h_first + gi;
    for (int qt = kt; qt < n_qt; ++qt) {  // causal: q tiles from the k tile on
      const int q0 = qt * BT;
      __syncthreads();  // every warp is done with the previous q tile
      for (int i = threadIdx.x; i < BT; i += NTHREADS) {
        const int row = q0 + i;
        const bool in = row < L;
        sSegQ[i] = in ? seg[(int64_t)b * L + row] : 0;
        sLse[i] = in ? lse[((int64_t)b * Hq + h) * L + row] : 0.f;
        sDelta[i] = in ? delta[((int64_t)b * Hq + h) * L + row] : 0.f;
      }
      __syncthreads();
      if (threadIdx.x == 0) {
        int qmin, qmax;
        seg_range(sSegQ, qmin, qmax);
        *sFlag = (qmax != 0) && (qmax >= kmin) && (qmin <= kmax);
      }
      __syncthreads();
      if (!*sFlag) continue;  // uniform across the CTA
      load_tile(sQ, q, b, q0, h, L, Hq);
      load_tile(sDO, dout, b, q0, h, L, Hq);
      __syncthreads();

      rows_times_rows_t(sS, sK, sQ, warp);    // s^T = k q^T
      rows_times_rows_t(sDP, sV, sDO, warp);  // dp^T = v do^T
      __syncwarp();

      {
        const float* srow = sS + r * LDS + half * 32;
        const float* dprow = sDP + r * LDS + half * 32;
        __nv_bfloat16* prow = sP + r * LDP + half * 32;
        __nv_bfloat16* dsrow = sDS + r * LDP + half * 32;
        for (int c = 0; c < 32; ++c) {
          const int qi = half * 32 + c;
          const bool ok = kseg != 0 && sSegQ[qi] == kseg && kpos <= q0 + qi;
          const float p = ok ? exp2f(srow[c] * scale_log2e - sLse[qi] * LOG2E) : 0.f;
          prow[c] = __float2bfloat16(p);
          dsrow[c] = __float2bfloat16(p * (dprow[c] - sDelta[qi]));
        }
      }
      __syncwarp();
      accumulate_pv(acc_dv, sP, sDO, warp);  // dv += p^T do
      accumulate_pv(acc_dk, sDS, sQ, warp);  // dk += ds^T q
    }
  }
  __syncthreads();  // the score tiles become the staging tile
  store_rows(acc_dk, sS, dk, b, k0, ho, L, heads, scale, warp, lane);
  store_rows(acc_dv, sS, dv, b, k0, ho, L, heads, 1.f, warp, lane);
}

int check_args(int B, int L, int Hq, int Hkv, int d) {
  if (d != D || Hkv <= 0 || Hq % Hkv != 0 || L <= 0 || B <= 0)
    return (int)cudaErrorInvalidValue;
  return 0;
}

template <bool TWO_PASS>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, const void* seg, void* dk, void* dv,
               int B, int L, int Hq, int Hkv, int d, float scale, void* stream) {
  if (int e = check_args(B, L, Hq, Hkv, d)) return e;
  cudaError_t e = cudaFuncSetAttribute(flash_dkv_kernel<TWO_PASS>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  const unsigned grid = (unsigned)((L + BT - 1) / BT) * (TWO_PASS ? Hq : Hkv) * B;
  flash_dkv_kernel<TWO_PASS><<<grid, NTHREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(seg), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), B, L, Hq, Hkv, scale * LOG2E, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int xt_flash_dq_bf16(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, const void* seg, void* dq,
                                int B, int L, int Hq, int Hkv, int d,
                                float scale, void* stream) {
  if (int e = check_args(B, L, Hq, Hkv, d)) return e;
  cudaError_t e = cudaFuncSetAttribute(
      flash_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  const unsigned grid = (unsigned)((L + BT - 1) / BT) * Hq * B;
  flash_dq_kernel<<<grid, NTHREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(seg), static_cast<__nv_bfloat16*>(dq), B, L, Hq,
      Hkv, scale * LOG2E, scale);
  return (int)cudaGetLastError();
}

// dk, dv (B, L, Hkv, D), each summed over its kv head's q-head group (#3)
extern "C" int xt_flash_dkv_bf16(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, const void* seg, void* dk,
                                 void* dv, int B, int L, int Hq, int Hkv, int d,
                                 float scale, void* stream) {
  return launch_dkv<false>(q, k, v, dout, lse, delta, seg, dk, dv, B, L, Hq, Hkv, d,
                           scale, stream);
}

// dk_h, dv_h (B, L, Hq, D) of each q head, not summed (#4)
extern "C" int xt_flash_dkv_two_pass_bf16(const void* q, const void* k, const void* v,
                                          const void* dout, const void* lse,
                                          const void* delta, const void* seg, void* dk,
                                          void* dv, int B, int L, int Hq, int Hkv,
                                          int d, float scale, void* stream) {
  return launch_dkv<true>(q, k, v, dout, lse, delta, seg, dk, dv, B, L, Hq, Hkv, d,
                          scale, stream);
}
