// Block-sparse flash attention over selected key blocks (DSA), forward and
// backward, for Hopper (sm_90a).
//
// Replaces two TPU kernels of xtuner_tpu/ops/attention/block_sparse.py:
// - _fwd_kernel (#14, pallas_call in _bs_fwd): out, lse and the per-slot
//   attention mass of each q row over the S key blocks its q-block chose;
// - _bwd_kernel (#15, pallas_call in _bs_bwd): dq, and dk/dv summed over
//   the q-head group.
// Layouts: q (B, L, Hq, D), k (B, L, Hkv, D), v (B, L, Hkv, DV), out and
// do (B, L, Hq, DV), all bf16; lse, delta (B, Hq, L) f32; mass
// (B, L, Hq, S) f32; block_idx (B, L / block, S) int32, ascending, -1 = an
// empty slot; segment_ids (B, L) int32, 0 = padding. Key m is visible to
// query l iff block m / block is in l's q-block's selection, seg[l] ==
// seg[m] != 0 and m <= l. Per visible pair, with s = q.k:
//   p = exp2(s * scale * log2e - lse * log2e); dp = do.v; ds = p (dp - delta)
//   out = sum p v;  dq = scale sum ds k;  dk = scale sum ds q;  dv = sum p do.
// A row that sees no key gets out 0, lse 1e30 and mass 0; mass[l, s] is
// the share of slot s's keys in row l's softmax (JAX's
// exp2(slot_lse - lse log2e)).
//
// What bounds it on the H100: the tensor-core work on the visible pairs
// (4 (D + DV) / 2 FLOPs per pair forward, about 2.5x that backward); HBM
// traffic is a few reads of q, k, v per selected block. The WMMA tiles and
// one CTA per SM (about 190 KB of shared memory at D = DV = 256) keep it
// far from that bound: simple and right first, wgmma/TMA later.
//
// Design. The TPU block of `block` keys is a selection granularity, not a
// tile: the kernels walk 64-row q tiles and 64-key tiles inside each
// selected block (block must be a multiple of 64), with 8 warps per CTA.
// - forward: one CTA per (q tile, q head, batch row) loops over its
//   q-block's slots and their key tiles up to the causal limit, skipping
//   tiles whose segment range cannot meet the q tile's. Online softmax in
//   base 2 and f32; O is an f32 tile in shared memory, rescaled there (the
//   WMMA accumulator layout is opaque). Each slot's exp-sum is kept in the
//   running-max frame of its last tile and written out as a base-2 log; the
//   end of the CTA turns it into the mass with the final lse.
// - backward, three launches: an inverse of block_idx (per row and key
//   block, the q-blocks that chose it, in ascending order); dq, one CTA per
//   (q tile, q head) over its slots, dq in registers (each warp 16 rows x
//   half of D); dk/dv, one CTA per (key tile, kv head) over the q heads of
//   its group and the q-blocks that chose its block, dk and dv in
//   registers, written once. No atomics, no per-slot partials (the TPU
//   kernel's (q-block, slot) partial blocks exist only for its
//   aliased-input hazard): deterministic.
// - (D, DV) in {(256, 256), (192, 128), (128, 128)}, templates; the
//   wrapper raises on any other.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int TILE = 64;  // q rows and keys per step
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int LDS = TILE + 4;  // f32 score tiles
constexpr int LDP = TILE + 8;  // bf16 p / ds tiles
constexpr float NEG_INF = -1e30f;
constexpr float BIG_LSE = 1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragBc = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major>;
using FragBr = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

constexpr size_t al(size_t x) { return (x + 127) & ~size_t(127); }
// bf16 tile of TILE rows with X columns, padded (every 16-row fragment
// start stays 32-byte aligned, as WMMA loads require)
__host__ __device__ constexpr int ldh(int x) { return x + 8; }
constexpr size_t h_bytes(int x) { return al(sizeof(__nv_bfloat16) * TILE * ldh(x)); }
constexpr size_t S_BYTES = al(sizeof(float) * TILE * LDS);
constexpr size_t P_BYTES = al(sizeof(__nv_bfloat16) * TILE * LDP);
constexpr size_t ROW_BYTES = al(sizeof(float) * TILE);
constexpr size_t stage_bytes(int x) { return al(sizeof(float) * TILE * (x + 4)); }

// rows [row0, row0 + 64) of head h of a (B, L, H, X) bf16 tensor -> smem
template <int X>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          int b, int row0, int h, int L, int H) {
  constexpr int PER_ROW = X / 8;  // 16-byte loads per row
  for (int i = threadIdx.x; i < TILE * PER_ROW; i += NTHREADS) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * 8;
    const __nv_bfloat16* p = src + (((int64_t)b * L + row0 + r) * H + h) * X + c;
    *reinterpret_cast<uint4*>(dst + r * ldh(X) + c) = *reinterpret_cast<const uint4*>(p);
  }
}

// out (TILE x TILE f32, ld LDS) = A (TILE x KD) B^T (B: TILE x KD), both
// row-major bf16 tiles; the 16 output fragments are split over the warps
template <int KD>
__device__ __forceinline__ void tile_nt(float* out, const __nv_bfloat16* A,
                                        const __nv_bfloat16* B, int warp) {
  FragA fa;
  FragBc fb;
  FragC fc;
  for (int f = warp; f < (TILE / 16) * (TILE / 16); f += NWARPS) {
    const int fr = f / (TILE / 16), fcol = f % (TILE / 16);
    wmma::fill_fragment(fc, 0.f);
#pragma unroll 4
    for (int kk = 0; kk < KD / 16; ++kk) {
      wmma::load_matrix_sync(fa, A + fr * 16 * ldh(KD) + kk * 16, ldh(KD));
      // B^T as a col-major operand: element (d, key) sits at B[key * ld + d]
      wmma::load_matrix_sync(fb, B + fcol * 16 * ldh(KD) + kk * 16, ldh(KD));
      wmma::mma_sync(fc, fa, fb, fc);
    }
    wmma::store_matrix_sync(out + fr * 16 * LDS + fcol * 16, fc, LDS, wmma::mem_row_major);
  }
}

// acc (TILE x N f32 in smem, ld N + 4) += P (TILE x TILE bf16, ld LDP) B
// (TILE x N bf16); the output fragments are split over the warps
template <int N>
__device__ __forceinline__ void tile_acc_smem(float* acc, const __nv_bfloat16* P,
                                              const __nv_bfloat16* B, int warp) {
  FragA fa;
  FragBr fb;
  FragC fc;
  constexpr int NF = N / 16;
  for (int f = warp; f < (TILE / 16) * NF; f += NWARPS) {
    const int fr = f / NF, fcol = f % NF;
    float* optr = acc + fr * 16 * (N + 4) + fcol * 16;
    wmma::load_matrix_sync(fc, optr, N + 4, wmma::mem_row_major);
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk) {
      wmma::load_matrix_sync(fa, P + fr * 16 * LDP + kk * 16, LDP);
      wmma::load_matrix_sync(fb, B + kk * 16 * ldh(N) + fcol * 16, ldh(N));
      wmma::mma_sync(fc, fa, fb, fc);
    }
    wmma::store_matrix_sync(optr, fc, N + 4, wmma::mem_row_major);
  }
}

// register accumulators: warp w owns rows 16 (w % 4) and columns
// (w / 4) N / 2 + [0, N / 2); acc += P (rows of this warp) B
template <int N>
__device__ __forceinline__ void tile_acc_regs(FragC (&acc)[N / 32], const __nv_bfloat16* P,
                                              const __nv_bfloat16* B, int warp) {
  const int rg = warp & 3, ch = warp >> 2;
  FragA fa;
  FragBr fb;
#pragma unroll
  for (int kk = 0; kk < TILE / 16; ++kk) {
    wmma::load_matrix_sync(fa, P + rg * 16 * LDP + kk * 16, LDP);
#pragma unroll
    for (int n = 0; n < N / 32; ++n) {
      wmma::load_matrix_sync(fb, B + kk * 16 * ldh(N) + ch * (N / 2) + n * 16, ldh(N));
      wmma::mma_sync(acc[n], fa, fb, acc[n]);
    }
  }
}

// write the register accumulators times `mul` to rows [row0, row0 + 64)
// of head h of a (B, L, H, N) bf16 tensor, through the f32 staging tile
template <int N>
__device__ __forceinline__ void store_acc(FragC (&acc)[N / 32], float* stage,
                                          __nv_bfloat16* dst, int b, int row0, int h,
                                          int L, int H, float mul, int warp) {
  const int rg = warp & 3, ch = warp >> 2;
  __syncthreads();  // the staging tile aliases tiles other warps may still read
#pragma unroll
  for (int n = 0; n < N / 32; ++n)
    wmma::store_matrix_sync(stage + rg * 16 * (N + 4) + ch * (N / 2) + n * 16, acc[n], N + 4,
                            wmma::mem_row_major);
  __syncthreads();
  for (int i = threadIdx.x; i < TILE * N / 2; i += NTHREADS) {
    const int r = i / (N / 2), c = (i % (N / 2)) * 2;
    const float* s = stage + r * (N + 4) + c;
    *reinterpret_cast<__nv_bfloat162*>(dst + (((int64_t)b * L + row0 + r) * H + h) * N + c) =
        __floats2bfloat162_rn(s[0] * mul, s[1] * mul);
  }
}

__device__ __forceinline__ void seg_range(const int* s, int& lo, int& hi) {
  lo = 0x7fffffff;
  hi = 0;
  for (int i = 0; i < TILE; ++i) {
    const int v = s[i];
    if (v != 0) { lo = min(lo, v); hi = max(hi, v); }
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---------------------------------------------------------------- forward
template <int D, int DV>
struct FwdSmem {
  static constexpr size_t Q = 0;
  static constexpr size_t K = Q + h_bytes(D);
  static constexpr size_t V = K + h_bytes(D);
  static constexpr size_t S = V + h_bytes(DV);
  static constexpr size_t P = S + S_BYTES;
  static constexpr size_t O = P + P_BYTES;
  static constexpr size_t SEGQ = O + stage_bytes(DV);
  static constexpr size_t SEGK = SEGQ + ROW_BYTES;
  static constexpr size_t ALPHA = SEGK + ROW_BYTES;
  static constexpr size_t FLAG = ALPHA + ROW_BYTES;
  static constexpr size_t BYTES = FLAG + 128;
};

template <int D, int DV>
__global__ void __launch_bounds__(NTHREADS)
bs_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v, const int* __restrict__ block_idx,
              const int* __restrict__ seg, __nv_bfloat16* __restrict__ out,
              float* __restrict__ lse, float* __restrict__ mass, int L, int Hq, int Hkv,
              int block, int S, float scale_log2e) {
  using SM = FwdSmem<D, DV>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem + SM::Q);
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem + SM::K);
  __nv_bfloat16* sV = reinterpret_cast<__nv_bfloat16*>(smem + SM::V);
  float* sS = reinterpret_cast<float*>(smem + SM::S);
  __nv_bfloat16* sP = reinterpret_cast<__nv_bfloat16*>(smem + SM::P);
  float* sO = reinterpret_cast<float*>(smem + SM::O);
  int* sSegQ = reinterpret_cast<int*>(smem + SM::SEGQ);
  int* sSegK = reinterpret_cast<int*>(smem + SM::SEGK);
  float* sAlpha = reinterpret_cast<float*>(smem + SM::ALPHA);
  int* sFlag = reinterpret_cast<int*>(smem + SM::FLAG);

  const int q0 = blockIdx.x * TILE;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (Hq / Hkv);
  const int nq = L / block;
  const int warp = threadIdx.x / 32;
  const int* sel = block_idx + ((int64_t)b * nq + q0 / block) * S;

  load_tile<D>(sQ, q, b, q0, h, L, Hq);
  for (int i = threadIdx.x; i < TILE; i += NTHREADS) sSegQ[i] = seg[(int64_t)b * L + q0 + i];
  for (int i = threadIdx.x; i < TILE * (DV + 4); i += NTHREADS) sO[i] = 0.f;
  __syncthreads();
  int qmin, qmax;
  seg_range(sSegQ, qmin, qmax);

  // four consecutive lanes own row r, 16 columns each
  const int r = threadIdx.x >> 2;
  const int c0 = (threadIdx.x & 3) * 16;
  const bool lead = (threadIdx.x & 3) == 0;
  const int qpos = q0 + r;
  const int qseg = sSegQ[r];
  float* mrow = mass + (((int64_t)b * L + qpos) * Hq + h) * S;
  float m_i = NEG_INF, l_i = 0.f;

  for (int s = 0; s < S; ++s) {
    const int j = (qmax == 0) ? -1 : sel[s];
    float slot_sum = 0.f;
    for (int k0 = j * block; j >= 0 && k0 < (j + 1) * block && k0 <= q0 + TILE - 1;
         k0 += TILE) {
      __syncthreads();  // every warp is done with the previous K/V tile
      for (int i = threadIdx.x; i < TILE; i += NTHREADS) sSegK[i] = seg[(int64_t)b * L + k0 + i];
      __syncthreads();
      if (threadIdx.x == 0) {
        int kmin, kmax;
        seg_range(sSegK, kmin, kmax);
        *sFlag = (kmax != 0) && (kmax >= qmin) && (kmin <= qmax);
      }
      __syncthreads();
      if (!*sFlag) continue;  // uniform across the CTA
      load_tile<D>(sK, k, b, k0, g, L, Hkv);
      load_tile<DV>(sV, v, b, k0, g, L, Hkv);
      __syncthreads();
      tile_nt<D>(sS, sQ, sK, warp);  // s = q k^T
      __syncthreads();
      {
        const float* srow = sS + r * LDS + c0;
        __nv_bfloat16* prow = sP + r * LDP + c0;
        float mx = NEG_INF;
#pragma unroll
        for (int c = 0; c < 16; ++c) {
          const bool ok = qseg != 0 && k0 + c0 + c <= qpos && sSegK[c0 + c] == qseg;
          if (ok) mx = fmaxf(mx, srow[c] * scale_log2e);
        }
        const float m_new = fmaxf(m_i, quad_max(mx));
        const float alpha = exp2f(m_i - m_new);
        float sum = 0.f;
#pragma unroll
        for (int c = 0; c < 16; ++c) {
          const bool ok = qseg != 0 && k0 + c0 + c <= qpos && sSegK[c0 + c] == qseg;
          const float p = ok ? exp2f(srow[c] * scale_log2e - m_new) : 0.f;
          sum += p;
          prow[c] = __float2bfloat16(p);
        }
        sum = quad_sum(sum);
        l_i = l_i * alpha + sum;
        slot_sum = slot_sum * alpha + sum;  // kept in the current running frame
        m_i = m_new;
        if (lead) sAlpha[r] = alpha;
      }
      __syncthreads();
      for (int i = threadIdx.x; i < TILE * DV; i += NTHREADS) {
        const int rr = i / DV, cc = i % DV;
        sO[rr * (DV + 4) + cc] *= sAlpha[rr];
      }
      __syncthreads();
      tile_acc_smem<DV>(sO, sP, sV, warp);  // O += p v
    }
    // the slot's base-2 log exp-sum in the frame of m_i, finished below
    if (lead) mrow[s] = slot_sum > 0.f ? m_i + log2f(slot_sum) : -INFINITY;
  }
  __syncthreads();

  const bool valid = l_i > 0.f;
  const float inv = valid ? 1.f / l_i : 0.f;
  const float lse2 = m_i + log2f(valid ? l_i : 1.f);
  {
    constexpr int PER = DV / 4;  // columns per lane
    const float* orow = sO + r * (DV + 4) + (threadIdx.x & 3) * PER;
    __nv_bfloat16* dst = out + (((int64_t)b * L + qpos) * Hq + h) * DV + (threadIdx.x & 3) * PER;
    for (int c = 0; c < PER; c += 2)
      *reinterpret_cast<__nv_bfloat162*>(dst + c) =
          __floats2bfloat162_rn(orow[c] * inv, orow[c + 1] * inv);
  }
  if (lead) {
    lse[((int64_t)b * Hq + h) * L + qpos] = valid ? lse2 * LN2 : BIG_LSE;
    for (int s = 0; s < S; ++s) mrow[s] = valid ? exp2f(mrow[s] - lse2) : 0.f;
  }
}

// ------------------------------------------------------ inverse selection
// per (row b, key block jb): count[b, jb] q-blocks chose jb, listed in
// ascending order in list[b, jb, :count]
__global__ void bs_inverse_kernel(const int* __restrict__ block_idx, int* __restrict__ count,
                                  int* __restrict__ list, int B, int nq, int nk, int S) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= B * nk) return;
  const int b = t / nk, jb = t % nk;
  int n = 0;
  for (int i = 0; i < nq; ++i) {
    const int* sel = block_idx + ((int64_t)b * nq + i) * S;
    for (int s = 0; s < S; ++s)
      if (sel[s] == jb) {
        list[(int64_t)t * nq + n++] = i;
        break;  // a q-block lists a key block once
      }
  }
  count[t] = n;
}

// ------------------------------------------------------------------- dq
template <int D, int DV>
struct DqSmem {
  static constexpr size_t Q = 0;
  static constexpr size_t DO = Q + h_bytes(D);
  static constexpr size_t K = DO + h_bytes(DV);  // K .. DS: the output staging
  static constexpr size_t V = K + h_bytes(D);
  static constexpr size_t S = V + h_bytes(DV);
  static constexpr size_t DP = S + S_BYTES;
  static constexpr size_t DS = DP + S_BYTES;
  static constexpr size_t LSE = DS + P_BYTES;
  static constexpr size_t DELTA = LSE + ROW_BYTES;
  static constexpr size_t SEGQ = DELTA + ROW_BYTES;
  static constexpr size_t SEGK = SEGQ + ROW_BYTES;
  static constexpr size_t FLAG = SEGK + ROW_BYTES;
  static constexpr size_t BYTES = FLAG + 128;
  static_assert(LSE - K >= stage_bytes(D), "dq staging fits the K..DS tiles");
};

template <int D, int DV>
__global__ void __launch_bounds__(NTHREADS)
bs_dq_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v, const int* __restrict__ block_idx,
             const int* __restrict__ seg, const __nv_bfloat16* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             __nv_bfloat16* __restrict__ dq, int L, int Hq, int Hkv, int block, int S,
             float scale_log2e, float scale) {
  using SM = DqSmem<D, DV>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem + SM::Q);
  __nv_bfloat16* sDO = reinterpret_cast<__nv_bfloat16*>(smem + SM::DO);
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem + SM::K);
  __nv_bfloat16* sV = reinterpret_cast<__nv_bfloat16*>(smem + SM::V);
  float* sS = reinterpret_cast<float*>(smem + SM::S);
  float* sDP = reinterpret_cast<float*>(smem + SM::DP);
  __nv_bfloat16* sDS = reinterpret_cast<__nv_bfloat16*>(smem + SM::DS);
  float* sLse = reinterpret_cast<float*>(smem + SM::LSE);
  float* sDelta = reinterpret_cast<float*>(smem + SM::DELTA);
  int* sSegQ = reinterpret_cast<int*>(smem + SM::SEGQ);
  int* sSegK = reinterpret_cast<int*>(smem + SM::SEGK);
  int* sFlag = reinterpret_cast<int*>(smem + SM::FLAG);

  const int q0 = blockIdx.x * TILE;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (Hq / Hkv);
  const int nq = L / block;
  const int warp = threadIdx.x / 32;
  const int* sel = block_idx + ((int64_t)b * nq + q0 / block) * S;

  load_tile<D>(sQ, q, b, q0, h, L, Hq);
  load_tile<DV>(sDO, dout, b, q0, h, L, Hq);
  for (int i = threadIdx.x; i < TILE; i += NTHREADS) {
    sSegQ[i] = seg[(int64_t)b * L + q0 + i];
    sLse[i] = lse[((int64_t)b * Hq + h) * L + q0 + i] * LOG2E;
    sDelta[i] = delta[((int64_t)b * Hq + h) * L + q0 + i];
  }
  __syncthreads();
  int qmin, qmax;
  seg_range(sSegQ, qmin, qmax);

  const int r = threadIdx.x >> 2;
  const int c0 = (threadIdx.x & 3) * 16;
  const int qpos = q0 + r;
  const int qseg = sSegQ[r];
  const float lse2 = sLse[r];
  const float dl = sDelta[r];

  FragC acc[D / 32];
#pragma unroll
  for (int n = 0; n < D / 32; ++n) wmma::fill_fragment(acc[n], 0.f);

  for (int s = 0; s < S; ++s) {
    const int j = (qmax == 0) ? -1 : sel[s];
    for (int k0 = j * block; j >= 0 && k0 < (j + 1) * block && k0 <= q0 + TILE - 1;
         k0 += TILE) {
      __syncthreads();  // every warp is done with the previous K/V tile
      for (int i = threadIdx.x; i < TILE; i += NTHREADS) sSegK[i] = seg[(int64_t)b * L + k0 + i];
      __syncthreads();
      if (threadIdx.x == 0) {
        int kmin, kmax;
        seg_range(sSegK, kmin, kmax);
        *sFlag = (kmax != 0) && (kmax >= qmin) && (kmin <= qmax);
      }
      __syncthreads();
      if (!*sFlag) continue;  // uniform across the CTA
      load_tile<D>(sK, k, b, k0, g, L, Hkv);
      load_tile<DV>(sV, v, b, k0, g, L, Hkv);
      __syncthreads();
      tile_nt<D>(sS, sQ, sK, warp);     // s = q k^T
      tile_nt<DV>(sDP, sDO, sV, warp);  // dp = do v^T
      __syncthreads();
      {
        const float* srow = sS + r * LDS + c0;
        const float* dprow = sDP + r * LDS + c0;
        __nv_bfloat16* dsrow = sDS + r * LDP + c0;
#pragma unroll
        for (int c = 0; c < 16; ++c) {
          const bool ok = qseg != 0 && k0 + c0 + c <= qpos && sSegK[c0 + c] == qseg;
          const float p = ok ? exp2f(srow[c] * scale_log2e - lse2) : 0.f;
          dsrow[c] = __float2bfloat16(p * (dprow[c] - dl));
        }
      }
      __syncthreads();
      tile_acc_regs<D>(acc, sDS, sK, warp);  // dq += ds k
    }
  }
  store_acc<D>(acc, reinterpret_cast<float*>(smem + SM::K), dq, b, q0, h, L, Hq, scale, warp);
}

// ----------------------------------------------------------------- dk/dv
template <int D, int DV>
struct DkvSmem {
  static constexpr size_t K = 0;
  static constexpr size_t V = K + h_bytes(D);
  static constexpr size_t Q = V + h_bytes(DV);  // Q .. DS: the output staging
  static constexpr size_t DO = Q + h_bytes(D);
  static constexpr size_t S = DO + h_bytes(DV);
  static constexpr size_t DP = S + S_BYTES;
  static constexpr size_t P = DP + S_BYTES;
  static constexpr size_t DS = P + P_BYTES;
  static constexpr size_t LSE = DS + P_BYTES;
  static constexpr size_t DELTA = LSE + ROW_BYTES;
  static constexpr size_t SEGK = DELTA + ROW_BYTES;
  static constexpr size_t SEGQ = SEGK + ROW_BYTES;
  static constexpr size_t FLAG = SEGQ + ROW_BYTES;
  static constexpr size_t BYTES = FLAG + 128;
  static_assert(LSE - Q >= stage_bytes(D > DV ? D : DV), "dk/dv staging fits Q..DS");
};

template <int D, int DV>
__global__ void __launch_bounds__(NTHREADS)
bs_dkv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v, const int* __restrict__ seg,
              const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
              const float* __restrict__ delta, const int* __restrict__ inv_count,
              const int* __restrict__ inv_list, __nv_bfloat16* __restrict__ dk,
              __nv_bfloat16* __restrict__ dv, int L, int Hq, int Hkv, int block,
              float scale_log2e, float scale) {
  using SM = DkvSmem<D, DV>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem + SM::K);
  __nv_bfloat16* sV = reinterpret_cast<__nv_bfloat16*>(smem + SM::V);
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem + SM::Q);
  __nv_bfloat16* sDO = reinterpret_cast<__nv_bfloat16*>(smem + SM::DO);
  float* sS = reinterpret_cast<float*>(smem + SM::S);
  float* sDP = reinterpret_cast<float*>(smem + SM::DP);
  __nv_bfloat16* sP = reinterpret_cast<__nv_bfloat16*>(smem + SM::P);
  __nv_bfloat16* sDS = reinterpret_cast<__nv_bfloat16*>(smem + SM::DS);
  float* sLse = reinterpret_cast<float*>(smem + SM::LSE);
  float* sDelta = reinterpret_cast<float*>(smem + SM::DELTA);
  int* sSegK = reinterpret_cast<int*>(smem + SM::SEGK);
  int* sSegQ = reinterpret_cast<int*>(smem + SM::SEGQ);
  int* sFlag = reinterpret_cast<int*>(smem + SM::FLAG);

  const int k0 = blockIdx.x * TILE;
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int ratio = Hq / Hkv;
  const int nq = L / block;
  const int nk = L / block;
  const int jb = k0 / block;
  const int warp = threadIdx.x / 32;
  const int n_sel = inv_count[(int64_t)b * nk + jb];
  const int* chose = inv_list + ((int64_t)b * nk + jb) * nq;

  load_tile<D>(sK, k, b, k0, g, L, Hkv);
  load_tile<DV>(sV, v, b, k0, g, L, Hkv);
  for (int i = threadIdx.x; i < TILE; i += NTHREADS) sSegK[i] = seg[(int64_t)b * L + k0 + i];
  __syncthreads();
  int kmin, kmax;
  seg_range(sSegK, kmin, kmax);

  // four consecutive lanes own key row r, 16 q columns each
  const int r = threadIdx.x >> 2;
  const int c0 = (threadIdx.x & 3) * 16;
  const int kpos = k0 + r;
  const int kseg = sSegK[r];

  FragC acc_dk[D / 32], acc_dv[DV / 32];
#pragma unroll
  for (int n = 0; n < D / 32; ++n) wmma::fill_fragment(acc_dk[n], 0.f);
#pragma unroll
  for (int n = 0; n < DV / 32; ++n) wmma::fill_fragment(acc_dv[n], 0.f);

  const int n_qblk = (kmax == 0) ? 0 : n_sel;  // a padding-only key tile gets zeros
  for (int gi = 0; gi < ratio; ++gi) {
    const int h = g * ratio + gi;
    for (int c = 0; c < n_qblk; ++c) {
      const int i = chose[c];
      for (int q0 = i * block; q0 < (i + 1) * block; q0 += TILE) {
        if (q0 + TILE - 1 < k0) continue;  // every query before every key
        __syncthreads();  // every warp is done with the previous q tile
        for (int t = threadIdx.x; t < TILE; t += NTHREADS) {
          sSegQ[t] = seg[(int64_t)b * L + q0 + t];
          sLse[t] = lse[((int64_t)b * Hq + h) * L + q0 + t] * LOG2E;
          sDelta[t] = delta[((int64_t)b * Hq + h) * L + q0 + t];
        }
        __syncthreads();
        if (threadIdx.x == 0) {
          int qmin, qmax;
          seg_range(sSegQ, qmin, qmax);
          *sFlag = (qmax != 0) && (qmax >= kmin) && (qmin <= kmax);
        }
        __syncthreads();
        if (!*sFlag) continue;  // uniform across the CTA
        load_tile<D>(sQ, q, b, q0, h, L, Hq);
        load_tile<DV>(sDO, dout, b, q0, h, L, Hq);
        __syncthreads();
        tile_nt<D>(sS, sK, sQ, warp);     // s^T = k q^T
        tile_nt<DV>(sDP, sV, sDO, warp);  // dp^T = v do^T
        __syncthreads();
        {
          const float* srow = sS + r * LDS + c0;
          const float* dprow = sDP + r * LDS + c0;
          __nv_bfloat16* prow = sP + r * LDP + c0;
          __nv_bfloat16* dsrow = sDS + r * LDP + c0;
#pragma unroll
          for (int cc = 0; cc < 16; ++cc) {
            const int qi = c0 + cc;
            const bool ok = kseg != 0 && sSegQ[qi] == kseg && kpos <= q0 + qi;
            const float p = ok ? exp2f(srow[cc] * scale_log2e - sLse[qi]) : 0.f;
            prow[cc] = __float2bfloat16(p);
            dsrow[cc] = __float2bfloat16(p * (dprow[cc] - sDelta[qi]));
          }
        }
        __syncthreads();
        tile_acc_regs<DV>(acc_dv, sP, sDO, warp);  // dv += p^T do
        tile_acc_regs<D>(acc_dk, sDS, sQ, warp);   // dk += ds^T q
      }
    }
  }
  float* stage = reinterpret_cast<float*>(smem + SM::Q);
  store_acc<D>(acc_dk, stage, dk, b, k0, g, L, Hkv, scale, warp);
  store_acc<DV>(acc_dv, stage, dv, b, k0, g, L, Hkv, 1.f, warp);
}

int check_args(int B, int L, int Hq, int Hkv, int block, int S) {
  if (B <= 0 || L <= 0 || Hkv <= 0 || Hq % Hkv != 0 || S <= 0 || block <= 0 ||
      block % TILE != 0 || L % block != 0)
    return (int)cudaErrorInvalidValue;
  return 0;
}

template <typename Kernel>
cudaError_t opt_in(Kernel kernel, size_t bytes) {
  // above 48 KB, dynamic shared memory must be opted into (per device)
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int D, int DV>
int launch_fwd(const void* q, const void* k, const void* v, const void* block_idx,
               const void* seg, void* out, void* lse, void* mass, int B, int L, int Hq,
               int Hkv, int block, int S, float scale, cudaStream_t stream) {
  constexpr size_t bytes = FwdSmem<D, DV>::BYTES;
  if (cudaError_t e = opt_in(bs_fwd_kernel<D, DV>, bytes)) return (int)e;
  bs_fwd_kernel<D, DV><<<dim3(L / TILE, Hq, B), NTHREADS, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(block_idx),
      static_cast<const int*>(seg), static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse),
      static_cast<float*>(mass), L, Hq, Hkv, block, S, scale * LOG2E);
  return (int)cudaGetLastError();
}

template <int D, int DV>
int launch_bwd(const void* q, const void* k, const void* v, const void* block_idx,
               const void* seg, const void* dout, const void* lse, const void* delta,
               void* inv_count, void* inv_list, void* dq, void* dk, void* dv, int B, int L,
               int Hq, int Hkv, int block, int S, float scale, cudaStream_t stream) {
  const int nq = L / block;
  bs_inverse_kernel<<<(B * nq + 127) / 128, 128, 0, stream>>>(
      static_cast<const int*>(block_idx), static_cast<int*>(inv_count),
      static_cast<int*>(inv_list), B, nq, nq, S);
  if (cudaError_t e = cudaGetLastError()) return (int)e;
  constexpr size_t dq_bytes = DqSmem<D, DV>::BYTES;
  if (cudaError_t e = opt_in(bs_dq_kernel<D, DV>, dq_bytes)) return (int)e;
  bs_dq_kernel<D, DV><<<dim3(L / TILE, Hq, B), NTHREADS, dq_bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(block_idx),
      static_cast<const int*>(seg), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dq), L, Hq, Hkv, block, S, scale * LOG2E, scale);
  if (cudaError_t e = cudaGetLastError()) return (int)e;
  constexpr size_t dkv_bytes = DkvSmem<D, DV>::BYTES;
  if (cudaError_t e = opt_in(bs_dkv_kernel<D, DV>, dkv_bytes)) return (int)e;
  bs_dkv_kernel<D, DV><<<dim3(L / TILE, Hkv, B), NTHREADS, dkv_bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(seg),
      static_cast<const __nv_bfloat16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const int*>(inv_count),
      static_cast<const int*>(inv_list), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), L, Hq, Hkv, block, scale * LOG2E, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int xt_block_sparse_fwd_bf16(const void* q, const void* k, const void* v,
                                        const void* block_idx, const void* seg, void* out,
                                        void* lse, void* mass, int B, int L, int Hq, int Hkv,
                                        int d, int dv, int block, int S, float scale,
                                        void* stream) {
  if (int e = check_args(B, L, Hq, Hkv, block, S)) return e;
  cudaStream_t st = (cudaStream_t)stream;
  if (d == 256 && dv == 256)
    return launch_fwd<256, 256>(q, k, v, block_idx, seg, out, lse, mass, B, L, Hq, Hkv, block,
                                S, scale, st);
  if (d == 192 && dv == 128)
    return launch_fwd<192, 128>(q, k, v, block_idx, seg, out, lse, mass, B, L, Hq, Hkv, block,
                                S, scale, st);
  if (d == 128 && dv == 128)
    return launch_fwd<128, 128>(q, k, v, block_idx, seg, out, lse, mass, B, L, Hq, Hkv, block,
                                S, scale, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int xt_block_sparse_bwd_bf16(const void* q, const void* k, const void* v,
                                        const void* block_idx, const void* seg,
                                        const void* dout, const void* lse, const void* delta,
                                        void* inv_count, void* inv_list, void* dq, void* dk,
                                        void* dv, int B, int L, int Hq, int Hkv, int d,
                                        int dv_dim, int block, int S, float scale,
                                        void* stream) {
  if (int e = check_args(B, L, Hq, Hkv, block, S)) return e;
  cudaStream_t st = (cudaStream_t)stream;
  if (d == 256 && dv_dim == 256)
    return launch_bwd<256, 256>(q, k, v, block_idx, seg, dout, lse, delta, inv_count, inv_list,
                                dq, dk, dv, B, L, Hq, Hkv, block, S, scale, st);
  if (d == 192 && dv_dim == 128)
    return launch_bwd<192, 128>(q, k, v, block_idx, seg, dout, lse, delta, inv_count, inv_list,
                                dq, dk, dv, B, L, Hq, Hkv, block, S, scale, st);
  if (d == 128 && dv_dim == 128)
    return launch_bwd<128, 128>(q, k, v, block_idx, seg, dout, lse, delta, inv_count, inv_list,
                                dq, dk, dv, B, L, Hq, Hkv, block, S, scale, st);
  return (int)cudaErrorInvalidValue;
}
