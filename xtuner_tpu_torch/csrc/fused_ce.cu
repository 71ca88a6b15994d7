// Fused cross-entropy statistics and their gradients, for Hopper (sm_90a).
//
// Replaces three TPU kernels of xtuner_tpu/ops/fused_ce.py:
// - _fwd_kernel (pallas_call in _run_fwd):
//     lse[r]         = logsumexp_v(h[r] . w[v])
//     label_logit[r] = h[r] . w[labels[r]]
// - _dh_kernel (first pallas_call in _ce_bwd):
//     dh[r] = sum_v c[r, v] w[v]
// - _dw_kernel (second pallas_call in _ce_bwd):
//     dw[v] = sum_r c[r, v] h[r]
//   with the coefficient c[r, v] = p[r, v] g_lse[r] + 1[v == labels[r]] g_lab[r],
//   p = exp(logit - lse), rounded to bf16 before the product (as the TPU
//   kernel rounds it to the weight dtype).
// h (N, H) bf16, w (V, H) bf16 VOCAB-MAJOR (the tied embedding as it is),
// labels (N,) int32 in [0, V). The (N, V) logits never reach device memory:
// each kernel recomputes its (128 x 128) logits tile on the tensor cores,
// keeps it in shared memory in f32, and folds it into per-row statistics
// (forward) or into the bf16 coefficient tile (backward).
//
// The vocab tail: the TPU splits 151936 = 74 * 2048 + 384 into a kernel
// prefix and an XLA tail merged with logaddexp. Here the last tile masks the
// columns >= V, so one launch covers the whole vocab with no pad copy.
//
// What bounds it on the H100: every kernel is a GEMM with K = H (1024 at the
// slice's shapes) behind each logits tile, ~2 N V H FLOPs per sweep, so the
// tensor cores bound it; this first version issues WMMA (mma.sync) from
// shared memory, like csrc/grouped_gemm.cu.
//
// The backward accumulators: the TPU keeps a (rows, H) f32 dh and a
// (vocab, H) f32 dw accumulator in VMEM for the whole sweep (1 MB and 4 MB
// at H = 1024). An SM has 228 KB of shared memory, so here the CTA owns a
// 128-wide "outer" tile (rows for dh, vocab for dw) and sweeps the "inner"
// axis (vocab for dh, rows for dw) in chunks of 256. For each chunk it
// computes the (128 x 256) bf16 coefficient tile once into shared memory,
// then walks H in 128-wide slices: load the f32 accumulator slice from an
// f32 partial buffer in device memory, add c . operand (K = 256) on the
// tensor cores, store it back. The partial is owned by one CTA (no atomics,
// deterministic); the read-modify-write costs 1 MB per 134 MFLOP chunk.
// Where the outer tiles are too few to fill the card, the inner axis is
// split over `splits` CTAs, each with its own partial; a last pass sums the
// partials in order and rounds to bf16. The logits are computed once per
// (outer, inner) tile: no recompute beyond the TPU kernel's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BM = 128;            // rows of a logits tile
constexpr int BV = 128;            // vocab columns of a logits tile
constexpr int BK = 32;             // contraction chunk per pipeline stage
constexpr int NTHREADS = 256;      // 8 warps, each 32 x 64 of a 128 x 128 tile
constexpr int LDK = BK + 8;        // (row, k) operand tiles: 80-byte rows
constexpr int LDS = BV + 4;        // f32 logits staging: 528-byte rows
constexpr int OP_STAGE = BM * LDK; // elements of one (128, 32) operand tile
constexpr int INNER = 2 * BV;      // backward chunk along the inner axis
constexpr int HS = 128;            // H slice of the backward product
constexpr int LDB2 = HS + 8;       // (k, h) operand tiles of the product
constexpr int LDC_DH = INNER + 8;  // c buffer for dh: (outer row, inner vocab)
constexpr int LDC_DW = BV + 8;     // c buffer for dw: (inner row, outer vocab)
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr float NEG_INF = -1e30f;

constexpr int FWD_SMEM = 4 * OP_STAGE * 2 + BM * LDS * 4;
constexpr int C_BYTES = (BM * LDC_DH > INNER * LDC_DW ? BM * LDC_DH : INNER * LDC_DW) * 2;
constexpr int BWD_SMEM = 4 * OP_STAGE * 2 + BM * LDS * 4 + C_BYTES + 4 * BM * 4;
static_assert(2 * BK * LDB2 <= 4 * OP_STAGE, "product ring must fit the logits ring");
static_assert(BWD_SMEM <= 232448, "shared memory");

using bf16 = __nv_bfloat16;
using FragAr = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragAc = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>;
using FragBr = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBc = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;  // 0 source bytes: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The (128 rows x 128 vocab) f32 logits tile h[r0:] . w[v0:]^T over the full
// H, into stg (row-major, LDS). Rows >= N and vocab rows >= V load as zeros.
// Ends with a barrier: stg is ready for every thread.
__device__ void logits_tile(const bf16* __restrict__ h, const bf16* __restrict__ w, int N,
                            int V, int H, int r0, int v0, bf16* sA, bf16* sB, float* stg) {
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 2, wn = warp % 2;

  auto load = [&](int stage, int k0) {
    bf16* a = sA + stage * OP_STAGE;
    bf16* b = sB + stage * OP_STAGE;
#pragma unroll
    for (int t = 0; t < (BM * BK / 8) / NTHREADS; ++t) {
      const int idx = tid + t * NTHREADS;
      const int row = idx / (BK / 8), ch = idx % (BK / 8);
      const int r = r0 + row, v = v0 + row;
      cp_async16(a + row * LDK + ch * 8, r < N ? h + (int64_t)r * H + k0 + ch * 8 : h,
                 r < N);
      cp_async16(b + row * LDK + ch * 8, v < V ? w + (int64_t)v * H + k0 + ch * 8 : w,
                 v < V);
    }
  };

  FragC acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int n_chunks = H / BK;
  load(0, 0);
  cp_async_commit();
  for (int kc = 0; kc < n_chunks; ++kc) {
    if (kc + 1 < n_chunks) {
      load((kc + 1) & 1, (kc + 1) * BK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* a = sA + (kc & 1) * OP_STAGE;
    const bf16* b = sB + (kc & 1) * OP_STAGE;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      FragAr fa[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], a + (wm * 32 + i * 16) * LDK + kk * 16, LDK);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        FragBc fb;  // element (k, v) at b[v * LDK + k]
        wmma::load_matrix_sync(fb, b + (wn * 64 + j * 16) * LDK + kk * 16, LDK);
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
      }
    }
    __syncthreads();  // this stage is free for the load after next
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(stg + (wm * 32 + i * 16) * LDS + wn * 64 + j * 16, acc[i][j],
                              LDS, wmma::mem_row_major);
  __syncthreads();
}

// One CTA per 128-row tile sweeps the whole vocab: online logsumexp (base 2,
// as the TPU kernel) and the label pick. Thread t owns row t / 2 and one
// half of the tile's columns; the two halves combine by a lane shuffle.
__global__ void __launch_bounds__(NTHREADS)
ce_fwd_kernel(const bf16* __restrict__ h, const bf16* __restrict__ w,
              const int* __restrict__ labels, float* __restrict__ lse_out,
              float* __restrict__ lab_out, int N, int V, int H) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sA = reinterpret_cast<bf16*>(smem);
  bf16* sB = sA + 2 * OP_STAGE;
  float* stg = reinterpret_cast<float*>(sB + 2 * OP_STAGE);
  const int tid = threadIdx.x, lane = tid % 32;
  const int row = tid / 2, half = tid % 2;
  const int r0 = blockIdx.x * BM;
  const int grow = r0 + row;
  const int label = grow < N ? labels[grow] : -1;
  float m = NEG_INF, l = 0.f, lab = 0.f;

  for (int v0 = 0; v0 < V; v0 += BV) {
    logits_tile(h, w, N, V, H, r0, v0, sA, sB, stg);
    const float* srow = stg + row * LDS + half * 64;
    const int vbase = v0 + half * 64;
    float tmax = NEG_INF;
    for (int j = 0; j < 64; ++j) {
      const int c = (j + lane) & 63;  // rotated start: no shared-memory bank conflicts
      if (vbase + c < V) tmax = fmaxf(tmax, srow[c] * LOG2E);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    const float m_new = fmaxf(m, tmax);
    float sum = 0.f;
    for (int j = 0; j < 64; ++j) {
      const int c = (j + lane) & 63;
      if (vbase + c < V) sum += exp2f(srow[c] * LOG2E - m_new);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l = l * exp2f(m - m_new) + sum;
    m = m_new;
    const int ll = label - vbase;  // at most one thread of the pair holds the label
    if (ll >= 0 && ll < 64) lab += srow[ll];
    __syncthreads();  // the next tile rewrites stg
  }
  lab += __shfl_xor_sync(0xffffffffu, lab, 1);
  if (half == 0 && grow < N) {
    lse_out[grow] = (m + log2f(fmaxf(l, 1e-37f))) * LN2;
    lab_out[grow] = lab;
  }
}

// DW = false: dh. The CTA owns rows [outer0, +128) and sweeps vocab chunks.
// DW = true:  dw. The CTA owns vocab [outer0, +128) and sweeps row chunks.
// part: (splits, gridDim.x * 128, H) f32; split s = blockIdx.y takes the
// inner chunks [s * n / splits, (s + 1) * n / splits).
template <bool DW>
__global__ void __launch_bounds__(NTHREADS)
ce_bwd_kernel(const bf16* __restrict__ h, const bf16* __restrict__ w,
              const int* __restrict__ labels, const float* __restrict__ lse,
              const float* __restrict__ g_lse, const float* __restrict__ g_lab,
              float* __restrict__ part, int N, int V, int H, int splits) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sA = reinterpret_cast<bf16*>(smem);
  bf16* sB = sA + 2 * OP_STAGE;
  bf16* ring = sA;  // the product's operand ring reuses the logits ring
  float* stg = reinterpret_cast<float*>(sB + 2 * OP_STAGE);
  bf16* cbuf = reinterpret_cast<bf16*>(stg + BM * LDS);
  float* r_lse = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(cbuf) + C_BYTES);
  float* r_glse = r_lse + BM;
  float* r_glab = r_glse + BM;
  int* r_lab = reinterpret_cast<int*>(r_glab + BM);

  const int tid = threadIdx.x, lane = tid % 32;
  const int warp = tid / 32;
  const int wm = warp / 2, wn = warp % 2;
  const int row = tid / 2, half = tid % 2;
  const int outer0 = blockIdx.x * 128;
  const int inner_len = DW ? N : V;
  const int n_chunks = (inner_len + INNER - 1) / INNER;
  const int c_begin = (int)((int64_t)blockIdx.y * n_chunks / splits);
  const int c_end = (int)((int64_t)(blockIdx.y + 1) * n_chunks / splits);
  float* part_s = part + (int64_t)blockIdx.y * gridDim.x * 128 * H;
  const bf16* operand = DW ? h : w;  // the product's right-hand side, (inner, H)

  for (int chunk = c_begin; chunk < c_end; ++chunk) {
    // ---- the (128 outer x 256 inner) coefficient tile, bf16 in cbuf
    for (int sub = 0; sub < 2; ++sub) {
      const int inner0 = chunk * INNER + sub * BV;
      const int r0 = DW ? inner0 : outer0;
      const int v0 = DW ? outer0 : inner0;
      if (tid < BM) {
        const int r = r0 + tid;
        const bool ok = r < N;
        r_lse[tid] = ok ? lse[r] * LOG2E : 0.f;
        r_glse[tid] = ok ? g_lse[r] : 0.f;
        r_glab[tid] = ok ? g_lab[r] : 0.f;
        r_lab[tid] = ok ? labels[r] : -1;
      }
      logits_tile(h, w, N, V, H, r0, v0, sA, sB, stg);  // ends with a barrier
      const bool row_ok = r0 + row < N;
      const float lse2 = r_lse[row], gl = r_glse[row], gb = r_glab[row];
      const int lab = r_lab[row];
      const float* srow = stg + row * LDS + half * 64;
      for (int j = 0; j < 64; ++j) {
        const int c = (j + lane) & 63;
        const int col = half * 64 + c;
        const int v = v0 + col;
        float val = 0.f;
        if (row_ok && v < V)
          val = exp2f(srow[c] * LOG2E - lse2) * gl + (v == lab ? gb : 0.f);
        const bf16 cv = __float2bfloat16(val);
        if (DW)
          cbuf[(sub * BV + row) * LDC_DW + col] = cv;
        else
          cbuf[row * LDC_DH + sub * BV + col] = cv;
      }
      __syncthreads();  // stg and the row arrays are rewritten next
    }

    // ---- part[outer, slice] += c (128 x 256) . operand[chunk rows, slice]
    for (int hs = 0; hs < H; hs += HS) {
      FragC acc[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float* p = part_s + (int64_t)(outer0 + wm * 32 + i * 16) * H + hs + wn * 64 + j * 16;
          if (chunk == c_begin)
            wmma::fill_fragment(acc[i][j], 0.f);
          else
            wmma::load_matrix_sync(acc[i][j], p, H, wmma::mem_row_major);
        }
      auto loadB = [&](int stage, int k0) {
        bf16* b = ring + stage * BK * LDB2;
#pragma unroll
        for (int t = 0; t < (BK * HS / 8) / NTHREADS; ++t) {
          const int idx = tid + t * NTHREADS;
          const int r = idx / (HS / 8), ch = idx % (HS / 8);
          const int gi = chunk * INNER + k0 + r;
          const bool ok = gi < inner_len;
          cp_async16(b + r * LDB2 + ch * 8,
                     ok ? operand + (int64_t)gi * H + hs + ch * 8 : operand, ok);
        }
      };
      constexpr int n_k = INNER / BK;
      loadB(0, 0);
      cp_async_commit();
      for (int kc = 0; kc < n_k; ++kc) {
        if (kc + 1 < n_k) {
          loadB((kc + 1) & 1, (kc + 1) * BK);
          cp_async_commit();
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();
        const bf16* b = ring + (kc & 1) * BK * LDB2;
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          const int kl = kc * BK + kk * 16;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            if (DW) {
              FragAc fa;  // c^T: element (v, r) at cbuf[r * LDC_DW + v]
              wmma::load_matrix_sync(fa, cbuf + kl * LDC_DW + wm * 32 + i * 16, LDC_DW);
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                FragBr fb;
                wmma::load_matrix_sync(fb, b + (kk * 16) * LDB2 + wn * 64 + j * 16, LDB2);
                wmma::mma_sync(acc[i][j], fa, fb, acc[i][j]);
              }
            } else {
              FragAr fa;
              wmma::load_matrix_sync(fa, cbuf + (wm * 32 + i * 16) * LDC_DH + kl, LDC_DH);
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                FragBr fb;
                wmma::load_matrix_sync(fb, b + (kk * 16) * LDB2 + wn * 64 + j * 16, LDB2);
                wmma::mma_sync(acc[i][j], fa, fb, acc[i][j]);
              }
            }
          }
        }
        __syncthreads();  // this stage is free for the load after next
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wmma::store_matrix_sync(
              part_s + (int64_t)(outer0 + wm * 32 + i * 16) * H + hs + wn * 64 + j * 16,
              acc[i][j], H, wmma::mem_row_major);
    }
  }
}

// out[i] = bf16(sum_s part[s * stride + i]) for i < count (a multiple of 4)
__global__ void ce_reduce_kernel(const float* __restrict__ part, bf16* __restrict__ out,
                                 int64_t count, int64_t stride, int splits) {
  for (int64_t i = (blockIdx.x * (int64_t)blockDim.x + threadIdx.x) * 4; i < count;
       i += (int64_t)gridDim.x * blockDim.x * 4) {
    float4 acc = *reinterpret_cast<const float4*>(part + i);
    for (int s = 1; s < splits; ++s) {
      const float4 p = *reinterpret_cast<const float4*>(part + s * stride + i);
      acc.x += p.x;
      acc.y += p.y;
      acc.z += p.z;
      acc.w += p.w;
    }
    __nv_bfloat162 lo = __floats2bfloat162_rn(acc.x, acc.y);
    __nv_bfloat162 hi = __floats2bfloat162_rn(acc.z, acc.w);
    uint2 packed;
    packed.x = *reinterpret_cast<unsigned*>(&lo);
    packed.y = *reinterpret_cast<unsigned*>(&hi);
    *reinterpret_cast<uint2*>(out + i) = packed;
  }
}

}  // namespace

// h (N, H), w (V, H) bf16, labels (N,) int32 -> lse, label_logit (N,) f32
extern "C" int xt_ce_fwd_bf16(const void* h, const void* w, const void* labels, void* lse,
                              void* lab, int N, int V, int H, void* stream) {
  if (N <= 0 || V <= 0 || H <= 0 || H % 128 != 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(ce_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, FWD_SMEM);
  if (err != cudaSuccess) return (int)err;
  ce_fwd_kernel<<<(N + BM - 1) / BM, NTHREADS, FWD_SMEM, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(w),
      static_cast<const int*>(labels), static_cast<float*>(lse), static_cast<float*>(lab), N,
      V, H);
  return (int)cudaGetLastError();
}

// dw = 0: dh (N, H) bf16; dw = 1: dw (V, H) bf16. part: f32 scratch of
// splits * ceil(outer / 128) * 128 * H elements (outer = N for dh, V for dw).
extern "C" int xt_ce_bwd_bf16(const void* h, const void* w, const void* labels,
                              const void* lse, const void* g_lse, const void* g_lab, void* part,
                              void* out, int N, int V, int H, int splits, int dw,
                              void* stream) {
  const int outer = dw ? V : N, inner = dw ? N : V;
  const int n_chunks = (inner + INNER - 1) / INNER;
  if (N <= 0 || V <= 0 || H <= 0 || H % 128 != 0 || splits < 1 || splits > n_chunks)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((outer + 127) / 128, splits);
  const bf16* hp = static_cast<const bf16*>(h);
  const bf16* wp = static_cast<const bf16*>(w);
  const int* lp = static_cast<const int*>(labels);
  const float* lsep = static_cast<const float*>(lse);
  const float* glp = static_cast<const float*>(g_lse);
  const float* gbp = static_cast<const float*>(g_lab);
  float* pp = static_cast<float*>(part);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (dw) {
    err = cudaFuncSetAttribute(ce_bwd_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, BWD_SMEM);
    if (err != cudaSuccess) return (int)err;
    ce_bwd_kernel<true><<<grid, NTHREADS, BWD_SMEM, st>>>(hp, wp, lp, lsep, glp, gbp, pp, N,
                                                           V, H, splits);
  } else {
    err = cudaFuncSetAttribute(ce_bwd_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, BWD_SMEM);
    if (err != cudaSuccess) return (int)err;
    ce_bwd_kernel<false><<<grid, NTHREADS, BWD_SMEM, st>>>(hp, wp, lp, lsep, glp, gbp, pp, N,
                                                            V, H, splits);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t count = (int64_t)outer * H;
  const int64_t stride = (int64_t)grid.x * 128 * H;
  const int64_t blocks = (count / 4 + 255) / 256;
  ce_reduce_kernel<<<(int)(blocks < 4096 ? blocks : 4096), 256, 0, st>>>(
      pp, static_cast<bf16*>(out), count, stride, splits);
  return (int)cudaGetLastError();
}
