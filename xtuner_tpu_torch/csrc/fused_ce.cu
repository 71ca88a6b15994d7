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
// labels (N,) int32 in [0, V). The (N, V) logits never reach device memory.
//
// The vocab tail: the TPU splits 151936 = 74 * 2048 + 384 into a kernel
// prefix and an XLA tail merged with logaddexp. Here the last tile masks the
// columns >= V, so one launch covers the whole vocab with no pad copy.
//
// The forward (ce_fwd_kernel): one CTA per 128-row tile sweeps the vocab,
// recomputing each (128 x 128) logits tile on WMMA (mma.sync) from a
// cp.async ring into shared memory, and folds it into the row statistics.
//
// The backward: three products of 2 N V H FLOPs (the logits, dh, dW), so
// the tensor cores bound it on the H100 (15.5 ms at N16384 H1024 V151936).
// A one-pass kernel would need (128 x H) f32 accumulators for both dh and
// dW, which do not fit on chip at H = 1024. So the rows are cut into
// chunks of Nc (ops/fused_ce.py::ce_chunk_plan, Nc <= 4096, the c chunk
// <= 1.25 GB at V151936), and for each chunk:
// 1. ce_coeff_kernel (here): S = h_chunk . w^T on wgmma m64n256k16 over
//    K = H from a TMA/mbarrier ring, then in registers c = bf16(exp2(S
//    log2e - lse log2e) g_lse + [v == label] g_lab), zero for v >= V, out
//    by TMA stores into a (Nc, V_pad) bf16 scratch (V_pad: V rounded up to
//    the 256-column tile, the pad columns zero). Only this c chunk, never
//    the f32 logits, reaches device memory, and it is reused by every chunk.
// 2. dh_chunk = c . w (xt_gemm_nn_bf16 in grouped_gemm.cu: the nn
//    instantiation of the grouped kernel, one group, bf16 out).
// 3. dW += c^T . h_chunk (xt_gemm_dw_bf16: its dw instantiation, f32 out;
//    chunks after the first add by TMA reduce-add stores). ce_round_kernel
//    rounds dW to bf16 at the end.
// Every accumulator lives in registers; the logits are computed once.
//
// ce_coeff_kernel's shape is grouped_kernel's "nt" (both operands K-major):
// a persistent grid of one CTA per SM walks (vocab tile, 128-row tile)
// items, the row tile innermost, so the CTAs resident together read the
// same few vocab tiles of w and the chunk's h from L2; thread 0 issues the
// TMA loads STAGES chunks ahead across items; each of the two warpgroups
// keeps its 64 x 256 f32 tile in registers and turns it into c on its way
// to the staging boxes.
//
// Measured on an H100 80GB HBM3 at 700 W (tools/bench_ce_cuda.py): the
// backward at N16384 takes 23.9-24.3 ms, 64% of the bound: the sweep 8.4,
// the dh products 6.9, the dW products 8.0 (torch.mm over one N x V x H
// product: 6.3). The sweep's epilogue (exp2 of 128 values a thread) runs
// while the tensor cores wait: the sweep costs ~1.5 ms more than the dh
// products, which do the same FLOPs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "sm90.cuh"

using namespace nvcuda;

namespace {

constexpr int BM = 128;            // rows of a logits tile
constexpr int BV = 128;            // vocab columns of a logits tile
constexpr int BK = 32;             // contraction chunk per pipeline stage
constexpr int NTHREADS = 256;      // 8 warps, each 32 x 64 of a 128 x 128 tile
constexpr int LDK = BK + 8;        // (row, k) operand tiles: 80-byte rows
constexpr int LDS = BV + 4;        // f32 logits staging: 528-byte rows
constexpr int OP_STAGE = BM * LDK; // elements of one (128, 32) operand tile
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr float NEG_INF = -1e30f;

constexpr int FWD_SMEM = 4 * OP_STAGE * 2 + BM * LDS * 4;

using bf16 = __nv_bfloat16;
using FragAr = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragBc = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// the coefficient kernel: 128 rows x 256 vocab columns a tile, 64-deep
// contraction chunks of h (128 x 64) and w (256 x 64), 128-byte-swizzled
// boxes of 64 columns; c staged per warpgroup as four 64 x 64 bf16 boxes
constexpr int CT_V = 256;
constexpr int CT_K = 64;
constexpr int CT_STAGES = 3;
constexpr uint32_t CT_BOX = 64 * 128;            // 64 rows of 64 bf16: 8 KB
constexpr uint32_t CT_A = 2 * CT_BOX;            // h rows
constexpr uint32_t CT_STAGE = CT_A + CT_V * 128; // + w rows: 48 KB
constexpr uint32_t CT_STG = CT_STAGES * CT_STAGE;
constexpr uint32_t CT_BAR = CT_STG + 2 * 4 * CT_BOX;  // full [STAGES], empty [STAGES]
constexpr uint32_t CT_BYTES = CT_BAR + 16 * CT_STAGES + 1024;  // + alignment slack
static_assert(CT_BYTES <= 232448, "fits one SM");

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


// 2^x in one instruction (subnormal results flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

struct CoeffArgs {
  const int* labels;  // the chunk's rows: (rows,) int32, f32 below
  const float* lse;
  const float* g_lse;
  const float* g_lab;
  int rows, V, H;
  int mt, vt;  // 128-row tiles, 256-column vocab tiles
};

// c (rows, V_pad) bf16 for one chunk of rows; see the file's comment
__global__ void __launch_bounds__(NTHREADS, 1)
ce_coeff_kernel(const __grid_constant__ CUtensorMap tm_h, const __grid_constant__ CUtensorMap tm_w,
                const __grid_constant__ CUtensorMap tm_c, const CoeffArgs a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t sbase = smem_u32(smem);
  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32, tq = lane % 4;
  const int items = a.mt * a.vt, kchunks = a.H / CT_K;

  if (tid == 0) {
    for (int s = 0; s < CT_STAGES; ++s) {
      mbar_init(sbase + CT_BAR + 8 * s, 1);
      mbar_init(sbase + CT_BAR + 8 * (CT_STAGES + s), NTHREADS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // thread 0's side: the next (item, chunk) to load, across this CTA's items
  const CUtensorMap* map_h = &tm_h;
  const CUtensorMap* map_w = &tm_w;
  int p_item = blockIdx.x, p_chunk = 0;
  unsigned pc = 0;  // loads issued
  auto issue = [&]() {
    if (p_item >= items) return;
    const uint32_t s = pc % CT_STAGES;
    const uint32_t full = sbase + CT_BAR + 8 * s, empty = full + 8 * CT_STAGES;
    if (pc >= (unsigned)CT_STAGES) mbar_wait(empty, (pc / CT_STAGES - 1) & 1);
    const uint32_t sa = sbase + s * CT_STAGE;
    mbar_expect_tx(full, CT_STAGE);
    const int k0 = p_chunk * CT_K;
    tma_load_2d(sa, map_h, full, k0, (p_item % a.mt) * BM);           // 128 rows
    tma_load_2d(sa + CT_A, map_w, full, k0, (p_item / a.mt) * CT_V);  // 256 vocab rows
    ++pc;
    if (++p_chunk == kchunks) {
      p_chunk = 0;
      p_item += gridDim.x;
    }
  };
  if (tid == 0)
    for (int s = 0; s < CT_STAGES; ++s) issue();

  float acc[CT_V / 2];
  const int row0 = 16 * warp + lane / 4;  // this thread's rows of its warpgroup: row0, row0 + 8
  uint32_t stage = 0, phase = 0;
  // every warp's arrival on the stage's empty barrier; thread 0 then
  // refills the ring (it waits for all eight warps)
  auto release = [&](uint32_t s) {
    __syncwarp();
    if (lane == 0) mbar_arrive(sbase + CT_BAR + 8 * (CT_STAGES + s));
    if (tid == 0) issue();
    __syncwarp();
  };

  for (int i = blockIdx.x; i < items; i += gridDim.x) {
    const int r0 = (i % a.mt) * BM, v0 = (i / a.mt) * CT_V;
    uint32_t prev = 0;
    for (int c = 0; c < kchunks; ++c) {
      const uint32_t sa = sbase + stage * CT_STAGE, sb = sa + CT_A;
      mbar_wait(sbase + CT_BAR + 8 * stage, phase);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < CT_K / 16; ++kk)
        wgmma_m64n256_ss<0, 0>(acc, desc(sa + wg * CT_BOX + 32 * kk, 16, 1024),
                               desc(sb + 32 * kk, 16, 1024), c > 0 || kk > 0);
      wg_commit();
      if (c > 0) {
        wg_wait<1>();
        reg_fence(acc);
        release(prev);
      }
      prev = stage;
      if (++stage == CT_STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    wg_wait0();
    reg_fence(acc);
    release(prev);

    // the chunk rows' statistics: rows past the chunk get 0 (and are not
    // stored); the label as a column offset from this thread's 2 tq
    float lse2[2], gl[2], gb[2];
    int lab[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int gr = r0 + 64 * wg + row0 + 8 * r;
      const bool ok = gr < a.rows;
      lse2[r] = ok ? a.lse[gr] * LOG2E : 0.f;
      gl[r] = ok ? a.g_lse[gr] : 0.f;
      gb[r] = ok ? a.g_lab[gr] : 0.f;
      lab[r] = ok ? a.labels[gr] - v0 - 2 * tq : -1;
    }
    const int vlim = a.V - v0 - 2 * tq;  // columns 8 j + e2 (+ 2 tq) below it are in the vocab

    // c, box by box, straight into this warpgroup's four staging boxes
    // (bf16 pairs, swizzled as TMA reads them): acc[4 j + 2 r + e2] is row
    // row0 + 8 r, column 8 j + 2 tq + e2 of the warpgroup's 64 x 256 block.
    // Out by TMA stores, which drain while the next item runs
    const bool lead = tid % 128 == 0;
    unsigned char* stg = smem + CT_STG + wg * 4 * CT_BOX;
    const uint32_t stg_s = sbase + CT_STG + wg * 4 * CT_BOX;
    if (lead) tma_store_wait();  // the last item's stores have read the boxes
    named_sync(1 + wg, 128);
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int j = b * 8 + jj, R = row0 + 8 * r;
          float cv[2];
#pragma unroll
          for (int e2 = 0; e2 < 2; ++e2) {
            const int col = 8 * j + e2;
            const float p = ex2(fmaf(acc[4 * j + 2 * r + e2], LOG2E, -lse2[r])) * gl[r];
            cv[e2] = col < vlim ? p + (col == lab[r] ? gb[r] : 0.f) : 0.f;
          }
          *reinterpret_cast<uint32_t*>(stg + b * CT_BOX + R * 128 + ((jj ^ (R & 7)) << 4) +
                                       4 * tq) = pack_bf16(cv[0], cv[1]);
        }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    named_sync(1 + wg, 128);
    const int m0 = r0 + 64 * wg;
    if (lead && m0 < a.rows) {
      for (int b = 0; b < 4; ++b) tma_store_2d(&tm_c, stg_s + b * CT_BOX, v0 + 64 * b, m0);
      tma_store_commit();
    }
  }
  if (tid % 128 == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");  // stores done
}

// out[i] = bf16(acc[i]) for i < count (a multiple of 4)
__global__ void ce_round_kernel(const float* __restrict__ acc, bf16* __restrict__ out,
                                int64_t count) {
  for (int64_t i = (blockIdx.x * (int64_t)blockDim.x + threadIdx.x) * 4; i < count;
       i += (int64_t)gridDim.x * blockDim.x * 4) {
    const float4 v = *reinterpret_cast<const float4*>(acc + i);
    uint2 packed;
    packed.x = pack_bf16(v.x, v.y);
    packed.y = pack_bf16(v.z, v.w);
    *reinterpret_cast<uint2*>(out + i) = packed;
  }
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      n = 0;
  }
  return n;
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

// One row chunk's coefficients: h (rows, H), labels, lse, g_lse, g_lab
// (rows,), the chunk's own rows; w (V, H) -> c (rows, v_pad) bf16, zero in
// the columns >= V. v_pad: a multiple of 256, >= V.
extern "C" int xt_ce_coeff_bf16(const void* h, const void* w, const void* labels,
                                const void* lse, const void* g_lse, const void* g_lab, void* c,
                                int rows, int V, int H, int v_pad, void* stream) {
  if (rows <= 0 || V <= 0 || H <= 0 || H % 128 != 0 || v_pad % CT_V != 0 || v_pad < V)
    return (int)cudaErrorInvalidValue;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  const cuuint64_t dh[2] = {(cuuint64_t)H, (cuuint64_t)rows};
  const cuuint64_t dw[2] = {(cuuint64_t)H, (cuuint64_t)V};
  const cuuint64_t dc[2] = {(cuuint64_t)v_pad, (cuuint64_t)rows};
  const cuuint32_t bh[2] = {64, BM}, bw[2] = {64, CT_V}, bc[2] = {64, 64};
  CUtensorMap th, tw, tc;
  if (!make_map_nd(&th, encode, h, 2, dh, bh) || !make_map_nd(&tw, encode, w, 2, dw, bw) ||
      !make_map_nd(&tc, encode, c, 2, dc, bc))
    return (int)cudaErrorInvalidValue;
  const CoeffArgs a{static_cast<const int*>(labels), static_cast<const float*>(lse),
                    static_cast<const float*>(g_lse), static_cast<const float*>(g_lab),
                    rows, V, H, (rows + BM - 1) / BM, v_pad / CT_V};
  cudaError_t err = cudaFuncSetAttribute(ce_coeff_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, CT_BYTES);
  if (err != cudaSuccess) return (int)err;
  const int items = a.mt * a.vt;
  ce_coeff_kernel<<<items < sms ? items : sms, NTHREADS, CT_BYTES, (cudaStream_t)stream>>>(
      th, tw, tc, a);
  return (int)cudaGetLastError();
}

// out (count,) bf16 = acc (count,) f32 rounded; count a multiple of 4
extern "C" int xt_ce_round_bf16(const void* acc, void* out, long long count, void* stream) {
  if (count <= 0 || count % 4 != 0) return (int)cudaErrorInvalidValue;
  const long long blocks = (count / 4 + 255) / 256;
  ce_round_kernel<<<(int)(blocks < 4096 ? blocks : 4096), 256, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(acc), static_cast<bf16*>(out), count);
  return (int)cudaGetLastError();
}
