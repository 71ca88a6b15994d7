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
// The backward: three products of 2 N V H FLOPs (the logits, dh, dW), so
// the tensor cores bound it on the H100 (15.5 ms at N16384 H1024 V151936).
// A one-pass kernel would need (128 x H) f32 accumulators for both dh and
// dW, which do not fit on chip at H = 1024. So the rows are cut into
// chunks of Nc (ops/fused_ce.py::ce_chunk_plan, Nc <= 4096, the c chunk
// <= 1.25 GB at V151936), and for each chunk:
// 1. the coefficient sweep (ce_sweep_kernel<false>, here): S = h_chunk .
//    w^T on wgmma m64n256k16 over K = H from a TMA/mbarrier ring, then in
//    registers c = bf16(exp2(S log2e - lse log2e) g_lse + [v == label]
//    g_lab), zero for v >= V, out
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
// The sweep (ce_sweep_kernel, both passes) has grouped_kernel's "nt" shape
// (both operands K-major):
// a persistent grid of one CTA per SM walks (vocab tile, 128-row tile)
// items, the row tile innermost, so the CTAs resident together read the
// same few vocab tiles of w and the chunk's h from L2; thread 0 issues the
// TMA loads STAGES chunks ahead across items; each of the two warpgroups
// keeps its 64 x 256 f32 tile in registers and turns it into c on its way
// to the staging boxes.
//
// The forward (#8): the same logits sweep as the backward's coefficient
// kernel (ce_sweep_kernel<true>, below), with a statistics epilogue. It is
// bound by its one product of 2 N V H FLOPs (5.15 ms at N16384 H1024
// V151936 on the H100). The sweep walks (vocab tile of 256, 128-row tile)
// items with the row tiles innermost, so no CTA sees a row's whole vocab:
// each item writes, per row, the (max, sum) of its 256 columns, base 2,
// into an f32 scratch of ceil(V / 256) x N pairs (8 N ceil(V / 256) bytes:
// 78 MB at N16384, 311 MB at N65536), and ce_lse_combine_kernel folds each
// row's pairs in vocab-tile order into lse, so the result does not depend
// on which CTA ran which item. The label logit is written once, by the
// thread that holds it, from the same f32 accumulator. Rows past N write
// nothing; columns >= V count neither in the max nor in the sum. The items
// go in groups of 32 row tiles (4096 rows, 8 MB of h at H1024: the
// backward's chunk), the vocab tiles in order within a group, so h stays
// in L2 while w streams once per group. With no staging boxes the ring
// takes four stages. A design with row-tile-outer CTAs keeping the
// statistics in registers needs no scratch, but reads the whole w (311 MB)
// from L2 for every 128 rows.
//
// Measured on an H100 80GB HBM3 at 700 W (tools/bench_ce_cuda.py): the
// backward at N16384 takes 23.9-24.3 ms, 64% of the bound: the sweep 8.4,
// the dh products 6.9, the dW products 8.0 (torch.mm over one N x V x H
// product: 6.3). The sweep's epilogue (exp2 of 128 values a thread) runs
// while the tensor cores wait: the sweep costs ~1.5 ms more than the dh
// products, which do the same FLOPs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int BM = 128;            // rows of a logits tile
constexpr int NTHREADS = 256;      // two warpgroups, 64 rows each
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr float NEG_INF = -1e30f;

using bf16 = __nv_bfloat16;

// the sweep: 128 rows x 256 vocab columns a tile, 64-deep contraction
// chunks of h (128 x 64) and w (256 x 64), 128-byte-swizzled boxes of 64
// columns; the coefficient epilogue stages c per warpgroup as four 64 x 64
// bf16 boxes, the statistics epilogue stages nothing and takes a fourth stage
constexpr int CT_V = 256;
constexpr int CT_K = 64;
constexpr int FWD_GROUP = 32;                    // row tiles per group of the forward's items
constexpr uint32_t CT_BOX = 64 * 128;            // 64 rows of 64 bf16: 8 KB
constexpr uint32_t CT_A = 2 * CT_BOX;            // h rows
constexpr uint32_t CT_STAGE = CT_A + CT_V * 128; // + w rows: 48 KB

template <bool FWD>
struct SweepLayout {
  static constexpr int STAGES = FWD ? 4 : 3;
  static constexpr uint32_t STG = STAGES * CT_STAGE;
  // full [STAGES], empty [STAGES] after the coefficients' staging boxes
  static constexpr uint32_t BAR = STG + (FWD ? 0 : 2 * 4 * CT_BOX);
  static constexpr uint32_t BYTES = BAR + 16 * STAGES + 1024;  // + alignment slack
  static_assert(BYTES <= 232448, "fits one SM");
};

// 2^x in one instruction (subnormal results flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

struct SweepArgs {
  const int* labels;  // (rows,) int32 of the rows swept
  const float* lse;   // the coefficients' (rows,) f32: lse, g_lse, g_lab
  const float* g_lse;
  const float* g_lab;
  float2* part;       // the forward's: (vt, rows) per-tile (max, sum), base 2
  float* lab_out;     // (rows,) label logit
  int rows, V, H;
  int mt, vt;  // 128-row tiles, 256-column vocab tiles
};

// the vocab tile and first row of item i: row tiles innermost; the
// forward's items in groups of FWD_GROUP row tiles (the last group shorter)
template <bool FWD>
__device__ __forceinline__ void sweep_item(const SweepArgs& a, int i, int& v0, int& r0) {
  if constexpr (FWD) {
    const int per = FWD_GROUP * a.vt, grp = i / per, rem = i - grp * per;
    const int g = min(FWD_GROUP, a.mt - grp * FWD_GROUP);
    v0 = (rem / g) * CT_V;
    r0 = (grp * FWD_GROUP + rem % g) * BM;
  } else {
    v0 = (i / a.mt) * CT_V;
    r0 = (i % a.mt) * BM;
  }
}

// The logits sweep of h . w^T, one epilogue per instantiation: FWD, the
// forward's per-tile row statistics and the label logit; else one row
// chunk's coefficients c (rows, V_pad) bf16. See the file's comment.
template <bool FWD>
__global__ void __launch_bounds__(NTHREADS, 1)
ce_sweep_kernel(const __grid_constant__ CUtensorMap tm_h, const __grid_constant__ CUtensorMap tm_w,
                const __grid_constant__ CUtensorMap tm_c, const SweepArgs a) {
  using Lay = SweepLayout<FWD>;
  constexpr int STAGES = Lay::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t sbase = smem_u32(smem);
  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32, tq = lane % 4;
  const int items = a.mt * a.vt, kchunks = a.H / CT_K;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(sbase + Lay::BAR + 8 * s, 1);
      mbar_init(sbase + Lay::BAR + 8 * (STAGES + s), NTHREADS / 32);
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
    const uint32_t s = pc % STAGES;
    const uint32_t full = sbase + Lay::BAR + 8 * s, empty = full + 8 * STAGES;
    if (pc >= (unsigned)STAGES) mbar_wait(empty, (pc / STAGES - 1) & 1);
    const uint32_t sa = sbase + s * CT_STAGE;
    mbar_expect_tx(full, CT_STAGE);
    const int k0 = p_chunk * CT_K;
    int pv0, pr0;
    sweep_item<FWD>(a, p_item, pv0, pr0);
    tma_load_2d(sa, map_h, full, k0, pr0);          // 128 rows
    tma_load_2d(sa + CT_A, map_w, full, k0, pv0);   // 256 vocab rows
    ++pc;
    if (++p_chunk == kchunks) {
      p_chunk = 0;
      p_item += gridDim.x;
    }
  };
  if (tid == 0)
    for (int s = 0; s < STAGES; ++s) issue();

  float acc[CT_V / 2];
  const int row0 = 16 * warp + lane / 4;  // this thread's rows of its warpgroup: row0, row0 + 8
  uint32_t stage = 0, phase = 0;
  // every warp's arrival on the stage's empty barrier; thread 0 then
  // refills the ring (it waits for all eight warps)
  auto release = [&](uint32_t s) {
    __syncwarp();
    if (lane == 0) mbar_arrive(sbase + Lay::BAR + 8 * (STAGES + s));
    if (tid == 0) issue();
    __syncwarp();
  };

  for (int i = blockIdx.x; i < items; i += gridDim.x) {
    int v0, r0;
    sweep_item<FWD>(a, i, v0, r0);
    uint32_t prev = 0;
    for (int c = 0; c < kchunks; ++c) {
      const uint32_t sa = sbase + stage * CT_STAGE, sb = sa + CT_A;
      mbar_wait(sbase + Lay::BAR + 8 * stage, phase);
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
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    wg_wait0();
    reg_fence(acc);
    release(prev);

    // acc[4 j + 2 r + e2] is row row0 + 8 r, column 8 j + 2 tq + e2 of the
    // warpgroup's 64 x 256 block; the columns from vlim on lie past V
    const int vlim = a.V - v0 - 2 * tq;
    if constexpr (FWD) {
      // per row: the max over the tile's columns < V and the sum of
      // exp2((s - max) log2e), each over the quad that holds the row's 256
      // columns; one (max log2e, sum) pair per row and tile. The label
      // logit from the thread that holds its column
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = NEG_INF;
#pragma unroll
        for (int j = 0; j < CT_V / 8; ++j)
#pragma unroll
          for (int e2 = 0; e2 < 2; ++e2)
            if (8 * j + e2 < vlim) mx = fmaxf(mx, acc[4 * j + 2 * r + e2]);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m2 = mx * LOG2E;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < CT_V / 8; ++j)
#pragma unroll
          for (int e2 = 0; e2 < 2; ++e2)
            if (8 * j + e2 < vlim) sum += ex2(fmaf(acc[4 * j + 2 * r + e2], LOG2E, -m2));
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        const int gr = r0 + 64 * wg + row0 + 8 * r;
        if (gr < a.rows) {
          if (tq == 0) a.part[(int64_t)(v0 / CT_V) * a.rows + gr] = make_float2(m2, sum);
          const int ll = a.labels[gr] - v0 - 2 * tq;  // the label's column, from this thread's 2 tq
          if (ll >= -2 * tq && ll < CT_V - 2 * tq) {
            float lv = 0.f;
            bool hit = false;
#pragma unroll
            for (int j = 0; j < CT_V / 8; ++j)
#pragma unroll
              for (int e2 = 0; e2 < 2; ++e2)
                if (8 * j + e2 == ll) {
                  lv = acc[4 * j + 2 * r + e2];
                  hit = true;
                }
            if (hit) a.lab_out[gr] = lv;
          }
        }
      }
    } else {
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

      // c, box by box, straight into this warpgroup's four staging boxes
      // (bf16 pairs, swizzled as TMA reads them). Out by TMA stores, which
      // drain while the next item runs
      const bool lead = tid % 128 == 0;
      unsigned char* stg = smem + Lay::STG + wg * 4 * CT_BOX;
      const uint32_t stg_s = sbase + Lay::STG + wg * 4 * CT_BOX;
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
  }
  if constexpr (!FWD)
    if (tid % 128 == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");  // stores done
}

// lse[r] from row r's per-tile (max log2e, sum) pairs, folded in vocab-tile
// order (a fixed order: the same bits whichever CTA wrote which pair)
__global__ void ce_lse_combine_kernel(const float2* __restrict__ part, float* __restrict__ lse,
                                      int rows, int vt) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  float m = NEG_INF, l = 0.f;
  for (int t = 0; t < vt; ++t) {
    const float2 p = part[(int64_t)t * rows + r];
    const float mn = fmaxf(m, p.x);
    l = l * exp2f(m - mn) + p.y * exp2f(p.x - mn);
    m = mn;
  }
  lse[r] = (m + log2f(l)) * LN2;
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

// the sweep over `a.rows` rows of h (rows, H) against w (V, H); c (rows,
// v_pad) for the coefficients, unused by the forward
template <bool FWD>
int launch_sweep(const void* h, const void* w, void* c, int v_pad, const SweepArgs& a,
                 cudaStream_t stream) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  const cuuint64_t dh[2] = {(cuuint64_t)a.H, (cuuint64_t)a.rows};
  const cuuint64_t dw[2] = {(cuuint64_t)a.H, (cuuint64_t)a.V};
  const cuuint64_t dc[2] = {(cuuint64_t)v_pad, (cuuint64_t)a.rows};
  const cuuint32_t bh[2] = {64, BM}, bw[2] = {64, CT_V}, bc[2] = {64, 64};
  CUtensorMap th, tw, tc;
  if (!make_map_nd(&th, encode, h, 2, dh, bh) || !make_map_nd(&tw, encode, w, 2, dw, bw))
    return (int)cudaErrorInvalidValue;
  if (FWD)
    tc = th;  // no c: the map is not read
  else if (!make_map_nd(&tc, encode, c, 2, dc, bc))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(ce_sweep_kernel<FWD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         SweepLayout<FWD>::BYTES);
  if (err != cudaSuccess) return (int)err;
  const int items = a.mt * a.vt;
  ce_sweep_kernel<FWD><<<items < sms ? items : sms, NTHREADS, SweepLayout<FWD>::BYTES, stream>>>(
      th, tw, tc, a);
  return (int)cudaGetLastError();
}

}  // namespace

// h (N, H), w (V, H) bf16, labels (N,) int32 -> lse, label_logit (N,) f32;
// part: f32 scratch of 2 N ceil(V / 256) (the per-tile row statistics)
extern "C" int xt_ce_fwd_bf16(const void* h, const void* w, const void* labels, void* part,
                              void* lse, void* lab, int N, int V, int H, void* stream) {
  if (N <= 0 || V <= 0 || H <= 0 || H % 128 != 0) return (int)cudaErrorInvalidValue;
  const SweepArgs a{static_cast<const int*>(labels), nullptr, nullptr, nullptr,
                    static_cast<float2*>(part), static_cast<float*>(lab),
                    N, V, H, (N + BM - 1) / BM, (V + CT_V - 1) / CT_V};
  cudaStream_t s = (cudaStream_t)stream;
  const int err = launch_sweep<true>(h, w, nullptr, 0, a, s);
  if (err != 0) return err;
  ce_lse_combine_kernel<<<(N + 255) / 256, 256, 0, s>>>(static_cast<const float2*>(part),
                                                        static_cast<float*>(lse), N, a.vt);
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
  const SweepArgs a{static_cast<const int*>(labels), static_cast<const float*>(lse),
                    static_cast<const float*>(g_lse), static_cast<const float*>(g_lab),
                    nullptr, nullptr, rows, V, H, (rows + BM - 1) / BM, v_pad / CT_V};
  return launch_sweep<false>(h, w, c, v_pad, a, (cudaStream_t)stream);
}

// out (count,) bf16 = acc (count,) f32 rounded; count a multiple of 4
extern "C" int xt_ce_round_bf16(const void* acc, void* out, long long count, void* stream) {
  if (count <= 0 || count % 4 != 0) return (int)cudaErrorInvalidValue;
  const long long blocks = (count / 4 + 255) / 256;
  ce_round_kernel<<<(int)(blocks < 4096 ? blocks : 4096), 256, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(acc), static_cast<bf16*>(out), count);
  return (int)cudaGetLastError();
}
