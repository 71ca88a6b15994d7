// GQA flash-attention backward over packed rows, for Hopper (sm_90a):
// at head dim 128, one pass that computes p and ds once per (k tile, q
// tile) pair and feeds dq, dk and dv from them, on wgmma with a TMA ring;
// at MLA's q/k dim 192 and v dim 128, at gpt-oss's 64 and 64 and at
// Qwen3.5's gated attention, 256 and 256, a dq kernel and a dk/dv kernel
// (the end of this file), which at 192/128 and 64/64 also take a sliding
// window, and at 64/64 and 72/72 non-causal attention (Qwen3-VL's vision
// towers: 72/72 on 128-column tiles, below).
//
// Replaces three TPU kernels of xtuner_tpu/ops/attention/flash.py:
// - _dq_kernel (the dq pallas_call in _flash_bwd_rule);
// - _dkv_grouped_kernel (pallas_call in _grouped_dkv): dk and dv of one kv
//   head, summed over its q-head group (the default, TWO_PASS = false);
// - _dkv_kernel (the two-pass pallas_call, XTUNER_ATTN_BWD=two_pass): dk_h
//   and dv_h of one q head to (B, L, Hq, D) (TWO_PASS = true); the wrapper
//   sums each group afterwards, as JAX does outside its kernel.
// Layouts as the forward (csrc/flash_fwd.cu): q (B, L, Hq, D), do (B, L,
// Hq, DV), k (B, L, Hkv, D), v (B, L, Hkv, DV), all bf16. The wrapper
// pads lse, delta (B, Hq, Lp) f32 and segment_ids (B, Lp) int32 (0 =
// padding) to Lp, a multiple of 128, and passes a table of (B, Lp / 64)
// 64-row tiles {lowest non-zero segment id, highest, the id if the tile
// holds one document and no padding else 0}.
// Key m is visible to query l iff seg[l] == seg[m] != 0 and m <= l (the
// last term dropped by a non-causal call at 64/64). For
// every visible pair:
//   p  = exp2(s * scale * log2e - lse * log2e)     (s = q.k)
//   dp = do . v;  ds = p * (dp - delta)
//   dq += ds k;   dk += ds q;   dv += p do;   dq, dk scaled by `scale`.
// Padding rows have seg 0: p = ds = 0 there, so they add exactly nothing
// and their dq, dk and dv rows are exactly zero.
//
// What bounds it on the H100: five L^2-sized bf16 products (s, dp, dv, dk,
// dq: 10 flops per visible pair and head dim) at 989 TFLOP/s; HBM traffic
// is small beside them.
//
// Design:
// - One CTA of two warpgroups per (128-row k tile, kv head, batch row)
//   (grouped) or per (128-row k tile, q head, batch row) (two-pass). Each
//   warpgroup owns 64 key rows and keeps their 64 x 128 dK and dV in f32
//   registers for the whole CTA; they are written once, dK times `scale`.
// - K and V stay resident (32 KB each). A 2-stage ring holds q tiles (64
//   rows of Q and dO by TMA; lse, delta and segment ids by bulk copy), with
//   a full and an empty mbarrier per stage. Thread 0 issues every load: the
//   first two steps before the loop, then at the top of step t the loads of
//   step t + 1 into the stage step t - 1 freed.
// - The CTA walks the `ratio` q heads of its group (one head when
//   two-pass) and, for each, the q tiles from the k tile's diagonal to the
//   last tile whose segment range meets the k tile's (the end of its last
//   document), which warp 0 finds once through the tile table, 32 tiles at
//   a time from the end of the row. No step outside that range costs a load
//   or a barrier.
// - Per step, each warpgroup: S^T = K Q^T and dP^T = V dO^T on wgmma
//   (m64n64k16, both operands in shared memory); P^T and dS^T in registers
//   in the accumulator layout (the per-element mask only on pairs that
//   straddle the diagonal, a document boundary or padding: JAX _tile_full);
//   dV += P^T dO and dK += dS^T Q on wgmma with A from those registers
//   (m64n128k16). dS^T also goes to shared memory (two buffers, so one
//   barrier per step orders the warpgroups), and dQ = dS K (each
//   warpgroup 64 of the 128 columns, m64n64k16, both operands transposed)
//   goes by one bulk reduce-add per warpgroup (cp.reduce.async.bulk .add.f32,
//   16 KB) into a zeroed f32 accumulator, times `scale`; the wrapper puts
//   it in (B, L, Hq, D) order as bf16.
// - Shared-memory tiles are 128-byte swizzled 64-column halves, as TMA
//   writes them and wgmma descriptors read them: the same Q and dO tiles
//   are K-major operands of S^T / dP^T and MN-major ones of dV / dK.
// - Registers: 256 threads, so ptxas may give each up to 255. A producer
//   warpgroup with setmaxnreg (384 threads) was tried first: ptxas then
//   allocates every region within the launch bound's 168 registers,
//   whatever setmaxnreg asks, so the consumers spilled ~1.5 KB and ptxas
//   serialized every wgmma (C7512).
// - TMA descriptors: cuTensorMapEncodeTiled, taken from the driver through
//   cudaGetDriverEntryPoint(ByVersion), so the library is not linked
//   against libcuda. These, the barriers, TMA and wgmma helpers are shared
//   with the forward in sm90.cuh.
// - Load balance: the 1-D grid puts k tile 0 (the longest walk) first.
// - Determinism: dk and dv are summed in a fixed order. dq's sum over k
//   tiles goes through bulk reduce-adds, whose order changes from run to
//   run, so dq is not bitwise reproducible between two runs (it agrees to
//   rounding).
// - Head dim 128, causal and no window only (anything else returns an
//   error); (D, DV) = (192, 128), (64, 64) and (256, 256) run the two
//   kernels at the end of this file.
// - ptxas (nvcc -Xptxas -v, sm_90a), both instantiations: 255 registers,
//   0 bytes of spills; 200,248 bytes of dynamic shared memory (one CTA per SM).

#include "attn_bwd64.cuh"
#include "sm90.cuh"

namespace {

constexpr int D = 128;
constexpr int BK = 128;  // key rows per CTA: two warpgroups of 64
constexpr int BQ = 64;   // query rows per ring stage
constexpr int STAGES = 2;
constexpr int NTHREADS = 256;  // two warpgroups
constexpr float LOG2E = 1.4426950408889634f;

// shared memory, in bytes from a 1024-aligned base; a tile is two 64-column
// halves of 128-byte rows, swizzled in 1024-byte atoms
constexpr uint32_t HALF_K = BK * 128;  // 16 KB
constexpr uint32_t HALF_Q = BQ * 128;  // 8 KB
constexpr uint32_t OFF_K = 0;
constexpr uint32_t OFF_V = OFF_K + 2 * HALF_K;
constexpr uint32_t OFF_RING = OFF_V + 2 * HALF_K;
constexpr uint32_t ST_Q = 0;
constexpr uint32_t ST_DO = ST_Q + 2 * HALF_Q;
constexpr uint32_t ST_LSE = ST_DO + 2 * HALF_Q;
constexpr uint32_t ST_DELTA = ST_LSE + BQ * 4;
constexpr uint32_t ST_SEG = ST_DELTA + BQ * 4;
constexpr uint32_t STAGE_BYTES = (ST_SEG + BQ * 4 + 1023) / 1024 * 1024;
constexpr uint32_t OFF_DS = OFF_RING + STAGES * STAGE_BYTES;
constexpr uint32_t DS_BYTES = BK * 128;  // dS^T: 128 key rows x 64 q columns
constexpr uint32_t OFF_STG = OFF_DS + 2 * DS_BYTES;  // dQ staging, 16 KB per warpgroup
constexpr uint32_t STG_BYTES = 64 * 64 * 4;
constexpr uint32_t OFF_KSEG = OFF_STG + 2 * STG_BYTES;
constexpr uint32_t OFF_RANGE = OFF_KSEG + BK * 4;  // first q tile, q tiles per head
constexpr uint32_t OFF_BAR = OFF_RANGE + 16;
constexpr uint32_t SMEM_BYTES = OFF_BAR + 8 * (2 * STAGES + 1) + 1024;  // + alignment slack
constexpr uint32_t STAGE_TX = 4 * HALF_Q + 3 * BQ * 4;
constexpr uint32_t KV_TX = 4 * HALF_K + BK * 4;
static_assert(SMEM_BYTES <= 232448, "fits one SM");


struct Args {
  const float* lse;    // (B, Hq, Lp)
  const float* delta;  // (B, Hq, Lp)
  const int* seg;      // (B, Lp)
  const int4* tiles;   // (B, Lp / 64)
  float* dq_acc;       // (B, Hq, Lp / 64, 2, 4096), zeroed: see the end of the step loop
  __nv_bfloat16* dk;   // (B, L, Hkv or Hq, D)
  __nv_bfloat16* dv;
  int B, L, Lp, Hq, Hkv;
  float scale_log2e, scale;
  int window;  // the split kernels: key m counts for query l only if l - m < window (Lp: full)
};

// P^T and dS^T of one (64 key rows, 64 q rows) tile in the accumulator
// layout (thread rows 16 warp + lane / 4 (+8), columns 8 j + 2 (lane % 4)
// (+1)), packed to bf16 pairs as wgmma's register A operand wants them
template <bool MASK>
__device__ __forceinline__ void softmax_grad(const float (&s)[32], const float (&dp)[32],
                                             uint32_t (&pa)[16], uint32_t (&da)[16],
                                             const unsigned char* st, int tq, int q0,
                                             const int (&kseg)[2], const int (&kpos)[2],
                                             float scale_log2e) {
  const float* lse_s = reinterpret_cast<const float*>(st + ST_LSE);
  const float* delta_s = reinterpret_cast<const float*>(st + ST_DELTA);
  const int* seg_s = reinterpret_cast<const int*>(st + ST_SEG);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = 8 * j + 2 * tq;
    const float2 l2 = *reinterpret_cast<const float2*>(lse_s + c);
    const float2 dl = *reinterpret_cast<const float2*>(delta_s + c);
    const float lb[2] = {l2.x * LOG2E, l2.y * LOG2E};
    const float dlv[2] = {dl.x, dl.y};
    int qs[2] = {0, 0};
    if (MASK) {
      const int2 sq = *reinterpret_cast<const int2*>(seg_s + c);
      qs[0] = sq.x;
      qs[1] = sq.y;
    }
    float p[4], ds[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * j + e, cc = e & 1, r = e >> 1;
      float pv = exp2f(fmaf(s[i], scale_log2e, -lb[cc]));
      float dsv = pv * (dp[i] - dlv[cc]);
      if (MASK) {
        const bool ok = kseg[r] != 0 && qs[cc] == kseg[r] && kpos[r] <= q0 + c + cc;
        pv = ok ? pv : 0.f;
        dsv = ok ? dsv : 0.f;
      }
      p[e] = pv;
      ds[e] = dsv;
    }
    pa[2 * j] = pack_bf16(p[0], p[1]);
    pa[2 * j + 1] = pack_bf16(p[2], p[3]);
    da[2 * j] = pack_bf16(ds[0], ds[1]);
    da[2 * j + 1] = pack_bf16(ds[2], ds[3]);
  }
}

// issue the loads of q tile j of q head h into ring stage `stage`: Q and dO
// by TMA, lse, delta and the segment ids by bulk copy
__device__ __forceinline__ void load_q_tile(const CUtensorMap* tm_q, const CUtensorMap* tm_do,
                                            const Args& a, uint32_t sbase, uint32_t bar_full,
                                            int stage, int j, int h, int b) {
  const uint32_t st = sbase + OFF_RING + stage * STAGE_BYTES;
  const uint32_t fb = bar_full + 8 * stage;
  const int q0 = j * BQ;
  mbar_expect_tx(fb, STAGE_TX);
  for (int half = 0; half < 2; ++half) {
    tma_load(st + ST_Q + half * HALF_Q, tm_q, fb, 64 * half, h, q0, b);
    tma_load(st + ST_DO + half * HALF_Q, tm_do, fb, 64 * half, h, q0, b);
  }
  const int64_t row = ((int64_t)b * a.Hq + h) * a.Lp + q0;
  bulk_load(st + ST_LSE, a.lse + row, BQ * 4, fb);
  bulk_load(st + ST_DELTA, a.delta + row, BQ * 4, fb);
  bulk_load(st + ST_SEG, a.seg + (int64_t)b * a.Lp + q0, BQ * 4, fb);
}

template <bool TWO_PASS>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_bwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_do,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v, const Args a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t sbase = smem_u32(smem);
  const uint32_t bar_full = sbase + OFF_BAR;         // [STAGES]: 1 arrival + the bytes
  const uint32_t bar_empty = bar_full + 8 * STAGES;  // [STAGES]: one arrival per warp
  const uint32_t bar_kv = bar_empty + 8 * STAGES;    // K, V and their segment ids
  int* range_s = reinterpret_cast<int*>(smem + OFF_RANGE);

  const int ratio = a.Hq / a.Hkv;
  const int heads = TWO_PASS ? a.Hq : a.Hkv;  // the output's heads
  const int per_tile = heads * a.B;
  const int kt = (int)(blockIdx.x / per_tile);  // longest first: k tile 0 walks every q tile
  const int ho = (int)(blockIdx.x % per_tile) % heads;
  const int b = (int)(blockIdx.x % per_tile) / heads;
  const int g = TWO_PASS ? ho / ratio : ho;  // the kv head
  const int h_first = TWO_PASS ? ho : g * ratio;
  const int n_heads = TWO_PASS ? 1 : ratio;  // q heads this CTA walks
  const int k0 = kt * BK;
  const int nq = a.Lp / BQ;
  const int wg = threadIdx.x / 128;  // key rows [64 wg, 64 wg + 64) of the k tile
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;

  // the k tile's documents: segment id range, and its one id if it holds a
  // single document and no padding
  const int4* tiles = a.tiles + (int64_t)b * nq;
  const int4 t0 = tiles[2 * kt], t1 = tiles[2 * kt + 1];
  const int kmin = min(t0.x, t1.x), kmax = max(t0.y, t1.y);
  const int kuni = t0.z == t1.z ? t0.z : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, NTHREADS / 32);
    }
    mbar_init(bar_kv, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_expect_tx(bar_kv, KV_TX);
    for (int half = 0; half < 2; ++half) {
      tma_load(sbase + OFF_K + half * HALF_K, &tm_k, bar_kv, 64 * half, g, k0, b);
      tma_load(sbase + OFF_V + half * HALF_K, &tm_v, bar_kv, 64 * half, g, k0, b);
    }
    bulk_load(sbase + OFF_KSEG, a.seg + (int64_t)b * a.Lp + k0, BK * 4, bar_kv);
  }
  if (warp == 0 && wg == 0) {
    // the q tiles to walk: from the diagonal to the last tile whose segment
    // range meets the k tile's (the end of its last document), found 32
    // tiles at a time from the end of the row
    int last = -1;
    if (kmax != 0) {
      for (int base = nq - 32;; base -= 32) {
        const int j = base + lane;
        bool ok = false;
        if (j >= 2 * kt) {
          const int4 t = tiles[j];
          ok = t.y >= kmin && t.x <= kmax;
        }
        const uint32_t m = __ballot_sync(0xffffffffu, ok);
        if (m) {
          last = base + 31 - __clz(m);
          break;
        }
        if (base <= 2 * kt) break;
      }
    }
    // the first tile holds only padding or other documents when the k
    // tile's first key with a segment id sits in its second half
    const int first = (t0.y >= kmin && t0.x <= kmax) ? 2 * kt : 2 * kt + 1;
    if (lane == 0) {
      range_s[0] = first;
      range_s[1] = last >= first ? last - first + 1 : 0;
    }
  }
  __syncthreads();
  const int j_first = range_s[0], n_tiles = range_s[1];
  const int total = n_tiles * n_heads;  // (head, q tile) steps, head-major
  if (threadIdx.x == 0)
    for (int t = 0; t < STAGES && t < total; ++t)
      load_q_tile(&tm_q, &tm_do, a, sbase, bar_full, t, j_first + t % n_tiles,
                  h_first + t / n_tiles, b);

  const int tq = lane % 4;
  const int row0 = 16 * warp + lane / 4;  // this thread's rows: row0 and row0 + 8

  float acc_dk[64], acc_dv[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc_dk[i] = acc_dv[i] = 0.f;

  mbar_wait(bar_kv, 0);
  const int* kseg_s = reinterpret_cast<const int*>(smem + OFF_KSEG);
  int kseg[2], kpos[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    kseg[r] = kseg_s[64 * wg + row0 + 8 * r];
    kpos[r] = k0 + 64 * wg + row0 + 8 * r;
  }
  const uint32_t sK = sbase + OFF_K + wg * (64 * 128);  // this warpgroup's 64 key rows
  const uint32_t sV = sbase + OFF_V + wg * (64 * 128);
  const uint32_t sKd = sbase + OFF_K + wg * HALF_K;  // all keys, this warpgroup's dq columns

  for (int t = 0; t < total; ++t) {
    const int stage = t % STAGES;
    const int j = j_first + t % n_tiles, h = h_first + t / n_tiles;
    const int q0 = j * BQ;
    const int4 tj = tiles[j];
    const bool full = kuni != 0 && tj.z == kuni && j >= 2 * kt + 2;  // JAX _tile_full
    if (threadIdx.x == 0 && t >= 1 && t + STAGES - 1 < total) {
      // refill the stage step t - 1 used, once every warp has released it
      const int n = t + STAGES - 1;
      mbar_wait(bar_empty + 8 * (n % STAGES), ((t - 1) / STAGES) & 1);
      load_q_tile(&tm_q, &tm_do, a, sbase, bar_full, n % STAGES, j_first + n % n_tiles,
                  h_first + n / n_tiles, b);
    }
    mbar_wait(bar_full + 8 * stage, (t / STAGES) & 1);
    const unsigned char* st = smem + OFF_RING + stage * STAGE_BYTES;
    const uint32_t sQ = sbase + OFF_RING + stage * STAGE_BYTES + ST_Q;
    const uint32_t sDO = sbase + OFF_RING + stage * STAGE_BYTES + ST_DO;

    // S^T = K Q^T, dP^T = V dO^T (64 keys x 64 queries, over D); then P^T
    // and dS^T in registers
    uint32_t pa[16], da[16];
    {
      float s[32], dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t ko = (kk / 4) * HALF_K + (kk % 4) * 32;
        const uint32_t qo = (kk / 4) * HALF_Q + (kk % 4) * 32;
        wgmma_m64n64_ss<0, 0>(s, desc(sK + ko, 16, 1024), desc(sQ + qo, 16, 1024), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t ko = (kk / 4) * HALF_K + (kk % 4) * 32;
        const uint32_t qo = (kk / 4) * HALF_Q + (kk % 4) * 32;
        wgmma_m64n64_ss<0, 0>(dp, desc(sV + ko, 16, 1024), desc(sDO + qo, 16, 1024), kk > 0);
      }
      wg_commit();
      wg_wait0();
      reg_fence(s);
      reg_fence(dp);
      if (full)
        softmax_grad<false>(s, dp, pa, da, st, tq, q0, kseg, kpos, a.scale_log2e);
      else
        softmax_grad<true>(s, dp, pa, da, st, tq, q0, kseg, kpos, a.scale_log2e);
    }

    // dV += P^T dO, dK += dS^T Q (64 keys x 128, over the 64 queries)
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      wgmma_m64n128_rs<1>(acc_dv, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3],
                          desc(sDO + kk * 2048, HALF_Q, 1024));
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      wgmma_m64n128_rs<1>(acc_dk, da[4 * kk], da[4 * kk + 1], da[4 * kk + 2], da[4 * kk + 3],
                          desc(sQ + kk * 2048, HALF_Q, 1024));
    wg_commit();

    // dS^T to shared memory (128 keys x 64 queries, swizzled) for dQ; two
    // buffers, so that one barrier per step orders the warpgroups
    unsigned char* dsb = smem + OFF_DS + (t & 1) * DS_BYTES;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int R = 64 * wg + row0 + 8 * r;
        *reinterpret_cast<uint32_t*>(dsb + R * 128 + ((jj ^ (R & 7)) << 4) + 4 * tq) =
            da[2 * jj + r];
      }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    named_sync(1, NTHREADS);  // both halves of dS^T are written
    wg_wait0();
    reg_fence(acc_dv);
    reg_fence(acc_dk);
    reg_fence(pa);
    reg_fence(da);
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * stage);  // this warp is done with the stage

    // dQ (64 queries x this warpgroup's 64 columns) = dS K, over 128 keys
    float dq[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dq[i] = 0.f;
    const uint32_t sDS = sbase + OFF_DS + (t & 1) * DS_BYTES;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_m64n64_ss<1, 1>(dq, desc(sDS + kk * 2048, HALF_Q, 1024),
                            desc(sKd + kk * 2048, HALF_K, 1024), kk > 0);
    wg_commit();
    wg_wait0();
    reg_fence(dq);

    // dQ * scale into the f32 accumulator by one bulk reduce-add per
    // warpgroup: its 16 KB block for (b, h, q tile, warpgroup) holds the
    // accumulator fragments as the threads hold them ([warp][j][lane][4]),
    // which the wrapper puts back in (B, L, Hq, D) order
    float* stg = reinterpret_cast<float*>(smem + OFF_STG + wg * STG_BYTES);
    if (threadIdx.x % 128 == 0)  // the last step's reduce has read the staging block
      asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    named_sync(2 + wg, 128);
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
      *reinterpret_cast<float4*>(stg + ((warp * 8 + jj) * 32 + lane) * 4) =
          make_float4(dq[4 * jj] * a.scale, dq[4 * jj + 1] * a.scale, dq[4 * jj + 2] * a.scale,
                      dq[4 * jj + 3] * a.scale);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    named_sync(2 + wg, 128);
    if (threadIdx.x % 128 == 0)
      bulk_reduce_add(a.dq_acc + ((((int64_t)b * a.Hq + h) * nq + j) * 2 + wg) * 4096,
                      smem_u32(stg), STG_BYTES);
  }
  if (threadIdx.x % 128 == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");

  // dK (times scale) and dV, each row written once
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + 64 * wg + row0 + 8 * r;
    if (key < a.L) {
      const int64_t o = (((int64_t)b * a.L + key) * heads + ho) * D + 2 * tq;
#pragma unroll
      for (int jj = 0; jj < D / 8; ++jj) {
        *reinterpret_cast<uint32_t*>(a.dk + o + 8 * jj) =
            pack_bf16(acc_dk[4 * jj + 2 * r] * a.scale, acc_dk[4 * jj + 2 * r + 1] * a.scale);
        *reinterpret_cast<uint32_t*>(a.dv + o + 8 * jj) =
            pack_bf16(acc_dv[4 * jj + 2 * r], acc_dv[4 * jj + 2 * r + 1]);
      }
    }
  }
}


template <bool TWO_PASS>
int launch(const void* q, const void* k, const void* v, const void* dout, const Args& a,
           cudaStream_t stream) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap tm_q, tm_do, tm_k, tm_v;
  if (!make_map(&tm_q, encode, q, a.B, a.L, a.Hq, BQ) ||
      !make_map(&tm_do, encode, dout, a.B, a.L, a.Hq, BQ) ||
      !make_map(&tm_k, encode, k, a.B, a.L, a.Hkv, BK) ||
      !make_map(&tm_v, encode, v, a.B, a.L, a.Hkv, BK))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_kernel<TWO_PASS>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  const unsigned grid = (unsigned)(a.Lp / BK) * (TWO_PASS ? a.Hq : a.Hkv) * a.B;
  flash_bwd_kernel<TWO_PASS><<<grid, NTHREADS, SMEM_BYTES, stream>>>(tm_q, tm_do, tm_k, tm_v, a);
  return (int)cudaGetLastError();
}


// ---------------------------- (D, DV) = (192, 128), (64, 64) and (256, 256)
// MLA's head dims, gpt-oss's and Qwen3.5's. The one pass above would hold dK as 64 x
// 192 f32 per warpgroup (32 registers a thread more than its 255) and need
// ~290 KB of shared memory, so the backward at 192/128 is two kernels in
// the layout of csrc/block_sparse.cu's backward (#15), with the dense
// causal walks of the pass above over 64-row tiles; the same two templates
// run gpt-oss's 64/64, whose sliding window of 128 they take as JAX's
// _tile_mask / _tile_full do (flash.py:57-80):
// - the dq walk starts at the key tile that holds the first key the CTA's
//   first row sees (q0 - window + 1), and a half runs a tile only if its
//   last key is inside the window of the half's first row;
// - the dk/dv walk of a key tile ends at the last q tile whose first row
//   still sees the tile's last key (q <= k0 + 63 + window - 1);
// - a tile is full (no per-element mask) only if every pair is inside the
//   window too; the masked ones add l - m < window to the mask.
// Each kernel is instantiated with and without these terms (WINDOW); the
// wrapper launches the windowed one only for a window shorter than the
// padded row, so a full layer runs the code it ran before the window.
// - flash_dq_kernel (#2): the forward's CTAs (128 q rows, q head, batch
//   row), Q and dO of the 128 rows resident; 64-key tiles of K and V from
//   the first whose segment range meets the rows' up to the diagonal,
//   through two rings (V one stage shorter: free once dP is done; K held
//   until dQ's product); per tile S = Q K^T and dP = dO V^T on m64n64k16
//   SS, dS in registers (the per-element mask only where a half's rows and
//   the tile are not one document below the diagonal), dQ += dS K on
//   m64n64k16 RS; dQ (64 x D f32 a warpgroup) written once, times scale, as
//   bf16 by TMA stores. Each ring stage carries its item (key tile, the
//   halves that run it, the halves that skip the mask), so the consumers
//   keep no walk state.
// - flash_dkv_kernel (#3 grouped, #4 two-pass): one CTA per (64-key tile,
//   kv head or q head, batch row), K and V resident; for each q head of the
//   group (one when two-pass) the q tiles from the key tile's diagonal to
//   the last whose segment range meets it, Q, dO, lse, delta and segment
//   ids through a ring. The warpgroups split by output: warpgroup 0 S^T =
//   K Q^T, P^T (to a shared f32 buffer, handed over by named barriers) and
//   dV += P^T dO (64 x 128 f32); warpgroup 1 dP^T = V dO^T, dS^T = P^T
//   (dP^T - delta) and dK += dS^T Q (64 x 192 f32).
// The dq pass after its prologue and the two dk/dv roles are
// attn_bwd64.cuh's, shared with #15: the kernels here own only their walks.
// Every output is written once, so two launches give the same bits, dq
// included. ptxas (nvcc -Xptxas -v, sm_90a, CUDA 12.9) at 192/128 without
// the window, 0 bytes of spills in each: flash_dq_kernel 234 registers,
// 230,600 bytes of dynamic shared memory (4 K and 3 V stages);
// flash_dkv_kernel 210 (grouped) and 212 (two-pass) registers, 225,432
// bytes (4 stages). At 64/64 the rings keep the same stage counts in less
// than half the bytes (DqSmem / DkvSmem size them from TILE_CAP).
// At 256/256 (Qwen3.5's gated attention, no window: the wrapper and the C
// entry refuse one) the same templates run with WINDOW = false only. Q and
// dO resident take 128 KB of the dq CTA, which leaves one V and two K
// stages (230,504 bytes): the producer loads the next V only once dP of
// the current tile is done, so the dq pass is serialised there. dQ is 64 x
// 256 f32 a warpgroup, 128 registers a thread before S and dP, as in
// block_sparse.cu's bs_dq_kernel at the same dims (253 registers). The
// dk/dv CTA keeps K and V (64 KB) and a 2-stage ring (215,640 bytes), the
// warpgroups split by output as above (dV and dK 64 x 256 f32 each).
// Non-causal at 64/64 (CAUSAL = false, no window): the dq walk ends at the
// last key tile that meets either half's segment range, found by warp 0's
// ballots from the end of the row; the dk/dv walk runs from the first q
// tile that meets the key tile's range (ballots from the start) to the
// last, for each head of the group, so both walks cross the diagonal; a
// tile whose rows and keys are one document skips the mask, the diagonal
// tile too. The causal instantiations compile as before.
// Non-causal at 72/72 (Qwen3-VL-8B's tower of 16 heads of 72): the 128/128
// instantiation of both kernels over tensors of 72 columns (DG = DVG = 72),
// read and written in place. Q, dO, K and V arrive as two 64-column boxes
// each, the second at column 64, its columns 72-127 zero-filled by TMA
// (the transaction counts the whole box); S = Q K^T, S^T = K Q^T and dP /
// dP^T = dO V^T run k16(72) = 80 deep, 5 k16 steps; dQ, dK and dV keep
// 64 x 128 f32 accumulators, whose columns 72-127 come out zero (K, Q and
// dO are zero there) and are never stored: dQ's TMA store writes nothing
// past the tensor's edge, and dK / dV store only 72 columns
// (`store_keys<128, ..., 72>`). Per visible pair 2 (80 + 80 + 3 x 128)
// flops for 2 (5 x 72) useful: 1.51 times the work, no padded copy.
// chip_smoke.py's build phase prints every instantiation's registers,
// spills and shared memory.

constexpr int T64 = 64;                     // rows of a key or q tile
constexpr uint32_t TILE_CAP = 225 * 1024;   // tiles of a CTA; the rest: barriers, slack

constexpr uint32_t tile_bytes(int rows, int cols) { return (uint32_t)rows * cols * 2; }

__device__ __forceinline__ bool meets4(int4 a, int4 c) { return a.y >= c.x && a.x <= c.y; }

template <int D, int DV>
struct DqSmem {
  static constexpr uint32_t QB = tile_bytes(2 * T64, D), OB = tile_bytes(2 * T64, DV);
  static constexpr uint32_t KB = tile_bytes(T64, D), VB = tile_bytes(T64, DV);
  static constexpr int PAIRS = (TILE_CAP - QB - OB) / (KB + VB);
  static constexpr int SV = PAIRS < 1 ? 1 : (PAIRS > 3 ? 3 : PAIRS);  // V stages
  static constexpr int SK = SV + 1;  // K stages: K is held until dQ's product
  static constexpr uint32_t OFF_DO = QB;
  static constexpr uint32_t OFF_K = OFF_DO + OB;
  static constexpr uint32_t OFF_V = OFF_K + SK * KB;
  static constexpr uint32_t OFF_META = OFF_V + SV * VB;  // an int4 item per K stage
  static constexpr uint32_t OFF_FIRST = OFF_META + 16 * SK;
  static constexpr uint32_t OFF_BAR = OFF_FIRST + 16;
  // K full, K empty [SK]; V full, V empty [SV]; Q and dO
  static constexpr uint32_t BYTES = OFF_BAR + 8 * (2 * SK + 2 * SV + 1) + 1024;
  static_assert(OFF_META <= TILE_CAP && BYTES <= 232448, "fits one SM");
};

// the dq walk's next item from key tile kt up to the CTA's last (2 i + 1,
// or the last that meets either half when not CAUSAL), as dq_body reads it:
// {key tile, 0 or -1 for each half (runs it or not), full bits (bit x:
// half x skips the mask)}; x = -1 at the end. Half x (q tile 2 i + x, table
// entry qt[x]) runs a tile at or below its diagonal (any tile when not
// CAUSAL) whose segment range meets its own and, with WINDOW, whose last
// key is inside the window of the half's first row
template <bool WINDOW, bool CAUSAL>
__device__ __forceinline__ int4 dq_next(const int4* tiles, int kt, int last, int i,
                                        const int4 (&qt)[2], int win) {
  for (; kt <= last; ++kt) {
    const int4 k = tiles[kt];
    int run[2], full = 0;
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int r0 = T64 * (2 * i + x);  // the half's first row
      run[x] = (!CAUSAL || kt <= 2 * i + x) && meets4(k, qt[x]) &&
                       (!WINDOW || T64 * kt + T64 - 1 > r0 - win)
                   ? 0
                   : -1;
      if (run[x] == 0 && (!CAUSAL || kt < 2 * i + x) && qt[x].z != 0 && k.z == qt[x].z &&
          (!WINDOW || r0 + T64 - 1 - T64 * kt < win))
        full |= 1 << x;  // JAX _tile_full
    }
    if (run[0] == 0 || run[1] == 0) return make_int4(kt, run[0], run[1], full);
  }
  return make_int4(-1, -1, -1, 0);
}

// item `it` into K stage `stage` (the end marker: a bare arrival)
template <int D, int DV>
__device__ __forceinline__ void dq_load_k(int4 it, int4* meta, int stage, uint32_t sbase,
                                          uint32_t kf, const CUtensorMap* tm_k, int g, int b) {
  using C = DqSmem<D, DV>;
  const uint32_t bar = kf + 8 * stage;
  meta[stage] = it;
  if (it.x < 0) {
    mbar_arrive(bar);
    return;
  }
  mbar_expect_tx(bar, C::KB);
  for (int c = 0; c < D / 64; ++c)
    tma_load(sbase + C::OFF_K + stage * C::KB + c * BOX64, tm_k, bar, 64 * c, g, it.x * T64, b);
}

// V of item n (already in the K stream) into V stage n % SV
template <int D, int DV>
__device__ __forceinline__ void dq_load_v(const int4* meta, int n, uint32_t sbase, uint32_t vf,
                                          const CUtensorMap* tm_v, int g, int b) {
  using C = DqSmem<D, DV>;
  const int stage = n % C::SV;
  const uint32_t bar = vf + 8 * stage;
  const int k0 = meta[n % C::SK].x * T64;
  mbar_expect_tx(bar, C::VB);
  for (int c = 0; c < DV / 64; ++c)
    tma_load(sbase + C::OFF_V + stage * C::VB + c * BOX64, tm_v, bar, 64 * c, g, k0, b);
}

// DG, DVG: the columns of q / k / dq and of v / do (the tile widths D, DV,
// or fewer: head dim 72 on 128-column tiles)
template <int D, int DV, bool WINDOW, bool CAUSAL, int DG, int DVG>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_dq_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_do,
                const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
                const __grid_constant__ CUtensorMap tm_dq, const Args a) {
  using C = DqSmem<D, DV>;
  constexpr int SK = C::SK, SV = C::SV;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const uint32_t sbase = smem_u32(smem);
  const uint32_t kf = sbase + C::OFF_BAR;  // [SK]: 1 arrival + the bytes
  const uint32_t ke = kf + 8 * SK;         // [SK]: one arrival per warp
  const uint32_t vf = ke + 8 * SK;         // [SV]: 1 arrival + the bytes
  const uint32_t ve = vf + 8 * SV;         // [SV]: one arrival per warp
  const uint32_t bar_q = ve + 8 * SV;
  int4* meta = reinterpret_cast<int4*>(smem + C::OFF_META);
  int* first_s = reinterpret_cast<int*>(smem + C::OFF_FIRST);

  // grid order: q tile innermost (last first: the longest walks start
  // first), then the q heads of a kv group, the batch row, the kv head
  const int ratio = a.Hq / a.Hkv, nqt = a.Lp / (2 * T64);
  int x = (int)blockIdx.x;
  const int i = nqt - 1 - x % nqt;
  x /= nqt;
  const int hr = x % ratio;
  x /= ratio;
  const int b = x % a.B, g = x / a.B, h = g * ratio + hr;
  const int q0 = 2 * T64 * i;
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int tq = lane % 4, row0 = 16 * warp + lane / 4;
  const int4* tiles = a.tiles + (int64_t)b * (a.Lp / T64);
  const int4 qt[2] = {tiles[2 * i], tiles[2 * i + 1]};

  if (threadIdx.x == 0) {
    for (int s = 0; s < SK; ++s) {
      mbar_init(kf + 8 * s, 1);
      mbar_init(ke + 8 * s, NTHREADS / 32);
    }
    for (int s = 0; s < SV; ++s) {
      mbar_init(vf + 8 * s, 1);
      mbar_init(ve + 8 * s, NTHREADS / 32);
    }
    mbar_init(bar_q, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_expect_tx(bar_q, C::QB + C::OB);
    for (int c = 0; c < D / 64; ++c)
      tma_load(sbase + c * 2 * BOX64, &tm_q, bar_q, 64 * c, h, q0, b);
    for (int c = 0; c < DV / 64; ++c)
      tma_load(sbase + C::OFF_DO + c * 2 * BOX64, &tm_do, bar_q, 64 * c, h, q0, b);
  }
  if (threadIdx.x < 32) {
    // the last key tile to walk: the diagonal's, or (not causal) the last
    // that meets either half, 32 at a time from the end of the row
    int last = 2 * i + 1;
    if constexpr (!CAUSAL) {
      last = -1;
      for (int base = a.Lp / T64 - 32;; base -= 32) {
        const int j = base + lane;
        const uint32_t m = __ballot_sync(
            0xffffffffu, j >= 0 && (meets4(tiles[j], qt[0]) || meets4(tiles[j], qt[1])));
        if (m) {
          last = base + 31 - __clz(m);
          break;
        }
        if (base <= 0) break;
      }
    }
    // the first key tile that meets either half, 32 at a time from the one
    // that holds the first key the CTA's first row sees in the window
    int first = last + 1;
    for (int base = WINDOW ? max(0, (q0 - a.window + 1) / T64) : 0; base <= last; base += 32) {
      const int j = base + lane;
      bool ok = false;
      if (j <= last) {
        const int4 k = tiles[j];
        ok = meets4(k, qt[0]) || meets4(k, qt[1]);
      }
      const unsigned hit = __ballot_sync(0xffffffffu, ok);
      if (hit) {
        first = base + __ffs(hit) - 1;
        break;
      }
    }
    if (lane == 0) {
      first_s[0] = first;
      if constexpr (!CAUSAL) first_s[1] = last;
    }
  }
  __syncthreads();  // barriers initialised, the first tile found
  // thread 0's walk: the next key tile to consider, items in the K stream
  const int last = CAUSAL ? 2 * i + 1 : first_s[1];
  int kn = first_s[0], produced = 0;
  bool done = false;
  auto load_next_k = [&](int stage) {
    const int4 it = dq_next<WINDOW, CAUSAL>(tiles, kn, last, i, qt, a.window);
    dq_load_k<D, DV>(it, meta, stage, sbase, kf, &tm_k, g, b);
    done = it.x < 0;
    if (!done) kn = it.x + 1, ++produced;
  };
  auto refill_k = [&](int stage, uint32_t parity) {
    if (done) return;
    mbar_wait(ke + 8 * stage, parity);
    load_next_k(stage);
  };
  auto refill_v = [&](int t) {
    if (t + SV >= produced) return;
    mbar_wait(ve + 8 * (t % SV), (t / SV) & 1);
    dq_load_v<D, DV>(meta, t + SV, sbase, vf, &tm_v, g, b);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < SK && !done; ++s) load_next_k(s);
    for (int n = 0; n < SV && n < produced; ++n)
      dq_load_v<D, DV>(meta, n, sbase, vf, &tm_v, g, b);
  }

  const int* seg = a.seg + (int64_t)b * a.Lp;
  int qpos[2], qs[2];
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    qpos[r] = q0 + 64 * wg + row0 + 8 * r;
    const int64_t o = ((int64_t)b * a.Hq + h) * a.Lp + qpos[r];
    qs[r] = seg[qpos[r]];
    lse2[r] = a.lse[o] * LOG2E;
    dl[r] = a.delta[o];
  }
  dq_body<D, DV, C, WINDOW, CAUSAL, k16(DG), k16(DVG)>(
      smem, sbase, kf, ke, vf, ve, bar_q, meta, refill_k, refill_v, seg, qs, qpos, lse2, dl,
      a.scale_log2e, a.scale, &tm_dq, h, q0, b, a.L, a.window);
}

template <int D, int DV>
struct DkvSmem {
  static constexpr uint32_t KB = tile_bytes(T64, D), VB = tile_bytes(T64, DV);
  static constexpr uint32_t SB = KB + VB;          // a stage's Q and dO tiles
  static constexpr uint32_t RB = 3 * T64 * 4;      // its lse, delta, segment ids
  static constexpr uint32_t PB = T64 * T64 * 4;    // P^T, f32, fragment order
  static constexpr int FIT = (TILE_CAP - KB - VB - PB) / (SB + RB);
  static constexpr int STAGES = FIT > 4 ? 4 : FIT;
  static constexpr uint32_t OFF_V = KB;
  static constexpr uint32_t OFF_RING = KB + VB;
  static constexpr uint32_t OFF_ROWS = OFF_RING + STAGES * SB;
  static constexpr uint32_t OFF_P = OFF_ROWS + STAGES * RB;
  static constexpr uint32_t OFF_META = OFF_P + PB;  // an int4 item per stage
  static constexpr uint32_t OFF_LAST = OFF_META + 16 * STAGES;
  static constexpr uint32_t OFF_BAR = OFF_LAST + 16;
  // full, empty [STAGES]; K and V
  static constexpr uint32_t BYTES = OFF_BAR + 8 * (2 * STAGES + 1) + 1024;
  static_assert(STAGES >= 2 && BYTES <= 232448, "fits one SM");
};

// thread 0's walk of one dk/dv CTA: for each of n_heads q heads from
// h_first, the q tiles from `first` (the key tile kt, or when not causal
// the first q tile that meets it) to `last` (inside the window) whose
// segment range meets the key tile's (kt4)
struct KvWalk {
  const int4* tiles;
  int4 kt4;
  int kt, first, last, h_first, n_heads, win;
  int q, r;  // the next q tile, the head index
  bool done;
};

// the next item: {q tile, q head, full, 0}; x = -1 at the end
template <bool WINDOW, bool CAUSAL>
__device__ __forceinline__ int4 kv_next(KvWalk& w) {
  while (w.r < w.n_heads) {
    if (w.q > w.last) {
      w.q = w.first;
      ++w.r;
      continue;
    }
    const int j = w.q++;
    const int4 t = w.tiles[j];
    if (!meets4(t, w.kt4)) continue;
    const int full = (!CAUSAL || j > w.kt) && w.kt4.z != 0 && t.z == w.kt4.z &&
                     (!WINDOW || T64 * (j - w.kt) + T64 - 1 < w.win);  // JAX _tile_full
    return make_int4(j, w.h_first + w.r, full, 0);
  }
  return make_int4(-1, -1, 0, 0);
}

// the walk's next item into ring stage `stage`: Q and dO by TMA, lse,
// delta and the segment ids by bulk copy (the end marker: a bare arrival)
template <int D, int DV, bool WINDOW, bool CAUSAL>
__device__ __forceinline__ void kv_produce(KvWalk& w, int4* meta, int stage, uint32_t sbase,
                                           uint32_t bar_full, const CUtensorMap* tm_q,
                                           const CUtensorMap* tm_do, const Args& a, int b) {
  using C = DkvSmem<D, DV>;
  const int4 it = kv_next<WINDOW, CAUSAL>(w);
  const uint32_t bar = bar_full + 8 * stage;
  meta[stage] = it;
  if (it.x < 0) {
    w.done = true;
    mbar_arrive(bar);
    return;
  }
  const int q0 = it.x * T64, h = it.y;
  const uint32_t st = sbase + C::OFF_RING + stage * C::SB;
  const uint32_t rows = sbase + C::OFF_ROWS + stage * C::RB;
  mbar_expect_tx(bar, C::SB + C::RB);
  for (int c = 0; c < D / 64; ++c) tma_load(st + c * BOX64, tm_q, bar, 64 * c, h, q0, b);
  for (int c = 0; c < DV / 64; ++c)
    tma_load(st + C::KB + c * BOX64, tm_do, bar, 64 * c, h, q0, b);
  const int64_t o = ((int64_t)b * a.Hq + h) * a.Lp + q0;
  bulk_load(rows, a.lse + o, T64 * 4, bar);
  bulk_load(rows + T64 * 4, a.delta + o, T64 * 4, bar);
  bulk_load(rows + 2 * T64 * 4, a.seg + (int64_t)b * a.Lp + q0, T64 * 4, bar);
}

template <int D, int DV, bool TWO_PASS, bool WINDOW, bool CAUSAL, int DG, int DVG>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_dkv_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_do,
                 const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
                 const Args a) {
  using C = DkvSmem<D, DV>;
  constexpr int ST = C::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const uint32_t sbase = smem_u32(smem);
  const uint32_t bar_full = sbase + C::OFF_BAR;  // [ST]: 1 arrival + the bytes
  const uint32_t bar_empty = bar_full + 8 * ST;  // [ST]: one arrival per warp
  const uint32_t bar_kv = bar_empty + 8 * ST;
  int4* meta = reinterpret_cast<int4*>(smem + C::OFF_META);
  int* last_s = reinterpret_cast<int*>(smem + C::OFF_LAST);

  // key tile innermost (ascending: key tile 0 has the longest walk), then
  // the output's head, the batch row
  const int ratio = a.Hq / a.Hkv;
  const int heads = TWO_PASS ? a.Hq : a.Hkv;
  const int nkt = a.Lp / T64;
  const int kt = (int)blockIdx.x % nkt;
  const int ho = (int)(blockIdx.x / nkt) % heads;
  const int b = (int)(blockIdx.x / nkt) / heads;
  const int g = TWO_PASS ? ho / ratio : ho;  // the kv head
  const int k0 = kt * T64;
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int tq = lane % 4, row0 = 16 * warp + lane / 4;
  const int4* tiles = a.tiles + (int64_t)b * nkt;
  const int4 kt4 = tiles[kt];

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, NTHREADS / 32);
    }
    mbar_init(bar_kv, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_expect_tx(bar_kv, C::KB + C::VB);
    for (int c = 0; c < D / 64; ++c) tma_load(sbase + c * BOX64, &tm_k, bar_kv, 64 * c, g, k0, b);
    for (int c = 0; c < DV / 64; ++c)
      tma_load(sbase + C::OFF_V + c * BOX64, &tm_v, bar_kv, 64 * c, g, k0, b);
  }
  if (threadIdx.x < 32) {
    // the last q tile whose segment range meets the key tile's (the end of
    // its last document) and whose first row still sees the tile's last key
    // in the window (q tile jw), 32 tiles at a time from there down
    const int lo = CAUSAL ? kt : 0;  // the first q tile that may see the key tile
    int last = -1, first = kt;
    const int jw = WINDOW ? (k0 + T64 - 2 + a.window) / T64 : nkt;
    if (kt4.y != 0) {
      for (int base = min(nkt, jw + 1) - 32;; base -= 32) {
        const int j = base + lane;
        const bool ok = j >= lo && (!WINDOW || j <= jw) && meets4(tiles[j], kt4);
        const uint32_t m = __ballot_sync(0xffffffffu, ok);
        if (m) {
          last = base + 31 - __clz(m);
          break;
        }
        if (base <= lo) break;
      }
    }
    if constexpr (!CAUSAL) {  // the first q tile that meets it, 32 at a time from 0
      first = last + 1;
      for (int base = 0; base <= last; base += 32) {
        const int j = base + lane;
        const uint32_t m = __ballot_sync(0xffffffffu, j <= last && meets4(tiles[j], kt4));
        if (m) {
          first = base + __ffs(m) - 1;
          break;
        }
      }
    }
    if (lane == 0) {
      last_s[0] = last;
      if constexpr (!CAUSAL) last_s[1] = first;
    }
  }
  const int* seg = a.seg + (int64_t)b * a.Lp;
  int kseg[2], kpos[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    kpos[r] = k0 + row0 + 8 * r;
    kseg[r] = seg[kpos[r]];
  }
  __syncthreads();  // barriers initialised, the walk's range found
  const int q_first = CAUSAL ? kt : last_s[1];
  KvWalk walk{tiles, kt4, kt, q_first, last_s[0], TWO_PASS ? ho : g * ratio,
              TWO_PASS ? 1 : ratio, a.window, q_first, 0, false};
  if (threadIdx.x == 0)
    for (int s = 0; s < ST && !walk.done; ++s)
      kv_produce<D, DV, WINDOW, CAUSAL>(walk, meta, s, sbase, bar_full, &tm_q, &tm_do, a, b);
  mbar_wait(bar_kv, 0);
  if (wg == 0) {
    auto refill = [&](int stage, uint32_t parity) {
      if (walk.done) return;
      mbar_wait(bar_empty + 8 * stage, parity);
      kv_produce<D, DV, WINDOW, CAUSAL>(walk, meta, stage, sbase, bar_full, &tm_q, &tm_do, a,
                                        b);
    };
    dkv_p_role<D, DV, C, true, WINDOW, CAUSAL, k16(DG), DVG>(
        smem, sbase, bar_full, bar_empty, meta, refill, a, b, ho, heads, k0, kseg, kpos, row0,
        tq, lane, a.window);
  } else {
    dkv_ds_role<D, DV, C, true, k16(DVG), DG>(smem, sbase, bar_full, bar_empty, meta, a, b, ho,
                                              heads, k0, row0, tq, lane);
  }
}

template <int D, int DV, bool TWO_PASS, bool WINDOW, bool CAUSAL = true, int DG = D,
          int DVG = DV>
int launch_split_w(const void* q, const void* k, const void* v, const void* dout, void* dq,
                   const Args& a, cudaStream_t stream) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap tq128, tdo128, tk, tv, tdq, tq64, tdo64;
  if (!make_map(&tq128, encode, q, a.B, a.L, a.Hq, 2 * T64, DG) ||
      !make_map(&tdo128, encode, dout, a.B, a.L, a.Hq, 2 * T64, DVG) ||
      !make_map(&tk, encode, k, a.B, a.L, a.Hkv, T64, DG) ||
      !make_map(&tv, encode, v, a.B, a.L, a.Hkv, T64, DVG) ||
      !make_map(&tdq, encode, dq, a.B, a.L, a.Hq, T64, DG) ||
      !make_map(&tq64, encode, q, a.B, a.L, a.Hq, T64, DG) ||
      !make_map(&tdo64, encode, dout, a.B, a.L, a.Hq, T64, DVG))
    return (int)cudaErrorInvalidValue;
  auto dq_kernel = flash_dq_kernel<D, DV, WINDOW, CAUSAL, DG, DVG>;
  auto dkv_kernel = flash_dkv_kernel<D, DV, TWO_PASS, WINDOW, CAUSAL, DG, DVG>;
  cudaError_t e = cudaFuncSetAttribute(dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)DqSmem<D, DV>::BYTES);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)DkvSmem<D, DV>::BYTES);
  if (e != cudaSuccess) return (int)e;
  dq_kernel<<<(unsigned)(a.Lp / (2 * T64)) * a.Hq * a.B, NTHREADS, DqSmem<D, DV>::BYTES,
              stream>>>(tq128, tdo128, tk, tv, tdq, a);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const unsigned grid = (unsigned)(a.Lp / T64) * (TWO_PASS ? a.Hq : a.Hkv) * a.B;
  dkv_kernel<<<grid, NTHREADS, DkvSmem<D, DV>::BYTES, stream>>>(tq64, tdo64, tk, tv, a);
  return (int)cudaGetLastError();
}

// the windowed instantiations only for a window shorter than the padded row
template <int D, int DV, bool TWO_PASS>
int launch_split(const void* q, const void* k, const void* v, const void* dout, void* dq,
                 const Args& a, cudaStream_t stream) {
  return a.window < a.Lp ? launch_split_w<D, DV, TWO_PASS, true>(q, k, v, dout, dq, a, stream)
                         : launch_split_w<D, DV, TWO_PASS, false>(q, k, v, dout, dq, a, stream);
}

}  // namespace

// q, do (B, L, Hq, d), k (B, L, Hkv, d), v (B, L, Hkv, dv) bf16, (d, dv) =
// (128, 128), (192, 128), (64, 64) or (256, 256); lse, delta (B, Hq, Lp),
// seg (B, Lp) and tiles (B, Lp / 64, 4) padded to Lp, a multiple of 128. At
// 128/128 dq is the f32 accumulator (zeroed by the caller), which gets dq *
// scale added; at the other pairs it is dq (B, L, Hq, d) bf16, written
// once. dk, dv: (B, L, Hkv, d / dv) summed over each q-head group (two_pass
// = 0), or (B, L, Hq, d / dv) per q head (two_pass = 1). window: key m
// counts for query l only if l - m < window (0: full; 128/128 and 256/256
// take none). causal: 0 for bidirectional attention within each document
// (64/64 and 72/72, no window only; 72/72 takes nothing else).
extern "C" int xt_flash_bwd_bf16(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse, const void* delta,
                                 const void* seg, const void* tiles, void* dq, void* dk,
                                 void* dv, int B, int L, int Lp, int Hq, int Hkv, int d,
                                 int dv_dim, float scale, int two_pass, int window,
                                 int causal, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || L <= 0 || B <= 0 || Lp % BK != 0 || Lp < L ||
      Lp - L >= BK || window < 0)
    return (int)cudaErrorInvalidValue;
  const bool nc_dims = (d == 64 && dv_dim == 64) || (d == 72 && dv_dim == 72);
  if (!causal && (!nc_dims || window > 0)) return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const float*>(lse), static_cast<const float*>(delta),
               static_cast<const int*>(seg), static_cast<const int4*>(tiles),
               static_cast<float*>(dq), static_cast<__nv_bfloat16*>(dk),
               static_cast<__nv_bfloat16*>(dv), B, L, Lp, Hq, Hkv, scale * LOG2E, scale,
               window > 0 && window < Lp ? window : Lp};
  cudaStream_t st = (cudaStream_t)stream;
  if (d == D && dv_dim == D) {
    if (window > 0) return (int)cudaErrorInvalidValue;
    return two_pass ? launch<true>(q, k, v, dout, a, st) : launch<false>(q, k, v, dout, a, st);
  }
  if (d == 192 && dv_dim == 128)
    return two_pass ? launch_split<192, 128, true>(q, k, v, dout, dq, a, st)
                    : launch_split<192, 128, false>(q, k, v, dout, dq, a, st);
  if (d == 64 && dv_dim == 64) {
    if (!causal)
      return two_pass ? launch_split_w<64, 64, true, false, false>(q, k, v, dout, dq, a, st)
                      : launch_split_w<64, 64, false, false, false>(q, k, v, dout, dq, a, st);
    return two_pass ? launch_split<64, 64, true>(q, k, v, dout, dq, a, st)
                    : launch_split<64, 64, false>(q, k, v, dout, dq, a, st);
  }
  if (d == 256 && dv_dim == 256) {  // no preset has a window at 256/256
    if (window > 0) return (int)cudaErrorInvalidValue;
    return two_pass ? launch_split_w<256, 256, true, false>(q, k, v, dout, dq, a, st)
                    : launch_split_w<256, 256, false, false>(q, k, v, dout, dq, a, st);
  }
  if (d == 72 && dv_dim == 72 && !causal)  // on 128-column tiles
    return two_pass
               ? launch_split_w<128, 128, true, false, false, 72, 72>(q, k, v, dout, dq, a, st)
               : launch_split_w<128, 128, false, false, false, 72, 72>(q, k, v, dout, dq, a, st);
  return (int)cudaErrorInvalidValue;
}

// the dynamic shared memory of one CTA (bytes): kernel 0 the one pass at
// 128/128, 1 flash_dq_kernel and 2 flash_dkv_kernel at 192/128, 64/64,
// 256/256 or 72/72 (on 128-column tiles);
// 0 for a pair the kernel is not built for
extern "C" int xt_flash_bwd_smem_bytes(int kernel, int d, int dv) {
  if (kernel == 0 && d == 128 && dv == 128) return (int)SMEM_BYTES;
  if (d == 192 && dv == 128)
    return kernel == 1 ? (int)DqSmem<192, 128>::BYTES
                       : (kernel == 2 ? (int)DkvSmem<192, 128>::BYTES : 0);
  if (d == 64 && dv == 64)
    return kernel == 1 ? (int)DqSmem<64, 64>::BYTES
                       : (kernel == 2 ? (int)DkvSmem<64, 64>::BYTES : 0);
  if (d == 256 && dv == 256)
    return kernel == 1 ? (int)DqSmem<256, 256>::BYTES
                       : (kernel == 2 ? (int)DkvSmem<256, 256>::BYTES : 0);
  if (d == 72 && dv == 72)
    return kernel == 1 ? (int)DqSmem<128, 128>::BYTES
                       : (kernel == 2 ? (int)DkvSmem<128, 128>::BYTES : 0);
  return 0;
}
