// The attention backward's 64-row-tile bodies shared by the block-sparse
// backward (block_sparse.cu, #15) and the flash backward at MLA's head dims
// (flash_bwd.cu, #2-#4 at 192/128), which walk different tiles through the
// same shared-memory layouts: the dq pass of a CTA of 128 q rows after its
// prologue, and the two warpgroup roles of a dk/dv CTA over one 64-key
// tile. The kernels keep their walks and hand them in as refill callbacks.
//
// A sliding window (the flash kernels' WINDOW instantiations: key m counts
// for query l only if l - m < window) joins the per-element masks here;
// the kernels' walks skip the tiles wholly outside it and mark as full
// only tiles wholly inside. The block-sparse kernels take no window, and
// their instantiations (WINDOW = false) compile to what they were without.
// Non-causal attention (the flash kernels' CAUSAL = false at 64/64 and at
// 72/72: key m counts for every query of its document) drops the position
// term of the masks; CAUSAL defaults to true, so #15 compiles as before. At
// head dim 72 the tiles are 128 columns wide (TMA zero-fills the columns
// past 72), the products over the head dim (S, dP) run KD / KDV = 80 deep
// and dK / dV store only the tensor's DG / DVG columns; every such argument
// defaults to the tile width, so the other instantiations are unchanged.
//
// A dk/dv CTA's layout C: K (D columns) at 0, V (DV) at C::OFF_V; ring stage
// s holds Q (C::KB bytes) then dO at C::OFF_RING + s C::SB, and the q rows'
// lse, delta and segment ids (64 each) at C::OFF_ROWS + s C::RB; P^T (64 x 64
// f32 in fragment order) at C::OFF_P. Each stage's item {q tile, q head,
// full (no per-element mask), 0} sits in meta[s]; x < 0 ends the walk.

#pragma once

#include "sm90.cuh"

namespace {

constexpr int PAIR_THREADS = 256;  // the two warpgroups of a CTA
constexpr int BAR_P_FULL = 1, BAR_P_EMPTY = 2;  // named barriers of the dk/dv roles
constexpr float BWD_LOG2E = 1.4426950408889634f;

// dS of one (64 q rows, 64 keys) tile from S and dP in the accumulator
// layout, packed to bf16 A fragments (with WINDOW, masked by the window too;
// without CAUSAL, not by position)
template <bool MASK, bool WINDOW = false, bool CAUSAL = true>
__device__ __forceinline__ void dq_grad(const float (&s)[32], const float (&dp)[32],
                                        uint32_t (&da)[16], float c, const float (&lse2)[2],
                                        const float (&dl)[2], const int* seg, int k0,
                                        const int (&qs)[2], const int (&qpos)[2], int tq,
                                        int window = 0) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float ds[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * j + e, r = e / 2, cc = e % 2;
      const float p = exp2f(fmaf(s[i], c, -lse2[r]));
      ds[e] = p * (dp[i] - dl[r]);
      if (MASK) {
        const int key = k0 + 8 * j + 2 * tq + cc;
        const bool ok = qs[r] != 0 && seg[key] == qs[r] && (!CAUSAL || key <= qpos[r]) &&
                        (!WINDOW || qpos[r] - key < window);
        ds[e] = ok ? ds[e] : 0.f;
      }
    }
    da[2 * j] = pack_bf16(ds[0], ds[1]);
    da[2 * j + 1] = pack_bf16(ds[2], ds[3]);
  }
}

// The dq pass of one CTA of 128 q rows (warpgroup wg: rows q0 + 64 wg..)
// once its prologue has issued the loads: each K stage carries its item
// {key tile, slot of half 0 or -1, slot of half 1 or -1, full bits (bit x:
// half x skips the per-element mask)}, x < 0 at the end. Per tile S = Q K^T
// and dP = dO V^T on m64n64k16 SS, dS in registers, dQ += dS K on RS (K the
// MN-major B); then dQ times scale to bf16 through the warpgroup's rows of
// the Q buffer and TMA stores to rows q0 + 64 wg.. of head h (none past L).
// Thread 0 refills the K stage the last step freed with refill_k(stage,
// parity of its empty barrier) and, once step t is done with V, its V
// stage with refill_v(t). Layout C: Q (128-row boxes) at 0, dO at C::OFF_DO,
// C::SK K stages at C::OFF_K, C::SV V stages at C::OFF_V. seg, qs, qpos,
// lse2 (base 2) and dl: the rows' segment ids (by key position), ids,
// positions, lse and delta; with WINDOW, `window` masks the items' tiles
// that are not full; without CAUSAL, no position does.
template <int D, int DV, typename C, bool WINDOW = false, bool CAUSAL = true, int KD = D,
          int KDV = DV, typename RefillK, typename RefillV>
__device__ __forceinline__ void dq_body(unsigned char* smem, uint32_t sbase, uint32_t kf,
                                        uint32_t ke, uint32_t vf, uint32_t ve, uint32_t bar_q,
                                        const int4* meta, RefillK&& refill_k,
                                        RefillV&& refill_v, const int* seg,
                                        const int (&qs)[2], const int (&qpos)[2],
                                        const float (&lse2)[2], const float (&dl)[2], float c,
                                        float scale, const CUtensorMap* tm_dq, int h, int q0,
                                        int b, int L, int window = 0) {
  constexpr int SK = C::SK, SV = C::SV;
  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32, tq = lane % 4;
  const int row0 = 16 * ((threadIdx.x % 128) / 32) + lane / 4;
  float dq[D / 64][32];
  uint32_t da[16];
#pragma unroll
  for (int n = 0; n < D / 64; ++n)
#pragma unroll
    for (int e = 0; e < 32; ++e) dq[n][e] = 0.f;
  const uint32_t sQ = sbase + wg * BOX64;  // this warpgroup's rows; boxes of 128 rows
  const uint32_t sDO = sbase + C::OFF_DO + wg * BOX64;
  mbar_wait(bar_q, 0);

  for (int t = 0;; ++t) {
    const int ks = t % SK, vs = t % SV;
    mbar_wait(kf + 8 * ks, (t / SK) & 1);
    const int4 it = meta[ks];
    if (it.x < 0) break;
    const bool run = (wg ? it.z : it.y) >= 0;
    const bool full = (it.w >> wg) & 1;
    const uint32_t sK = sbase + C::OFF_K + ks * C::KB;
    const uint32_t sV = sbase + C::OFF_V + vs * C::VB;
    float s[32], dp[32];
    if (run) {  // S = Q K^T
      wg_fence();
      ss_nt<KD>(s, sQ, 2 * BOX64, sK);
      wg_commit();
    }
    if (t > 0) {
      // the last tile's dQ product is done: release its K stage, and refill it
      if (run) wg_wait<1>();
      else wg_wait0();
      reg_fence(dq);
      reg_fence(da);
      const int prev = (t - 1) % SK;
      __syncwarp();
      if (lane == 0) mbar_arrive(ke + 8 * prev);
      if (threadIdx.x == 0) refill_k(prev, ((t - 1) / SK) & 1);
      __syncwarp();
    }
    // every warpgroup waits for V, run or not: a parity wait must not skip a
    // phase (with one V stage, the next tile's wait would pass on this
    // tile's parity while its load is still in flight)
    mbar_wait(vf + 8 * vs, (t / SV) & 1);
    if (run) {  // dP = dO V^T
      wg_fence();
      ss_nt<KDV>(dp, sDO, 2 * BOX64, sV);
      wg_commit();
      wg_wait0();
      reg_fence(s);
      reg_fence(dp);
    }
    // V of this tile is done with: release its stage for item t + SV
    __syncwarp();
    if (lane == 0) mbar_arrive(ve + 8 * vs);
    if (threadIdx.x == 0) refill_v(t);
    __syncwarp();
    if (!run) continue;
    if (full)
      dq_grad<false, WINDOW, CAUSAL>(s, dp, da, c, lse2, dl, seg, it.x * 64, qs, qpos, tq,
                                     window);
    else
      dq_grad<true, WINDOW, CAUSAL>(s, dp, da, c, lse2, dl, seg, it.x * 64, qs, qpos, tq,
                                    window);
    // dQ += dS K (64 q rows x D, over the 64 keys)
    wg_fence();
    acc_rs<D / 64>(dq, da, sK);
    wg_commit();
  }
  wg_wait0();
  reg_fence(dq);

  // dQ times scale to bf16 in this warpgroup's rows of the Q buffer, TMA stores
  const float mul[2] = {scale, scale};
  stage_rows<D / 64>(smem, dq, mul, wg, row0, tq);
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  named_sync(3 + wg, 128);
  if (threadIdx.x % 128 == 0 && q0 + 64 * wg < L) {
    for (int n = 0; n < D / 64; ++n)
      tma_store(tm_dq, sbase + n * 2 * BOX64 + wg * BOX64, 64 * n, h, q0 + 64 * wg, b);
    tma_store_commit();
    tma_store_wait();
  }
}

// warpgroup 0: S^T = K Q^T, P^T (masked) to the shared buffer, dV += P^T dO;
// thread 0 refills the stage the last step freed with refill(stage, parity
// of its empty barrier). dV goes to rows k0.. of head h of a (B, L, H, DV)
// tensor (with BOUNDED, none at or past L). With WINDOW, P^T of the items
// that are not full is masked by `window` too; without CAUSAL, not by position
template <int D, int DV, typename C, bool BOUNDED, bool WINDOW = false, bool CAUSAL = true,
          int KD = D, int DVG = DV, typename Args, typename Refill>
__device__ __forceinline__ void dkv_p_role(unsigned char* smem, uint32_t sbase,
                                           uint32_t bar_full, uint32_t bar_empty,
                                           const int4* meta, Refill&& refill, const Args& a,
                                           int b, int h, int H, int k0, const int (&kseg)[2],
                                           const int (&kpos)[2], int row0, int tq, int lane,
                                           int window = 0) {
  constexpr int ST = C::STAGES;
  float acc[DV / 64][32], s[32];
  uint32_t pa[16];
#pragma unroll
  for (int n = 0; n < DV / 64; ++n)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[n][e] = 0.f;
  float4* pbuf = reinterpret_cast<float4*>(smem + C::OFF_P) + threadIdx.x % 128;
  const float c = a.scale_log2e;
  for (int t = 0;; ++t) {
    const int stage = t % ST;
    mbar_wait(bar_full + 8 * stage, (t / ST) & 1);
    const int4 it = meta[stage];
    if (it.x < 0) break;
    const int q0 = it.x * 64;
    const uint32_t sQ = sbase + C::OFF_RING + stage * C::SB;
    const unsigned char* rows = smem + C::OFF_ROWS + stage * C::RB;
    wg_fence();
    ss_nt<KD>(s, sbase, BOX64, sQ);  // S^T = K Q^T (64 keys x 64 queries)
    wg_commit();
    if (t > 0) {
      wg_wait<1>();  // the last dV product is done
      reg_fence(acc);
      reg_fence(pa);
      const int prev = (t - 1) % ST;
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty + 8 * prev);
      if (threadIdx.x == 0) refill(prev, ((t - 1) / ST) & 1);
      __syncwarp();
    }
    wg_wait0();
    reg_fence(s);
    const float* lse_s = reinterpret_cast<const float*>(rows);
    const int* seg_s = reinterpret_cast<const int*>(rows + 2 * 64 * 4);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 8 * j + 2 * tq;
      const float2 l2 = *reinterpret_cast<const float2*>(lse_s + col);
      const int2 sq = *reinterpret_cast<const int2*>(seg_s + col);
      const float lb[2] = {l2.x * BWD_LOG2E, l2.y * BWD_LOG2E};
      const int qsg[2] = {sq.x, sq.y};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * j + e, r = e / 2, cc = e % 2;
        const float p = exp2f(fmaf(s[i], c, -lb[cc]));
        const bool ok = it.z || (kseg[r] != 0 && qsg[cc] == kseg[r] &&
                                 (!CAUSAL || kpos[r] <= q0 + col + cc) &&
                                 (!WINDOW || q0 + col + cc - kpos[r] < window));
        s[i] = ok ? p : 0.f;
      }
    }
    named_sync(BAR_P_EMPTY, PAIR_THREADS);  // warpgroup 1 has read the last P^T
#pragma unroll
    for (int j = 0; j < 8; ++j)
      pbuf[128 * j] = make_float4(s[4 * j], s[4 * j + 1], s[4 * j + 2], s[4 * j + 3]);
    named_arrive(BAR_P_FULL, PAIR_THREADS);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      pa[2 * j] = pack_bf16(s[4 * j], s[4 * j + 1]);
      pa[2 * j + 1] = pack_bf16(s[4 * j + 2], s[4 * j + 3]);
    }
    wg_fence();
    acc_rs<DV / 64>(acc, pa, sQ + C::KB);  // dV += P^T dO
    wg_commit();
  }
  wg_wait0();
  reg_fence(acc);
  named_sync(BAR_P_EMPTY, PAIR_THREADS);  // pairs warpgroup 1's last arrival
  store_keys<DV, BOUNDED, DVG>(a.dv, acc, 1.f, b, k0, h, a.L, H, row0, tq);
}

// warpgroup 1: dP^T = V dO^T, dS^T = P^T (dP^T - delta), dK += dS^T Q; dK
// times scale goes to rows k0.. of head h of a (B, L, H, D) tensor
template <int D, int DV, typename C, bool BOUNDED, int KDV = DV, int DG = D, typename Args>
__device__ __forceinline__ void dkv_ds_role(unsigned char* smem, uint32_t sbase,
                                            uint32_t bar_full, uint32_t bar_empty,
                                            const int4* meta, const Args& a, int b, int h, int H,
                                            int k0, int row0, int tq, int lane) {
  constexpr int ST = C::STAGES;
  float acc[D / 64][32], dp[32];
  uint32_t da[16];
#pragma unroll
  for (int n = 0; n < D / 64; ++n)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[n][e] = 0.f;
  const float4* pbuf = reinterpret_cast<const float4*>(smem + C::OFF_P) + threadIdx.x % 128;
  named_arrive(BAR_P_EMPTY, PAIR_THREADS);  // the P^T buffer starts free
  for (int t = 0;; ++t) {
    const int stage = t % ST;
    mbar_wait(bar_full + 8 * stage, (t / ST) & 1);
    const int4 it = meta[stage];
    if (it.x < 0) break;
    const uint32_t sQ = sbase + C::OFF_RING + stage * C::SB;
    const unsigned char* rows = smem + C::OFF_ROWS + stage * C::RB;
    wg_fence();
    ss_nt<KDV>(dp, sbase + C::OFF_V, BOX64, sQ + C::KB);  // dP^T = V dO^T
    wg_commit();
    if (t > 0) {
      wg_wait<1>();  // the last dK product is done
      reg_fence(acc);
      reg_fence(da);
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty + 8 * ((t - 1) % ST));
    }
    wg_wait0();
    reg_fence(dp);
    const float* delta_s = reinterpret_cast<const float*>(rows + 64 * 4);
    named_sync(BAR_P_FULL, PAIR_THREADS);  // warpgroup 0 wrote this tile's P^T
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4 p = pbuf[128 * j];
      const float2 dl = *reinterpret_cast<const float2*>(delta_s + 8 * j + 2 * tq);
      da[2 * j] = pack_bf16(p.x * (dp[4 * j] - dl.x), p.y * (dp[4 * j + 1] - dl.y));
      da[2 * j + 1] = pack_bf16(p.z * (dp[4 * j + 2] - dl.x), p.w * (dp[4 * j + 3] - dl.y));
    }
    named_arrive(BAR_P_EMPTY, PAIR_THREADS);
    wg_fence();
    acc_rs<D / 64>(acc, da, sQ);  // dK += dS^T Q
    wg_commit();
  }
  wg_wait0();
  reg_fence(acc);
  store_keys<D, BOUNDED, DG>(a.dk, acc, a.scale, b, k0, h, a.L, H, row0, tq);
}

}  // namespace
