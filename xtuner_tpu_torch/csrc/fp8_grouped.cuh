// Tile-wise fp8 GEMMs for Hopper (sm_90a): one persistent kernel on wgmma
// with a TMA ring and per-scale-tile promotion, for the MoE expert path's
// forward and dgrad (#12) and wgrad (#13), and for the attention
// projections' dense product (#11). Its C entries: fp8_grouped.cu (#12,
// #13) and fp8_gemm.cu (#11).
//
// Replaces three TPU kernels, two of xtuner_tpu/ops/fp8_grouped.py:
// - #12 _gg_kernel (pallas_call in fp8_grouped_gemm), forward and dgrad:
//     out[m, n] = sum_t (xq[m, t] . W[e(m)][t, n]) sx[m, t] sw[e(m), t, n / 128]
//   rows sorted by expert, e(m) the expert whose row range holds m (the
//   group sizes stay on the device); rows past the last group get zeros.
//   W[e] arrives K-major as wt (E, N, K).
// - #13 _dw_kernel (pallas_call in fp8_grouped_gemm_dw), the wgrad:
//     dW[e] = sum over the 128-row tiles r of (xq_r^T dyq_r) sx[r] sy[r]
//   over expert e's rows only (rows of other experts in a straddling tile
//   are zeroed before the product), f32, zero for an empty expert. Both
//   operands contract over rows and arrive row-contiguous in 128-row tiles:
//   xt (Mp/128, K, 128), yt (Mp/128, N, 128), Mp a 128 multiple.
// and xtuner_tpu/ops/fp8_gemm.py::_gemm_kernel (pallas_call in
// fp8_gemm_tilewise):
// - #11, the dense product (mode DENSE):
//     y[m, n] = sum_t (xq[m, t] . wq[t, n]) sx[m, t] sw[t, n / 128]
//   run as #12 with one group of all M rows, the group taken from M (no
//   group-size tensor, nothing allocated or copied per call); wq arrives
//   K-major as wt (N, K), in e4m3 or e5m2 (the e5m2 gradient's wgrad).
//
// What bounds them on the H100: at the moe_heavy step (M = 131072 routed
// rows, 16 experts, K, N in 768..1024) the forward and dgrad do 540-590 fp8
// operations per byte of operands and bf16 output, at the card's ridge
// (1,979 TFLOP/s over 3.35 TB/s = 590): bytes and operations bound them
// about equally; the wgrad (~730 per byte, E K N f32 out) is bound by its
// operations, and so are the attention projections (#11: M = 16384, K, N
// in 1024..2048, ~800 per byte).
//
// Design (the bf16 grouped kernel's, grouped_gemm.cu, with fp8 operands):
// - Products: wgmma m64n128k32 fp8 from 128-byte-swizzled shared memory,
//   both operands K-major (fp8 wgmma takes no transposed operand). One
//   swizzled 128-byte row holds 128 codes, one scale tile of depth, so a
//   ring stage is one scale step: A 128 x 128 codes and B 128 x 128, 32 KB,
//   four k32 products (+32 bytes per k-step in the descriptors).
// - Promotion per scale tile: each step's products go to a fresh f32
//   "part" (64 registers); after its wgmma wait the part is scaled and
//   added into the running f32 sum in registers (#12: part sx[row, t]
//   sw[e, t, nt], each thread holding two rows of the m64 layout; #13:
//   part sx[r] sy[r], one scalar). Raw products never run across scale
//   tiles, as in JAX's kernels (one dot per scale tile), and the fp8 tensor
//   cores' limited accumulation precision covers 128 products at most.
//   That precision shows against the plain version (f32 sums of the same
//   products): relative to the largest entry, 2.0e-4-2.7e-4 for #12 (f32
//   out) and 1.1e-4-1.6e-4 for #13, where the mma.sync kernel this one
//   replaced got 1.4e-6-1.8e-6 and 6.8e-7-7.2e-7, and a copy of this kernel
//   that promotes each k32 product alone gets 4.8e-5-5.8e-5 and
//   4.0e-5-4.9e-5 at 33-55% more time: the wgmma accumulation loses bits
//   both across the four k32 products of a step and inside one.
//   part and sum take 128 registers a thread, so the tile is 128 x 128
//   (n256 would need 256), two consumer warpgroups of 64 rows each, whose
//   steps interleave: one warpgroup's wait and promotion overlap the
//   other's products. The per-step wait and promotion cost 20-23% of #12
//   and 10-11% of #13 against a copy of this kernel that sums the raw
//   products across steps in one accumulator with one wgmma group in
//   flight (wrong numerics): 0.290-0.295 ms against 0.233 at K1024 N768,
//   0.318-0.324 against 0.248-0.249 at K768 N1024; #13 0.262-0.270
//   against 0.237-0.240. Two part buffers (the next step's products under
//   this step's promotion) need 192 registers: at 288 threads ptxas counts
//   three warpgroups and allows 168. (Both copies were one-off edits of the
//   main loop, timed by tools/bench_fp8_grouped_cuda.py on an H100 80GB
//   HBM3 at 700 W, M131072 E16, the sft_fp8 path's group sizes.)
// - A producer warp (warp 8; 288 threads, so ptxas may give the consumers
//   224 registers) issues every TMA load, STAGES steps ahead of the
//   products, across item boundaries; the consumer warps release a stage
//   by mbarrier as soon as their products have read it.
// - #12's work list (ops/bf16_grouped.py::grouped_tile_plan in plain
//   torch): each expert's rows cut into 128-row tiles that start at its
//   first row, so a tile never mixes experts; rows past the last group make
//   zero tiles, stored as zeros with no load and no product. Items are
//   (tile, 128-column N tile), expert-major, the N tile innermost, so CTAs
//   resident together read one expert's weights and the same x rows from
//   L2. Every CTA scans the group sizes in shared memory: no host work, no
//   extra launch. DENSE walks the same list with one group: M's 128-row
//   tiles, the N tile innermost, so the CTAs resident together share a
//   band of ~132 / (N / 128) row tiles of x and all of W in L2; the last
//   tile's rows past M read as zeros (TMA) and are not stored. The row
//   scales are read by each thread from sx (M, K/128) before the step's
//   wait, so their latency hides under it.
// - #12's epilogue: the warpgroup's 64 x 128 result through its staging
//   boxes in the swizzled layout; a warpgroup whose 64 rows all belong to
//   the expert stores them by TMA (asynchronous: the next item's products
//   start at once); the expert's last, partial rows go out by masked
//   16-byte stores, since a TMA store would overwrite the next expert's
//   rows, which another CTA owns.
// - #13's work list: items are (expert, 128-row K tile, 128-column N tile),
//   experts by falling row count, so the longest walks start first; each
//   item walks the global 128-row tiles that overlap the expert's rows
//   [rs, re) (ops/fp8_grouped.py::fp8_dw_items). TMA reads the operands as
//   3-D boxes of (128 bytes, 128 rows, 1 tile). In a straddling tile (at
//   most the first and last of an item) M is the contiguous dimension, so
//   the codes at M positions outside [rs, re) are zeroed byte by byte in
//   shared memory after the TMA lands (position j of swizzled row p sits
//   in 16-byte chunk (j / 16) ^ (p & 7), byte j % 16), then
//   fence.proxy.async before wgmma reads them. Each dW tile is written by
//   exactly one CTA by TMA stores (no atomics): two launches give the same
//   bits. An empty expert's dW tiles are zero items.
// - A device counter, when given, sums per launch the items with products,
//   the zero items and the scale steps walked (the plan checks of the card
//   tests and chip_smoke.py).
// - Limits: E <= 256; K and N multiples of 128; any M and group sizes.
//   Types (A x B): e4m3 x e4m3, e5m2 x e4m3 (#12, #11), e4m3 x e5m2 (#13,
//   #11); f32 or bf16 out (#13: f32).


#pragma once

#include <algorithm>

#include "sm90.cuh"

namespace {

constexpr int TILE = 128;                // tile rows and columns; depth of one scale step
constexpr int NCONS = 256;               // two consumer warpgroups
constexpr int NTHREADS = NCONS + 32;     // and the producer warp
constexpr int MAX_E = 256;
constexpr uint32_t OPND = TILE * TILE;   // one operand of one step: 128 x 128 codes
constexpr uint32_t STAGE = 2 * OPND;     // A then B
constexpr uint32_t BOX = 64 * 128;       // a staging box: 64 rows of 128 bytes
constexpr uint32_t WG_ROWS = 64 * 128;   // bytes of a warpgroup's 64 A rows

enum Mode { GG = 0, DW = 1, DENSE = 2 };  // DENSE: GG with one group of M rows
enum Fp8Type { E4M3 = 0, E5M2 = 1 };

// shared memory, in bytes from a 1024-aligned base; a warpgroup's 64 x 128
// result needs BN * sizeof(OutT) / 128 staging boxes: 2 in bf16 (five
// stages fit), 4 in f32 (four)
template <typename OutT>
struct Layout {
  static constexpr int SB = TILE * sizeof(OutT) / 128;
  static constexpr int STAGES = SB == 2 ? 5 : 4;
  static constexpr uint32_t STG = STAGES * STAGE;          // 2 warpgroups x SB staging boxes
  static constexpr uint32_t BAR = STG + 2 * SB * BOX;      // full [STAGES], empty [STAGES]
  static constexpr uint32_t OFFS = BAR + 16 * STAGES;      // int [MAX_E + 1]
  static constexpr uint32_t TAB = OFFS + 4 * (MAX_E + 1);  // int [MAX_E + 1]: tile prefix or order
  static constexpr uint32_t WSUM = TAB + 4 * (MAX_E + 1);  // int [9]: the scan's warp sums
  static constexpr uint32_t BYTES = WSUM + 64 + 1024;      // + alignment slack
  static_assert(BYTES <= 232448, "fits one SM");
};

struct Args {
  const int* sizes;   // (E,) group sizes; DENSE: none (E = 1, its size M)
  const float* sa;    // GG: sx (M, K/128); DW: sx (Mp/128)
  const float* sb;    // GG: sw (E, K/128, N/128); DW: sy (Mp/128)
  void* out;          // GG: (M, N) OutT; DW: (E, K, N) f32
  unsigned long long* counts;  // [items with products, zero items, steps] or null
  int M, E, K, N;     // GG: x (M, K) -> out (M, N); DW: Mp rows -> dW (E, K, N)
};

// one item of the work list
struct Item {
  int e;       // expert (-1: a zero tile past the last group)
  int r0, r1;  // GG: the tile's rows [r0, r1); DW: the expert's rows
  int c0;      // GG: first output column; DW: first dW row (K index)
  int n0;      // DW: first dW column
  int t0;      // DW: the first global row tile
  int steps;   // scale steps (0: a zero item)
};

template <int MODE>
struct Plan {
  const int* offs;  // (E + 1) row offsets, clamped to M
  const int* tab;   // GG: (E + 1) tile prefix; DW: experts by falling row count
  int M, E, kt, nt, items;

  __device__ __forceinline__ Item item(int i) const {
    Item it;
    if (MODE == DW) {
      const int per = kt * nt, r = i / per, rem = i % per;
      it.e = tab[r];
      it.r0 = offs[it.e];
      it.r1 = offs[it.e + 1];
      it.c0 = (rem / nt) * TILE;
      it.n0 = (rem % nt) * TILE;
      it.t0 = it.r0 / TILE;
      it.steps = it.r1 > it.r0 ? (it.r1 - 1) / TILE - it.t0 + 1 : 0;
      return it;
    }
    const int t = i / nt;
    it.c0 = (i % nt) * TILE;
    it.n0 = it.t0 = 0;
    if (t < tab[E]) {  // the expert e with tab[e] <= t < tab[e + 1]
      int lo = 0, hi = E - 1;
      while (lo < hi) {
        const int mid = (lo + hi + 1) / 2;
        if (tab[mid] <= t) lo = mid; else hi = mid - 1;
      }
      it.e = lo;
      it.r0 = offs[lo] + TILE * (t - tab[lo]);
      it.r1 = min(it.r0 + TILE, offs[lo + 1]);
      it.steps = kt;
    } else {  // rows past the last group
      it.e = -1;
      it.r0 = offs[E] + TILE * (t - tab[E]);
      it.r1 = min(it.r0 + TILE, M);
      it.steps = 0;
    }
    return it;
  }
};

// zero the codes at M positions outside [lo, hi) of one 128-byte swizzled
// shared-memory row p (its 16-byte chunk q holds positions 16 (q ^ (p & 7))
// to that + 15)
__device__ __forceinline__ void mask_row(unsigned char* row, int p, int lo, int hi) {
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int j0 = 16 * (q ^ (p & 7));
    if (j0 >= lo && j0 + 16 <= hi) continue;
    uint4* chunk = reinterpret_cast<uint4*>(row + 16 * q);
    if (j0 + 16 <= lo || j0 >= hi) {
      *chunk = make_uint4(0u, 0u, 0u, 0u);
      continue;
    }
    uint32_t w[4] = {chunk->x, chunk->y, chunk->z, chunk->w};
#pragma unroll
    for (int b = 0; b < 16; ++b)
      if (j0 + b < lo || j0 + b >= hi) w[b / 4] &= ~(0xffu << (8 * (b % 4)));
    *chunk = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

template <int MODE, int TA, int TB, typename OutT>
__global__ void __launch_bounds__(NTHREADS, 1)
fp8_grouped_kernel(const __grid_constant__ CUtensorMap tm_a,
                   const __grid_constant__ CUtensorMap tm_b,
                   const __grid_constant__ CUtensorMap tm_out, const Args a) {
  using Lay = Layout<OutT>;
  constexpr int STAGES = Lay::STAGES, SB = Lay::SB;
  constexpr int COLS = 128 / sizeof(OutT);  // output columns of one staging box
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t sbase = smem_u32(smem);
  int* offs = reinterpret_cast<int*>(smem + Lay::OFFS);
  int* tab = reinterpret_cast<int*>(smem + Lay::TAB);
  int* wsum = reinterpret_cast<int*>(smem + Lay::WSUM);
  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32, tq = lane % 4;
  const int E = a.E, M = a.M;

  // the tables: offsets (clamped to M), then the tile prefix (GG) or the
  // experts by falling row count (DW)
  {
    const int n = MODE == DENSE ? (tid == 0 ? M : 0) : tid < E ? max(a.sizes[tid], 0) : 0;
    int total;
    const int ex = block_scan<NTHREADS>(n, wsum, total);
    const int rs = min(ex, M), re = min(ex + n, M);
    if (tid < E) offs[tid] = rs;
    if (tid == 0) offs[E] = min(total, M);
    if (MODE == DW) {
      if (tid < E) tab[tid] = re - rs;
      __syncthreads();
      int rank = 0;
      for (int f = 0; f < E; ++f) {
        const int nf = tab[f];
        rank += (nf > re - rs || (nf == re - rs && f < tid)) ? 1 : 0;
      }
      __syncthreads();
      if (tid < E) tab[rank] = tid;
    } else {
      const int tiles = tid < E ? (re - rs + TILE - 1) / TILE : 0;
      const int tex = block_scan<NTHREADS>(tiles, wsum, total);
      if (tid < E) tab[tid] = tex;
      if (tid == 0) tab[E] = total;
    }
  }
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(sbase + Lay::BAR + 8 * s, 1);
      mbar_init(sbase + Lay::BAR + 8 * (STAGES + s), NCONS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  Plan<MODE> plan;
  plan.offs = offs;
  plan.tab = tab;
  plan.M = M;
  plan.E = E;
  plan.kt = a.K / TILE;
  plan.nt = a.N / TILE;
  plan.items = MODE == DW ? E * plan.kt * plan.nt
                          : (tab[E] + (M - offs[E] + TILE - 1) / TILE) * plan.nt;

  if (tid >= NCONS) {
    // the producer: every load of this CTA's items, STAGES steps ahead
    if (tid == NCONS) {
      uint32_t pc = 0;
      for (int i = blockIdx.x; i < plan.items; i += gridDim.x) {
        const Item it = plan.item(i);
        for (int c = 0; c < it.steps; ++c, ++pc) {
          const uint32_t s = pc % STAGES;
          const uint32_t full = sbase + Lay::BAR + 8 * s, empty = full + 8 * STAGES;
          if (pc >= (uint32_t)STAGES) mbar_wait(empty, (pc / STAGES - 1) & 1);
          const uint32_t sa = sbase + s * STAGE, sb = sa + OPND;
          mbar_expect_tx(full, STAGE);
          if (MODE == DW) {  // row tile t0 + c: K rows c0.. and N rows n0.., 128 positions each
            tma_load_3d(sa, &tm_a, full, 0, it.c0, it.t0 + c);
            tma_load_3d(sb, &tm_b, full, 0, it.n0, it.t0 + c);
          } else {  // x rows r0.., W[e] rows c0.. (the output columns), codes 128 c..
            tma_load_2d(sa, &tm_a, full, TILE * c, it.r0);
            tma_load_3d(sb, &tm_b, full, TILE * c, it.c0, it.e);
          }
        }
      }
    }
    return;
  }

  unsigned long long n_prod = 0, n_zero = 0, n_steps = 0;
  float acc[64], part[64];
  const int row0 = 16 * warp + lane / 4;  // this thread's rows of its warpgroup: row0, row0 + 8
  uint32_t stage = 0, phase = 0;
  unsigned char* stg = smem + Lay::STG + wg * SB * BOX;
  const uint32_t stg_s = sbase + Lay::STG + wg * SB * BOX;
  const bool lead = tid % 128 == 0;

  for (int i = blockIdx.x; i < plan.items; i += gridDim.x) {
    const Item it = plan.item(i);
    if (it.steps == 0) {
      // zero item: GG rows past the last group, or an empty expert's dW tile
      if constexpr (MODE == DW) {
        float* dw = static_cast<float*>(a.out) + (int64_t)it.e * a.K * a.N;
        for (int j = tid; j < TILE * TILE / 4; j += NCONS) {
          const int r = it.c0 + j / (TILE / 4), c = it.n0 + 4 * (j % (TILE / 4));
          *reinterpret_cast<float4*>(dw + (int64_t)r * a.N + c) = make_float4(0.f, 0.f, 0.f, 0.f);
        }
      } else {
        OutT* out = static_cast<OutT*>(a.out);
        constexpr int PER = 16 / sizeof(OutT);  // columns of one 16-byte store
        for (int j = tid; j < (it.r1 - it.r0) * (TILE / PER); j += NCONS) {
          const int r = it.r0 + j / (TILE / PER), c = it.c0 + PER * (j % (TILE / PER));
          *reinterpret_cast<uint4*>(out + (int64_t)r * a.N + c) = make_uint4(0u, 0u, 0u, 0u);
        }
      }
      n_zero += 1;
      continue;
    }
    n_prod += 1;
    n_steps += it.steps;
#pragma unroll
    for (int j = 0; j < 64; ++j) acc[j] = 0.f;
    // GG: this thread's two rows; rows past the tile's expert get scale 0
    // (they are never stored)
    const int ra = it.r0 + 64 * wg + row0, rb = ra + 8;
    const int kt = plan.kt;
    for (int c = 0; c < it.steps; ++c) {
      float s0, s1;
      if (MODE == DW) {
        s0 = s1 = __ldg(a.sa + it.t0 + c) * __ldg(a.sb + it.t0 + c);
      } else {
        const float sw = __ldg(a.sb + ((int64_t)it.e * kt + c) * plan.nt + it.c0 / TILE);
        s0 = ra < it.r1 ? __ldg(a.sa + (int64_t)ra * kt + c) * sw : 0.f;
        s1 = rb < it.r1 ? __ldg(a.sa + (int64_t)rb * kt + c) * sw : 0.f;
      }
      const uint32_t sa = sbase + stage * STAGE, sb = sa + OPND;
      mbar_wait(sbase + Lay::BAR + 8 * stage, phase);
      if (MODE == DW) {
        const int base = TILE * (it.t0 + c);
        const int lo = it.r0 - base, hi = it.r1 - base;
        if (lo > 0 || hi < TILE) {
          // a tile that straddles the expert's rows: thread t masks row
          // t % 128 of A (first warpgroup) or of B (second)
          mask_row(smem + stage * STAGE + wg * OPND + (tid % 128) * 128, tid % 128, lo, hi);
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
          named_sync(3, NCONS);
        }
      }
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < TILE / 32; ++kk)
        wgmma_m64n128k32_fp8<TA, TB>(part, desc(sa + wg * WG_ROWS + 32 * kk, 16, 1024),
                                     desc(sb + 32 * kk, 16, 1024), kk > 0);
      wg_commit();
      wg_wait0();
      reg_fence(part);
      __syncwarp();
      if (lane == 0) mbar_arrive(sbase + Lay::BAR + 8 * (STAGES + stage));
#pragma unroll
      for (int j = 0; j < 64; ++j) acc[j] = fmaf(part[j], (j % 4) < 2 ? s0 : s1, acc[j]);
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }

    // the warpgroup's 64 x 128 result through its staging boxes (128-byte
    // swizzled rows of COLS columns)
    if (lead) tma_store_wait();  // the last stores have read the staging boxes
    named_sync(1 + wg, 128);
#pragma unroll
    for (int b = 0; b < SB; ++b)
#pragma unroll
      for (int jj = 0; jj < COLS / 8; ++jj)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int j = b * (COLS / 8) + jj, R = row0 + 8 * r;
          if constexpr (sizeof(OutT) == 4)
            *reinterpret_cast<float2*>(stg + b * BOX + R * 128 +
                                       (((2 * jj + tq / 2) ^ (R & 7)) << 4) + 8 * (tq & 1)) =
                make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
          else
            *reinterpret_cast<uint32_t*>(stg + b * BOX + R * 128 + ((jj ^ (R & 7)) << 4) +
                                         4 * tq) = pack_bf16(acc[4 * j + 2 * r],
                                                             acc[4 * j + 2 * r + 1]);
        }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    named_sync(1 + wg, 128);
    if (MODE == DW) {  // dW rows c0 + 64 wg.., into the (N, K, E) map
      if (lead) {
        for (int b = 0; b < SB; ++b)
          tma_store_3d(&tm_out, stg_s + b * BOX, it.n0 + COLS * b, it.c0 + 64 * wg, it.e);
        tma_store_commit();
      }
    } else {
      // whole rows of the expert by TMA, its last partial rows by masked stores
      const int m0 = it.r0 + 64 * wg;
      if (m0 + 64 <= it.r1) {
        if (lead) {
          for (int b = 0; b < SB; ++b) tma_store_2d(&tm_out, stg_s + b * BOX, it.c0 + COLS * b, m0);
          tma_store_commit();
        }
      } else {
        OutT* out = static_cast<OutT*>(a.out);
        const int rows = it.r1 - m0;  // < 64; may be <= 0 for the second warpgroup
        for (int j = tid % 128; j < max(rows, 0) * SB * 8; j += 128) {
          const int R = j / (SB * 8), b = (j / 8) % SB, c16 = j % 8;
          const int col = it.c0 + COLS * b + c16 * (16 / (int)sizeof(OutT));
          *reinterpret_cast<uint4*>(out + (int64_t)(m0 + R) * a.N + col) =
              *reinterpret_cast<const uint4*>(stg + b * BOX + R * 128 + ((c16 ^ (R & 7)) << 4));
        }
      }
    }
  }
  if (lead) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");  // stores done
  if (tid == 0 && a.counts != nullptr) {
    atomicAdd(a.counts, n_prod);
    atomicAdd(a.counts + 1, n_zero);
    atomicAdd(a.counts + 2, n_steps);
  }
}

template <int MODE, int TA, int TB, typename OutT>
int launch(const CUtensorMap& ta, const CUtensorMap& tb, const CUtensorMap& tout, const Args& a,
           int64_t max_items, cudaStream_t stream) {
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  auto kern = fp8_grouped_kernel<MODE, TA, TB, OutT>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)Layout<OutT>::BYTES);
  if (e != cudaSuccess) return (int)e;
  const int grid = (int)std::min<int64_t>(sms, std::max<int64_t>(max_items, 1));
  kern<<<grid, NTHREADS, Layout<OutT>::BYTES, stream>>>(ta, tb, tout, a);
  return (int)cudaGetLastError();
}

}  // namespace
