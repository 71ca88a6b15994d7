// Fused MoE expert MLP forward over expert-sorted rows, for Hopper (sm_90a):
// one persistent wgmma/TMA kernel.
//
// Replaces xtuner_tpu/ops/fused_moe_mlp.py:_mlp_kernel (the pallas_call in
// fused_mlp_fwd_kernel). For every row m of expert e = e(m):
//   gu[m]     = bf16(x[m] @ W_gu[e])                    (f32 accumulation)
//   hidden[m] = bf16(silu(gate) * up), gate, up = gu[m][:F], gu[m][F:] in f32
//   out[m]    = bf16(hidden[m] @ W_dn[e])               (f32 accumulation)
// x (M, H), W_gu (E, H, 2F) (gate | up), W_dn (E, F, H), out (M, H) and
// gu (M, 2F) all bf16; group_sizes (E,) int32 on the device, never read by
// the host. gu is rounded to bf16 before the activation, as the TPU kernel
// does, so the forward matches the decomposed path and the backward
// (ops/fused_moe_mlp.py) re-reads the same bf16 gu. Rows past the last
// group get zeros in out and gu.
//
// What bounds it on the H100: 6 M H F FLOPs against x, out, gu and the
// weights. At the moe_heavy shapes (F 768) the tensor cores bound it; at
// the longctx row's F 128 (about 80 FLOPs per byte of x, out and gu) the
// bytes do, by a little. The trouble is on-chip space: a 128-row tile's
// f32 output at H 1024 is 512 KB and its hidden tile 192 KB at F 768, more
// than the 227 KB a CTA may use beside its operand ring.
//
// Design:
// - Tiles: grouped_gemm.cu's work list at its tile height. Each expert's
//   rows [offs[e], offs[e+1]) are cut into ceil(n_e / 128) tiles that start
//   at the expert's first row, so a tile never mixes experts; rows past the
//   last group make zero tiles, stored as zeros with no load and no
//   product. Every CTA scans the group sizes in shared memory (offsets and
//   the per-expert tile prefix); ops/bf16_grouped.py::grouped_tile_plan
//   is the same list in plain torch. A persistent grid of one CTA per SM
//   walks the tiles in expert order, so the CTAs resident together read one
//   expert's weights from L2.
// - Per tile, two warpgroups of 64 rows each, every product on wgmma
//   m64n256k16 with the f32 sum in registers, over one ring of 64-deep
//   contraction chunks (A 128 x 64, B 64 x 256, 128-byte-swizzled boxes)
//   that thread 0 fills by TMA STAGES chunks ahead, across phases and
//   tiles:
//   1. over chunks of 128 columns of F: A = x (K-major), B = the gate and
//      up columns of the chunk side by side (W_gu MN-major, mapped as (F, 2,
//      H, E), so columns past F read as zeros), n 256: each thread holds a
//      row's gate and up values of the same column, so gu and silu(gate) *
//      up are formed in registers. gu goes out through this warpgroup's
//      staging boxes by TMA (masked stores for an expert's last, partial
//      rows, since a TMA store would overwrite the next expert's rows);
//      hidden goes by TMA into the CTA's own slot of a bf16 scratch of 128
//      x F rows per CTA (L2-resident: 26 MB in all at F 768), written once
//      and read back at once.
//   2. over passes of 256 output columns: A = the CTA's hidden slot
//      (K-major, by TMA), B = W_dn (MN-major), out through the staging
//      boxes as in the grouped kernel. No pass recomputes phase 1.
//   Thread 0 issues a tile's first phase-2 load only after both
//   warpgroups' hidden stores have completed (an mbarrier of two arrivals
//   after cp.async.bulk.wait_group 0); until then its loads wait at that
//   chunk. Keeping hidden in shared memory would cap F: 64 x F bf16 per
//   warpgroup is 192 KB at F 1536.
// - 256 threads, up to 255 registers each; no producer warpgroup (see
//   grouped_gemm.cu).
// - A device counter, when given, sums per launch the tiles with products,
//   the zero tiles and the contraction chunks walked (the plan check of
//   chip_smoke.py and the card tests).
//
// Shape limits: H % 128 == 0 (the TMA boxes and the output passes), F % 64
// == 0 (phase 2's contraction chunks), F <= 1536 (the hidden slots, 128 x F
// bf16 per CTA, stay within L2), E <= 1024 (the tables in shared memory).
// The wrapper raises outside them.

#include "sm90.cuh"

namespace {

constexpr int BM = 128;  // tile rows: two warpgroups of 64
constexpr int BK = 64;   // contraction chunk
constexpr int FC = 128;  // gate (and up) columns of a phase-1 chunk
constexpr int BN = 256;  // columns of every product: gate|up of a chunk, or an output pass
constexpr int NTHREADS = 256;
constexpr int STAGES = 3;
constexpr int MAX_E = 1024;
constexpr int MAX_F = 1536;
constexpr uint32_t BOX = 64 * 128;  // one 64-row box of 64 bf16 columns: 8 KB
constexpr uint32_t A_BYTES = 2 * BOX;
constexpr uint32_t STAGE = A_BYTES + BN * 128;  // A then B: 48 KB
constexpr int SB = 4;                           // staging boxes per warpgroup
// shared memory, in bytes from a 1024-aligned base
constexpr uint32_t STG = STAGES * STAGE;
constexpr uint32_t BAR = STG + 2 * SB * BOX;     // full [STAGES], empty [STAGES], hidden
constexpr uint32_t OFFS = BAR + 8 * (2 * STAGES + 1);
constexpr uint32_t TAB = OFFS + 4 * (MAX_E + 1);  // int [MAX_E + 1]: the tile prefix
constexpr uint32_t WSUM = TAB + 4 * (MAX_E + 1);  // int [8]: the scan's warp sums
constexpr uint32_t BYTES = WSUM + 32 + 1024;      // + alignment slack
static_assert(BYTES <= 232448, "fits one SM");

struct Args {
  const int* sizes;  // (E,) group sizes
  __nv_bfloat16* out;  // (M, H)
  __nv_bfloat16* gu;   // (M, 2F)
  unsigned long long* counts;  // [tiles with products, zero tiles, chunks] or null
  int M, E, H, F;
};

// one tile of the work list: expert e's rows [r0, r1), or rows past the
// last group (e = -1)
struct Item {
  int e, r0, r1;
};

struct Plan {
  const int* offs;  // (E + 1) row offsets, clamped to M
  const int* tab;   // (E + 1) tile prefix
  int M, E, items;
  int kh, nf, kf, np;  // phase 1: H chunks, F chunks; phase 2: F chunks, output passes
  int n1, chunks;      // a tile's phase-1 chunks, all its chunks

  __device__ __forceinline__ Item item(int t) const {
    Item it;
    if (t < tab[E]) {  // the expert e with tab[e] <= t < tab[e + 1]
      int lo = 0, hi = E - 1;
      while (lo < hi) {
        const int mid = (lo + hi + 1) / 2;
        if (tab[mid] <= t) lo = mid; else hi = mid - 1;
      }
      it.e = lo;
      it.r0 = offs[lo] + BM * (t - tab[lo]);
      it.r1 = min(it.r0 + BM, offs[lo + 1]);
    } else {
      it.e = -1;
      it.r0 = offs[E] + BM * (t - tab[E]);
      it.r1 = min(it.r0 + BM, M);
    }
    return it;
  }
};

struct Maps {
  CUtensorMap x;    // (H, M), box (64, 128)
  CUtensorMap wgu;  // (F, 2, H, E), box (64, 1, 64, 1)
  CUtensorMap wdn;  // (H, F, E), box (64, 64, 1)
  CUtensorMap hid;  // (F, grid x 128), box (64, 64): the hidden slots
  CUtensorMap out;  // (H, M), box (64, 64)
  CUtensorMap gu;   // (F, 2, M), box (64, 1, 64)
};

// thread 0's side: the next chunk to load, across this CTA's tiles. A
// tile's phase-2 chunks wait until its hidden slot is complete (hid_ok)
struct Producer {
  int item, chunk;
  Item it;
  unsigned pc;  // loads issued
  bool hid_ok;

  __device__ __forceinline__ void seek(const Plan& p) {
    while (item < p.items) {
      it = p.item(item);
      if (it.e >= 0) return;
      item += gridDim.x;
    }
  }

  __device__ __forceinline__ void issue(const Plan& p, const Maps& m, uint32_t sbase) {
    if (item >= p.items || (chunk == p.n1 && !hid_ok)) return;
    const uint32_t s = pc % STAGES;
    const uint32_t full = sbase + BAR + 8 * s, empty = full + 8 * STAGES;
    if (pc >= (unsigned)STAGES) mbar_wait(empty, (pc / STAGES - 1) & 1);
    const uint32_t sa = sbase + s * STAGE, sb = sa + A_BYTES;
    mbar_expect_tx(full, STAGE);
    if (chunk < p.n1) {  // x rows r0.., columns k0..; gate and up columns f0..
      const int f0 = (chunk / p.kh) * FC, k0 = (chunk % p.kh) * BK;
      tma_load_2d(sa, &m.x, full, k0, it.r0);
      for (int q = 0; q < 4; ++q)
        tma_load(sb + q * BOX, &m.wgu, full, f0 + 64 * (q % 2), q / 2, k0, it.e);
    } else {  // the hidden slot's columns k0..; W_dn rows k0.., columns n0..
      const int c = chunk - p.n1, n0 = (c / p.kf) * BN, k0 = (c % p.kf) * BK;
      const int slot = blockIdx.x * BM;
      tma_load_2d(sa, &m.hid, full, k0, slot);
      tma_load_2d(sa + BOX, &m.hid, full, k0, slot + 64);
      for (int q = 0; q < 4; ++q) tma_load_3d(sb + q * BOX, &m.wdn, full, n0 + 64 * q, k0, it.e);
    }
    ++pc;
    if (++chunk == p.chunks) {
      chunk = 0;
      hid_ok = false;
      item += gridDim.x;
      seek(p);
    }
  }
};

__device__ __forceinline__ float silu(float g) { return g / (1.0f + __expf(-g)); }

// acc = this warpgroup's 64 rows of A . B over the next n chunks of the
// ring (stage, phase: the consumer's place in it)
template <typename Release>
__device__ __forceinline__ void run_chunks(float (&acc)[BN / 2], int n, uint32_t sbase, int wg,
                                           uint32_t& stage, uint32_t& phase, Release& release) {
  uint32_t prev = 0;
  for (int c = 0; c < n; ++c) {
    const uint32_t sa = sbase + stage * STAGE, sb = sa + A_BYTES;
    mbar_wait(sbase + BAR + 8 * stage, phase);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_m64n256_ss<0, 1>(acc, desc(sa + wg * BOX + 32 * kk, 16, 1024),
                             desc(sb + 2048 * kk, BOX, 1024), c > 0 || kk > 0);
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
}

// acc's 256 columns as bf16 into this warpgroup's four staging boxes of 64
// columns, swizzled as TMA reads them: acc[4 j + 2 r + e2] is row row0 +
// 8 r, column 8 j + 2 tq + e2. Waits for the last stores to have read the
// boxes first; ends with the boxes ready for TMA and every thread
__device__ __forceinline__ void stage_bf16(const float (&acc)[BN / 2], unsigned char* stg,
                                           int wg, int row0, int tq, bool lead) {
  if (lead) tma_store_wait();
  named_sync(1 + wg, 128);
#pragma unroll
  for (int b = 0; b < SB; ++b)
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int j = b * 8 + jj, R = row0 + 8 * r;
        *reinterpret_cast<uint32_t*>(stg + b * BOX + R * 128 + ((jj ^ (R & 7)) << 4) + 4 * tq) =
            pack_bf16(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
      }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  named_sync(1 + wg, 128);
}

__global__ void __launch_bounds__(NTHREADS, 1)
fused_moe_mlp_kernel(const __grid_constant__ Maps maps, const Args a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t sbase = smem_u32(smem);
  int* offs = reinterpret_cast<int*>(smem + OFFS);
  int* tab = reinterpret_cast<int*>(smem + TAB);
  int* wsum = reinterpret_cast<int*>(smem + WSUM);
  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32, tq = lane % 4;
  const int E = a.E, M = a.M, H = a.H, F = a.F;
  const uint32_t hid_bar = sbase + BAR + 16 * STAGES;

  // the tables: offsets (clamped to M) and the tile prefix, 256 experts at a time
  {
    int carry = 0, tcarry = 0;
    for (int base = 0; base < E; base += NTHREADS) {
      const int e = base + tid;
      const int n = e < E ? max(a.sizes[e], 0) : 0;
      int total, ttotal;
      const int ex = carry + block_scan<NTHREADS>(n, wsum, total);
      const int rs = min(ex, M), re = min(ex + n, M);
      const int tiles = e < E ? (re - rs + BM - 1) / BM : 0;
      const int tex = tcarry + block_scan<NTHREADS>(tiles, wsum, ttotal);
      if (e < E) {
        offs[e] = rs;
        tab[e] = tex;
      }
      carry += total;
      tcarry += ttotal;
    }
    if (tid == 0) {
      offs[E] = min(carry, M);
      tab[E] = tcarry;
    }
  }
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(sbase + BAR + 8 * s, 1);
      mbar_init(sbase + BAR + 8 * (STAGES + s), NTHREADS / 32);
    }
    mbar_init(hid_bar, 2);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  Plan plan;
  plan.offs = offs;
  plan.tab = tab;
  plan.M = M;
  plan.E = E;
  plan.items = tab[E] + (M - offs[E] + BM - 1) / BM;
  plan.kh = H / BK;
  plan.nf = (F + FC - 1) / FC;
  plan.kf = F / BK;
  plan.np = (H + BN - 1) / BN;
  plan.n1 = plan.nf * plan.kh;
  plan.chunks = plan.n1 + plan.np * plan.kf;

  Producer prod;
  unsigned long long n_prod = 0, n_zero = 0, n_chunks = 0;
  if (tid == 0) {
    prod.item = blockIdx.x;
    prod.chunk = 0;
    prod.pc = 0;
    prod.hid_ok = false;
    prod.seek(plan);
    for (int s = 0; s < STAGES; ++s) prod.issue(plan, maps, sbase);
  }

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  const int row0 = 16 * warp + lane / 4;  // this thread's rows of its warpgroup: row0, row0 + 8
  uint32_t stage = 0, phase = 0, hid_phase = 0;
  const bool lead = tid % 128 == 0;
  unsigned char* stg = smem + STG + wg * SB * BOX;
  const uint32_t stg_s = sbase + STG + wg * SB * BOX;

  // every warp's arrival on the stage's empty barrier; thread 0 then
  // refills the ring (it waits for all eight warps)
  auto release = [&](uint32_t s) {
    __syncwarp();
    if (lane == 0) mbar_arrive(sbase + BAR + 8 * (STAGES + s));
    if (tid == 0) prod.issue(plan, maps, sbase);
    __syncwarp();
  };

  // staging box b (64 x 64 bf16) to rows m0.. of a row-major (M, ld) bf16
  // matrix at column col, rows below r1 only (the expert's last rows)
  auto store_rows = [&](__nv_bfloat16* dst, int ld, int m0, int r1, int b, int col) {
    const int rows = r1 - m0;  // < 64; may be <= 0 for the second warpgroup
    for (int j = tid % 128; j < max(rows, 0) * 8; j += 128) {
      const int R = j / 8, c16 = j % 8;
      *reinterpret_cast<uint4*>(dst + (int64_t)(m0 + R) * ld + col + 8 * c16) =
          *reinterpret_cast<const uint4*>(stg + b * BOX + R * 128 + ((c16 ^ (R & 7)) << 4));
    }
  };

  for (int i = blockIdx.x; i < plan.items; i += gridDim.x) {
    const Item it = plan.item(i);
    if (it.e < 0) {  // rows past the last group: zeros in out and gu
      for (int j = tid; j < (it.r1 - it.r0) * (H / 8); j += NTHREADS)
        reinterpret_cast<uint4*>(a.out + (int64_t)(it.r0 + j / (H / 8)) * H)[j % (H / 8)] =
            make_uint4(0u, 0u, 0u, 0u);
      for (int j = tid; j < (it.r1 - it.r0) * (F / 4); j += NTHREADS)
        reinterpret_cast<uint4*>(a.gu + (int64_t)(it.r0 + j / (F / 4)) * 2 * F)[j % (F / 4)] =
            make_uint4(0u, 0u, 0u, 0u);
      n_zero += 1;
      continue;
    }
    n_prod += 1;
    n_chunks += plan.chunks;
    const int m0 = it.r0 + 64 * wg;
    const bool whole = m0 + 64 <= it.r1;

    // ---- phase 1: gu and hidden, 128 columns of F at a time
    for (int fc = 0; fc < plan.nf; ++fc) {
      run_chunks(acc, plan.kh, sbase, wg, stage, phase, release);
      const int f0 = fc * FC;
      // gu: boxes gate 0-63, gate 64-127, up 0-63, up 64-127 of the chunk
      stage_bf16(acc, stg, wg, row0, tq, lead);
      for (int b = 0; b < SB; ++b) {
        const int col = f0 + 64 * (b % 2);  // of the gate (b / 2 = 0) or the up half
        if (col >= F) continue;
        if (!whole)
          store_rows(a.gu, 2 * F, m0, it.r1, b, (b / 2) * F + col);
        else if (lead)
          tma_store_3d(&maps.gu, stg_s + b * BOX, col, b / 2, m0);
      }
      if (whole && lead) tma_store_commit();
      // hidden = bf16(silu(gate) * up) of the bf16 gu, into boxes 0-1, then
      // the CTA's slot (all 64 rows: a row past the expert is never read out)
      if (lead) tma_store_wait();
      named_sync(1 + wg, 128);
#pragma unroll
      for (int b = 0; b < 2; ++b)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int j = b * 8 + jj, R = row0 + 8 * r;
            float hv[2];
#pragma unroll
            for (int e2 = 0; e2 < 2; ++e2) {
              const float g = __bfloat162float(__float2bfloat16(acc[4 * j + 2 * r + e2]));
              const float u =
                  __bfloat162float(__float2bfloat16(acc[4 * (j + FC / 8) + 2 * r + e2]));
              hv[e2] = silu(g) * u;
            }
            *reinterpret_cast<uint32_t*>(stg + b * BOX + R * 128 + ((jj ^ (R & 7)) << 4) + 4 * tq) =
                pack_bf16(hv[0], hv[1]);
          }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      named_sync(1 + wg, 128);
      if (lead) {
        for (int b = 0; b < 2; ++b)
          if (f0 + 64 * b < F)
            tma_store_2d(&maps.hid, stg_s + b * BOX, f0 + 64 * b, blockIdx.x * BM + 64 * wg);
        tma_store_commit();
      }
    }
    // the slot is complete once both warpgroups' stores are: then thread 0
    // lets the tile's phase-2 loads go
    if (lead) {
      asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
      asm volatile("fence.proxy.async.global;" ::: "memory");
      mbar_arrive(hid_bar);
    }
    if (tid == 0) {
      mbar_wait(hid_bar, hid_phase);
      asm volatile("fence.proxy.async.global;" ::: "memory");
      prod.hid_ok = true;
      for (int s = 0; s < STAGES; ++s) prod.issue(plan, maps, sbase);
    }
    hid_phase ^= 1;

    // ---- phase 2: out = hidden @ W_dn[e], 256 columns at a time
    for (int p = 0; p < plan.np; ++p) {
      run_chunks(acc, plan.kf, sbase, wg, stage, phase, release);
      stage_bf16(acc, stg, wg, row0, tq, lead);
      const int n0 = p * BN;
      if (whole) {
        if (lead) {
          for (int b = 0; b < SB; ++b)
            if (n0 + 64 * b < H) tma_store_2d(&maps.out, stg_s + b * BOX, n0 + 64 * b, m0);
          tma_store_commit();
        }
      } else {
        for (int b = 0; b < SB; ++b)
          if (n0 + 64 * b < H) store_rows(a.out, H, m0, it.r1, b, n0 + 64 * b);
      }
    }
  }
  if (lead) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");  // stores done
  if (tid == 0 && a.counts != nullptr) {
    atomicAdd(a.counts, n_prod);
    atomicAdd(a.counts + 1, n_zero);
    atomicAdd(a.counts + 2, n_chunks);
  }
}

}  // namespace

// x (M, H), w_gu (E, H, 2F), w_dn (E, F, H), group_sizes (E,) int32 -> out
// (M, H), gu (M, 2F); hid: bf16 scratch of slots x 128 rows of F (one slot
// per CTA: slots >= the SM count, or the tiles if fewer); counts: device
// uint64 [tiles with products, zero tiles, chunks] or null
extern "C" int xt_fused_moe_mlp_bf16(const void* x, const void* w_gu, const void* w_dn,
                                     const void* group_sizes, void* out, void* gu, void* hid,
                                     int slots, int M, int E, int H, int F, void* counts,
                                     void* stream) {
  if (M < 0 || E <= 0 || E > MAX_E || H <= 0 || H % 128 != 0 || F <= 0 || F % 64 != 0 ||
      F > MAX_F || slots <= 0)
    return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  // tiles: at most ceil(n_e / 128) per expert and ceil(tail / 128), so
  // below M / 128 + E + 1
  const long long max_items = (long long)M / BM + E + 1;
  const int grid = (int)(max_items < sms ? max_items : sms);
  if (slots < grid) return (int)cudaErrorInvalidValue;
  const cuuint64_t dx[2] = {(cuuint64_t)H, (cuuint64_t)M};
  const cuuint64_t dgu_w[4] = {(cuuint64_t)F, 2, (cuuint64_t)H, (cuuint64_t)E};
  const cuuint64_t ddn[3] = {(cuuint64_t)H, (cuuint64_t)F, (cuuint64_t)E};
  const cuuint64_t dhid[2] = {(cuuint64_t)F, (cuuint64_t)slots * BM};
  const cuuint64_t dgu[3] = {(cuuint64_t)F, 2, (cuuint64_t)M};
  const cuuint32_t bx[2] = {64, BM}, b64[2] = {64, 64}, bgu_w[4] = {64, 1, 64, 1};
  const cuuint32_t bdn[3] = {64, 64, 1}, bgu[3] = {64, 1, 64};
  Maps m;
  if (!make_map_nd(&m.x, encode, x, 2, dx, bx) ||
      !make_map_nd(&m.wgu, encode, w_gu, 4, dgu_w, bgu_w) ||
      !make_map_nd(&m.wdn, encode, w_dn, 3, ddn, bdn) ||
      !make_map_nd(&m.hid, encode, hid, 2, dhid, b64) ||
      !make_map_nd(&m.out, encode, out, 2, dx, b64) ||
      !make_map_nd(&m.gu, encode, gu, 3, dgu, bgu))
    return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const int*>(group_sizes), static_cast<__nv_bfloat16*>(out),
               static_cast<__nv_bfloat16*>(gu), static_cast<unsigned long long*>(counts),
               M, E, H, F};
  cudaError_t e = cudaFuncSetAttribute(fused_moe_mlp_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)BYTES);
  if (e != cudaSuccess) return (int)e;
  fused_moe_mlp_kernel<<<grid, NTHREADS, BYTES, (cudaStream_t)stream>>>(m, a);
  return (int)cudaGetLastError();
}

// the dynamic shared memory of one CTA (bytes)
extern "C" int xt_fused_moe_mlp_smem_bytes() { return (int)BYTES; }
