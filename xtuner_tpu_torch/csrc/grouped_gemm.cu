// Ragged grouped GEMMs of the MoE expert path, for Hopper (sm_90a): one
// persistent kernel on wgmma with a TMA ring, for the forward and dgrad
// (#6) and the wgrad (#7).
//
// Replaces two TPU kernels of xtuner_tpu/ops/bf16_grouped.py:
// - _gg_kernel (pallas_call in grouped_gemm_bf16), both orientations:
//     "nn": out[m] = x[m] @ W[e(m)]            x (M, K), W (E, K, N) -> (M, N)
//     "nt": out[m] = x[m] @ W[e(m)]^T          x (M, N), W (E, K, N) -> (M, K)
//   where rows are sorted by expert and e(m) is the expert whose row range
//   holds m (group_sizes (E,) int32 on the device, never read by the host);
//   rows past the last group get zeros;
// - _dw_kernel (pallas_call in grouped_gemm_bf16_dw):
//     dW[e] = x_e^T @ dy_e over expert e's rows, f32; zero for an empty expert.
// All operands bf16, f32 accumulation; nn/nt round the result to bf16 once.
//
// What bounds it on the H100: at the MoE training shapes (M = 65536 to
// 262144 routed rows, widths 128 to 2048) nn and nt do ~100+ FLOPs per byte
// they must move, so the tensor cores bound them; dw at 128 experts writes
// an f32 dW of 4 E K N bytes, and that write binds it.
//
// Design:
// - The work list: each expert's rows [offs[e], offs[e+1]) are cut into
//   ceil(n_e / 128) M tiles that start at the expert's first row, so a tile
//   never mixes experts and its pipeline never restarts. Rows past the
//   last group, [offs[E], M), make zero tiles, stored as zeros with no load
//   and no product. A work item is (expert, M tile, N tile) for nn/nt, in
//   expert order with the N tile innermost, so the CTAs resident together
//   read one expert's weight columns and the same x rows from L2; for dw it
//   is (expert, K tile, N tile), experts in order of falling row count, so
//   the longest walks start first. Every CTA reads the E group sizes and
//   scans them in shared memory (offsets, the per-expert tile prefix, for
//   dw the expert order): no host work, no extra launch.
//   ops/bf16_grouped.py::grouped_tile_plan is the same list in plain torch.
// - Persistent grid: one CTA per SM walks the items with a stride of
//   gridDim.x. Thread 0 issues every TMA load, running STAGES chunks ahead
//   of the products across item boundaries, so the next item's first
//   chunks land while this item's epilogue runs. 256 threads (two
//   warpgroups, up to 255 registers each); no producer warpgroup: under
//   setmaxnreg ptxas caps every region at the launch bound's registers
//   (see flash_bwd.cu).
// - Products: each warpgroup owns 64 rows of the 128 x BN tile and keeps
//   its 64 x BN f32 sum in registers (wgmma m64n256k16, BN = 256, or
//   m64n128k16, BN = 128, picked from the output width), over a ring of
//   64-deep contraction chunks: A 128 x 64 bf16 and B 64 x BN, as 128-byte
//   swizzled boxes of 64 columns with full and empty mbarriers. The
//   operands' major order: nn: A = x K-major, B = W[e] MN-major; nt: A = x
//   K-major, B = W[e]^T K-major (W read in place, no transposed copy); dw:
//   A = x_e^T MN-major, B = dy_e MN-major. One wgmma group stays in flight
//   across chunks; its stage is released when the next one is issued.
// - Tensor maps: x, out and dy as 2-D tensors, W (E, K, N) as a 3-D
//   (N, K, E) one: TMA reads zeros past M, past each width, and past K of
//   one expert, never the next expert's rows.
// - nn/nt epilogue: bf16 into a staging buffer per warpgroup in the
//   swizzled layout; a warpgroup whose 64 rows all belong to the expert
//   stores them by TMA (asynchronous: the next item's products start at
//   once); the expert's last, partial rows go out by masked 16-byte stores
//   of rows in [rs, re), since a TMA store would overwrite the next
//   expert's rows, which another CTA owns.
// - dw: the contraction walks the expert's rows in chunks of 64 from
//   offs[e]. The last chunk's rows past the expert (the next expert's, or
//   rows past the last group, which lie inside the tensor and are not
//   zero-filled) are zeroed in shared memory in both operands (a whole
//   128-byte row is the same bytes under the swizzle), then
//   fence.proxy.async before wgmma reads them. The f32 result goes through
//   the warpgroup's staging boxes (32 columns of 64 rows, two rounds at BN
//   = 256) and out by TMA stores into dW mapped as (N, K, E), so it streams
//   while the next item computes.
// - Measured on an H100 80GB HBM3 at 700 W (tools/bench_grouped_cuda.py,
//   Qwen3-30B-A3B's E128 gate|up wgrad): 1.15-1.17 ms with the f32 result
//   stored from registers, 0.69 ms with no store at all, 1.06-1.10 ms
//   through TMA stores. A ring of 32-row chunks, which leaves room to stage
//   the whole f32 tile, ran 1.2-1.6x slower at every shape; nn/nt with four
//   stages and 8 KB of staging per warpgroup ran no faster in sum.
// - A device counter, when given, sums per launch the items with products,
//   the zero items and the contraction chunks walked (the plan check of
//   chip_smoke.py and the card tests).
// - The fused-CE backward's dh and dW products (xt_gemm_nn_bf16,
//   xt_gemm_dw_bf16) run the nn and dw instantiations with one group and
//   no counter; dW over row chunks adds into its f32 accumulator by TMA
//   reduce-add stores (grouped_kernel<dw, BN, true>).
// - Limits: E <= 256 (DeepSeek-V3's routed experts); nn/nt: contraction a
//   multiple of 32, output width of 8; dw: K and N multiples of 16.
//   Anything else returns an error.

#include <algorithm>

#include "sm90.cuh"

namespace {

constexpr int BM = 128;  // tile rows: nn/nt output rows; dw rows of dW (the K index)
constexpr int BK = 64;   // contraction chunk
constexpr int NTHREADS = 256;
constexpr int MAX_E = 256;
constexpr uint32_t BOX = 64 * 128;  // one 64-row box of 64 bf16 columns: 8 KB
constexpr uint32_t A_BYTES = 2 * BOX;

enum Mode { NN = 0, NT = 1, DW = 2 };

// shared memory, in bytes from a 1024-aligned base
template <int MODE, int BN, int STAGES, int SB>
struct Layout {
  static constexpr uint32_t STAGE = A_BYTES + BN * 128;   // A then B
  static constexpr uint32_t STG = STAGES * STAGE;         // 2 warpgroups x SB staging boxes
  static constexpr uint32_t BAR = STG + 2 * SB * BOX;     // full [STAGES], empty [STAGES]
  static constexpr uint32_t OFFS = BAR + 16 * STAGES;     // int [MAX_E + 1]
  static constexpr uint32_t TAB = OFFS + 4 * (MAX_E + 1); // int [MAX_E + 1]: tile prefix or order
  static constexpr uint32_t WSUM = TAB + 4 * (MAX_E + 1); // int [8]: the scan's warp sums
  static constexpr uint32_t BYTES = WSUM + 32 + 1024;     // + alignment slack
  static_assert(BYTES <= 232448, "fits one SM");
  // a staging box holds 64 bf16 (nn/nt) or 32 f32 (dw) columns of 64 rows
  static constexpr int ROUNDS = BN / ((MODE == DW ? 32 : 64) * SB);
  static_assert(ROUNDS * (MODE == DW ? 32 : 64) * SB == BN, "whole staging rounds");
};

// the instantiations: three stages and 32 KB of staging per warpgroup at
// BN = 256 (nn/nt: the warpgroup's whole 64 x 256 bf16 block; dw: half its
// f32 block, so two rounds), four stages at 128
template <int MODE, int BN> struct Cfg;
template <> struct Cfg<NN, 256> { static constexpr int STAGES = 3, SB = 4; };
template <> struct Cfg<NN, 128> { static constexpr int STAGES = 4, SB = 2; };
template <> struct Cfg<NT, 256> { static constexpr int STAGES = 3, SB = 4; };
template <> struct Cfg<NT, 128> { static constexpr int STAGES = 4, SB = 2; };
template <> struct Cfg<DW, 256> { static constexpr int STAGES = 3, SB = 4; };
template <> struct Cfg<DW, 128> { static constexpr int STAGES = 4, SB = 4; };

template <int MODE, int BN>
using L = Layout<MODE, BN, Cfg<MODE, BN>::STAGES, Cfg<MODE, BN>::SB>;

struct Args {
  const int* sizes;  // (E,) group sizes
  void* out;         // nn/nt: (M, nout) bf16; dw: (E, K, N) f32
  unsigned long long* counts;  // [items with products, zero items, chunks] or null
  int M, E, C;       // rows, experts, contraction (nn/nt: C; dw: unused)
  int K, N;          // nn/nt: the output width is N; dw: dW is (E, K, N)
};

// one item of the work list
struct Item {
  int e;       // expert (-1: a zero item)
  int r0, r1;  // nn/nt: the tile's rows [r0, r1); dw: the expert's rows
  int c0;      // nn/nt: first output column; dw: first dW row (K index)
  int n0;      // dw: first dW column
  int chunks;  // contraction chunks (0: a zero item)
};

template <int MODE, int BN>
struct Plan {
  const int* offs;  // (E + 1) row offsets, clamped to M
  const int* tab;   // nn/nt: (E + 1) tile prefix; dw: experts by falling row count
  int M, E, nt, kt, chunks_c, items;

  __device__ __forceinline__ Item item(int i) const {
    Item it;
    if (MODE == DW) {
      const int per = kt * nt, r = i / per, rem = i % per;
      it.e = tab[r];
      it.r0 = offs[it.e];
      it.r1 = offs[it.e + 1];
      it.c0 = (rem / nt) * BM;
      it.n0 = (rem % nt) * BN;
      it.chunks = (it.r1 - it.r0 + BK - 1) / BK;
      return it;
    }
    const int t = i / nt;
    it.c0 = (i % nt) * BN;
    it.n0 = 0;
    if (t < tab[E]) {  // the expert e with tab[e] <= t < tab[e + 1]
      int lo = 0, hi = E - 1;
      while (lo < hi) {
        const int mid = (lo + hi + 1) / 2;
        if (tab[mid] <= t) lo = mid; else hi = mid - 1;
      }
      it.e = lo;
      it.r0 = offs[lo] + BM * (t - tab[lo]);
      it.r1 = min(it.r0 + BM, offs[lo + 1]);
      it.chunks = chunks_c;
    } else {  // rows past the last group
      it.e = -1;
      it.r0 = offs[E] + BM * (t - tab[E]);
      it.r1 = min(it.r0 + BM, M);
      it.chunks = 0;
    }
    return it;
  }
};

// thread 0's side: the next chunk to load, across this CTA's items
template <int MODE, int BN>
struct Producer {
  int item, chunk;
  Item it;
  unsigned pc;  // loads issued

  __device__ __forceinline__ void seek(const Plan<MODE, BN>& p) {
    while (item < p.items) {
      it = p.item(item);
      if (it.chunks > 0) return;
      item += gridDim.x;
    }
  }

  __device__ __forceinline__ void issue(const Plan<MODE, BN>& p, const CUtensorMap* ta,
                                        const CUtensorMap* tb, uint32_t sbase) {
    constexpr int STAGES = Cfg<MODE, BN>::STAGES;
    using Lay = L<MODE, BN>;
    if (item >= p.items) return;
    const uint32_t s = pc % STAGES;
    const uint32_t full = sbase + Lay::BAR + 8 * s, empty = full + 8 * STAGES;
    if (pc >= (unsigned)STAGES) mbar_wait(empty, (pc / STAGES - 1) & 1);
    const uint32_t sa = sbase + s * Lay::STAGE, sb = sa + A_BYTES;
    mbar_expect_tx(full, Lay::STAGE);
    const int k0 = chunk * BK;
    if (MODE == DW) {
      const int row = it.r0 + k0;
      for (int h = 0; h < 2; ++h) tma_load_2d(sa + h * BOX, ta, full, it.c0 + 64 * h, row);
      for (int h = 0; h < BN / 64; ++h) tma_load_2d(sb + h * BOX, tb, full, it.n0 + 64 * h, row);
    } else {
      tma_load_2d(sa, ta, full, k0, it.r0);  // 128 rows x 64 contraction columns
      if (MODE == NN)
        for (int h = 0; h < BN / 64; ++h)  // W[e] rows k0.., columns c0 + 64 h..
          tma_load_3d(sb + h * BOX, tb, full, it.c0 + 64 * h, k0, it.e);
      else  // W[e] rows c0.. (the output columns), columns k0.. (the contraction)
        tma_load_3d(sb, tb, full, k0, it.c0, it.e);
    }
    ++pc;
    if (++chunk == it.chunks) {
      chunk = 0;
      item += gridDim.x;
      seek(p);
    }
  }
};

template <int BN, int TA, int TB>
__device__ __forceinline__ void mma(float (&d)[BN / 2], uint64_t da, uint64_t db, int acc) {
  if constexpr (BN == 256)
    wgmma_m64n256_ss<TA, TB>(d, da, db, acc);
  else
    wgmma_m64n128_ss<TA, TB>(d, da, db, acc);
}

// RED (dw only): add the f32 result into dW by TMA reduce-add stores in
// place of plain stores (the fused-CE backward's dW over row chunks)
template <int MODE, int BN, bool RED = false>
__global__ void __launch_bounds__(NTHREADS, 1)
grouped_kernel(const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_b,
               const __grid_constant__ CUtensorMap tm_out, const Args a) {
  constexpr int STAGES = Cfg<MODE, BN>::STAGES, SB = Cfg<MODE, BN>::SB;
  using Lay = L<MODE, BN>;
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

  // the tables: offsets (clamped to M), then the tile prefix (nn/nt) or
  // the experts by falling row count (dw)
  {
    const int n = tid < E ? max(a.sizes[tid], 0) : 0;
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
      const int tiles = tid < E ? (re - rs + BM - 1) / BM : 0;
      const int tex = block_scan<NTHREADS>(tiles, wsum, total);
      if (tid < E) tab[tid] = tex;
      if (tid == 0) tab[E] = total;
    }
  }
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(sbase + Lay::BAR + 8 * s, 1);
      mbar_init(sbase + Lay::BAR + 8 * (STAGES + s), NTHREADS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  Plan<MODE, BN> plan;
  plan.offs = offs;
  plan.tab = tab;
  plan.M = M;
  plan.E = E;
  if (MODE == DW) {
    plan.nt = (a.N + BN - 1) / BN;
    plan.kt = (a.K + BM - 1) / BM;
    plan.chunks_c = 0;
    plan.items = E * plan.kt * plan.nt;
  } else {
    plan.nt = (a.N + BN - 1) / BN;
    plan.kt = 0;
    plan.chunks_c = (a.C + BK - 1) / BK;
    plan.items = (tab[E] + (M - offs[E] + BM - 1) / BM) * plan.nt;
  }

  Producer<MODE, BN> prod;
  unsigned long long n_prod = 0, n_zero = 0, n_chunks = 0;
  if (tid == 0) {
    prod.item = blockIdx.x;
    prod.chunk = 0;
    prod.pc = 0;
    prod.seek(plan);
    for (int s = 0; s < STAGES; ++s) prod.issue(plan, &tm_a, &tm_b, sbase);
  }

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  const int row0 = 16 * warp + lane / 4;  // this thread's rows of its warpgroup: row0, row0 + 8
  uint32_t stage = 0, phase = 0;

  // every warp's arrival on the stage's empty barrier; thread 0 then
  // refills the ring (it waits for all eight warps)
  auto release = [&](uint32_t s) {
    __syncwarp();
    if (lane == 0) mbar_arrive(sbase + Lay::BAR + 8 * (STAGES + s));
    if (tid == 0) prod.issue(plan, &tm_a, &tm_b, sbase);
    __syncwarp();
  };

  for (int i = blockIdx.x; i < plan.items; i += gridDim.x) {
    const Item it = plan.item(i);
    if (it.chunks == 0) {
      // zero item: nn/nt rows past the last group, or an empty expert's dW
      if constexpr (MODE == DW) {
        float* dw = static_cast<float*>(a.out) + (int64_t)it.e * a.K * a.N;
        const int rows = min(BM, a.K - it.c0), cols = min(BN, a.N - it.n0);
        for (int j = tid; j < rows * (cols / 4); j += NTHREADS) {
          const int r = it.c0 + j / (cols / 4), c = it.n0 + 4 * (j % (cols / 4));
          *reinterpret_cast<float4*>(dw + (int64_t)r * a.N + c) = make_float4(0.f, 0.f, 0.f, 0.f);
        }
      } else {
        __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out);
        const int cols = min(BN, a.N - it.c0);
        for (int j = tid; j < (it.r1 - it.r0) * (cols / 8); j += NTHREADS) {
          const int r = it.r0 + j / (cols / 8), c = it.c0 + 8 * (j % (cols / 8));
          *reinterpret_cast<uint4*>(out + (int64_t)r * a.N + c) = make_uint4(0u, 0u, 0u, 0u);
        }
      }
      n_zero += 1;
      continue;
    }
    n_prod += 1;
    n_chunks += it.chunks;
    uint32_t prev = 0;
    for (int c = 0; c < it.chunks; ++c) {
      const uint32_t sa = sbase + stage * Lay::STAGE, sb = sa + A_BYTES;
      mbar_wait(sbase + Lay::BAR + 8 * stage, phase);
      if (MODE == DW) {
        const int valid = it.r1 - it.r0 - c * BK;
        if (valid < BK) {
          // rows past the expert read as zeros in both operands: whole
          // 128-byte rows, the same bytes under the swizzle
          unsigned char* st = smem + stage * Lay::STAGE;
          const int nrows = (BK - valid) * (2 + BN / 64);
          for (int j = tid; j < nrows * 8; j += NTHREADS) {
            const int r = j / 8, box = r / (BK - valid), rr = valid + r % (BK - valid);
            *reinterpret_cast<uint4*>(st + box * BOX + rr * 128 + 16 * (j % 8)) =
                make_uint4(0u, 0u, 0u, 0u);
          }
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
          named_sync(3, NTHREADS);
        }
      }
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const int first = c > 0 || kk > 0;
        if (MODE == NN)
          mma<BN, 0, 1>(acc, desc(sa + wg * BOX + 32 * kk, 16, 1024),
                        desc(sb + 2048 * kk, BOX, 1024), first);
        else if (MODE == NT)
          mma<BN, 0, 0>(acc, desc(sa + wg * BOX + 32 * kk, 16, 1024),
                        desc(sb + 32 * kk, 16, 1024), first);
        else
          mma<BN, 1, 1>(acc, desc(sa + wg * BOX + 2048 * kk, BOX, 1024),
                        desc(sb + 2048 * kk, BOX, 1024), first);
      }
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

    const bool lead = tid % 128 == 0;
    unsigned char* stg = smem + Lay::STG + wg * SB * BOX;
    const uint32_t stg_s = sbase + Lay::STG + wg * SB * BOX;
    if constexpr (MODE == DW) {
      // f32 dW rows c0 + 64 wg.., through this warpgroup's staging boxes of
      // 32 columns (128-byte swizzled), SB at a time, by TMA stores into
      // the (N, K, E) map: they stream out while the next item computes
      const int k0 = it.c0 + 64 * wg;
#pragma unroll
      for (int round = 0; round < Lay::ROUNDS; ++round) {
        if (lead) tma_store_wait();  // the last stores have read the staging boxes
        named_sync(1 + wg, 128);
#pragma unroll
        for (int b = 0; b < SB; ++b)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int j = (round * SB + b) * 4 + jj, R = row0 + 8 * r;
              *reinterpret_cast<float2*>(stg + b * BOX + R * 128 +
                                         (((2 * jj + tq / 2) ^ (R & 7)) << 4) + 8 * (tq & 1)) =
                  make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
            }
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        named_sync(1 + wg, 128);
        if (lead && k0 < a.K) {
          for (int b = 0; b < SB; ++b) {
            const int col = it.n0 + 32 * (round * SB + b);
            if (col >= a.N) continue;
            if constexpr (RED)
              tma_reduce_add_3d(&tm_out, stg_s + b * BOX, col, k0, it.e);
            else
              tma_store_3d(&tm_out, stg_s + b * BOX, col, k0, it.e);
          }
          tma_store_commit();
        }
      }
    } else {
      // bf16 through this warpgroup's staging boxes, SB at a time; whole
      // rows of the expert by TMA, its last partial rows by masked stores
      const int m0 = it.r0 + 64 * wg;
      const bool whole = m0 + 64 <= it.r1;
#pragma unroll
      for (int round = 0; round < Lay::ROUNDS; ++round) {
        if (lead) tma_store_wait();  // the last stores have read the staging boxes
        named_sync(1 + wg, 128);
#pragma unroll
        for (int b = 0; b < SB; ++b)
#pragma unroll
          for (int jj = 0; jj < 8; ++jj)
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int j = (round * SB + b) * 8 + jj, R = row0 + 8 * r;
              *reinterpret_cast<uint32_t*>(stg + b * BOX + R * 128 + ((jj ^ (R & 7)) << 4) +
                                           4 * tq) = pack_bf16(acc[4 * j + 2 * r],
                                                               acc[4 * j + 2 * r + 1]);
            }
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        named_sync(1 + wg, 128);
        const int col0 = it.c0 + 64 * round * SB;
        if (whole) {
          if (lead) {
            for (int b = 0; b < SB; ++b)
              if (col0 + 64 * b < a.N) tma_store_2d(&tm_out, stg_s + b * BOX, col0 + 64 * b, m0);
            tma_store_commit();
          }
        } else {
          __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out);
          const int rows = it.r1 - m0;  // < 64; may be <= 0 for the second warpgroup
          for (int j = tid % 128; j < max(rows, 0) * SB * 8; j += 128) {
            const int R = j / (SB * 8), b = (j / 8) % SB, c16 = j % 8;
            const int col = col0 + 64 * b + 8 * c16;
            if (col < a.N)
              *reinterpret_cast<uint4*>(out + (int64_t)(m0 + R) * a.N + col) =
                  *reinterpret_cast<const uint4*>(stg + b * BOX + R * 128 +
                                                  ((c16 ^ (R & 7)) << 4));
          }
        }
      }
    }
  }
  if (tid % 128 == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");  // stores done
  if (tid == 0 && a.counts != nullptr) {
    atomicAdd(a.counts, n_prod);
    atomicAdd(a.counts + 1, n_zero);
    atomicAdd(a.counts + 2, n_chunks);
  }
}

template <int MODE, int BN, bool RED = false>
int launch(const CUtensorMap& ta, const CUtensorMap& tb, const CUtensorMap& tout, const Args& a,
           int max_items, cudaStream_t stream) {
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  cudaError_t e = cudaFuncSetAttribute(grouped_kernel<MODE, BN, RED>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)L<MODE, BN>::BYTES);
  if (e != cudaSuccess) return (int)e;
  grouped_kernel<MODE, BN, RED><<<min(sms, max_items), NTHREADS, L<MODE, BN>::BYTES, stream>>>(
      ta, tb, tout, a);
  return (int)cudaGetLastError();
}

}  // namespace

// x (M, C), w (E, K, N), group_sizes (E,) int32 -> out (M, N) (trans = 0,
// C == K) or (M, K) (trans = 1, C == N); counts: device uint64 [items
// with products, zero items, chunks] or null
extern "C" int xt_grouped_gemm_bf16(const void* x, const void* w, const void* group_sizes,
                                    void* out, int M, int C, int E, int K, int N, int trans,
                                    void* counts, void* stream) {
  const int nout = trans ? K : N;
  if (M < 0 || E <= 0 || E > MAX_E || C % 32 != 0 || C != (trans ? N : K) || nout % 8 != 0 ||
      K <= 0 || N <= 0)
    return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  const int bn = nout <= 128 ? 128 : 256;
  const cuuint64_t dx[2] = {(cuuint64_t)C, (cuuint64_t)M};
  const cuuint64_t dwt[3] = {(cuuint64_t)N, (cuuint64_t)K, (cuuint64_t)E};
  const cuuint64_t dout[2] = {(cuuint64_t)nout, (cuuint64_t)M};
  const cuuint32_t bx[2] = {64, BM}, bout[2] = {64, 64};
  const cuuint32_t bw[3] = {64, trans ? (cuuint32_t)bn : 64u, 1};
  CUtensorMap tx, tw, tout;
  if (!make_map_nd(&tx, encode, x, 2, dx, bx) || !make_map_nd(&tw, encode, w, 3, dwt, bw) ||
      !make_map_nd(&tout, encode, out, 2, dout, bout))
    return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const int*>(group_sizes), out,
               static_cast<unsigned long long*>(counts), M, E, C, K, nout};
  // tiles: at most ceil(n_e / 128) per expert and ceil(tail / 128), so
  // below M / 128 + E + 1
  const int64_t items = ((int64_t)M / BM + E + 1) * ((nout + bn - 1) / bn);
  const int max_items = (int)std::min<int64_t>(items, 1 << 30);
  cudaStream_t s = (cudaStream_t)stream;
  if (trans)
    return bn == 256 ? launch<NT, 256>(tx, tw, tout, a, max_items, s)
                     : launch<NT, 128>(tx, tw, tout, a, max_items, s);
  return bn == 256 ? launch<NN, 256>(tx, tw, tout, a, max_items, s)
                   : launch<NN, 128>(tx, tw, tout, a, max_items, s);
}

// x (M, K), dy (M, N), group_sizes (E,) int32 -> dw (E, K, N) f32; counts
// as above
extern "C" int xt_grouped_gemm_dw_bf16(const void* x, const void* dy, const void* group_sizes,
                                       void* dw, int M, int E, int K, int N, void* counts,
                                       void* stream) {
  if (M < 0 || E <= 0 || E > MAX_E || K % 16 != 0 || N % 16 != 0 || K <= 0 || N <= 0)
    return (int)cudaErrorInvalidValue;
  if (M == 0)  // no rows: every expert is empty
    return (int)cudaMemsetAsync(dw, 0, (size_t)E * K * N * 4, (cudaStream_t)stream);
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  const int bn = N <= 128 ? 128 : 256;
  const cuuint64_t dxm[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t dym[2] = {(cuuint64_t)N, (cuuint64_t)M};
  const cuuint64_t ddw[3] = {(cuuint64_t)N, (cuuint64_t)K, (cuuint64_t)E};
  const cuuint32_t box[2] = {64, 64}, bdw[3] = {32, 64, 1};
  CUtensorMap tx, ty, tdw;
  if (!make_map_nd(&tx, encode, x, 2, dxm, box) || !make_map_nd(&ty, encode, dy, 2, dym, box) ||
      !make_map_nd(&tdw, encode, dw, 3, ddw, bdw, true))
    return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const int*>(group_sizes), dw,
               static_cast<unsigned long long*>(counts), M, E, 0, K, N};
  const int items = E * ((K + BM - 1) / BM) * ((N + bn - 1) / bn);
  cudaStream_t s = (cudaStream_t)stream;
  return bn == 256 ? launch<DW, 256>(tx, ty, tdw, a, items, s)
                   : launch<DW, 128>(tx, ty, tdw, a, items, s);
}

// Dense products of the fused-CE backward (csrc/fused_ce.cu, driven by
// ops/fused_ce.py::ce_bwd): the same kernel with one group of M rows, whose
// size `rows` ((1,) int32) holds on the device. No walked counts: the MoE
// layer's counters stay its own.
//
// nn: out (M, N) bf16 = x[:, :K] @ w, x (M, ldx) bf16 with ldx >= K
// rounded up to 64, w (K, N) bf16; w's rows past K read as zeros.
extern "C" int xt_gemm_nn_bf16(const void* x, const void* w, const void* rows, void* out, int M,
                               int ldx, int K, int N, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || N % 8 != 0 || ldx % 64 != 0 || ldx < (K + 63) / 64 * 64)
    return (int)cudaErrorInvalidValue;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  // BN 128 where its tiles fill the card's waves clearly better than
  // 256's (a chunk of few rows), else the wider, cheaper tile
  auto fill = [&](int bn) {
    const int items = (M + BM - 1) / BM * ((N + bn - 1) / bn);
    return (double)items / (double)(((items + sms - 1) / sms) * sms);
  };
  const int bn = (N <= 128 || fill(128) > 1.1 * fill(256)) ? 128 : 256;
  const cuuint64_t dx[2] = {(cuuint64_t)ldx, (cuuint64_t)M};
  const cuuint64_t dwt[3] = {(cuuint64_t)N, (cuuint64_t)K, 1};
  const cuuint64_t dout[2] = {(cuuint64_t)N, (cuuint64_t)M};
  const cuuint32_t bx[2] = {64, BM}, bout[2] = {64, 64}, bw[3] = {64, 64, 1};
  CUtensorMap tx, tw, tout;
  if (!make_map_nd(&tx, encode, x, 2, dx, bx) || !make_map_nd(&tw, encode, w, 3, dwt, bw) ||
      !make_map_nd(&tout, encode, out, 2, dout, bout))
    return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const int*>(rows), out, nullptr, M, 1, K, K, N};
  const int max_items = (M / BM + 2) * ((N + bn - 1) / bn);
  cudaStream_t s = (cudaStream_t)stream;
  return bn == 256 ? launch<NN, 256>(tx, tw, tout, a, max_items, s)
                   : launch<NN, 128>(tx, tw, tout, a, max_items, s);
}

// dw: dw (K, N) f32 = x[:, :K]^T @ dy (accumulate = 0) or += it
// (accumulate = 1, by TMA reduce-add; each launch adds each tile once, so
// the sum over launches is taken in launch order), x (M, ldx) bf16 with
// ldx >= K, dy (M, N) bf16.
extern "C" int xt_gemm_dw_bf16(const void* x, const void* dy, const void* rows, void* dw, int M,
                               int ldx, int K, int N, int accumulate, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || N % 16 != 0 || ldx % 8 != 0 || ldx < K)
    return (int)cudaErrorInvalidValue;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  const int bn = N <= 128 ? 128 : 256;
  const cuuint64_t dxm[2] = {(cuuint64_t)ldx, (cuuint64_t)M};
  const cuuint64_t dym[2] = {(cuuint64_t)N, (cuuint64_t)M};
  const cuuint64_t ddw[3] = {(cuuint64_t)N, (cuuint64_t)K, 1};
  const cuuint32_t box[2] = {64, 64}, bdw[3] = {32, 64, 1};
  CUtensorMap tx, ty, tdw;
  if (!make_map_nd(&tx, encode, x, 2, dxm, box) || !make_map_nd(&ty, encode, dy, 2, dym, box) ||
      !make_map_nd(&tdw, encode, dw, 3, ddw, bdw, true))
    return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const int*>(rows), dw, nullptr, M, 1, 0, K, N};
  const int items = (K + BM - 1) / BM * ((N + bn - 1) / bn);
  cudaStream_t s = (cudaStream_t)stream;
  if (accumulate)
    return bn == 256 ? launch<DW, 256, true>(tx, ty, tdw, a, items, s)
                     : launch<DW, 128, true>(tx, ty, tdw, a, items, s);
  return bn == 256 ? launch<DW, 256>(tx, ty, tdw, a, items, s)
                   : launch<DW, 128>(tx, ty, tdw, a, items, s);
}

// the dynamic shared memory of one CTA (bytes): mode 0 nn, 1 nt, 2 dw; bn 128 or 256
extern "C" int xt_grouped_gemm_smem_bytes(int mode, int bn) {
  if (mode == NN) return bn == 256 ? (int)L<NN, 256>::BYTES : (int)L<NN, 128>::BYTES;
  if (mode == NT) return bn == 256 ? (int)L<NT, 256>::BYTES : (int)L<NT, 128>::BYTES;
  return bn == 256 ? (int)L<DW, 256>::BYTES : (int)L<DW, 128>::BYTES;
}
