// Block-sparse flash attention over selected key blocks (DSA), forward and
// backward, for Hopper (sm_90a): wgmma products fed by TMA loads through
// mbarrier rings, the accumulators in registers.
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
// What bounds it on the H100: the tensor-core work on the visible pairs (2
// products forward, 5 backward, 2 (D or DV) FLOPs per pair each) at 989
// TFLOP/s; HBM traffic is q, k, v, do, out once each plus what L2 does not
// serve of the selected K/V (forward, dq) and Q/dO (dk/dv) tiles.
//
// Work order. Tiles are 64 rows. A 64-row tile table of the segment ids
// (tile_table.cuh; {lowest id, highest, the id if one document and no
// padding}) lets a walk skip, without a load, every tile whose segment range
// cannot meet the other side's, and take a tile wholly inside the rows' one
// document and below the diagonal without the per-element mask (JAX
// _tile_full). Thread 0 walks and issues every TMA load; each ring stage
// carries its item ({key or q tile, slots, full flags}) beside the data, so
// consumers follow the walk by reading it after the stage's full barrier.
// ops/attention/block_sparse.py::fwd_walk and dkv_walk are the same walks
// in torch, tested against the visible pairs.
// - forward (#14): one CTA of two consumer warpgroups per (128-row q tile,
//   q head, batch row); warpgroup w owns q rows [64 w, 64 w + 64) and keeps
//   their O (64 x DV f32: 128 registers a thread at DV 256), row max and
//   sum and the current slot's exp-sum in registers. At block 64 (or any
//   odd multiple of 64) the two halves can sit in different q-blocks: the
//   walk merges the halves' selections (both ascending) into one stream of
//   key blocks, each with its slot in either half or -1, so a key block
//   both chose is loaded once; a half that does not run a tile skips its
//   products, and still waits for the tile's loads (a parity wait must not
//   skip a phase) and releases the stage. Per key tile: S = Q K^T on
//   wgmma m64n64k16 (SS, both K-major); the softmax in the accumulator
//   layout in base 2 with the alpha rescale of O in registers; P packed to
//   bf16 A fragments; O += P V on wgmma m64n64k16 per 64 columns (RS, V the
//   MN-major B). The next tile's S is issued before the last PV is waited
//   on. A slot's exp-sum is carried in the running-max frame and written as
//   a base-2 log when the slot's last tile is done; the epilogue turns it
//   into the mass with the final lse. out = O / l is staged in the
//   warpgroup's own rows of the Q buffer and written by TMA stores.
//   Shared memory: Q (128 rows, loaded once) and a ring of K and V tiles
//   (K and V each with a full barrier, one empty barrier per stage).
// - backward (#15), five launches counted as one: the tile table; delta =
//   rowsum(do * out) (bs_delta_kernel, one warp per row and head); the
//   inverse of block_idx (per row and key block, the q-blocks that chose
//   it, ascending); then
//   - dq: the forward's CTAs and walk; Q and dO of the 128 rows resident;
//     per key tile S and dP = dO V^T on m64n64k16 SS, P and dS in
//     registers, dQ += dS K on m64n64k16 RS (K the MN-major B), dQ (64 x D
//     f32 a warpgroup) written once, times scale, by TMA stores. K and V
//     have separate rings, V one stage shorter: V is free once dP is done,
//     K only after dQ's product (at 256/256 the resident 128 KB leave room
//     for two K and one V stage);
//   - dk/dv: one CTA per (64-key tile, kv head, batch row) with K and V
//     resident; the walk goes over the q heads of the group and, per head,
//     the q tiles of the q-blocks that chose the key tile's block, Q, dO,
//     lse, delta and the q segment ids streamed through a ring. dK and dV
//     of 64 keys at 256/256 would be 256 f32 registers for one warpgroup,
//     so the warpgroups split by output: warpgroup 0 computes S^T = K Q^T,
//     P^T (to a shared f32 buffer, handed over by named barriers) and dV +=
//     P^T dO; warpgroup 1 computes dP^T = V dO^T, dS^T = P^T (dP^T - delta)
//     and dK += dS^T Q (RS products, Q and dO the MN-major B operands).
//   Every output is written once: no atomics, no reduce-add, so two
//   launches give the same bits.
// - (D, DV) in {(256, 256), (192, 128), (128, 128)}, templates; the
//   wrapper raises on any other. block: any multiple of 64 dividing L.
// - 256 threads, so ptxas may give each up to 255 registers (a producer
//   warpgroup under setmaxnreg is capped at the launch bound: flash_bwd.cu).
//   ptxas (nvcc -Xptxas -v, sm_90a, CUDA 12.9), registers and dynamic
//   shared memory at 256/256, 192/128, 128/128, 0 bytes of spills in every
//   instantiation (chip_smoke.py's build phase prints them):
//     bs_fwd_kernel  236, 166, 166;  197,832, 214,296, 165,144 bytes
//     bs_dq_kernel   253, 230, 196;  230,600, 230,696, 181,544 bytes
//     bs_dkv_kernel  226, 196, 164;  215,704, 225,496, 184,536 bytes
//   At GLM-5.2's shapes (B1 L16384 H64, 256/256, block 256, S 8) on an
//   H100 80GB HBM3 at 700 W: #14 4.37 ms (36% of its bound) at a synthetic
//   selection of long documents, 1.16 ms (56%, bytes) at the recipe's own;
//   #15 14.7 ms (27%) and 3.64 ms (35%). PERF.md §6 has the table.

#include <math.h>

#include "sm90.cuh"
#include "tile_table.cuh"

namespace {

constexpr int TILE = 64;  // q rows of a warpgroup; keys of a key tile
constexpr int NTHREADS = 256;
constexpr float NEG_INF = -1e30f;
constexpr float BIG_LSE = 1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr uint32_t BOX = TILE * 128;  // one 64-column box of a 64-row tile: 8 KB
constexpr uint32_t TILE_CAP = 225 * 1024;  // tiles of a CTA; the rest: barriers, slack
constexpr int NONE = 0x7fffffff;
// named barriers of the dk/dv pass (0 is __syncthreads)
constexpr int BAR_P_FULL = 1, BAR_P_EMPTY = 2;

constexpr uint32_t tile_bytes(int rows, int cols) { return (uint32_t)rows * cols * 2; }

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(p) + 1023) &
                                          ~static_cast<uintptr_t>(1023));
}

__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ bool meets(int4 a, int4 c) { return a.y >= c.x && a.x <= c.y; }

template <int M, int N>
__device__ __forceinline__ void reg_fence(float (&r)[M][N]) {
#pragma unroll
  for (int m = 0; m < M; ++m) reg_fence(r[m]);
}

// ------------------------------------------------------------------ walks
// the forward's and the dq pass's walk of one CTA of 128 q rows (halves x =
// 0, 1: q tiles 2 i + x), held in shared memory and advanced by thread 0
struct QWalk {
  const int* sel[2];  // each half's selection (S slots), null past L
  const int4* tiles;  // this batch row's tile table
  int4 qt[2];         // the halves' table entries
  int qi[2];          // the halves' q tiles
  int S, bpt;         // slots; key tiles per block
  int p[2];           // each half's next slot
  int s[2];           // the current key block's slot in each half, -1 if not chosen
  int kt, kt_end;     // the current block's next key tile, and its causal end
  int done, produced;  // the walk is over; items produced (dq: the V stream reads it)
};

__device__ __forceinline__ void qwalk_init(QWalk& w, const int* block_idx, const int4* tiles,
                                           int b, int i, int L, int Lp, int block, int S) {
  const int nq = L / block;
  w.tiles = tiles + (int64_t)b * (Lp / TILE);
  w.S = S;
  w.bpt = block / TILE;
  for (int x = 0; x < 2; ++x) {
    w.qi[x] = 2 * i + x;
    const int r = TILE * w.qi[x];
    w.sel[x] = r < L ? block_idx + ((int64_t)b * nq + r / block) * S : nullptr;
    w.p[x] = r < L ? 0 : S;
    w.qt[x] = w.tiles[w.qi[x]];
  }
  w.kt = w.kt_end = 0;
  w.done = w.produced = 0;
}

// the next item: {key tile, slot of half 0 or -1, slot of half 1 or -1,
// full flags (bit x: half x skips the per-element mask)}; false at the end
__device__ bool qwalk_next(QWalk& w, int4& item) {
  for (;;) {
    if (w.kt >= w.kt_end) {  // the next key block of the merged selections
      int hd[2];
      for (int x = 0; x < 2; ++x) {
        while (w.p[x] < w.S && w.sel[x][w.p[x]] < 0) ++w.p[x];
        hd[x] = w.p[x] < w.S ? w.sel[x][w.p[x]] : NONE;
      }
      const int jb = min(hd[0], hd[1]);
      if (jb == NONE) return false;
      for (int x = 0; x < 2; ++x) w.s[x] = hd[x] == jb ? w.p[x]++ : -1;
      w.kt = jb * w.bpt;
      w.kt_end = min(w.kt + w.bpt, w.qi[1] + 1);  // no key past the CTA's last row
    }
    const int kt = w.kt++;
    const int4 k = w.tiles[kt];
    int slot[2], full = 0;
    for (int x = 0; x < 2; ++x) {
      const bool run = w.s[x] >= 0 && kt <= w.qi[x] && meets(k, w.qt[x]);
      slot[x] = run ? w.s[x] : -1;
      if (run && kt < w.qi[x] && w.qt[x].z != 0 && k.z == w.qt[x].z) full |= 1 << x;
    }
    if (slot[0] >= 0 || slot[1] >= 0) {
      item = make_int4(kt, slot[0], slot[1], full);
      return true;
    }
  }
}

// the dk/dv pass's walk of one CTA (a 64-key tile of one kv head): the q
// heads of the group, then the q-blocks that chose the key tile's block
// (ascending), then their q tiles from the key tile's diagonal
struct KWalk {
  const int* chose;   // the q-blocks that chose this block
  const int4* tiles;  // this batch row's tile table
  int4 kt4;           // the key tile's table entry
  int n_sel, bpt, ratio, g, kt;
  int r, c, qt, qt_end;
  int done;
};

// the next item: {q tile, q head, full, 0}; false at the end
__device__ bool kwalk_next(KWalk& w, int4& item) {
  if (w.n_sel == 0) return false;
  for (;;) {
    if (w.qt >= w.qt_end) {
      if (++w.c >= w.n_sel) {
        w.c = 0;
        if (++w.r >= w.ratio) return false;
      }
      const int i = w.chose[w.c];
      w.qt = max(i * w.bpt, w.kt);  // a q tile before the key tile sees none of it
      w.qt_end = (i + 1) * w.bpt;
    }
    const int q = w.qt++;
    const int4 t = w.tiles[q];
    if (!meets(t, w.kt4)) continue;
    const int full = q > w.kt && w.kt4.z != 0 && t.z == w.kt4.z;
    item = make_int4(q, w.g * w.ratio + w.r, full, 0);
    return true;
  }
}

// ---------------------------------------------------------------- forward
template <int D, int DV>
struct Fwd {
  static constexpr uint32_t QB = tile_bytes(2 * TILE, D);  // Q: 128 rows
  static constexpr uint32_t KB = tile_bytes(TILE, D), VB = tile_bytes(TILE, DV);
  static constexpr int FIT = (TILE_CAP - QB) / (KB + VB);
  static constexpr int STAGES = FIT > 4 ? 4 : FIT;
  static constexpr uint32_t OFF_K = QB;
  static constexpr uint32_t OFF_V = OFF_K + STAGES * KB;
  static constexpr uint32_t OFF_META = OFF_V + STAGES * VB;  // an int4 item per stage
  static constexpr uint32_t OFF_WALK = OFF_META + 16 * STAGES;
  static constexpr uint32_t OFF_BAR = OFF_WALK + (sizeof(QWalk) + 15) / 16 * 16;
  // K full, V full, empty [STAGES]; Q
  static constexpr uint32_t BYTES = OFF_BAR + 8 * (3 * STAGES + 1) + 1024;
  static_assert(STAGES >= 2 && BYTES <= 232448, "fits one SM");
};

struct FwdArgs {
  const int* block_idx;  // (B, L / block, S)
  const int* seg;        // (B, L)
  const int4* tiles;     // (B, Lp / 64)
  float* lse;            // (B, Hq, L)
  float* mass;           // (B, L, Hq, S)
  int B, L, Lp, Hq, Hkv, block, S;
  float scale_log2e;
};

// the CTA's (q tile, q head, batch row): q tile innermost (last first), then
// the q heads of a kv group, the batch row, the kv head, so that the CTAs
// resident together read one head's K/V (from L2 after the first)
struct QCta {
  int i, h, g, b;
};
__device__ __forceinline__ QCta q_cta(int Lp, int B, int Hq, int Hkv) {
  const int ratio = Hq / Hkv, nqt = Lp / (2 * TILE);
  int x = (int)blockIdx.x;
  QCta c;
  c.i = nqt - 1 - x % nqt;
  x /= nqt;
  const int hr = x % ratio;
  x /= ratio;
  c.b = x % B;
  c.g = x / B;
  c.h = c.g * ratio + hr;
  return c;
}

// P of one (64 q rows, 64 keys) tile from S in the accumulator layout (rows
// row0 + 8 r, keys k0 + 8 j + 2 tq + cc for s[4 j + 2 r + cc]), packed to
// bf16 A fragments; m, l, the slot's sum `ss` and O rescaled by alpha
template <bool MASK, int NO>
__device__ __forceinline__ void fwd_softmax(float (&s)[32], uint32_t (&pa)[16],
                                            float (&o)[NO][32], float (&m)[2], float (&l)[2],
                                            float (&ss)[2], float c, const int* seg, int k0,
                                            const int (&qs)[2], const int (&qpos)[2], int tq) {
  float mx[2] = {m[0], m[1]};
  if (MASK) {
    int ks[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) ks[e] = seg[k0 + 8 * (e / 2) + 2 * tq + e % 2];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int j = i / 4, r = (i / 2) % 2, cc = i % 2;
      const bool ok = qs[r] != 0 && ks[2 * j + cc] == qs[r] && k0 + 8 * j + 2 * tq + cc <= qpos[r];
      s[i] = ok ? s[i] * c : __int_as_float(0xff800000);  // -inf
      mx[r] = fmaxf(mx[r], s[i]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] *= c;
      mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], s[i]);
    }
  }
  float alpha[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    alpha[r] = exp2f(m[r] - mx[r]);  // m starts at -1e30: a row's first visible key gives 0
    m[r] = mx[r];
    l[r] *= alpha[r];
    ss[r] *= alpha[r];
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = (i / 2) % 2;
    const float p = exp2f(s[i] - mx[r]);  // masked: exp2(-inf) = 0
    l[r] += p;
    ss[r] += p;
    s[i] = p;
  }
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[n][i] *= alpha[(i / 2) % 2];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    pa[2 * j] = pack_bf16(s[4 * j], s[4 * j + 1]);
    pa[2 * j + 1] = pack_bf16(s[4 * j + 2], s[4 * j + 3]);
  }
}

// the quad's sums of a slot, written as its base-2 log in the frame of m
__device__ __forceinline__ void flush_slot(int slot, const float (&ss)[2], const float (&m)[2],
                                           float* const (&mrow)[2], int tq) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float v = ss[r];
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    if (tq == 0 && mrow[r] != nullptr) mrow[r][slot] = v > 0.f ? m[r] + log2f(v) : -INFINITY;
  }
}

// acc[n] (64 x 64 f32, columns 64 n..) += A (16 keys a step, bf16 registers)
// B, where B is an MN-major tile of 64 keys in 64-column boxes at `tile`
template <int N>
__device__ __forceinline__ void acc_rs(float (&acc)[N][32], const uint32_t (&a)[16],
                                       uint32_t tile) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk)
      wgmma_m64n64_rs<1>(acc[n], a[4 * kk], a[4 * kk + 1], a[4 * kk + 2], a[4 * kk + 3],
                         desc(tile + n * BOX + kk * 2048, BOX, 1024));
}

// s (64 x 64 f32) = A B^T over X columns: A, B K-major tiles of 64 rows in
// 64-column boxes, box strides a_box and BOX
template <int X>
__device__ __forceinline__ void ss_nt(float (&s)[32], uint32_t a, uint32_t a_box, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < X / 16; ++kk)
    wgmma_m64n64_ss<0, 0>(s, desc(a + (kk / 4) * a_box + (kk % 4) * 32, 16, 1024),
                          desc(b + (kk / 4) * BOX + (kk % 4) * 32, 16, 1024), kk > 0);
}

// rows of a warpgroup's accumulator (times mul, to bf16) into its 64 rows
// of a 128-row buffer of 64-column boxes (box stride 2 BOX), swizzled as TMA
// reads them
template <int N>
__device__ __forceinline__ void stage_rows(unsigned char* buf, const float (&acc)[N][32],
                                           const float (&mul)[2], int wg, int row0, int tq) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int R = 64 * wg + row0 + 8 * r;
        *reinterpret_cast<uint32_t*>(buf + n * 2 * BOX + R * 128 + ((j ^ (R & 7)) << 4) +
                                     4 * tq) =
            pack_bf16(acc[n][4 * j + 2 * r] * mul[r], acc[n][4 * j + 2 * r + 1] * mul[r]);
      }
}

template <int D, int DV>
__device__ __forceinline__ void fwd_produce(QWalk* w, int4* meta, int stage, uint32_t sbase,
                                            uint32_t bar_k, uint32_t bar_v,
                                            const CUtensorMap* tm_k, const CUtensorMap* tm_v,
                                            int g, int b) {
  using C = Fwd<D, DV>;
  int4 it;
  const uint32_t fk = bar_k + 8 * stage, fv = bar_v + 8 * stage;
  if (!qwalk_next(*w, it)) {  // the end marker
    w->done = 1;
    meta[stage] = make_int4(-1, -1, -1, 0);
    mbar_arrive(fk);
    return;
  }
  meta[stage] = it;
  const int k0 = it.x * TILE;
  mbar_expect_tx(fk, C::KB);
  for (int c = 0; c < D / 64; ++c)
    tma_load(sbase + C::OFF_K + stage * C::KB + c * BOX, tm_k, fk, 64 * c, g, k0, b);
  mbar_expect_tx(fv, C::VB);
  for (int c = 0; c < DV / 64; ++c)
    tma_load(sbase + C::OFF_V + stage * C::VB + c * BOX, tm_v, fv, 64 * c, g, k0, b);
}

template <int D, int DV>
__global__ void __launch_bounds__(NTHREADS, 1)
bs_fwd_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
              const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_o,
              const FwdArgs a) {
  using C = Fwd<D, DV>;
  constexpr int ST = C::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const uint32_t sbase = smem_u32(smem);
  const uint32_t bar_k = sbase + C::OFF_BAR;  // [ST]: 1 arrival + the bytes
  const uint32_t bar_v = bar_k + 8 * ST;      // [ST]: 1 arrival + the bytes
  const uint32_t bar_e = bar_v + 8 * ST;      // [ST]: one arrival per warp
  const uint32_t bar_q = bar_e + 8 * ST;
  int4* meta = reinterpret_cast<int4*>(smem + C::OFF_META);
  QWalk* walk = reinterpret_cast<QWalk*>(smem + C::OFF_WALK);

  const QCta cta = q_cta(a.Lp, a.B, a.Hq, a.Hkv);
  const int q0 = 2 * TILE * cta.i;
  const int wg = threadIdx.x / 128;  // q rows [64 wg, 64 wg + 64) of the tile
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int tq = lane % 4, row0 = 16 * warp + lane / 4;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
      mbar_init(bar_e + 8 * s, NTHREADS / 32);
    }
    mbar_init(bar_q, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_expect_tx(bar_q, C::QB);
    for (int c = 0; c < D / 64; ++c)
      tma_load(sbase + c * 2 * BOX, &tm_q, bar_q, 64 * c, cta.h, q0, cta.b);
    qwalk_init(*walk, a.block_idx, a.tiles, cta.b, cta.i, a.L, a.Lp, a.block, a.S);
    for (int s = 0; s < ST && !walk->done; ++s)
      fwd_produce<D, DV>(walk, meta, s, sbase, bar_k, bar_v, &tm_k, &tm_v, cta.g, cta.b);
  }

  const int* seg = a.seg + (int64_t)cta.b * a.L;
  int qpos[2], qs[2];
  float* mrow[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    qpos[r] = q0 + 64 * wg + row0 + 8 * r;
    const bool in = qpos[r] < a.L;
    qs[r] = in ? seg[qpos[r]] : 0;
    mrow[r] = in ? a.mass + (((int64_t)cta.b * a.L + qpos[r]) * a.Hq + cta.h) * a.S : nullptr;
    if (in && tq == 0)
      for (int s = 0; s < a.S; ++s) mrow[r][s] = -INFINITY;  // a slot never walked: mass 0
  }
  const float c = a.scale_log2e;
  float o[DV / 64][32], s[32], m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f},
        ss[2] = {0.f, 0.f};
  uint32_t pa[16];
#pragma unroll
  for (int n = 0; n < DV / 64; ++n)
#pragma unroll
    for (int e = 0; e < 32; ++e) o[n][e] = 0.f;
#pragma unroll
  for (int e = 0; e < 32; ++e) s[e] = 0.f;
  int cur = -1;  // the slot whose sum `ss` holds
  const uint32_t sQ = sbase + wg * BOX;  // this warpgroup's rows; boxes of 128 rows
  __syncthreads();  // barriers initialised
  mbar_wait(bar_q, 0);

  for (int t = 0;; ++t) {
    const int stage = t % ST;
    const uint32_t phase = (t / ST) & 1;
    mbar_wait(bar_k + 8 * stage, phase);
    const int4 it = meta[stage];
    if (it.x < 0) break;
    const int slot = wg ? it.z : it.y;
    const bool run = slot >= 0;
    const bool full = (it.w >> wg) & 1;
    const uint32_t sK = sbase + C::OFF_K + stage * C::KB;
    const uint32_t sV = sbase + C::OFF_V + stage * C::VB;

    if (run) {  // S = Q K^T (64 q rows x 64 keys, over D)
      wg_fence();
      ss_nt<D>(s, sQ, 2 * BOX, sK);
      wg_commit();
    }
    if (t > 0) {
      // the last tile's PV is done: release its stage, and refill it
      if (run) wg_wait<1>();
      else wg_wait0();
      reg_fence(o);
      reg_fence(pa);
      const int prev = (t - 1) % ST;
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_e + 8 * prev);
      if (threadIdx.x == 0 && !walk->done) {
        mbar_wait(bar_e + 8 * prev, ((t - 1) / ST) & 1);
        fwd_produce<D, DV>(walk, meta, prev, sbase, bar_k, bar_v, &tm_k, &tm_v, cta.g, cta.b);
      }
      __syncwarp();
    }
    if (!run) {  // no phase of V skipped (see the dq kernel)
      mbar_wait(bar_v + 8 * stage, phase);
      continue;
    }
    wg_wait0();
    reg_fence(s);
    if (slot != cur) {
      if (cur >= 0) flush_slot(cur, ss, m, mrow, tq);
      cur = slot;
      ss[0] = ss[1] = 0.f;
    }
    if (full)
      fwd_softmax<false>(s, pa, o, m, l, ss, c, seg, it.x * TILE, qs, qpos, tq);
    else
      fwd_softmax<true>(s, pa, o, m, l, ss, c, seg, it.x * TILE, qs, qpos, tq);
    // O += P V (64 q rows x DV, over the 64 keys)
    mbar_wait(bar_v + 8 * stage, phase);
    wg_fence();
    acc_rs<DV / 64>(o, pa, sV);
    wg_commit();
  }
  wg_wait0();
  reg_fence(o);
  if (cur >= 0) flush_slot(cur, ss, m, mrow, tq);

  // epilogue: out = O / l to bf16 in this warpgroup's rows of the Q buffer
  // (its S products are done), TMA stores; lse; mass from the slots' logs
  float inv[2], lse2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = l[r] > 0.f ? 1.f / l[r] : 0.f;
    lse2[r] = m[r] + log2f(l[r] > 0.f ? l[r] : 1.f);
  }
  stage_rows<DV / 64>(smem, o, inv, wg, row0, tq);
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  named_sync(3 + wg, 128);
  const bool store = threadIdx.x % 128 == 0 && q0 + 64 * wg < a.L;
  if (store) {
    for (int n = 0; n < DV / 64; ++n)
      tma_store(&tm_o, sbase + n * 2 * BOX + wg * BOX, 64 * n, cta.h, q0 + 64 * wg, cta.b);
    tma_store_commit();
  }
  if (tq == 0)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (mrow[r] != nullptr) {
        const bool valid = l[r] > 0.f;
        a.lse[((int64_t)cta.b * a.Hq + cta.h) * a.L + qpos[r]] = valid ? lse2[r] * LN2 : BIG_LSE;
        for (int sl = 0; sl < a.S; ++sl)
          mrow[r][sl] = valid ? exp2f(mrow[r][sl] - lse2[r]) : 0.f;
      }
  if (store) tma_store_wait();  // the stores have read the staging rows
}

// ------------------------------------------------------ backward helpers
// delta[b, h, l] = rowsum(do * out) in f32: one warp per (b, l, h) row
__global__ void __launch_bounds__(256)
bs_delta_kernel(const __nv_bfloat16* __restrict__ out, const __nv_bfloat16* __restrict__ dout,
                float* __restrict__ delta, int rows, int L, int Hq, int DV) {
  const int w = (int)((blockIdx.x * blockDim.x + threadIdx.x) / 32);
  const int lane = threadIdx.x % 32;
  if (w >= rows) return;  // whole warps
  const __nv_bfloat16* o = out + (int64_t)w * DV;
  const __nv_bfloat16* d = dout + (int64_t)w * DV;
  float acc = 0.f;
  for (int col = 8 * lane; col < DV; col += 256) {
    const uint4 x = *reinterpret_cast<const uint4*>(o + col);
    const uint4 y = *reinterpret_cast<const uint4*>(d + col);
    const __nv_bfloat162* xp = reinterpret_cast<const __nv_bfloat162*>(&x);
    const __nv_bfloat162* yp = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 xf = __bfloat1622float2(xp[e]), yf = __bfloat1622float2(yp[e]);
      acc = fmaf(xf.x, yf.x, acc);
      acc = fmaf(xf.y, yf.y, acc);
    }
  }
  for (int off = 16; off > 0; off /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int h = w % Hq, bl = w / Hq;
    delta[((int64_t)(bl / L) * Hq + h) * L + bl % L] = acc;
  }
}

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

// --------------------------------------------------------------------- dq
template <int D, int DV>
struct Dq {
  static constexpr uint32_t QB = tile_bytes(2 * TILE, D), OB = tile_bytes(2 * TILE, DV);
  static constexpr uint32_t KB = tile_bytes(TILE, D), VB = tile_bytes(TILE, DV);
  static constexpr int PAIRS = (TILE_CAP - QB - OB) / (KB + VB);
  static constexpr int SV = PAIRS < 1 ? 1 : (PAIRS > 3 ? 3 : PAIRS);  // V stages
  static constexpr int SK = SV + 1;  // K stages: K is held until dQ's product
  static constexpr uint32_t OFF_DO = QB;
  static constexpr uint32_t OFF_K = OFF_DO + OB;
  static constexpr uint32_t OFF_V = OFF_K + SK * KB;
  static constexpr uint32_t OFF_META = OFF_V + SV * VB;  // an int4 item per K stage
  static constexpr uint32_t OFF_WALK = OFF_META + 16 * SK;
  static constexpr uint32_t OFF_BAR = OFF_WALK + (sizeof(QWalk) + 15) / 16 * 16;
  // K full, K empty [SK]; V full, V empty [SV]; Q and dO
  static constexpr uint32_t BYTES = OFF_BAR + 8 * (2 * SK + 2 * SV + 1) + 1024;
  static_assert(OFF_META <= TILE_CAP && BYTES <= 232448, "fits one SM");
};

struct DqArgs {
  const int* block_idx;
  const int* seg;
  const int4* tiles;
  const float* lse;    // (B, Hq, L)
  const float* delta;  // (B, Hq, L)
  int B, L, Lp, Hq, Hkv, block, S;
  float scale_log2e, scale;
};

template <int D, int DV>
__device__ __forceinline__ void dq_produce_k(QWalk* w, int4* meta, int stage, uint32_t sbase,
                                             uint32_t kf, const CUtensorMap* tm_k, int g,
                                             int b) {
  using C = Dq<D, DV>;
  int4 it;
  const uint32_t bar = kf + 8 * stage;
  if (!qwalk_next(*w, it)) {
    w->done = 1;
    meta[stage] = make_int4(-1, -1, -1, 0);
    mbar_arrive(bar);
    return;
  }
  meta[stage] = it;
  ++w->produced;
  mbar_expect_tx(bar, C::KB);
  for (int c = 0; c < D / 64; ++c)
    tma_load(sbase + C::OFF_K + stage * C::KB + c * BOX, tm_k, bar, 64 * c, g, it.x * TILE, b);
}

// V of item n (already in the K stream) into V stage n % SV
template <int D, int DV>
__device__ __forceinline__ void dq_produce_v(const int4* meta, int n, uint32_t sbase,
                                             uint32_t vf, const CUtensorMap* tm_v, int g,
                                             int b) {
  using C = Dq<D, DV>;
  const int stage = n % C::SV;
  const uint32_t bar = vf + 8 * stage;
  const int k0 = meta[n % C::SK].x * TILE;
  mbar_expect_tx(bar, C::VB);
  for (int c = 0; c < DV / 64; ++c)
    tma_load(sbase + C::OFF_V + stage * C::VB + c * BOX, tm_v, bar, 64 * c, g, k0, b);
}

// dS of one (64 q rows, 64 keys) tile from S and dP in the accumulator
// layout, packed to bf16 A fragments
template <bool MASK>
__device__ __forceinline__ void dq_grad(const float (&s)[32], const float (&dp)[32],
                                        uint32_t (&da)[16], float c, const float (&lse2)[2],
                                        const float (&dl)[2], const int* seg, int k0,
                                        const int (&qs)[2], const int (&qpos)[2], int tq) {
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
        const bool ok = qs[r] != 0 && seg[key] == qs[r] && key <= qpos[r];
        ds[e] = ok ? ds[e] : 0.f;
      }
    }
    da[2 * j] = pack_bf16(ds[0], ds[1]);
    da[2 * j + 1] = pack_bf16(ds[2], ds[3]);
  }
}

template <int D, int DV>
__global__ void __launch_bounds__(NTHREADS, 1)
bs_dq_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_do,
             const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
             const __grid_constant__ CUtensorMap tm_dq, const DqArgs a) {
  using C = Dq<D, DV>;
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
  QWalk* walk = reinterpret_cast<QWalk*>(smem + C::OFF_WALK);

  const QCta cta = q_cta(a.Lp, a.B, a.Hq, a.Hkv);
  const int q0 = 2 * TILE * cta.i;
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int tq = lane % 4, row0 = 16 * warp + lane / 4;

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
      tma_load(sbase + c * 2 * BOX, &tm_q, bar_q, 64 * c, cta.h, q0, cta.b);
    for (int c = 0; c < DV / 64; ++c)
      tma_load(sbase + C::OFF_DO + c * 2 * BOX, &tm_do, bar_q, 64 * c, cta.h, q0, cta.b);
    qwalk_init(*walk, a.block_idx, a.tiles, cta.b, cta.i, a.L, a.Lp, a.block, a.S);
    for (int s = 0; s < SK && !walk->done; ++s)
      dq_produce_k<D, DV>(walk, meta, s, sbase, kf, &tm_k, cta.g, cta.b);
    for (int n = 0; n < SV && n < walk->produced; ++n)
      dq_produce_v<D, DV>(meta, n, sbase, vf, &tm_v, cta.g, cta.b);
  }

  const int* seg = a.seg + (int64_t)cta.b * a.L;
  int qpos[2], qs[2];
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    qpos[r] = q0 + 64 * wg + row0 + 8 * r;
    const bool in = qpos[r] < a.L;
    const int64_t o = ((int64_t)cta.b * a.Hq + cta.h) * a.L + qpos[r];
    qs[r] = in ? seg[qpos[r]] : 0;
    lse2[r] = in ? a.lse[o] * LOG2E : 0.f;
    dl[r] = in ? a.delta[o] : 0.f;
  }
  const float c = a.scale_log2e;
  float dq[D / 64][32];
  uint32_t da[16];
#pragma unroll
  for (int n = 0; n < D / 64; ++n)
#pragma unroll
    for (int e = 0; e < 32; ++e) dq[n][e] = 0.f;
  const uint32_t sQ = sbase + wg * BOX;
  const uint32_t sDO = sbase + C::OFF_DO + wg * BOX;
  __syncthreads();  // barriers initialised
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
      ss_nt<D>(s, sQ, 2 * BOX, sK);
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
      if (threadIdx.x == 0 && !walk->done) {
        mbar_wait(ke + 8 * prev, ((t - 1) / SK) & 1);
        dq_produce_k<D, DV>(walk, meta, prev, sbase, kf, &tm_k, cta.g, cta.b);
      }
      __syncwarp();
    }
    // every warpgroup waits for V, run or not: a parity wait must not skip a
    // phase (with one V stage, the next tile's wait would pass on this
    // tile's parity while its load is still in flight)
    mbar_wait(vf + 8 * vs, (t / SV) & 1);
    if (run) {  // dP = dO V^T
      wg_fence();
      ss_nt<DV>(dp, sDO, 2 * BOX, sV);
      wg_commit();
      wg_wait0();
      reg_fence(s);
      reg_fence(dp);
    }
    // V of this tile is done with: release its stage for item t + SV
    __syncwarp();
    if (lane == 0) mbar_arrive(ve + 8 * vs);
    if (threadIdx.x == 0 && t + SV < walk->produced) {
      mbar_wait(ve + 8 * vs, (t / SV) & 1);
      dq_produce_v<D, DV>(meta, t + SV, sbase, vf, &tm_v, cta.g, cta.b);
    }
    __syncwarp();
    if (!run) continue;
    if (full)
      dq_grad<false>(s, dp, da, c, lse2, dl, seg, it.x * TILE, qs, qpos, tq);
    else
      dq_grad<true>(s, dp, da, c, lse2, dl, seg, it.x * TILE, qs, qpos, tq);
    // dQ += dS K (64 q rows x D, over the 64 keys)
    wg_fence();
    acc_rs<D / 64>(dq, da, sK);
    wg_commit();
  }
  wg_wait0();
  reg_fence(dq);

  // dQ times scale to bf16 in this warpgroup's rows of the Q buffer, TMA stores
  const float mul[2] = {a.scale, a.scale};
  stage_rows<D / 64>(smem, dq, mul, wg, row0, tq);
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  named_sync(3 + wg, 128);
  if (threadIdx.x % 128 == 0 && q0 + 64 * wg < a.L) {
    for (int n = 0; n < D / 64; ++n)
      tma_store(&tm_dq, sbase + n * 2 * BOX + wg * BOX, 64 * n, cta.h, q0 + 64 * wg, cta.b);
    tma_store_commit();
    tma_store_wait();
  }
}

// ------------------------------------------------------------------ dk/dv
template <int D, int DV>
struct Dkv {
  static constexpr uint32_t KB = tile_bytes(TILE, D), VB = tile_bytes(TILE, DV);
  static constexpr uint32_t SB = KB + VB;              // a stage's Q and dO tiles
  static constexpr uint32_t RB = 3 * TILE * 4;         // its lse, delta, segment ids
  static constexpr uint32_t PB = TILE * TILE * 4;      // P^T, f32, fragment order
  static constexpr int FIT = (TILE_CAP - KB - VB - PB) / (SB + RB);
  static constexpr int STAGES = FIT > 4 ? 4 : FIT;
  static constexpr uint32_t OFF_V = KB;
  static constexpr uint32_t OFF_RING = KB + VB;
  static constexpr uint32_t OFF_ROWS = OFF_RING + STAGES * SB;
  static constexpr uint32_t OFF_P = OFF_ROWS + STAGES * RB;
  static constexpr uint32_t OFF_META = OFF_P + PB;
  static constexpr uint32_t OFF_WALK = OFF_META + 16 * STAGES;
  static constexpr uint32_t OFF_BAR = OFF_WALK + (sizeof(KWalk) + 15) / 16 * 16;
  // full, empty [STAGES]; K and V
  static constexpr uint32_t BYTES = OFF_BAR + 8 * (2 * STAGES + 1) + 1024;
  static_assert(STAGES >= 2 && BYTES <= 232448, "fits one SM");
};

struct DkvArgs {
  const int* seg;
  const int4* tiles;
  const float* lse;
  const float* delta;
  const int* inv_count;  // (B, nk)
  const int* inv_list;   // (B, nk, nq)
  __nv_bfloat16* dk;     // (B, L, Hkv, D)
  __nv_bfloat16* dv;     // (B, L, Hkv, DV)
  int B, L, Lp, Hq, Hkv, block;
  float scale_log2e, scale;
};

template <int D, int DV>
__device__ __forceinline__ void dkv_produce(KWalk* w, int4* meta, int stage, uint32_t sbase,
                                            uint32_t bar_full, const CUtensorMap* tm_q,
                                            const CUtensorMap* tm_do, const DkvArgs& a, int b) {
  using C = Dkv<D, DV>;
  int4 it;
  const uint32_t bar = bar_full + 8 * stage;
  if (!kwalk_next(*w, it)) {
    w->done = 1;
    meta[stage] = make_int4(-1, -1, 0, 0);
    mbar_arrive(bar);
    return;
  }
  meta[stage] = it;
  const int q0 = it.x * TILE, h = it.y;
  const uint32_t st = sbase + C::OFF_RING + stage * C::SB;
  const uint32_t rows = sbase + C::OFF_ROWS + stage * C::RB;
  mbar_expect_tx(bar, C::SB + C::RB);
  for (int c = 0; c < D / 64; ++c) tma_load(st + c * BOX, tm_q, bar, 64 * c, h, q0, b);
  for (int c = 0; c < DV / 64; ++c)
    tma_load(st + C::KB + c * BOX, tm_do, bar, 64 * c, h, q0, b);
  const int64_t o = ((int64_t)b * a.Hq + h) * a.L + q0;
  bulk_load(rows, a.lse + o, TILE * 4, bar);
  bulk_load(rows + TILE * 4, a.delta + o, TILE * 4, bar);
  bulk_load(rows + 2 * TILE * 4, a.seg + (int64_t)b * a.L + q0, TILE * 4, bar);
}

// write one warpgroup's (64 key rows x X) accumulator, times mul, as bf16
// rows of a (B, L, Hkv, X) tensor
template <int X>
__device__ __forceinline__ void store_keys(__nv_bfloat16* dst, const float (&acc)[X / 64][32],
                                           float mul, int b, int k0, int g, int L, int Hkv,
                                           int row0, int tq) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int64_t o = (((int64_t)b * L + k0 + row0 + 8 * r) * Hkv + g) * X + 2 * tq;
#pragma unroll
    for (int n = 0; n < X / 64; ++n)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<uint32_t*>(dst + o + 64 * n + 8 * j) =
            pack_bf16(acc[n][4 * j + 2 * r] * mul, acc[n][4 * j + 2 * r + 1] * mul);
  }
}

// warpgroup 0: S^T = K Q^T, P^T (masked) to the shared buffer, dV += P^T dO
template <int D, int DV>
__device__ __forceinline__ void dkv_p_role(unsigned char* smem, uint32_t sbase, uint32_t bar_full,
                                           uint32_t bar_empty, int4* meta, KWalk* walk,
                                           const CUtensorMap* tm_q, const CUtensorMap* tm_do,
                                           const DkvArgs& a, int b, int g, int k0,
                                           const int (&kseg)[2], const int (&kpos)[2],
                                           int row0, int tq, int lane) {
  using C = Dkv<D, DV>;
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
    const int q0 = it.x * TILE;
    const uint32_t sQ = sbase + C::OFF_RING + stage * C::SB;
    const unsigned char* rows = smem + C::OFF_ROWS + stage * C::RB;
    wg_fence();
    ss_nt<D>(s, sbase, BOX, sQ);  // S^T = K Q^T (64 keys x 64 queries)
    wg_commit();
    if (t > 0) {
      wg_wait<1>();  // the last dV product is done
      reg_fence(acc);
      reg_fence(pa);
      const int prev = (t - 1) % ST;
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty + 8 * prev);
      if (threadIdx.x == 0 && !walk->done) {
        mbar_wait(bar_empty + 8 * prev, ((t - 1) / ST) & 1);
        dkv_produce<D, DV>(walk, meta, prev, sbase, bar_full, tm_q, tm_do, a, b);
      }
      __syncwarp();
    }
    wg_wait0();
    reg_fence(s);
    const float* lse_s = reinterpret_cast<const float*>(rows);
    const int* seg_s = reinterpret_cast<const int*>(rows + 2 * TILE * 4);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 8 * j + 2 * tq;
      const float2 l2 = *reinterpret_cast<const float2*>(lse_s + col);
      const int2 sq = *reinterpret_cast<const int2*>(seg_s + col);
      const float lb[2] = {l2.x * LOG2E, l2.y * LOG2E};
      const int qsg[2] = {sq.x, sq.y};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * j + e, r = e / 2, cc = e % 2;
        const float p = exp2f(fmaf(s[i], c, -lb[cc]));
        const bool ok = it.z || (kseg[r] != 0 && qsg[cc] == kseg[r] && kpos[r] <= q0 + col + cc);
        s[i] = ok ? p : 0.f;
      }
    }
    named_sync(BAR_P_EMPTY, NTHREADS);  // warpgroup 1 has read the last P^T
#pragma unroll
    for (int j = 0; j < 8; ++j)
      pbuf[128 * j] = make_float4(s[4 * j], s[4 * j + 1], s[4 * j + 2], s[4 * j + 3]);
    named_arrive(BAR_P_FULL, NTHREADS);
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
  named_sync(BAR_P_EMPTY, NTHREADS);  // pairs warpgroup 1's last arrival
  store_keys<DV>(a.dv, acc, 1.f, b, k0, g, a.L, a.Hkv, row0, tq);
}

// warpgroup 1: dP^T = V dO^T, dS^T = P^T (dP^T - delta), dK += dS^T Q
template <int D, int DV>
__device__ __forceinline__ void dkv_ds_role(unsigned char* smem, uint32_t sbase,
                                            uint32_t bar_full, uint32_t bar_empty,
                                            const int4* meta, const DkvArgs& a, int b, int g,
                                            int k0, int row0, int tq, int lane) {
  using C = Dkv<D, DV>;
  constexpr int ST = C::STAGES;
  float acc[D / 64][32], dp[32];
  uint32_t da[16];
#pragma unroll
  for (int n = 0; n < D / 64; ++n)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[n][e] = 0.f;
  const float4* pbuf = reinterpret_cast<const float4*>(smem + C::OFF_P) + threadIdx.x % 128;
  named_arrive(BAR_P_EMPTY, NTHREADS);  // the P^T buffer starts free
  for (int t = 0;; ++t) {
    const int stage = t % ST;
    mbar_wait(bar_full + 8 * stage, (t / ST) & 1);
    const int4 it = meta[stage];
    if (it.x < 0) break;
    const uint32_t sQ = sbase + C::OFF_RING + stage * C::SB;
    const unsigned char* rows = smem + C::OFF_ROWS + stage * C::RB;
    wg_fence();
    ss_nt<DV>(dp, sbase + C::OFF_V, BOX, sQ + C::KB);  // dP^T = V dO^T
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
    const float* delta_s = reinterpret_cast<const float*>(rows + TILE * 4);
    named_sync(BAR_P_FULL, NTHREADS);  // warpgroup 0 wrote this tile's P^T
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4 p = pbuf[128 * j];
      const float2 dl = *reinterpret_cast<const float2*>(delta_s + 8 * j + 2 * tq);
      da[2 * j] = pack_bf16(p.x * (dp[4 * j] - dl.x), p.y * (dp[4 * j + 1] - dl.y));
      da[2 * j + 1] = pack_bf16(p.z * (dp[4 * j + 2] - dl.x), p.w * (dp[4 * j + 3] - dl.y));
    }
    named_arrive(BAR_P_EMPTY, NTHREADS);
    wg_fence();
    acc_rs<D / 64>(acc, da, sQ);  // dK += dS^T Q
    wg_commit();
  }
  wg_wait0();
  reg_fence(acc);
  store_keys<D>(a.dk, acc, a.scale, b, k0, g, a.L, a.Hkv, row0, tq);
}

template <int D, int DV>
__global__ void __launch_bounds__(NTHREADS, 1)
bs_dkv_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_do,
              const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
              const DkvArgs a) {
  using C = Dkv<D, DV>;
  constexpr int ST = C::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const uint32_t sbase = smem_u32(smem);
  const uint32_t bar_full = sbase + C::OFF_BAR;      // [ST]: 1 arrival + the bytes
  const uint32_t bar_empty = bar_full + 8 * ST;      // [ST]: one arrival per warp
  const uint32_t bar_kv = bar_empty + 8 * ST;
  int4* meta = reinterpret_cast<int4*>(smem + C::OFF_META);
  KWalk* walk = reinterpret_cast<KWalk*>(smem + C::OFF_WALK);

  // key tile innermost (ascending: early blocks are chosen by more q-blocks)
  const int nkt = a.L / TILE, nk = a.L / a.block;
  const int kt = (int)blockIdx.x % nkt;
  const int g = (int)(blockIdx.x / nkt) % a.Hkv;
  const int b = (int)(blockIdx.x / nkt) / a.Hkv;
  const int k0 = kt * TILE;
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int tq = lane % 4, row0 = 16 * warp + lane / 4;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, NTHREADS / 32);
    }
    mbar_init(bar_kv, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_expect_tx(bar_kv, C::KB + C::VB);
    for (int c = 0; c < D / 64; ++c) tma_load(sbase + c * BOX, &tm_k, bar_kv, 64 * c, g, k0, b);
    for (int c = 0; c < DV / 64; ++c)
      tma_load(sbase + C::OFF_V + c * BOX, &tm_v, bar_kv, 64 * c, g, k0, b);
    const int jb = k0 / a.block;
    KWalk& w = *walk;
    w.tiles = a.tiles + (int64_t)b * (a.Lp / TILE);
    w.kt4 = w.tiles[kt];
    w.chose = a.inv_list + ((int64_t)b * nk + jb) * nk;
    w.n_sel = a.inv_count[(int64_t)b * nk + jb];
    w.bpt = a.block / TILE;
    w.ratio = a.Hq / a.Hkv;
    w.g = g;
    w.kt = kt;
    w.r = 0;
    w.c = -1;
    w.qt = w.qt_end = 0;
    w.done = 0;
    for (int s = 0; s < ST && !w.done; ++s)
      dkv_produce<D, DV>(walk, meta, s, sbase, bar_full, &tm_q, &tm_do, a, b);
  }
  const int* seg = a.seg + (int64_t)b * a.L;
  int kseg[2], kpos[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    kpos[r] = k0 + row0 + 8 * r;
    kseg[r] = seg[kpos[r]];
  }
  __syncthreads();  // barriers initialised
  mbar_wait(bar_kv, 0);
  if (wg == 0)
    dkv_p_role<D, DV>(smem, sbase, bar_full, bar_empty, meta, walk, &tm_q, &tm_do, a, b, g, k0,
                      kseg, kpos, row0, tq, lane);
  else
    dkv_ds_role<D, DV>(smem, sbase, bar_full, bar_empty, meta, a, b, g, k0, row0, tq, lane);
}

// ------------------------------------------------------------------- host
int check_args(int B, int L, int Hq, int Hkv, int block, int S) {
  if (B <= 0 || L <= 0 || Hkv <= 0 || Hq % Hkv != 0 || S <= 0 || block <= 0 ||
      block % TILE != 0 || L % block != 0)
    return (int)cudaErrorInvalidValue;
  return 0;
}

// (B, L, H, X) bf16 -> boxes of (64 columns, 1 head, rows, 1 batch row)
bool map4(CUtensorMap* map, EncodeTiled encode, const void* ptr, int B, int L, int H, int X,
          int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)X, (cuuint64_t)H, (cuuint64_t)L, (cuuint64_t)B};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  return make_map_nd(map, encode, ptr, 4, dims, box);
}

template <typename Kernel>
cudaError_t opt_in(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

int padded(int L) { return (L + 2 * TILE - 1) / (2 * TILE) * (2 * TILE); }

template <int D, int DV>
int launch_fwd(const void* q, const void* k, const void* v, const void* block_idx,
               const void* seg, void* tiles, void* out, void* lse, void* mass, int B, int L,
               int Hq, int Hkv, int block, int S, float scale, cudaStream_t stream) {
  const int Lp = padded(L);
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap tm_q, tm_k, tm_v, tm_o;
  if (!map4(&tm_q, encode, q, B, L, Hq, D, 2 * TILE) ||
      !map4(&tm_k, encode, k, B, L, Hkv, D, TILE) ||
      !map4(&tm_v, encode, v, B, L, Hkv, DV, TILE) ||
      !map4(&tm_o, encode, out, B, L, Hq, DV, TILE))
    return (int)cudaErrorInvalidValue;
  if (cudaError_t e = opt_in(bs_fwd_kernel<D, DV>, Fwd<D, DV>::BYTES)) return (int)e;
  if (cudaError_t e = launch_tile_table(static_cast<const int*>(seg), static_cast<int4*>(tiles),
                                        B, L, Lp, stream))
    return (int)e;
  const FwdArgs a{static_cast<const int*>(block_idx), static_cast<const int*>(seg),
                  static_cast<const int4*>(tiles), static_cast<float*>(lse),
                  static_cast<float*>(mass), B, L, Lp, Hq, Hkv, block, S, scale * LOG2E};
  const unsigned grid = (unsigned)(Lp / (2 * TILE)) * Hq * B;
  bs_fwd_kernel<D, DV><<<grid, NTHREADS, Fwd<D, DV>::BYTES, stream>>>(tm_q, tm_k, tm_v, tm_o, a);
  return (int)cudaGetLastError();
}

template <int D, int DV>
int launch_bwd(const void* q, const void* k, const void* v, const void* block_idx,
               const void* seg, const void* out, const void* dout, const void* lse,
               void* delta, void* tiles, void* inv_count, void* inv_list, void* dq, void* dk,
               void* dv, int B, int L, int Hq, int Hkv, int block, int S, float scale,
               cudaStream_t stream) {
  const int Lp = padded(L), nq = L / block;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap tq128, tdo128, tk, tv, tdq, tq64, tdo64;
  if (!map4(&tq128, encode, q, B, L, Hq, D, 2 * TILE) ||
      !map4(&tdo128, encode, dout, B, L, Hq, DV, 2 * TILE) ||
      !map4(&tk, encode, k, B, L, Hkv, D, TILE) || !map4(&tv, encode, v, B, L, Hkv, DV, TILE) ||
      !map4(&tdq, encode, dq, B, L, Hq, D, TILE) || !map4(&tq64, encode, q, B, L, Hq, D, TILE) ||
      !map4(&tdo64, encode, dout, B, L, Hq, DV, TILE))
    return (int)cudaErrorInvalidValue;
  if (cudaError_t e = opt_in(bs_dq_kernel<D, DV>, Dq<D, DV>::BYTES)) return (int)e;
  if (cudaError_t e = opt_in(bs_dkv_kernel<D, DV>, Dkv<D, DV>::BYTES)) return (int)e;
  if (cudaError_t e = launch_tile_table(static_cast<const int*>(seg), static_cast<int4*>(tiles),
                                        B, L, Lp, stream))
    return (int)e;
  const int rows = B * L * Hq;
  bs_delta_kernel<<<(rows + 7) / 8, 256, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(out), static_cast<const __nv_bfloat16*>(dout),
      static_cast<float*>(delta), rows, L, Hq, DV);
  if (cudaError_t e = cudaGetLastError()) return (int)e;
  bs_inverse_kernel<<<(B * nq + 127) / 128, 128, 0, stream>>>(
      static_cast<const int*>(block_idx), static_cast<int*>(inv_count),
      static_cast<int*>(inv_list), B, nq, nq, S);
  if (cudaError_t e = cudaGetLastError()) return (int)e;
  const DqArgs qa{static_cast<const int*>(block_idx), static_cast<const int*>(seg),
                  static_cast<const int4*>(tiles), static_cast<const float*>(lse),
                  static_cast<const float*>(delta), B, L, Lp, Hq, Hkv, block, S,
                  scale * LOG2E, scale};
  bs_dq_kernel<D, DV><<<(unsigned)(Lp / (2 * TILE)) * Hq * B, NTHREADS, Dq<D, DV>::BYTES,
                        stream>>>(tq128, tdo128, tk, tv, tdq, qa);
  if (cudaError_t e = cudaGetLastError()) return (int)e;
  const DkvArgs ka{static_cast<const int*>(seg), static_cast<const int4*>(tiles),
                   static_cast<const float*>(lse), static_cast<const float*>(delta),
                   static_cast<const int*>(inv_count), static_cast<const int*>(inv_list),
                   static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), B, L, Lp,
                   Hq, Hkv, block, scale * LOG2E, scale};
  bs_dkv_kernel<D, DV><<<(unsigned)(L / TILE) * Hkv * B, NTHREADS, Dkv<D, DV>::BYTES,
                         stream>>>(tq64, tdo64, tk, tv, ka);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, block_idx, segment_ids; tiles: scratch of (B, Lp / 64, 4) int32,
// Lp = L rounded up to 128; out, lse, mass
extern "C" int xt_block_sparse_fwd_bf16(const void* q, const void* k, const void* v,
                                        const void* block_idx, const void* seg, void* tiles,
                                        void* out, void* lse, void* mass, int B, int L, int Hq,
                                        int Hkv, int d, int dv, int block, int S, float scale,
                                        void* stream) {
  if (int e = check_args(B, L, Hq, Hkv, block, S)) return e;
  cudaStream_t st = (cudaStream_t)stream;
  if (d == 256 && dv == 256)
    return launch_fwd<256, 256>(q, k, v, block_idx, seg, tiles, out, lse, mass, B, L, Hq, Hkv,
                                block, S, scale, st);
  if (d == 192 && dv == 128)
    return launch_fwd<192, 128>(q, k, v, block_idx, seg, tiles, out, lse, mass, B, L, Hq, Hkv,
                                block, S, scale, st);
  if (d == 128 && dv == 128)
    return launch_fwd<128, 128>(q, k, v, block_idx, seg, tiles, out, lse, mass, B, L, Hq, Hkv,
                                block, S, scale, st);
  return (int)cudaErrorInvalidValue;
}

// ... out, do, lse; delta (B, Hq, L) f32, tiles, inverse count (B, nk) and
// list (B, nk, nq) int32: scratch; dq, dk, dv
extern "C" int xt_block_sparse_bwd_bf16(const void* q, const void* k, const void* v,
                                        const void* block_idx, const void* seg, const void* out,
                                        const void* dout, const void* lse, void* delta,
                                        void* tiles, void* inv_count, void* inv_list, void* dq,
                                        void* dk, void* dv, int B, int L, int Hq, int Hkv,
                                        int d, int dv_dim, int block, int S, float scale,
                                        void* stream) {
  if (int e = check_args(B, L, Hq, Hkv, block, S)) return e;
  cudaStream_t st = (cudaStream_t)stream;
  if (d == 256 && dv_dim == 256)
    return launch_bwd<256, 256>(q, k, v, block_idx, seg, out, dout, lse, delta, tiles,
                                inv_count, inv_list, dq, dk, dv, B, L, Hq, Hkv, block, S, scale,
                                st);
  if (d == 192 && dv_dim == 128)
    return launch_bwd<192, 128>(q, k, v, block_idx, seg, out, dout, lse, delta, tiles,
                                inv_count, inv_list, dq, dk, dv, B, L, Hq, Hkv, block, S, scale,
                                st);
  if (d == 128 && dv_dim == 128)
    return launch_bwd<128, 128>(q, k, v, block_idx, seg, out, dout, lse, delta, tiles,
                                inv_count, inv_list, dq, dk, dv, B, L, Hq, Hkv, block, S, scale,
                                st);
  return (int)cudaErrorInvalidValue;
}

// the dynamic shared memory of one CTA (bytes): kernel 0 forward, 1 dq,
// 2 dk/dv, at (d, dv); 0 for a pair the kernels are not built for
extern "C" int xt_block_sparse_smem_bytes(int kernel, int d, int dv) {
#define XT_BS_SMEM(D_, DV_)                                                        \
  if (d == D_ && dv == DV_)                                                        \
    return kernel == 0 ? (int)Fwd<D_, DV_>::BYTES                                  \
                       : (kernel == 1 ? (int)Dq<D_, DV_>::BYTES : (int)Dkv<D_, DV_>::BYTES);
  XT_BS_SMEM(256, 256)
  XT_BS_SMEM(192, 128)
  XT_BS_SMEM(128, 128)
#undef XT_BS_SMEM
  return 0;
}
