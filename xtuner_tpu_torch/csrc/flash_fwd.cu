// GQA flash-attention forward over packed rows, for Hopper (sm_90a):
// wgmma for both products, K and V through a TMA ring, the output and the
// softmax state in registers.
//
// Replaces the TPU kernel xtuner_tpu/ops/attention/flash.py::_fwd_kernel
// (pallas_call in _flash_forward), both of its variants: running max, and
// max-free (taken when a proven bound on |scaled logit| is <= 45). Same
// function: q, k (B, L, Hq or Hkv, D), v (B, L, Hkv, DV) bf16, (D, DV) =
// (128, 128), MLA's (192, 128), gpt-oss's (64, 64) or Qwen3.5's (256, 256:
// flash_fwd64_kernel, 64-key tiles, below), segment_ids
// (B, L) int32 (0 = padding). A first small kernel (tile_table.cuh) builds
// the backward's table of 64-row tiles over the ids padded to Lp, a
// multiple of 128 (flash.py _tile_table: {lowest non-zero id, highest, the
// id if the tile holds one document and no padding else 0}), into scratch
// the wrapper gives, so the host does no work per call. Key m is visible
// to query l iff seg[l] == seg[m] != 0 and m <= l (without the last term
// at 64/64 when the call is not causal: CAUSAL = false), and with a sliding
// window w > 0 (a kernel argument; 0 = full attention, so one
// instantiation serves gpt-oss's windowed and full layers) l - m < w
// (JAX _tile_mask). Sinks are folded into out and lse outside the kernel,
// as JAX folds them (ops/attention/flash.py::fold_sinks). Returns out (B, L, Hq,
// D) bf16 and lse (B, Hq, L) f32 in natural log; a row with no visible key
// gets out = 0 and lse = 1e30; out is (B, L, Hq, DV).
//
// What bounds it on the H100: two L^2-sized bf16 products (S = Q K^T and
// O = P V: 2 (D + DV) flops per visible pair) at 989 TFLOP/s; q, k, v
// and out cross HBM once. Every CTA reads all the K/V tiles below its
// diagonal, so the K/V stream has to come from L2 (see the grid order).
//
// Design:
// - One CTA of two warpgroups per (128-row q tile, q head, batch row); each
//   warpgroup owns 64 q rows and keeps their 64 x 128 O, row max and row
//   sum in f32 registers for the whole walk. Both warpgroups read each K/V
//   tile. 256 threads, so ptxas may give each up to 255 registers; thread 0
//   issues every TMA load (a producer warpgroup under setmaxnreg is capped
//   at the launch bound's 168 registers: see flash_bwd.cu).
// - Shared memory: the Q tile (D / 64 boxes of 16 KB, loaded once) and a
//   ring of STAGES K tiles (D / 64 boxes) and V tiles (DV / 64 boxes), all
//   128-byte-swizzled 64-column boxes (sm90.cuh): 160 KB at 128/128, 208
//   KB at 192/128. K and V of a stage have their own full barrier, so S
//   starts as soon as K has landed; one empty barrier per stage takes an
//   arrival from each warp when its PV product is done.
// - Per k tile, each warpgroup: S = Q K^T on wgmma m64n128k16 (both
//   operands K-major in shared memory, D / 16 steps over D / 64 boxes);
//   the softmax in the accumulator layout in base 2 (scale * log2(e) on
//   the f32 scores, as the plain version does; JAX folds it into bf16 q),
//   row max and sum by quad
//   shuffles; P packed to bf16 A fragments in registers; O += P V on wgmma
//   m64n128k16 with A from registers and V as the MN-major B operand. The
//   PV product of tile t runs while S of tile t + 1 is issued (one wait on
//   the older group frees tile t's stage). The running-max variant rescales
//   O and the row sum by alpha = exp2(m_old - m_new) in registers; the
//   max-free variant (|scaled logit| <= 45: exp2 stays inside f32, and
//   softmax is shift-invariant) has neither max nor rescale. Each thread
//   sums its part of a row; the quad's parts are added in the epilogue.
// - The walk: k tiles from the first whose segment range meets the q
//   tile's (warp 0 finds it by ballots over the tile table) up to the
//   diagonal, skipping any that does not meet it; producer and consumers
//   read the same predicate. With a window the search starts at the k tile
//   that holds the q tile's first row's first visible key, so tiles wholly
//   outside the window are never loaded: a windowed layer walks at most
//   ceil(w / 128) + 1 tiles a q tile, O(L w), not O(L^2 / 2). A tile
//   wholly inside the q tile's one document, below the diagonal and (with
//   a window) wholly inside it skips the per-element mask (JAX
//   _tile_full); only tiles on the diagonal, a document boundary, the
//   window's edge or padding are masked.
// - Non-causal (CAUSAL = false, 64/64 only, no window: Qwen3-VL's vision
//   tower): the walk ends at the last k tile whose segment range meets the
//   q tile's, which warp 0 finds by ballots from the end of the row, so a
//   q tile walks the k tiles of its documents on both sides of the
//   diagonal; a tile that holds the q tile's one document skips the mask,
//   the diagonal tile too. The ring's stage and phase count walked tiles,
//   not tile indices, so the walk may start below the q tile and end above.
// - Epilogue: out = O / l (0 where nothing was visible) to bf16, staged in
//   the warpgroup's own rows of the Q buffer in the swizzled layout and
//   written by two TMA stores (rows past L are not written); lse by the
//   quad's first thread.
// - Grid order (1-D): q tile outermost, last tile first (the longest walks
//   start first), then batch row, kv head, and the q heads of the kv group
//   innermost. The ~132 resident CTAs are then ~8 neighbouring q tiles of
//   every head of one row, which walk the same K/V tiles from tile 0 up at
//   about the same time: each K/V tile crosses HBM about once per wave and
//   is read from L2 by every CTA of the wave.
// - The variant comes from the device scalar `bound`, read per CTA, so the
//   host never waits; CTA 0 of a max-free launch adds one to a device
//   counter, and thread 0 of every CTA adds its walked and full k tiles to
//   a second counter when one is given (the plan check of chip_smoke.py).
// - Deterministic: no atomics touch out or lse.
// - (D, DV) in {(128, 128), (192, 128), (64, 64)}, templates (DV = 128: O
//   and P take the registers of D = 128; only the S product and the Q and
//   K tiles grow; at 64/64 Q, K and V are one 64-column box each, O is 64
//   x 64 (32 registers a thread) and PV runs on wgmma m64n64k16), causal,
//   and non-causal at 64/64 and 72/72 (anything else returns an error).
// - Head dim 72 (Qwen3-VL-8B's tower, non-causal only): the 128/128
//   instantiation over tensors of 72 columns (DG = DVG = 72). A 72-column
//   bf16 row is 144 bytes, a multiple of TMA's 16, so q, k, v and out are
//   read and written in place, no padded copy: each tile is two 64-column
//   boxes, the second at column 64, whose columns 72-127 lie outside the
//   tensor and arrive as zeros (the transaction still counts the whole
//   box). S = Q K^T runs k16(72) = 80 deep (5 k16 steps, not 8: columns
//   80-127 would add zeros); O = P V stays 128 wide (the zero columns of V
//   give zero columns of O, which the out store drops: a TMA store writes
//   nothing past the tensor's edge). The scale is 72^-0.5 from the caller.
//   Per visible pair that is 2 (80 + 128) flops for 2 (72 + 72) useful:
//   1.44 times the work, the price of reusing the 128/128 kernel as it is.
// - ptxas (nvcc -Xptxas -v, sm_90a, CUDA 12.9): one kernel holds both
//   variants (the bound is read on the device): at 128/128 254 registers,
//   0 bytes of spills, 164,936 bytes of dynamic shared memory (one CTA per
//   SM); at 192/128 238 registers, 0 spills, 214,088 bytes; at 64/64 232
//   registers, 0 spills, 83,016 bytes; flash_fwd64_kernel<256, 256> 239
//   registers, 0 spills, 197,704 bytes (two stages). A three-stage ring
//   fits too at 128/128, and ran slower than two at L65536 and L8192.
//   chip_smoke.py's build phase prints every instantiation.

#include "sm90.cuh"
#include "tile_table.cuh"

namespace {

constexpr int BM = 128;  // q rows per CTA: two warpgroups of 64
constexpr int BN = 128;  // key rows per k tile
constexpr int STAGES = 2;
constexpr int NTHREADS = 256;
constexpr float NEG_INF = -1e30f;
constexpr float BIG_LSE = 1e30f;
constexpr float LN2 = 0.6931471805599453f;
constexpr float LOG2E = 1.4426950408889634f;
// |scaled logit| bound of the max-free variant (flash.py MAX_FREE_BOUND)
constexpr float MAX_FREE_BOUND = 45.f;

// shared memory, in bytes from a 1024-aligned base
constexpr uint32_t HALF = BN * 128;  // one 64-column box of a 128-row tile: 16 KB
template <int D, int DV>
struct Smem {
  static_assert((DV == 128 || DV == 64) && D % 64 == 0, "O is 64 x DV per warpgroup");
  static constexpr uint32_t QT = (D / 64) * HALF, KT = (D / 64) * HALF, VT = (DV / 64) * HALF;
  static constexpr uint32_t OFF_Q = 0;
  static constexpr uint32_t OFF_K = OFF_Q + QT;
  static constexpr uint32_t OFF_V = OFF_K + STAGES * KT;
  static constexpr uint32_t OFF_BAR = OFF_V + STAGES * VT;  // K full, V full, empty [STAGES]; Q
  static constexpr uint32_t OFF_FIRST = OFF_BAR + 8 * (3 * STAGES + 1);
  static constexpr uint32_t BYTES = OFF_FIRST + 16 + 1024;  // + alignment slack
  static_assert(BYTES <= 232448, "fits one SM");
};

struct Args {
  const int* seg;      // (B, L)
  const int4* tiles;   // (B, Lp / 64)
  float* lse;          // (B, Hq, L)
  const float* bound;  // device scalar or null (running max)
  int* max_free_count;                // device int or null
  unsigned long long* tile_count;     // [walked, full] or null
  int B, L, Lp, Hq, Hkv;
  int window;  // > 0: key m visible to query l only if l - m < window; 0: full
  float scale_log2e;
};

// whether k tile j's segment range meets the q tile's [qmin, qmax]
__device__ __forceinline__ bool meets(const int4* tiles, int j, int qmin, int qmax) {
  const int4 a = tiles[2 * j], c = tiles[2 * j + 1];
  return max(a.y, c.y) >= qmin && min(a.x, c.x) <= qmax;
}

// the first k tile from j up to the diagonal i that meets the q tile (i + 1 if none)
__device__ __forceinline__ int next_tile(const int4* tiles, int j, int i, int qmin, int qmax) {
  while (j <= i && !meets(tiles, j, qmin, qmax)) ++j;
  return j;
}

template <int D, int DV>
__device__ __forceinline__ void load_kv(const CUtensorMap* tm_k, const CUtensorMap* tm_v,
                                        uint32_t sbase, uint32_t bar_k, uint32_t bar_v,
                                        int stage, int j, int g, int b) {
  using C = Smem<D, DV>;
  const uint32_t fk = bar_k + 8 * stage, fv = bar_v + 8 * stage;
  mbar_expect_tx(fk, C::KT);
  for (int c = 0; c < D / 64; ++c)
    tma_load(sbase + C::OFF_K + stage * C::KT + c * HALF, tm_k, fk, 64 * c, g, j * BN, b);
  mbar_expect_tx(fv, C::VT);
  for (int c = 0; c < DV / 64; ++c)
    tma_load(sbase + C::OFF_V + stage * C::VT + c * HALF, tm_v, fv, 64 * c, g, j * BN, b);
}

// P of one (64 q rows, 128 keys) tile from S in the accumulator layout
// (rows row0 + 8 r, columns 8 j + 2 tq + cc for s[4 j + 2 r + cc]), packed
// to bf16 A fragments; m, l and O (NO = DV / 2 registers, the same layout)
// updated for the running-max variant. A key is visible to row r if it is
// in its document, at or below qpos[r] (with CAUSAL) and above klo[r] (the
// window)
template <bool MAX_FREE, bool MASK, bool CAUSAL, int NO>
__device__ __forceinline__ void softmax_tile(float (&s)[64], uint32_t (&pa)[32], float (&o)[NO],
                                             float (&m)[2], float (&l)[2], float c,
                                             const int* kseg, int k0, int L,
                                             const int (&qs)[2], const int (&qpos)[2],
                                             const int (&klo)[2], int tq) {
  int ks[32];
  if (MASK) {
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int pos = k0 + 8 * (e / 2) + 2 * tq + e % 2;
      ks[e] = pos < L ? kseg[pos] : 0;  // past L: padding
    }
  }
  auto visible = [&](int i) {
    const int j = i / 4, r = (i / 2) % 2, cc = i % 2;
    const int kpos = k0 + 8 * j + 2 * tq + cc;
    return qs[r] != 0 && ks[2 * j + cc] == qs[r] && (!CAUSAL || kpos <= qpos[r]) &&
           kpos > klo[r];
  };
  if (MAX_FREE) {
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      float p = exp2f(s[i] * c);
      if (MASK) p = visible(i) ? p : 0.f;
      l[(i / 2) % 2] += p;
      s[i] = p;
    }
  } else {
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      float v = s[i] * c;
      if (MASK) v = visible(i) ? v : __int_as_float(0xff800000);  // -inf
      s[i] = v;
      mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], v);
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2f(m[r] - mx[r]);  // m starts at -1e30: a row's first visible key gives 0
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const float p = exp2f(s[i] - mx[(i / 2) % 2]);  // masked: exp2(-inf) = 0
      l[(i / 2) % 2] += p;
      s[i] = p;
    }
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] *= alpha[(i / 2) % 2];
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    pa[2 * j] = pack_bf16(s[4 * j], s[4 * j + 1]);
    pa[2 * j + 1] = pack_bf16(s[4 * j + 2], s[4 * j + 3]);
  }
}

template <bool MAX_FREE, int D, int DV, bool CAUSAL, int DG>
__device__ __forceinline__ void fwd_body(const CUtensorMap* tm_q, const CUtensorMap* tm_k,
                                         const CUtensorMap* tm_v, const CUtensorMap* tm_o,
                                         const Args& a, unsigned char* smem) {
  using C = Smem<D, DV>;
  const uint32_t sbase = smem_u32(smem);
  const uint32_t bar_k = sbase + C::OFF_BAR;         // [STAGES]: 1 arrival + the bytes
  const uint32_t bar_v = bar_k + 8 * STAGES;      // [STAGES]: 1 arrival + the bytes
  const uint32_t bar_e = bar_v + 8 * STAGES;      // [STAGES]: one arrival per warp
  const uint32_t bar_q = bar_e + 8 * STAGES;
  int* first_s = reinterpret_cast<int*>(smem + C::OFF_FIRST);

  // grid order: q tile (last first), batch row, kv head, q head of the group
  const int ratio = a.Hq / a.Hkv;
  int x = (int)blockIdx.x;
  const int hr = x % ratio;
  x /= ratio;
  const int g = x % a.Hkv;
  x /= a.Hkv;
  const int b = x % a.B;
  const int i = a.Lp / BM - 1 - x / a.B;  // the q tile, and the last k tile it may see
  const int h = g * ratio + hr;
  const int q0 = i * BM;
  const int wg = threadIdx.x / 128;  // q rows [64 wg, 64 wg + 64) of the tile
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int tq = lane % 4;
  const int row0 = 16 * warp + lane / 4;  // this thread's rows: row0 and row0 + 8

  const int4* tiles = a.tiles + (int64_t)b * (a.Lp / 64);
  const int* seg = a.seg + (int64_t)b * a.L;
  const int4 t0 = tiles[2 * i], t1 = tiles[2 * i + 1];
  const int qmin = min(t0.x, t1.x), qmax = max(t0.y, t1.y);
  const int quni = t0.z == t1.z ? t0.z : 0;
  // with a window, the k tile that holds the first row's first visible key
  const int j_lo = a.window > 0 ? max(0, q0 - a.window + 1) / BN : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
      mbar_init(bar_e + 8 * s, NTHREADS / 32);
    }
    mbar_init(bar_q, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_expect_tx(bar_q, C::QT);
    for (int c = 0; c < D / 64; ++c)
      tma_load(sbase + C::OFF_Q + c * HALF, tm_q, bar_q, 64 * c, h, q0, b);
  }
  if (threadIdx.x < 32) {
    // the last k tile to walk: the diagonal, or (not causal) the last that
    // meets the q tile, 32 tiles at a time from the end of the row
    int last = i;
    if constexpr (!CAUSAL) {
      last = -1;
      for (int base = a.Lp / BN - 32;; base -= 32) {
        const int j = base + lane;
        const unsigned hit = __ballot_sync(0xffffffffu, j >= 0 && meets(tiles, j, qmin, qmax));
        if (hit) {
          last = base + 31 - __clz(hit);
          break;
        }
        if (base <= 0) break;
      }
    }
    // the first k tile to walk, 32 tiles at a time from j_lo
    int first = last + 1;
    for (int base = j_lo; base <= last; base += 32) {
      const int j = base + lane;
      const unsigned hit = __ballot_sync(0xffffffffu, j <= last && meets(tiles, j, qmin, qmax));
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
  __syncthreads();
  const int j_first = first_s[0];
  const int last = CAUSAL ? i : first_s[1];
  int jn = j_first;  // thread 0: the next k tile to load
  if (threadIdx.x == 0)
    for (int s = 0; s < STAGES && jn <= last; ++s) {
      load_kv<D, DV>(tm_k, tm_v, sbase, bar_k, bar_v, s, jn, g, b);
      jn = next_tile(tiles, jn + 1, last, qmin, qmax);
    }

  int qpos[2], qs[2], klo[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    qpos[r] = q0 + 64 * wg + row0 + 8 * r;
    qs[r] = qpos[r] < a.L ? seg[qpos[r]] : 0;
    klo[r] = a.window > 0 ? qpos[r] - a.window : -1;  // keys above it are in the window
  }
  const float c = a.scale_log2e;
  constexpr int NO = DV / 2;  // O's registers: 64 x DV over the warpgroup
  float o[NO], s[64], m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  uint32_t pa[32];
#pragma unroll
  for (int e = 0; e < 64; ++e) s[e] = 0.f;
#pragma unroll
  for (int e = 0; e < NO; ++e) o[e] = 0.f;
  const uint32_t sQ = sbase + C::OFF_Q + wg * (64 * 128);  // this warpgroup's 64 rows
  mbar_wait(bar_q, 0);

  int t = 0, n_full = 0;
  for (int j = j_first; j <= last; ++t) {
    const int j_next = next_tile(tiles, j + 1, last, qmin, qmax);
    const int4 ka = tiles[2 * j], kb = tiles[2 * j + 1];
    const bool full = (!CAUSAL || j < i) && quni != 0 && ka.z == quni && kb.z == quni &&
                      (a.window == 0 || q0 + BM - 1 - j * BN < a.window);  // JAX _tile_full
    const int stage = t % STAGES;
    const uint32_t phase = (t / STAGES) & 1;
    const uint32_t sK = sbase + C::OFF_K + stage * C::KT;
    const uint32_t sV = sbase + C::OFF_V + stage * C::VT;

    // S = Q K^T (64 q rows x 128 keys, over the DG columns the tensors have)
    mbar_wait(bar_k + 8 * stage, phase);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < k16(DG) / 16; ++kk) {
      const uint32_t off = (kk / 4) * HALF + (kk % 4) * 32;
      wgmma_m64n128_ss<0, 0>(s, desc(sQ + off, 16, 1024), desc(sK + off, 16, 1024), kk > 0);
    }
    wg_commit();
    if (t > 0) {
      // the last tile's PV is done: release its stage, and refill it
      wg_wait<1>();
      reg_fence(o);
      reg_fence(pa);
      const int prev = (t - 1) % STAGES;
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_e + 8 * prev);
      if (threadIdx.x == 0 && jn <= last) {
        mbar_wait(bar_e + 8 * prev, ((t - 1) / STAGES) & 1);
        load_kv<D, DV>(tm_k, tm_v, sbase, bar_k, bar_v, prev, jn, g, b);
        jn = next_tile(tiles, jn + 1, last, qmin, qmax);
      }
      __syncwarp();
    }
    wg_wait0();
    reg_fence(s);

    n_full += full;
    if (full)
      softmax_tile<MAX_FREE, false, CAUSAL>(s, pa, o, m, l, c, seg, j * BN, a.L, qs, qpos, klo,
                                            tq);
    else
      softmax_tile<MAX_FREE, true, CAUSAL>(s, pa, o, m, l, c, seg, j * BN, a.L, qs, qpos, klo,
                                           tq);

    // O += P V (64 q rows x DV, over the 128 keys)
    mbar_wait(bar_v + 8 * stage, phase);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      if constexpr (DV == 128)
        wgmma_m64n128_rs<1>(o, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3],
                            desc(sV + kk * 2048, HALF, 1024));
      else
        wgmma_m64n64_rs<1>(o, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3],
                           desc(sV + kk * 2048, HALF, 1024));
    }
    wg_commit();
    j = j_next;
  }
  wg_wait0();
  reg_fence(o);

  // epilogue: the quad's row sums; out = O / l to bf16 in this warpgroup's
  // rows of the Q buffer (its S products are done; DV / 64 boxes of 64
  // columns, within the Q buffer's D / 64), then one TMA store a box
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = l[r] > 0.f ? 1.f / l[r] : 0.f;
  }
  unsigned char* stg = smem + C::OFF_Q;
#pragma unroll
  for (int j = 0; j < DV / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int R = 64 * wg + row0 + 8 * r;
      *reinterpret_cast<uint32_t*>(stg + (j / 8) * HALF + R * 128 + (((j % 8) ^ (R & 7)) << 4) +
                                   4 * tq) =
          pack_bf16(o[4 * j + 2 * r] * inv[r], o[4 * j + 2 * r + 1] * inv[r]);
    }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  named_sync(1 + wg, 128);
  const bool store = threadIdx.x % 128 == 0 && q0 + 64 * wg < a.L;
  if (store) {
    for (int half = 0; half < DV / 64; ++half)
      tma_store(tm_o, sbase + C::OFF_Q + half * HALF + wg * (64 * 128), 64 * half, h,
                q0 + 64 * wg, b);
    tma_store_commit();
  }
  if (tq == 0)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (qpos[r] < a.L) {
        const float lse2 = MAX_FREE ? log2f(l[r]) : m[r] + log2f(l[r]);
        a.lse[((int64_t)b * a.Hq + h) * a.L + qpos[r]] = l[r] > 0.f ? lse2 * LN2 : BIG_LSE;
      }
  if (threadIdx.x == 0 && a.tile_count != nullptr) {
    atomicAdd(a.tile_count, (unsigned long long)t);
    atomicAdd(a.tile_count + 1, (unsigned long long)n_full);
  }
  if (store) tma_store_wait();  // the stores have read the staging rows
}

template <int D, int DV, bool CAUSAL, int DG, int DVG>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 const __grid_constant__ CUtensorMap tm_o, const Args a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const bool max_free = a.bound != nullptr && *a.bound <= MAX_FREE_BOUND;
  if (max_free) {
    if (a.max_free_count != nullptr && threadIdx.x == 0 && blockIdx.x == 0)
      atomicAdd(a.max_free_count, 1);
    fwd_body<true, D, DV, CAUSAL, DG>(&tm_q, &tm_k, &tm_v, &tm_o, a, smem);
  } else {
    fwd_body<false, D, DV, CAUSAL, DG>(&tm_q, &tm_k, &tm_v, &tm_o, a, smem);
  }
}

// DG, DVG: the columns of q / k and of v / out (the tile widths D, DV, or
// fewer: head dim 72 on 128-column tiles)
template <int D, int DV, bool CAUSAL = true, int DG = D, int DVG = DV>
int launch(const void* q, const void* k, const void* v, const void* seg, void* tiles, void* out,
           const Args& a, cudaStream_t stream) {
  using C = Smem<D, DV>;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap tm_q, tm_k, tm_v, tm_o;
  if (!make_map(&tm_q, encode, q, a.B, a.L, a.Hq, BM, DG) ||
      !make_map(&tm_k, encode, k, a.B, a.L, a.Hkv, BN, DG) ||
      !make_map(&tm_v, encode, v, a.B, a.L, a.Hkv, BN, DVG) ||
      !make_map(&tm_o, encode, out, a.B, a.L, a.Hq, 64, DVG))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_kernel<D, DV, CAUSAL, DG, DVG>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)C::BYTES);
  if (e != cudaSuccess) return (int)e;
  e = launch_tile_table(static_cast<const int*>(seg), static_cast<int4*>(tiles), a.B, a.L, a.Lp,
                        stream);
  if (e != cudaSuccess) return (int)e;
  const unsigned grid = (unsigned)(a.Lp / BM) * a.Hq * a.B;
  flash_fwd_kernel<D, DV, CAUSAL, DG, DVG><<<grid, NTHREADS, C::BYTES, stream>>>(
      tm_q, tm_k, tm_v, tm_o, a);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------
// (256, 256): 64-key tiles. O of 64 rows x 256 is 128 f32 registers a
// thread, so S must shrink: a 64 x 64 S tile (32 registers) and its P (16)
// leave room under 255. Q (128 rows x 256, 64 KB) stays resident; a stage
// of K and V (64 keys x 256 each, 64 KB) fits twice beside it. The layout
// is block_sparse.cu's forward at 256/256 (ss_nt, acc_rs, stage_rows); the
// walk, the masks, the window and both variants are fwd_body's, on 64-key
// tiles: tile j is walked if j <= 2 i + 1 (the q tile's last row) and its
// segment range meets the q tile's; warpgroup 0 (rows q0..q0 + 63) runs no
// product on tile 2 i + 1, wholly above its rows, but still waits on its
// loads and releases its stage. A tile is full (no per-element mask) if it
// lies below both halves (j < 2 i) and holds the q tile's one document.
constexpr int BN64 = 64;  // key rows per k tile at (256, 256)
constexpr uint32_t TILE_CAP = 225 * 1024;  // tiles of a CTA; the rest: barriers, slack

template <int D, int DV>
struct Smem64 {
  static constexpr uint32_t QT = (D / 64) * HALF;  // 128 rows
  static constexpr uint32_t KT = (D / 64) * BOX64, VT = (DV / 64) * BOX64;  // 64 rows
  static constexpr int FIT = (int)((TILE_CAP - QT) / (KT + VT));
  static constexpr int STAGES = FIT > 4 ? 4 : FIT;
  static constexpr uint32_t OFF_Q = 0;
  static constexpr uint32_t OFF_K = OFF_Q + QT;
  static constexpr uint32_t OFF_V = OFF_K + STAGES * KT;
  static constexpr uint32_t OFF_BAR = OFF_V + STAGES * VT;  // K full, V full, empty [STAGES]; Q
  static constexpr uint32_t OFF_FIRST = OFF_BAR + 8 * (3 * STAGES + 1);
  static constexpr uint32_t BYTES = OFF_FIRST + 16 + 1024;  // + alignment slack
  static_assert(STAGES >= 2 && BYTES <= 232448, "fits one SM");
};

// whether 64-row k tile j's segment range meets [qmin, qmax]
__device__ __forceinline__ bool meets64(const int4* tiles, int j, int qmin, int qmax) {
  const int4 a = tiles[j];
  return a.y >= qmin && a.x <= qmax;
}

__device__ __forceinline__ int next_tile64(const int4* tiles, int j, int last, int qmin,
                                           int qmax) {
  while (j <= last && !meets64(tiles, j, qmin, qmax)) ++j;
  return j;
}

template <int D, int DV>
__device__ __forceinline__ void load_kv64(const CUtensorMap* tm_k, const CUtensorMap* tm_v,
                                          uint32_t sbase, uint32_t bar_k, uint32_t bar_v,
                                          int stage, int j, int g, int b) {
  using C = Smem64<D, DV>;
  const uint32_t fk = bar_k + 8 * stage, fv = bar_v + 8 * stage;
  mbar_expect_tx(fk, C::KT);
  for (int c = 0; c < D / 64; ++c)
    tma_load(sbase + C::OFF_K + stage * C::KT + c * BOX64, tm_k, fk, 64 * c, g, j * BN64, b);
  mbar_expect_tx(fv, C::VT);
  for (int c = 0; c < DV / 64; ++c)
    tma_load(sbase + C::OFF_V + stage * C::VT + c * BOX64, tm_v, fv, 64 * c, g, j * BN64, b);
}

// softmax_tile on a (64 q rows, 64 keys) tile: s[4 j + 2 r + cc] at rows
// row0 + 8 r, keys k0 + 8 j + 2 tq + cc; O as NO blocks of 64 columns
template <bool MAX_FREE, bool MASK, int NO>
__device__ __forceinline__ void softmax_tile64(float (&s)[32], uint32_t (&pa)[16],
                                               float (&o)[NO][32], float (&m)[2], float (&l)[2],
                                               float c, const int* kseg, int k0, int L,
                                               const int (&qs)[2], const int (&qpos)[2],
                                               const int (&klo)[2], int tq) {
  int ks[16];
  if (MASK) {
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const int pos = k0 + 8 * (e / 2) + 2 * tq + e % 2;
      ks[e] = pos < L ? kseg[pos] : 0;  // past L: padding
    }
  }
  auto visible = [&](int i) {
    const int j = i / 4, r = (i / 2) % 2, cc = i % 2;
    const int kpos = k0 + 8 * j + 2 * tq + cc;
    return qs[r] != 0 && ks[2 * j + cc] == qs[r] && kpos <= qpos[r] && kpos > klo[r];
  };
  if (MAX_FREE) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float p = exp2f(s[i] * c);
      if (MASK) p = visible(i) ? p : 0.f;
      l[(i / 2) % 2] += p;
      s[i] = p;
    }
  } else {
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float v = s[i] * c;
      if (MASK) v = visible(i) ? v : __int_as_float(0xff800000);  // -inf
      s[i] = v;
      mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], v);
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2f(m[r] - mx[r]);  // m starts at -1e30: a row's first visible key gives 0
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float p = exp2f(s[i] - mx[(i / 2) % 2]);  // masked: exp2(-inf) = 0
      l[(i / 2) % 2] += p;
      s[i] = p;
    }
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[n][i] *= alpha[(i / 2) % 2];
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    pa[2 * j] = pack_bf16(s[4 * j], s[4 * j + 1]);
    pa[2 * j + 1] = pack_bf16(s[4 * j + 2], s[4 * j + 3]);
  }
}

template <bool MAX_FREE, int D, int DV>
__device__ __forceinline__ void fwd64_body(const CUtensorMap* tm_q, const CUtensorMap* tm_k,
                                           const CUtensorMap* tm_v, const CUtensorMap* tm_o,
                                           const Args& a, unsigned char* smem) {
  using C = Smem64<D, DV>;
  constexpr int ST = C::STAGES;
  const uint32_t sbase = smem_u32(smem);
  const uint32_t bar_k = sbase + C::OFF_BAR;  // [ST]: 1 arrival + the bytes
  const uint32_t bar_v = bar_k + 8 * ST;      // [ST]: 1 arrival + the bytes
  const uint32_t bar_e = bar_v + 8 * ST;      // [ST]: one arrival per warp
  const uint32_t bar_q = bar_e + 8 * ST;
  int* first_s = reinterpret_cast<int*>(smem + C::OFF_FIRST);

  // grid order as fwd_body's
  const int ratio = a.Hq / a.Hkv;
  int x = (int)blockIdx.x;
  const int hr = x % ratio;
  x /= ratio;
  const int g = x % a.Hkv;
  x /= a.Hkv;
  const int b = x % a.B;
  const int i = a.Lp / BM - 1 - x / a.B;  // the q tile (128 rows)
  const int last = 2 * i + 1;              // the last 64-key tile it may see
  const int h = g * ratio + hr;
  const int q0 = i * BM;
  const int wg = threadIdx.x / 128;  // q rows [64 wg, 64 wg + 64) of the tile
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int tq = lane % 4;
  const int row0 = 16 * warp + lane / 4;

  const int4* tiles = a.tiles + (int64_t)b * (a.Lp / 64);
  const int* seg = a.seg + (int64_t)b * a.L;
  const int4 t0 = tiles[2 * i], t1 = tiles[2 * i + 1];
  const int qmin = min(t0.x, t1.x), qmax = max(t0.y, t1.y);
  const int quni = t0.z == t1.z ? t0.z : 0;
  const int j_lo = a.window > 0 ? max(0, q0 - a.window + 1) / BN64 : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
      mbar_init(bar_e + 8 * s, NTHREADS / 32);
    }
    mbar_init(bar_q, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_expect_tx(bar_q, C::QT);
    for (int c = 0; c < D / 64; ++c)
      tma_load(sbase + C::OFF_Q + c * HALF, tm_q, bar_q, 64 * c, h, q0, b);
  }
  if (threadIdx.x < 32) {  // the first k tile to walk, 32 tiles at a time from j_lo
    int first = last + 1;
    for (int base = j_lo; base <= last; base += 32) {
      const int j = base + lane;
      const unsigned hit =
          __ballot_sync(0xffffffffu, j <= last && meets64(tiles, j, qmin, qmax));
      if (hit) {
        first = base + __ffs(hit) - 1;
        break;
      }
    }
    if (lane == 0) *first_s = first;
  }
  __syncthreads();
  const int j_first = *first_s;
  int jn = j_first;  // thread 0: the next k tile to load
  if (threadIdx.x == 0)
    for (int s = 0; s < ST && jn <= last; ++s) {
      load_kv64<D, DV>(tm_k, tm_v, sbase, bar_k, bar_v, s, jn, g, b);
      jn = next_tile64(tiles, jn + 1, last, qmin, qmax);
    }

  int qpos[2], qs[2], klo[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    qpos[r] = q0 + 64 * wg + row0 + 8 * r;
    qs[r] = qpos[r] < a.L ? seg[qpos[r]] : 0;
    klo[r] = a.window > 0 ? qpos[r] - a.window : -1;
  }
  const float c = a.scale_log2e;
  constexpr int NO = DV / 64;
  float o[NO][32], s[32], m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  uint32_t pa[16];
#pragma unroll
  for (int e = 0; e < 32; ++e) s[e] = 0.f;
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 32; ++e) o[n][e] = 0.f;
  const uint32_t sQ = sbase + C::OFF_Q + wg * BOX64;  // this warpgroup's 64 rows
  mbar_wait(bar_q, 0);

  int t = 0, n_full = 0;
  for (int j = j_first; j <= last; ++t) {
    const int j_next = next_tile64(tiles, j + 1, last, qmin, qmax);
    const int4 kt = tiles[j];
    const bool full = j < 2 * i && quni != 0 && kt.z == quni &&
                      (a.window == 0 || q0 + BM - 1 - j * BN64 < a.window);
    const bool run = j <= 2 * i + wg;  // tile 2 i + 1 lies above warpgroup 0's rows
    const int stage = t % ST;
    const uint32_t phase = (t / ST) & 1;
    const uint32_t sK = sbase + C::OFF_K + stage * C::KT;
    const uint32_t sV = sbase + C::OFF_V + stage * C::VT;

    mbar_wait(bar_k + 8 * stage, phase);
    if (run) {  // S = Q K^T (64 q rows x 64 keys, over D)
      wg_fence();
      ss_nt<D>(s, sQ, HALF, sK);
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
      if (threadIdx.x == 0 && jn <= last) {
        mbar_wait(bar_e + 8 * prev, ((t - 1) / ST) & 1);
        load_kv64<D, DV>(tm_k, tm_v, sbase, bar_k, bar_v, prev, jn, g, b);
        jn = next_tile64(tiles, jn + 1, last, qmin, qmax);
      }
      __syncwarp();
    }
    n_full += full;
    if (!run) {  // no phase of V skipped: a parity wait must see every phase
      mbar_wait(bar_v + 8 * stage, phase);
      j = j_next;
      continue;
    }
    wg_wait0();
    reg_fence(s);
    if (full)
      softmax_tile64<MAX_FREE, false>(s, pa, o, m, l, c, seg, j * BN64, a.L, qs, qpos, klo, tq);
    else
      softmax_tile64<MAX_FREE, true>(s, pa, o, m, l, c, seg, j * BN64, a.L, qs, qpos, klo, tq);
    // O += P V (64 q rows x DV, over the 64 keys)
    mbar_wait(bar_v + 8 * stage, phase);
    wg_fence();
    acc_rs<NO>(o, pa, sV);
    wg_commit();
    j = j_next;
  }
  wg_wait0();
  reg_fence(o);

  // epilogue as fwd_body's: out = O / l in this warpgroup's rows of the Q
  // buffer, one TMA store a 64-column box; lse by the quad's first thread
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = l[r] > 0.f ? 1.f / l[r] : 0.f;
  }
  stage_rows<NO>(smem + C::OFF_Q, o, inv, wg, row0, tq);
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  named_sync(1 + wg, 128);
  const bool store = threadIdx.x % 128 == 0 && q0 + 64 * wg < a.L;
  if (store) {
    for (int n = 0; n < NO; ++n)
      tma_store(tm_o, sbase + C::OFF_Q + n * HALF + wg * BOX64, 64 * n, h, q0 + 64 * wg, b);
    tma_store_commit();
  }
  if (tq == 0)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (qpos[r] < a.L) {
        const float lse2 = MAX_FREE ? log2f(l[r]) : m[r] + log2f(l[r]);
        a.lse[((int64_t)b * a.Hq + h) * a.L + qpos[r]] = l[r] > 0.f ? lse2 * LN2 : BIG_LSE;
      }
  if (threadIdx.x == 0 && a.tile_count != nullptr) {
    atomicAdd(a.tile_count, (unsigned long long)t);
    atomicAdd(a.tile_count + 1, (unsigned long long)n_full);
  }
  if (store) tma_store_wait();
}

template <int D, int DV>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_fwd64_kernel(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const __grid_constant__ CUtensorMap tm_o, const Args a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const bool max_free = a.bound != nullptr && *a.bound <= MAX_FREE_BOUND;
  if (max_free) {
    if (a.max_free_count != nullptr && threadIdx.x == 0 && blockIdx.x == 0)
      atomicAdd(a.max_free_count, 1);
    fwd64_body<true, D, DV>(&tm_q, &tm_k, &tm_v, &tm_o, a, smem);
  } else {
    fwd64_body<false, D, DV>(&tm_q, &tm_k, &tm_v, &tm_o, a, smem);
  }
}

template <int D, int DV>
int launch64(const void* q, const void* k, const void* v, const void* seg, void* tiles,
             void* out, const Args& a, cudaStream_t stream) {
  using C = Smem64<D, DV>;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap tm_q, tm_k, tm_v, tm_o;
  if (!make_map(&tm_q, encode, q, a.B, a.L, a.Hq, BM, D) ||
      !make_map(&tm_k, encode, k, a.B, a.L, a.Hkv, BN64, D) ||
      !make_map(&tm_v, encode, v, a.B, a.L, a.Hkv, BN64, DV) ||
      !make_map(&tm_o, encode, out, a.B, a.L, a.Hq, 64, DV))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(flash_fwd64_kernel<D, DV>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)C::BYTES);
  if (e != cudaSuccess) return (int)e;
  e = launch_tile_table(static_cast<const int*>(seg), static_cast<int4*>(tiles), a.B, a.L, a.Lp,
                        stream);
  if (e != cudaSuccess) return (int)e;
  const unsigned grid = (unsigned)(a.Lp / BM) * a.Hq * a.B;
  flash_fwd64_kernel<D, DV><<<grid, NTHREADS, C::BYTES, stream>>>(tm_q, tm_k, tm_v, tm_o, a);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, L, Hq, d), k (B, L, Hkv, d), v (B, L, Hkv, dv), out (B, L, Hq, dv)
// bf16, (d, dv) = (128, 128), (192, 128), (64, 64), (256, 256) or (72, 72); seg (B, L) int32;
// tiles: scratch of (B, Lp / 64, 4) int32, Lp = L rounded up to 128; lse
// (B, Hq, L) f32. window: > 0 a sliding window, 0 full attention. causal:
// 0 for bidirectional attention within each document (64/64 and 72/72,
// no window only; 72/72 takes nothing else). bound:
// device f32 or null (always the running-max variant);
// max_free_count: device int32 or null; tile_count: device uint64 [walked,
// full] or null.
extern "C" int xt_flash_fwd_bf16(const void* q, const void* k, const void* v, const void* seg,
                                 void* tiles, void* out, void* lse, int B, int L, int Hq,
                                 int Hkv, int d, int dv, float scale, int window, int causal,
                                 const void* bound, void* max_free_count, void* tile_count,
                                 void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || L <= 0 || B <= 0 || window < 0)
    return (int)cudaErrorInvalidValue;
  const bool nc_dims = (d == 64 && dv == 64) || (d == 72 && dv == 72);
  if (!causal && (!nc_dims || window > 0)) return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const int*>(seg), static_cast<const int4*>(tiles),
               static_cast<float*>(lse), static_cast<const float*>(bound),
               static_cast<int*>(max_free_count),
               static_cast<unsigned long long*>(tile_count), B, L, (L + BM - 1) / BM * BM, Hq,
               Hkv, window, scale * LOG2E};
  cudaStream_t st = (cudaStream_t)stream;
  if (d == 128 && dv == 128) return launch<128, 128>(q, k, v, seg, tiles, out, a, st);
  if (d == 192 && dv == 128) return launch<192, 128>(q, k, v, seg, tiles, out, a, st);
  if (d == 64 && dv == 64)
    return causal ? launch<64, 64>(q, k, v, seg, tiles, out, a, st)
                  : launch<64, 64, false>(q, k, v, seg, tiles, out, a, st);
  if (d == 256 && dv == 256) return launch64<256, 256>(q, k, v, seg, tiles, out, a, st);
  if (d == 72 && dv == 72 && !causal)
    return launch<128, 128, false, 72, 72>(q, k, v, seg, tiles, out, a, st);
  return (int)cudaErrorInvalidValue;
}

// the dynamic shared memory one CTA of the kernel takes at (d, dv) (bytes;
// 0 for a pair it is not built for)
extern "C" int xt_flash_fwd_smem_bytes(int d, int dv) {
  if (d == 128 && dv == 128) return (int)Smem<128, 128>::BYTES;
  if (d == 192 && dv == 128) return (int)Smem<192, 128>::BYTES;
  if (d == 64 && dv == 64) return (int)Smem<64, 64>::BYTES;
  if (d == 256 && dv == 256) return (int)Smem64<256, 256>::BYTES;
  if (d == 72 && dv == 72) return (int)Smem<128, 128>::BYTES;  // on 128-column tiles
  return 0;
}
