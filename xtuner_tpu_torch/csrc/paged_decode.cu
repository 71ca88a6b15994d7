// C-token GQA decode attention over a paged KV pool, for Hopper (sm_90a):
// split-KV, a TMA ring, mma.sync products.
//
// Replaces the TPU kernel xtuner_tpu/ops/attention/paged_decode.py::_kernel
// (pallas_call in paged_decode_attn). Same function: q (B, C, Hq, D) bf16,
// D = 128, gpt-oss's 64 or Qwen3.5's 256 (a template); pool_k/pool_v (L, NB, BS, Hkv, D)
// bf16; block_table (B, MB) int32; seq_lens (B,) int32 = tokens cached
// before this chunk. Chunk token i of slot b sits at seq_lens[b] + i
// (already written to the pool) and attends the pool slots s <= seq_lens[b]
// + i, and with a sliding window w > 0 only those with seq_lens[b] + i - s
// < w. Optional per-head sinks (Hq,) f32 join each row's softmax
// denominator once (JAX _kernel's finalize: the sink in base 2 takes part
// in the max, exp2(sink - m) adds to the sum). Returns (B, C, Hq, D) f32.
//
// What bounds it on the H100: decode reads every cached K/V byte once for
// 2-8 operations per byte (C * Hq / Hkv <= 16 query rows per kv head), so
// HBM bandwidth bounds it (3.35 TB/s). The (slot, kv head) pairs are few
// (32 at 4 slots x 8 kv heads, on 132 SMs), so one CTA per pair cannot
// fill the card, and each CTA must keep its loads in flight while it
// computes.
//
// Design:
// - Split-KV. The grid is (splits, Hkv, B). The host picks the split count
//   from B, Hkv and MB alone (ops/attention/paged_decode.py::
//   paged_decode_split_plan: about 2 CTAs per SM, one wave, if every table
//   were full), so it never reads seq_lens (that would synchronise once
//   per layer on a host-bound loop). Against 1 and 4 (timed by
//   tools/bench_paged_decode_cuda.py on an H100 80GB HBM3 at 700 W): 2 is
//   fastest at the serving shape and within 6% of the best at uniform
//   rollouts; 4 is 3-8% faster at rollouts of mixed lengths. On the device
//   each slot cuts its blocks [start, n_blk) into that many splits of
//   ceil((n_blk - start) / splits) whole blocks, so a slot's splits are
//   even whatever MB is; a split past the slot's last block exits at once.
//   n_blk = ceil((seq_len + C) / BS); start is 0, or with a window JAX's
//   _start_block, floor(max(seq_len + 1 - w, 0) / BS): the block of the
//   first slot any row can see, so blocks wholly outside the window are
//   never loaded (a window of 128 over blocks of 128 leaves at most two
//   blocks a slot, and the wrapper plans the splits for that many). A persistent
//   grid over a device-built work list would need a prefix pass over
//   seq_lens first; with ~97 KB of shared memory two CTAs share an SM, so
//   one's prologue and combine overlap the other's stream instead.
// - Loads in flight. Warp 4 (lane 0) streams the split's blocks in chunks
//   of CR rows (the largest multiple of 16 up to 64 that divides BS)
//   through a 3-stage ring: per chunk 2 D / 64 TMA loads (K and V, each D /
//   64 64-column boxes of CR rows, 128-byte swizzled) out of the pool viewed
//   as (L NB, BS, Hkv, D), batch coordinate layer * NB + block id,
//   completing on the stage's full mbarrier; the consumer warps release a
//   stage on its empty mbarrier. Up to 96 KB in flight per CTA.
// - Products on mma.sync m16n8k16 bf16: the <= 16 query rows are exactly
//   one m16 tile (wgmma's 64-row tile would waste >= 75% and is not
//   needed at a few operations per byte). Each of the 4 consumer warps
//   takes 16 keys of every chunk and keeps its own online softmax (f32,
//   base 2, running max and sum) and O (16 x D f32 in registers): S = Q
//   K^T with Q as A fragments held for the whole walk and K by ldmatrix
//   from the swizzled stage, then O += P V with V by ldmatrix.trans. P goes
//   in as two bf16 parts, hi = bf16(p) and lo = bf16(p - hi), so the
//   product keeps ~16 bits of p and the result stays f32-exact to ~1e-6
//   (a bf16 P alone misses PAGED_ATOL, 2e-4, at tens of keys).
// - Right-pad: slots >= seq_len + C hold whatever the pool holds (never
//   written by this sequence); their scores are set to -inf and their V
//   rows zeroed in registers, so they never reach O. Slots below a row's
//   window (in the first walked block) get -inf scores: p is exactly 0.
// - Combine. The 4 warps' (m, l, O) merge in warp order through shared
//   memory (the ring's space, free after the walk). A slot with one split
//   writes out = O / l at once. Otherwise each split writes its partial (O
//   unnormalised, m and l per row, f32) into the workspace the wrapper
//   allocates (once per stream, as the tickets), fences, and takes a
//   ticket (atomicAdd on a per-(slot, kv head) int); the CTA that draws
//   the last ticket merges the partials in split order and resets the
//   ticket to 0 for the next launch. One launch per call, and two launches
//   give the same bits: the merge order is fixed, and which CTA runs it
//   changes nothing. The sinks join in the last normalisation only (after
//   the split merge, or at once for a slot with one split), never in a
//   partial, so a sink counts once whatever the split count. A split whose
//   blocks all lie outside the table (entries < 0 or >= NB) writes the
//   neutral partial m = -1e30, l = 0, O = 0, which the merge weighs by 0
//   (or by 1 with l = 0 when every split is empty: out 0).
// - ptxas (nvcc -Xptxas -v, sm_90a, CUDA 12.9): D 128 166 registers, 0
//   spills, 99,392 bytes of dynamic shared memory at blocks of 128 (two
//   CTAs an SM); D 64 124 registers, 0 spills, 50,240 bytes; D 256 254
//   registers (O and Q's fragments: one CTA an SM), 0 spills, 197,696
//   bytes (the 3-stage ring of 64-row chunks, 64 KB a stage). The combine
//   gives each thread the (row, column) pairs tid, tid + 128, ..., so D
//   256 takes two columns a row.
// - Inactive slots (all-zero table, seq_len 0) read the trash block 0 and
//   stay finite; their output is discarded by the caller. Table entries
//   < 0 or >= NB are skipped (no load, no products).

#include "sm90.cuh"

namespace {

constexpr int NCONS = 128;              // four consumer warps
constexpr int NTHREADS = NCONS + 32;    // and the producer warp
constexpr int MAXR = 16;                // query rows per CTA (C * rep)
constexpr int STAGES = 3;
constexpr int MAX_CR = 64;              // rows of a ring stage
constexpr int MAX_SPLITS = 256;         // splits a slot merges: MERGE_BYTES holds their (m, l)
constexpr int MAX_DEVICES = 64;         // devices whose shared-memory opt-in is remembered
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// a ring stage: K then V, each D / 64 64-column boxes of cr rows x 128 bytes
__host__ __device__ constexpr uint32_t stage_bytes(int cr, int d) {
  return 2u * (d / 64) * cr * 128;
}
// padded O row of the warp combine (floats)
__host__ __device__ constexpr int ldo(int d) { return d + 8; }
// the warp combine: O [4][MAXR][LDO], m [4][MAXR], l [4][MAXR] (f32)
__host__ __device__ constexpr uint32_t combine_bytes(int d) {
  return (NCONS / 32) * MAXR * (ldo(d) + 2) * 4;
}
// the split merge: every split's (m, l) per row (f32)
constexpr uint32_t MERGE_BYTES = 2 * MAX_SPLITS * MAXR * 4;

struct Layout {
  uint32_t bar;    // full [STAGES], empty [STAGES] (after the ring or the combine)
  uint32_t flag;   // int: this CTA merges the splits
  uint32_t bytes;  // + 1024 alignment slack
};
__host__ __device__ inline Layout layout(int cr, int d) {
  const uint32_t ring = STAGES * stage_bytes(cr, d);
  const uint32_t after = combine_bytes(d) > MERGE_BYTES ? combine_bytes(d) : MERGE_BYTES;
  Layout l;
  l.bar = ring > after ? ring : after;
  l.flag = l.bar + 16 * STAGES;
  l.bytes = l.flag + 16 + 1024;
  return l;
}

struct Args {
  const __nv_bfloat16* q;
  const int* table;
  const int* seq_lens;
  const float* sinks;  // (Hq,) sink logits, or null
  float* out;
  float* ws;     // (B, Hkv, splits, rows, D) partial O, then (B, Hkv, splits, rows, 2) (m, l)
  int* tickets;  // (B * Hkv), zero between launches
  int C, Hq, Hkv, NB, BS, MB, layer, splits, cr;
  int window;    // > 0: a sliding window; 0: full attention
  float sl2;     // scale * log2(e)
};

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
// D(16 x 8, f32) += A(16 x 16, bf16) B(16 x 8, bf16)
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// (x, y) as bf16 pairs hi = bf16(.) and lo = bf16(. - hi)
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// out = O / L of one row after the merge, with the row's sink (base 2)
// joining the max and the sum once
__device__ __forceinline__ float finish_row(float M, float L, float O, const Args& a, int head) {
  if (a.sinks != nullptr) {
    const float sk = a.sinks[head] * LOG2E;
    const float mn = fmaxf(M, sk), f = exp2f(M - mn);
    O *= f;
    L = L * f + exp2f(sk - mn);
  }
  return L > 0.f ? O / L : 0.f;
}

// two CTAs an SM up to D 128; at D 256 O (16 rows x 256 a warp: 128 f32
// registers a thread) and Q's fragments (64) need the whole register file
template <int D>
__global__ void __launch_bounds__(NTHREADS, D > 128 ? 1 : 2)
paged_decode_kernel(const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v, const Args a) {
  constexpr int LDO = ldo(D);
  const int sp = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int C = a.C, BS = a.BS, cr = a.cr;
  // this split's blocks [t0, t1) of the slot's [start, n_blk)
  const int end = a.seq_lens[b] + C;  // slots [0, end) hold keys
  const int n_blk = max(0, min((end + BS - 1) / BS, a.MB));
  const int start = a.window > 0 ? min(max(a.seq_lens[b] + 1 - a.window, 0) / BS, n_blk) : 0;
  const int per = max(1, (n_blk - start + a.splits - 1) / a.splits);
  const int nsb = max(1, (n_blk - start + per - 1) / per);
  if (sp >= nsb) return;
  const int t0 = start + sp * per, t1 = min(t0 + per, n_blk);
  if (threadIdx.x == NCONS) {  // the producer: have the TMA unit fetch the maps now
    asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&tm_k)) : "memory");
    asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&tm_v)) : "memory");
  }

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t sbase = smem_u32(smem);
  const Layout lay = layout(cr, D);
  const uint32_t sbytes = stage_bytes(cr, D), hbytes = cr * 128;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(sbase + lay.bar + 8 * s, 1);
      mbar_init(sbase + lay.bar + 8 * (STAGES + s), NCONS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= NCONS) {
    // the producer: every chunk of the split's valid blocks, STAGES ahead
    if (tid == NCONS) {
      uint32_t pc = 0;
      for (int t = t0; t < t1; ++t) {
        const int blk = a.table[(int64_t)b * a.MB + t];
        if (blk < 0 || blk >= a.NB) continue;
        const int plane = a.layer * a.NB + blk;
        for (int c0 = 0; c0 < BS && t * BS + c0 < end; c0 += cr, ++pc) {
          const uint32_t s = pc % STAGES;
          const uint32_t full = sbase + lay.bar + 8 * s, empty = full + 8 * STAGES;
          if (pc >= (uint32_t)STAGES) mbar_wait(empty, (pc / STAGES - 1) & 1);
          const uint32_t dst = sbase + s * sbytes;
          mbar_expect_tx(full, sbytes);
          for (int c = 0; c < D / 64; ++c) {
            tma_load(dst + c * hbytes, &tm_k, full, 64 * c, g, c0, plane);
            tma_load(dst + (D / 64 + c) * hbytes, &tm_v, full, 64 * c, g, c0, plane);
          }
        }
      }
    }
    return;
  }

  const int warp = tid / 32, lane = tid % 32, gq = lane / 4, tq = lane % 4;
  const int rep = a.Hq / a.Hkv, rows = C * rep;  // row r = i * rep + j: token i, head g*rep+j
  // this thread's rows gq and gq + 8 (rows past `rows` mirror the last one),
  // the last slot each attends (seq_len + i) and, with a window, the slot
  // below its first one
  const int ra = gq, rb = gq + 8;
  const int lim_a = end - C + min(ra, rows - 1) / rep;
  const int lim_b = end - C + min(rb, rows - 1) / rep;
  const int lo_a = a.window > 0 ? lim_a - a.window : -1;
  const int lo_b = a.window > 0 ? lim_b - a.window : -1;

  // Q as m16n8k16 A fragments over D / 16 k16 steps; rows past `rows` zero
  uint32_t qa[D / 16][4];
  {
    const uint32_t* pa = nullptr;
    const uint32_t* pb = nullptr;
    if (ra < rows)
      pa = reinterpret_cast<const uint32_t*>(
          a.q + (((int64_t)b * C + ra / rep) * a.Hq + g * rep + ra % rep) * D);
    if (rb < rows)
      pb = reinterpret_cast<const uint32_t*>(
          a.q + (((int64_t)b * C + rb / rep) * a.Hq + g * rep + rb % rep) * D);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      qa[kk][0] = pa ? pa[8 * kk + tq] : 0u;
      qa[kk][1] = pb ? pb[8 * kk + tq] : 0u;
      qa[kk][2] = pa ? pa[8 * kk + 4 + tq] : 0u;
      qa[kk][3] = pb ? pb[8 * kk + 4 + tq] : 0u;
    }
  }

  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_a = NEG_INF, m_b = NEG_INF, l_a = 0.f, l_b = 0.f;  // l: this thread's columns
  const int kb = 16 * warp;  // this warp's keys in each chunk
  const int mi = lane >> 3;  // the 8 x 8 matrix whose row this lane addresses

  uint32_t pc = 0;
  for (int t = t0; t < t1; ++t) {
    const int blk = a.table[(int64_t)b * a.MB + t];
    if (blk < 0 || blk >= a.NB) continue;
    for (int c0 = 0; c0 < BS && t * BS + c0 < end; c0 += cr, ++pc) {
      const uint32_t s = pc % STAGES;
      const int key0 = t * BS + c0 + kb;  // slot of this warp's first key
      mbar_wait(sbase + lay.bar + 8 * s, (pc / STAGES) & 1);
      if (kb < cr && key0 < end) {
        const uint32_t kbase = sbase + s * sbytes, vbase = kbase + (D / 64) * hbytes;
        // S = Q K^T over keys kb.. kb + 15: two n8 tiles
        float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        {
          const int row = kb + ((mi >> 1) << 3) + (lane & 7);
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            const int u = 2 * kk + (mi & 1);  // 16-byte unit of the 2 D-byte row
            uint32_t r[4];
            ldsm_x4(r, kbase + (u >> 3) * hbytes + row * 128 + (((u & 7) ^ (row & 7)) << 4));
            mma16816(sc[0], qa[kk], r[0], r[1]);
            mma16816(sc[1], qa[kk], r[2], r[3]);
          }
        }
        // online softmax in base 2: scores past each row's last slot, or
        // below its window, are -inf
        float mx_a = NEG_INF, mx_b = NEG_INF;
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int slot = key0 + 8 * j + 2 * tq + e;
            sc[j][e] = slot <= lim_a && slot > lo_a ? sc[j][e] * a.sl2 : NEG_INF;
            sc[j][2 + e] = slot <= lim_b && slot > lo_b ? sc[j][2 + e] * a.sl2 : NEG_INF;
            mx_a = fmaxf(mx_a, sc[j][e]);
            mx_b = fmaxf(mx_b, sc[j][2 + e]);
          }
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
          mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
        }
        const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
        const float al_a = exp2f(m_a - mn_a), al_b = exp2f(m_b - mn_b);
        m_a = mn_a;
        m_b = mn_b;
        uint32_t ph[4], pl[4];  // P as A fragments: hi and lo bf16 parts
        float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float p[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            p[e] = sc[j][e] > 0.5f * NEG_INF ? exp2f(sc[j][e] - (e < 2 ? mn_a : mn_b)) : 0.f;
          sum_a += p[0] + p[1];
          sum_b += p[2] + p[3];
          split_bf16(p[0], p[1], ph[2 * j], pl[2 * j]);
          split_bf16(p[2], p[3], ph[2 * j + 1], pl[2 * j + 1]);
        }
        l_a = l_a * al_a + sum_a;
        l_b = l_b * al_b + sum_b;
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          o[n][0] *= al_a;
          o[n][1] *= al_a;
          o[n][2] *= al_b;
          o[n][3] *= al_b;
        }
        // O += P V over D / 8 n8 tiles; V rows past `end` zeroed
        const bool tail = key0 + 16 > end;
        const uint32_t keep0 = (key0 + 2 * tq < end ? 0xffffu : 0u) |
                               (key0 + 2 * tq + 1 < end ? 0xffff0000u : 0u);
        const uint32_t keep1 = (key0 + 8 + 2 * tq < end ? 0xffffu : 0u) |
                               (key0 + 9 + 2 * tq < end ? 0xffff0000u : 0u);
        const int row = kb + ((mi & 1) << 3) + (lane & 7);
#pragma unroll
        for (int p2 = 0; p2 < D / 16; ++p2) {
          const int u = 2 * p2 + (mi >> 1);
          uint32_t r[4];
          ldsm_x4_t(r, vbase + (u >> 3) * hbytes + row * 128 + (((u & 7) ^ (row & 7)) << 4));
          if (tail) {
            r[0] &= keep0;
            r[2] &= keep0;
            r[1] &= keep1;
            r[3] &= keep1;
          }
          mma16816(o[2 * p2], ph, r[0], r[1]);
          mma16816(o[2 * p2], pl, r[0], r[1]);
          mma16816(o[2 * p2 + 1], ph, r[2], r[3]);
          mma16816(o[2 * p2 + 1], pl, r[2], r[3]);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(sbase + lay.bar + 8 * (STAGES + s));
    }
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }

  // the warps' (m, l, O) through shared memory, merged in warp order; the
  // ring is free: every load was waited on
  named_sync(1, NCONS);
  float* cO = reinterpret_cast<float*>(smem);
  float* cM = cO + (NCONS / 32) * MAXR * LDO;
  float* cL = cM + (NCONS / 32) * MAXR;
  {
    float* w = cO + warp * MAXR * LDO;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<float2*>(w + ra * LDO + 8 * n + 2 * tq) = make_float2(o[n][0], o[n][1]);
      *reinterpret_cast<float2*>(w + rb * LDO + 8 * n + 2 * tq) = make_float2(o[n][2], o[n][3]);
    }
    if (tq == 0) {
      cM[warp * MAXR + ra] = m_a;
      cL[warp * MAXR + ra] = l_a;
      cM[warp * MAXR + rb] = m_b;
      cL[warp * MAXR + rb] = l_b;
    }
  }
  named_sync(1, NCONS);

  // this thread's outputs: the (row, column) pairs tid, tid + NCONS, ..
  // of the rows x D output (D 64: two rows at a time; D 256: two columns
  // of each row)
  const int bg = b * a.Hkv + g;
  auto out_at = [&](int r, int d) -> float* {
    return a.out + (((int64_t)b * C + r / rep) * a.Hq + g * rep + r % rep) * D + d;
  };
  float* ws_o = a.ws + (int64_t)bg * a.splits * rows * D;
  float* ws_ml = a.ws + (int64_t)gridDim.z * a.Hkv * a.splits * rows * D +
                 (int64_t)bg * a.splits * rows * 2;
  for (int x = tid; x < rows * D; x += NCONS) {
    const int r = x / D, d = x % D;
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < NCONS / 32; ++w) M = fmaxf(M, cM[w * MAXR + r]);
    float L = 0.f, O = 0.f;
#pragma unroll
    for (int w = 0; w < NCONS / 32; ++w) {
      const float f = exp2f(cM[w * MAXR + r] - M);
      L += cL[w * MAXR + r] * f;
      O += cO[(w * MAXR + r) * LDO + d] * f;
    }
    if (nsb == 1) {
      *out_at(r, d) = finish_row(M, L, O, a, g * rep + r % rep);
    } else {
      ws_o[((int64_t)sp * rows + r) * D + d] = O;
      if (d == 0) {
        ws_ml[((int64_t)sp * rows + r) * 2] = M;
        ws_ml[((int64_t)sp * rows + r) * 2 + 1] = L;
      }
    }
  }
  if (nsb == 1) return;

  // the last split of this (slot, kv head) to finish merges them all
  __threadfence();
  named_sync(1, NCONS);
  int* flag = reinterpret_cast<int*>(smem + lay.flag);
  if (tid == 0) *flag = atomicAdd(a.tickets + bg, 1) == nsb - 1;
  named_sync(1, NCONS);
  if (!*flag) return;
  __threadfence();
  // every split's (m, l) into shared memory at once (the warps' O is
  // spent), then per row the O columns, their loads unrolled so that they
  // are in flight together: the merge costs a few L2 round trips, not one
  // per split and row
  float* sml = cO;
  for (int j = tid; j < 2 * nsb * rows; j += NCONS) sml[j] = __ldcg(ws_ml + j);
  named_sync(1, NCONS);
  for (int x = tid; x < rows * D; x += NCONS) {
    const int r = x / D, d = x % D;
    float M = NEG_INF;
    for (int i = 0; i < nsb; ++i) M = fmaxf(M, sml[(i * rows + r) * 2]);
    float L = 0.f, O = 0.f;
#pragma unroll 8
    for (int i = 0; i < nsb; ++i) {
      const float f = exp2f(sml[(i * rows + r) * 2] - M);
      L += sml[(i * rows + r) * 2 + 1] * f;
      O += __ldcg(ws_o + ((int64_t)i * rows + r) * D + d) * f;
    }
    *out_at(r, d) = finish_row(M, L, O, a, g * rep + r % rep);
  }
  if (tid == 0) a.tickets[bg] = 0;
}

// rows of a ring stage: the largest multiple of 16 up to 64 that divides bs
int chunk_rows(int bs) {
  for (int cr = MAX_CR; cr >= 16; cr -= 16)
    if (bs % cr == 0) return cr;
  return 0;
}

template <int D>
int launch(const void* pool_k, const void* pool_v, const Args& a, int B, int L,
           cudaStream_t stream) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap tk, tv;
  if (!make_map(&tk, encode, pool_k, L * a.NB, a.BS, a.Hkv, a.cr, D) ||
      !make_map(&tv, encode, pool_v, L * a.NB, a.BS, a.Hkv, a.cr, D))
    return (int)cudaErrorInvalidValue;
  const uint32_t smem = layout(a.cr, D).bytes;
  // the shared-memory opt-in, once per device and size (a host call on
  // the decode loop's every launch otherwise)
  static uint32_t smem_set[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= MAX_DEVICES || smem_set[dev] < smem) {
    e = cudaFuncSetAttribute(paged_decode_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    if (dev < MAX_DEVICES) smem_set[dev] = smem;
  }
  dim3 grid(a.splits, a.Hkv, B);
  paged_decode_kernel<D><<<grid, NTHREADS, smem, stream>>>(tk, tv, a);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, C, Hq, D), pool_k / pool_v (L, NB, BS, Hkv, D) bf16 (D 64, 128 or 256),
// block_table (B, MB) int32, seq_lens (B,) int32, sinks (Hq,) f32 or null
// -> out (B, C, Hq, D) f32. ws: f32 scratch of B Hkv splits (C Hq / Hkv)
// (D + 2); tickets: B Hkv int32, zero (and left zero). splits: per (slot,
// kv head), from paged_decode_split_plan. window: > 0 a sliding window, 0
// full attention.
extern "C" int xt_paged_decode_bf16(const void* q, const void* pool_k, const void* pool_v,
                                    const void* table, const void* seq_lens, const void* sinks,
                                    void* out, void* ws, void* tickets, int B, int C, int Hq,
                                    int Hkv, int d, int L, int NB, int BS, int MB, int layer,
                                    int splits, int window, float scale, void* stream) {
  if ((d != 64 && d != 128 && d != 256) || B <= 0 || B > 65535 || C <= 0 || Hkv <= 0 || Hkv > 65535 ||
      Hq % Hkv != 0 || C * (Hq / Hkv) > MAXR || BS <= 0 || BS % 16 != 0 || BS > 256 ||
      MB <= 0 || NB <= 0 || L <= 0 || layer < 0 || layer >= L || splits <= 0 ||
      splits > MAX_SPLITS || window < 0)
    return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const __nv_bfloat16*>(q), static_cast<const int*>(table),
               static_cast<const int*>(seq_lens), static_cast<const float*>(sinks),
               static_cast<float*>(out), static_cast<float*>(ws), static_cast<int*>(tickets),
               C, Hq, Hkv, NB, BS, MB, layer, splits, chunk_rows(BS), window,
               scale * LOG2E};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 64) return launch<64>(pool_k, pool_v, a, B, L, st);
  if (d == 128) return launch<128>(pool_k, pool_v, a, B, L, st);
  return launch<256>(pool_k, pool_v, a, B, L, st);
}

// the dynamic shared memory of one CTA (bytes) at pool block size bs and
// head dim d (0 for what the kernel does not take)
extern "C" int xt_paged_decode_smem_bytes(int bs, int d) {
  return bs > 0 && bs % 16 == 0 && (d == 64 || d == 128 || d == 256)
             ? (int)layout(chunk_rows(bs), d).bytes
             : 0;
}
