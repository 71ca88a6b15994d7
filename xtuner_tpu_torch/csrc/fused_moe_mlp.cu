// Fused MoE expert MLP forward over expert-sorted rows, for Hopper (sm_90a).
//
// Replaces xtuner_tpu/ops/fused_moe_mlp.py:_mlp_kernel (the pallas_call in
// fused_mlp_fwd_kernel). For every row m of expert e = e(m):
//   gu[m]     = bf16(x[m] @ W_gu[e])                    (f32 accumulation)
//   hidden[m] = bf16(silu(gate) * up), gate, up = gu[m][:F], gu[m][F:] in f32
//   out[m]    = bf16(hidden[m] @ W_dn[e])               (f32 accumulation)
// x (M, H), W_gu (E, H, 2F) (gate | up), W_dn (E, F, H), out (M, H) and
// gu (M, 2F) all bf16; offs (E + 1) int32 = exclusive cumsum of the group
// sizes, on the device. gu is rounded to bf16 before the activation, as the
// TPU kernel does, so the forward matches the decomposed path and the
// backward (ops/fused_moe_mlp.py) re-reads the same bf16 gu. Rows past the
// last group get zeros in out and gu.
//
// What bounds it on the H100: 6 M H F FLOPs against x, out, gu and the
// weights. At the moe_heavy shapes (F 768) the tensor cores bound it; at
// the longctx row's F 128 (about 80 FLOPs per byte of x, out and gu) the
// bytes do, by a little. The trouble is on-chip space, not arithmetic: a
// 64-row tile's f32 output at H 1024 is 256 KB, more than a CTA's 227 KB
// of shared memory and more than the SM's register file, so the output is
// never tiled as a whole.
//
// Design (simple and right first; wgmma/TMA later): one CTA of 8 warps per
// 64-row tile of M. It runs the whole MLP once for each expert whose rows
// meet the tile (loading only that expert's rows, zero-filling the others
// and storing only them), in two phases:
// 1. Over chunks of 64 columns of F: the gate and up chunks (a 64 x 128
//    tile) against all of H with WMMA, f32 accumulators in registers, x and
//    W_gu streamed by cp.async in 32-deep stages of a two-stage ring. The
//    chunk goes through an f32 staging tile; gu is rounded to bf16 and
//    written to device memory (it is an output anyway), and
//    bf16(silu(gate) * up) lands in a (64, F) hidden tile in shared memory.
// 2. Over 128-column chunks of H: out = hidden @ W_dn[e] from shared memory
//    with WMMA, f32 accumulators in registers, W_dn streamed the same way,
//    bf16 written once.
// Every product is computed once, and neither gu nor hidden makes a second
// trip to device memory. The TPU kernel's visit table, dump block,
// straddle read-modify-write and 512-row padding answer the TPU's
// sequential grid and are not needed.
//
// Shape limits: H % 128 == 0 (phase 2's output chunks), F % 64 == 0 (phase
// 1's chunks) and F <= 1536: the hidden tile (64 x (F + 8) bf16) and the
// 33 KB work region must fit the 227 KB a CTA may use. The wrapper raises
// outside them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BM = 64;    // rows per CTA
constexpr int FC = 64;    // gate (and up) columns per phase-1 chunk
constexpr int BN = 128;   // phase-1 chunk width (FC gate + FC up); phase-2 output columns
constexpr int BC = 32;    // contraction depth per stage
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int MAX_F = 1536;
constexpr int LDA = BC + 8;  // x stage (64 x 32): 80-byte rows
constexpr int LDB = BN + 8;  // weight stage (32 x 128): 272-byte rows
constexpr int LDF = BN + 4;  // f32 staging (64 x 128)

constexpr size_t X_STAGE = sizeof(__nv_bfloat16) * BM * LDA;
constexpr size_t W_STAGE = sizeof(__nv_bfloat16) * BC * LDB;
constexpr size_t RING = 2 * (X_STAGE + W_STAGE);
constexpr size_t STAGING = sizeof(float) * BM * LDF;
// the work region holds, one after the other: the phase-1 ring, the f32
// staging tile, the phase-2 ring, the per-warp epilogue scratch
constexpr size_t WORK = RING > STAGING ? RING : STAGING;
static_assert(2 * W_STAGE <= WORK && NWARPS * 256 * sizeof(float) <= WORK, "work region");

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

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

// first expert whose row range ends past row m (offs has E + 1 entries)
__device__ __forceinline__ int first_expert(const int* offs, int E, int m) {
  int lo = 0, hi = E;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (offs[mid + 1] > m) hi = mid; else lo = mid + 1;
  }
  return lo;
}

__device__ __forceinline__ float silu(float g) { return g / (1.0f + expf(-g)); }

// Phase 1, chunk f0: gate|up columns [f0, f0 + 64) and [F + f0, F + f0 + 64)
// of rows [rs, re) -> gu (device) and the hidden tile (shared).
__device__ void gate_up_chunk(const __nv_bfloat16* __restrict__ x,
                              const __nv_bfloat16* __restrict__ wgu,
                              __nv_bfloat16* __restrict__ gu, __nv_bfloat16* sH, int ldh,
                              unsigned char* work, int H, int F, int m0, int rs, int re,
                              int f0) {
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp % 4, wn = warp / 4;  // 16-row slab; 0: gate, 1: up
  __nv_bfloat16* sX = reinterpret_cast<__nv_bfloat16*>(work);
  __nv_bfloat16* sW = reinterpret_cast<__nv_bfloat16*>(work + 2 * X_STAGE);

  auto load = [&](int stage, int c0) {
    __nv_bfloat16* a = sX + stage * (BM * LDA);
    __nv_bfloat16* bt = sW + stage * (BC * LDB);
    {  // x rows: 64 rows x 4 chunks of 8, one per thread
      const int row = tid / (BC / 8), ch = tid % (BC / 8);
      const int grow = m0 + row;
      const bool ok = grow >= rs && grow < re;
      cp_async16(a + row * LDA + ch * 8, ok ? x + (int64_t)grow * H + c0 + ch * 8 : x, ok);
    }
#pragma unroll
    for (int t = 0; t < (BC * BN / 8) / NTHREADS; ++t) {  // W_gu rows c0.., 128 cols
      const int idx = tid + t * NTHREADS;
      const int row = idx / (BN / 8), ch = idx % (BN / 8);
      const int col = ch < FC / 8 ? f0 + ch * 8 : F + f0 + (ch - FC / 8) * 8;
      cp_async16(bt + row * LDB + ch * 8, wgu + (int64_t)(c0 + row) * 2 * F + col, true);
    }
  };

  FragC acc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.f);
  const int n_chunks = H / BC;
  load(0, 0);
  cp_async_commit();
  for (int kc = 0; kc < n_chunks; ++kc) {
    if (kc + 1 < n_chunks) {
      load((kc + 1) & 1, (kc + 1) * BC);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* a = sX + (kc & 1) * (BM * LDA);
    const __nv_bfloat16* bt = sW + (kc & 1) * (BC * LDB);
#pragma unroll
    for (int kk = 0; kk < BC / 16; ++kk) {
      FragA fa;
      wmma::load_matrix_sync(fa, a + (wm * 16) * LDA + kk * 16, LDA);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        FragB fb;
        wmma::load_matrix_sync(fb, bt + (kk * 16) * LDB + wn * 64 + j * 16, LDB);
        wmma::mma_sync(acc[j], fa, fb, acc[j]);
      }
    }
    __syncthreads();  // this stage is free for the load after next
  }

  // the ring is idle: stage the 64 x 128 f32 chunk over it
  float* st = reinterpret_cast<float*>(work);
#pragma unroll
  for (int j = 0; j < 4; ++j)
    wmma::store_matrix_sync(st + (wm * 16) * LDF + wn * 64 + j * 16, acc[j], LDF,
                            wmma::mem_row_major);
  __syncthreads();
  {  // each thread: one row, 16 gate columns and their 16 up columns
    const int r = tid / 4, c = (tid % 4) * 16;
    const int grow = m0 + r;
    __align__(16) __nv_bfloat16 g16[16], u16[16], h16[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      g16[i] = __float2bfloat16(st[r * LDF + c + i]);
      u16[i] = __float2bfloat16(st[r * LDF + FC + c + i]);
      h16[i] = __float2bfloat16(silu(__bfloat162float(g16[i])) * __bfloat162float(u16[i]));
    }
    const uint4* gv = reinterpret_cast<const uint4*>(g16);
    const uint4* uv = reinterpret_cast<const uint4*>(u16);
    const uint4* hv = reinterpret_cast<const uint4*>(h16);
    uint4* hdst = reinterpret_cast<uint4*>(sH + r * ldh + f0 + c);
    hdst[0] = hv[0];
    hdst[1] = hv[1];
    if (grow >= rs && grow < re) {
      uint4* gdst = reinterpret_cast<uint4*>(gu + (int64_t)grow * 2 * F + f0 + c);
      uint4* udst = reinterpret_cast<uint4*>(gu + (int64_t)grow * 2 * F + F + f0 + c);
      gdst[0] = gv[0];
      gdst[1] = gv[1];
      udst[0] = uv[0];
      udst[1] = uv[1];
    }
  }
  __syncthreads();  // the staging tile is the next chunk's ring
}

// Phase 2, output columns [n0, n0 + 128): out = hidden @ W_dn[e] for rows
// [rs, re).
__device__ void down_chunk(const __nv_bfloat16* sH, int ldh,
                           const __nv_bfloat16* __restrict__ wdn,
                           __nv_bfloat16* __restrict__ out, unsigned char* work, int H,
                           int F, int m0, int rs, int re, int n0) {
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp % 4, wn = warp / 4;  // 16 rows x 64 columns per warp
  __nv_bfloat16* sW = reinterpret_cast<__nv_bfloat16*>(work);

  auto load = [&](int stage, int c0) {
    __nv_bfloat16* bt = sW + stage * (BC * LDB);
#pragma unroll
    for (int t = 0; t < (BC * BN / 8) / NTHREADS; ++t) {  // W_dn rows c0.., 128 cols
      const int idx = tid + t * NTHREADS;
      const int row = idx / (BN / 8), ch = idx % (BN / 8);
      cp_async16(bt + row * LDB + ch * 8, wdn + (int64_t)(c0 + row) * H + n0 + ch * 8, true);
    }
  };

  FragC acc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.f);
  const int n_chunks = F / BC;
  load(0, 0);
  cp_async_commit();
  for (int kc = 0; kc < n_chunks; ++kc) {
    if (kc + 1 < n_chunks) {
      load((kc + 1) & 1, (kc + 1) * BC);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* bt = sW + (kc & 1) * (BC * LDB);
#pragma unroll
    for (int kk = 0; kk < BC / 16; ++kk) {
      FragA fa;
      wmma::load_matrix_sync(fa, sH + (wm * 16) * ldh + kc * BC + kk * 16, ldh);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        FragB fb;
        wmma::load_matrix_sync(fb, bt + (kk * 16) * LDB + wn * 64 + j * 16, LDB);
        wmma::mma_sync(acc[j], fa, fb, acc[j]);
      }
    }
    __syncthreads();
  }

  // epilogue: each warp stages one 16 x 16 block at a time in its own 1 KB
  // of the idle ring and stores its rows in [rs, re)
  float* scratch = reinterpret_cast<float*>(work) + warp * 256;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    wmma::store_matrix_sync(scratch, acc[j], 16, wmma::mem_row_major);
    __syncwarp();
    const int row = lane / 2, c8 = (lane % 2) * 8;
    const int grow = m0 + wm * 16 + row;
    if (grow >= rs && grow < re) {
      __align__(16) __nv_bfloat16 v[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) v[c] = __float2bfloat16(scratch[row * 16 + c8 + c]);
      *reinterpret_cast<uint4*>(out + (int64_t)grow * H + n0 + wn * 64 + j * 16 + c8) =
          *reinterpret_cast<const uint4*>(v);
    }
    __syncwarp();
  }
  __syncthreads();  // the scratch is the next chunk's ring
}

__global__ void __launch_bounds__(NTHREADS)
fused_moe_mlp_kernel(const __nv_bfloat16* __restrict__ x,
                     const __nv_bfloat16* __restrict__ wgu,
                     const __nv_bfloat16* __restrict__ wdn, const int* __restrict__ offs,
                     __nv_bfloat16* __restrict__ out, __nv_bfloat16* __restrict__ gu,
                     int M, int E, int H, int F) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldh = F + 8;  // every 16-row fragment start stays 32-byte aligned
  __nv_bfloat16* sH = reinterpret_cast<__nv_bfloat16*>(smem);
  unsigned char* work = smem + sizeof(__nv_bfloat16) * BM * ldh;
  const int m0 = blockIdx.x * BM;
  const int mend = min(m0 + BM, M);
  for (int e = first_expert(offs, E, m0); e < E && offs[e] < mend; ++e) {
    const int rs = max(offs[e], m0);
    const int re = min(offs[e + 1], mend);
    if (rs >= re) continue;  // empty expert
    const __nv_bfloat16* wgu_e = wgu + (int64_t)e * H * 2 * F;
    const __nv_bfloat16* wdn_e = wdn + (int64_t)e * F * H;
    for (int f0 = 0; f0 < F; f0 += FC)
      gate_up_chunk(x, wgu_e, gu, sH, ldh, work, H, F, m0, rs, re, f0);
    for (int n0 = 0; n0 < H; n0 += BN)
      down_chunk(sH, ldh, wdn_e, out, work, H, F, m0, rs, re, n0);
  }
  // rows past the last group (none when the sizes sum to M) get zeros
  const int tail = max(min(offs[E], mend), m0);
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int i = threadIdx.x; i < (mend - tail) * (H / 8); i += NTHREADS)
    reinterpret_cast<uint4*>(out + (int64_t)(tail + i / (H / 8)) * H)[i % (H / 8)] = zero;
  for (int i = threadIdx.x; i < (mend - tail) * (2 * F / 8); i += NTHREADS)
    reinterpret_cast<uint4*>(gu + (int64_t)(tail + i / (2 * F / 8)) * 2 * F)[i % (2 * F / 8)] =
        zero;
}

}  // namespace

// x (M, H), w_gu (E, H, 2F), w_dn (E, F, H), offs (E + 1) int32 exclusive
// cumsum of the group sizes -> out (M, H), gu (M, 2F)
extern "C" int xt_fused_moe_mlp_bf16(const void* x, const void* w_gu, const void* w_dn,
                                     const void* offs, void* out, void* gu, int M, int E,
                                     int H, int F, void* stream) {
  if (M < 0 || E <= 0 || H <= 0 || H % BN != 0 || F <= 0 || F % FC != 0 || F > MAX_F)
    return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  const size_t smem = sizeof(__nv_bfloat16) * BM * (F + 8) + WORK;
  cudaError_t e = cudaFuncSetAttribute(fused_moe_mlp_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const unsigned grid = (unsigned)((M + BM - 1) / BM);
  fused_moe_mlp_kernel<<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w_gu),
      static_cast<const __nv_bfloat16*>(w_dn), static_cast<const int*>(offs),
      static_cast<__nv_bfloat16*>(out), static_cast<__nv_bfloat16*>(gu), M, E, H, F);
  return (int)cudaGetLastError();
}
