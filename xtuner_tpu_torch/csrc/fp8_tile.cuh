// Shared pieces of the tile-wise fp8 GEMM kernels (fp8_gemm.cu: TPU kernel
// #11; fp8_grouped.cu: #12 and #13), for Hopper (sm_90a).
//
// A CTA of 8 warps owns a 128 x 128 f32 output tile. Both operands arrive
// K-major (row r of A and row n of B hold their contraction bytes
// contiguously), which is what the fp8 tensor cores take: the wrappers lay
// the codes out so. The contraction runs in 128-deep steps, one per scale
// tile: each step is accumulated into a fresh register fragment ("part")
// by mma.sync m16n8k32 (fp8 x fp8 -> f32), then scaled by its tile's scales
// and added into the running f32 accumulator, so raw products never run
// across scale tiles.
//
// Shared memory: two stages (cp.async ring, the next step loads while this
// one computes) of a 128 x 128-byte A tile and a 128 x 128-byte B tile,
// 64 KB in all. Each 128-byte row is eight 16-byte chunks stored at chunk
// index (c ^ (row & 7)), so the eight row addresses of an ldmatrix phase
// fall in eight different bank groups.
//
// Warp layout: 2 (M) x 4 (N) warps, each 64 x 32 of the tile: 4 m16 x 4 n8
// fragments, 64 f32 of part and 64 of accumulator per thread.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace xt_fp8 {

constexpr int TILE = 128;              // output rows/cols per CTA, scale tile depth
constexpr int NTHREADS = 256;
constexpr int TILE_BYTES = TILE * TILE;  // one operand tile of one stage
constexpr int SMEM_BYTES = 2 * 2 * TILE_BYTES;  // 2 stages x (A, B)

enum Fp8Type { E4M3 = 0, E5M2 = 1 };

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// byte offset of (row, 16-byte chunk) in a swizzled 128 x 128-byte tile
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * TILE + ((chunk ^ (row & 7)) << 4);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const int n = valid ? 16 : 0;  // 0 source bytes: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(smem)),
               "l"(gmem), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* smem) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(smem)));
}

// d += a (16 x 32, row) * b (32 x 8, col), fp8 in, f32 accumulate
template <int TA, int TB>
__device__ __forceinline__ void mma_fp8(float d[4], const uint32_t a[4], const uint32_t b[2]) {
#define XT_FP8_MMA(TYPES)                                                              \
  asm volatile("mma.sync.aligned.m16n8k32.row.col.f32." TYPES ".f32 "                \
               "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"    \
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])                       \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]))
  if constexpr (TA == E4M3 && TB == E4M3) XT_FP8_MMA("e4m3.e4m3");
  else if constexpr (TA == E5M2 && TB == E4M3) XT_FP8_MMA("e5m2.e4m3");
  else if constexpr (TA == E4M3 && TB == E5M2) XT_FP8_MMA("e4m3.e5m2");
  else XT_FP8_MMA("e5m2.e5m2");
#undef XT_FP8_MMA
}

// Per-thread register state of one 128 x 128 output tile.
struct Frag {
  float v[4][4][4];  // [m16 tile][n8 tile][c0..c3]
};

__device__ __forceinline__ void zero(Frag& f) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) f.v[i][j][c] = 0.f;
}

// part = A tile (128 rows x 128 bytes) . B tile (128 rows x 128 bytes)^T
template <int TA, int TB>
__device__ __forceinline__ void mma_step(Frag& part, const uint8_t* sa, const uint8_t* sb) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4;
  zero(part);
#pragma unroll
  for (int kk = 0; kk < TILE / 32; ++kk) {
    uint32_t a[4][4], b[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = wm * 64 + i * 16 + (lane & 15);
      ldmatrix_x4(a[i], sa + swz(row, kk * 2 + (lane >> 4)));
    }
#pragma unroll
    for (int j2 = 0; j2 < 2; ++j2) {
      const int row = wn * 32 + j2 * 16 + (lane & 7) + ((lane >> 4) << 3);
      uint32_t r[4];
      ldmatrix_x4(r, sb + swz(row, kk * 2 + ((lane >> 3) & 1)));
      b[2 * j2][0] = r[0];
      b[2 * j2][1] = r[1];
      b[2 * j2 + 1][0] = r[2];
      b[2 * j2 + 1][1] = r[3];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_fp8<TA, TB>(part.v[i][j], a[i], b[j]);
  }
}

// Tile-local row of fragment element (i, c) and column of (j, c), for this thread.
__device__ __forceinline__ int frag_row(int i, int c) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  return (warp / 4) * 64 + i * 16 + (lane >> 2) + (c >= 2 ? 8 : 0);
}
__device__ __forceinline__ int frag_col(int j, int c) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  return (warp % 4) * 32 + j * 8 + (lane & 3) * 2 + (c & 1);
}

// Load a 128-row x 128-byte K-major tile: rows row0.. of a (rows, ld) byte
// matrix, bytes col0..col0+127; rows outside [lo, hi) are zero-filled.
__device__ __forceinline__ void load_rows(uint8_t* s, const uint8_t* g, int64_t ld, int row0,
                                          int col0, int lo, int hi) {
#pragma unroll
  for (int t = 0; t < TILE * 8 / NTHREADS; ++t) {
    const int idx = threadIdx.x + t * NTHREADS;
    const int row = idx >> 3, ch = idx & 7;
    const int grow = row0 + row;
    const bool ok = grow >= lo && grow < hi;
    cp_async16(s + swz(row, ch), ok ? g + grow * ld + col0 + ch * 16 : g, ok);
  }
}

template <typename T>
__device__ __forceinline__ void store2(T* p, float a, float b);
template <>
__device__ __forceinline__ void store2<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <>
__device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// One 128 x 128 output tile of rows [rs, re) (inside [m0, m0 + 128)):
// out[m, n0 + c] = sum_t (A[m, t] . B[n0 + c, t]) sa[m, t] sb[t]
// A (M, K) codes, sa (M, K/128) f32 row scales; B (N, K) codes of this CTA's
// weights; sb the per-K-tile scale of B's 128-col block, stride sb_stride.
template <int TA, int TB, typename OutT>
__device__ void scaled_tile(const uint8_t* __restrict__ A, const float* __restrict__ sa,
                            const uint8_t* __restrict__ B, const float* __restrict__ sb,
                            int sb_stride, OutT* __restrict__ out, int K, int N, int m0,
                            int n0, int rs, int re, uint8_t* smem) {
  const int KT = K / TILE;
  uint8_t* sA = smem;
  uint8_t* sB = smem + 2 * TILE_BYTES;
  Frag acc, part;
  zero(acc);

  load_rows(sA, A, K, m0, 0, rs, re);
  load_rows(sB, B, K, n0, 0, n0, n0 + TILE);
  cp_async_commit();
  for (int t = 0; t < KT; ++t) {
    if (t + 1 < KT) {
      const int st = (t + 1) & 1;
      load_rows(sA + st * TILE_BYTES, A, K, m0, (t + 1) * TILE, rs, re);
      load_rows(sB + st * TILE_BYTES, B, K, n0, (t + 1) * TILE, n0, n0 + TILE);
      cp_async_commit();
    }
    // the row scales of this step, read while the tensor cores work
    float rsc[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + frag_row(i, 2 * h);
        rsc[i][h] = (m >= rs && m < re) ? __ldg(sa + (int64_t)m * KT + t) : 0.f;
      }
    const float bsc = __ldg(sb + (int64_t)t * sb_stride);
    if (t + 1 < KT) cp_async_wait<1>(); else cp_async_wait<0>();
    __syncthreads();
    mma_step<TA, TB>(part, sA + (t & 1) * TILE_BYTES, sB + (t & 1) * TILE_BYTES);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc.v[i][j][c] += part.v[i][j][c] * (rsc[i][c >> 1] * bsc);
    __syncthreads();  // this stage is free for the load after next
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + frag_row(i, 2 * h);
      if (m < rs || m >= re) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        store2<OutT>(out + (int64_t)m * N + n0 + frag_col(j, 0), acc.v[i][j][2 * h],
                     acc.v[i][j][2 * h + 1]);
    }
}

}  // namespace xt_fp8
