// Hopper (sm_90a) building blocks shared by the flash-attention kernels
// (flash_fwd.cu, flash_bwd.cu), the grouped GEMMs (grouped_gemm.cu,
// fp8_grouped.cu), the fused CE (fused_ce.cu), the fused expert MLP
// (fused_moe_mlp.cu) and the block-sparse attention (block_sparse.cu):
// mbarriers with a watchdog, TMA loads, stores and reduce-adds of
// 128-byte-swizzled 64-column boxes, bulk copies, wgmma descriptors and
// products (SS and RS, A in registers; fp8 SS), fences, bf16 packing, the
// 64-row tile products, staging and row stores of the block-sparse kernels
// and the flash backward at D != 128, a CTA-wide prefix sum, and the host side's SM count and tensor maps (bf16,
// f32 and uint8 codes).
//
// A shared-memory tile is made of 64-column halves of 128-byte rows,
// swizzled in 1024-byte atoms of 8 rows, as TMA writes them
// (CU_TENSOR_MAP_SWIZZLE_128B) and wgmma descriptors read them (layout
// type 1 << 62). Bases are 1024-byte aligned.
//
// wgmma accumulator layout (m64nN, f32): thread t of the warpgroup holds
// rows 16 (t / 32) + (t % 32) / 4 and that + 8; d[4 j + e] is row + 8 (e / 2),
// column 8 j + 2 (t % 4) + (e % 2). Packing d[4 j], d[4 j + 1] and d[4 j + 2],
// d[4 j + 3] to bf16 pairs gives the register A operand of a k16 product
// over columns 16 kk.. 16 kk + 15 as the four registers 4 kk .. 4 kk + 3.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr long long WATCHDOG_CYCLES = 1ll << 35;  // ~17 s: trap rather than hang
constexpr int MAP_D = 128;  // the head dim of every tensor map

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_reduce_add(float* dst, uint32_t src, uint32_t bytes) {
  asm volatile("cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], [%1], %2;"
               ::"l"(dst), "r"(src), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.b32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

// wait for the phase of parity `parity` to complete; a barrier that never
// completes traps (an error the wrapper reports) instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try(bar, parity))
    if (clock64() - t0 > WATCHDOG_CYCLES) __trap();
}

// box (64 columns, 1 head, rows, 1 batch row) of a (B, L, H, D) bf16 tensor
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int col, int h, int row, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(h), "r"(row), "r"(b), "r"(bar)
      : "memory");
}

// the same box from shared memory to a (B, L, H, D) bf16 tensor; rows past
// L are not written. Commit it, and wait for its reads before the buffer
// is reused or the CTA exits (tma_store_wait)
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int col, int h,
                                          int row, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(col), "r"(h), "r"(row), "r"(b)
      : "memory");
}
__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}
__device__ __forceinline__ void tma_store_wait() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// box (64 columns, rows) of a 2-D bf16 tensor, or (64 columns, rows, 1) of
// a 3-D one (make_map_nd); what lies past an edge reads as zeros
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int col, int row, int plane) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(plane), "r"(bar)
      : "memory");
}
// the same box from shared memory to a 2-D or 3-D tensor; what lies past
// an edge is not written. Commit it, and wait as tma_store does
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, uint32_t src, int col,
                                             int row) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];"
               ::"l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(col), "r"(row)
               : "memory");
}
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, uint32_t src, int col,
                                             int row, int plane) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(col), "r"(row), "r"(plane)
      : "memory");
}

// the same box added element-wise into an f32 3-D tensor (a reduce-add by
// the TMA unit: one read-modify-write per element, no atomics in the
// kernel); what lies past an edge is not touched. Commit and wait as above
__device__ __forceinline__ void tma_reduce_add_3d(const CUtensorMap* map, uint32_t src, int col,
                                                  int row, int plane) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.3d.global.shared::cta.add.bulk_group [%0, {%2, %3, %4}], [%1];"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(col), "r"(row), "r"(plane)
      : "memory");
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// wgmma descriptor of a 128-byte-swizzled operand: start address, leading
// and stride byte offsets (K-major: SBO = 1024 between 8-row groups, LBO
// unused; MN-major: LBO between 64-wide column halves, SBO = 1024 between
// 8-row groups along K)
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// keep the compiler from touching registers an async wgmma reads or writes
// across the wait
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// D(64 x 64, f32 registers) (+)= A(64 x 16, shared) B(16 x 64, shared)
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n64_ss(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
}

// D(64 x 128, f32 registers) (+)= A(64 x 16, shared) B(16 x 128, shared)
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128_ss(float (&d)[64], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
}

// D(64 x 256, f32 registers) (+)= A(64 x 16, shared) B(16 x 256, shared)
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n256_ss(float (&d)[128], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]),
        "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]),
        "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),
        "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]),
        "+f"(d[127])
      : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
}

// D(64 x 64, f32 registers) += A(64 x 16, bf16 registers) B(16 x 64, shared)
template <int TB>
__device__ __forceinline__ void wgmma_m64n64_rs(float (&d)[32], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1), "n"(TB));
}

// D(64 x 128, f32 registers) += A(64 x 16, bf16 registers) B(16 x 128, shared)
template <int TB>
__device__ __forceinline__ void wgmma_m64n128_rs(float (&d)[64], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1), "n"(TB));
}

// D(64 x 128, f32 registers) (+)= A(64 x 32, shared) B(32 x 128, shared), fp8
// codes (TA, TB: 0 e4m3, 1 e5m2), both operands K-major: fp8 wgmma takes
// no transposed operand
#define XT_WGMMA_FP8(TYPES)                                                            \
  asm volatile(                                                                        \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                                     \
      "wgmma.mma_async.sync.aligned.m64n128k32.f32." TYPES " "                         \
      "{"                                                                              \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                                               \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                                         \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                                       \
      "%24, %25, %26, %27, %28, %29, %30, %31, "                                       \
      "%32, %33, %34, %35, %36, %37, %38, %39, "                                       \
      "%40, %41, %42, %43, %44, %45, %46, %47, "                                       \
      "%48, %49, %50, %51, %52, %53, %54, %55, "                                       \
      "%56, %57, %58, %59, %60, %61, %62, %63"                                         \
      "}, %64, %65, p, 1, 1;\n}\n"                                                     \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),        \
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),      \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),  \
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),  \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),  \
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),  \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),  \
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),  \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),  \
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),  \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                             \
      : "l"(da), "l"(db), "r"(acc))
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128k32_fp8(float (&d)[64], uint64_t da, uint64_t db,
                                                     int acc) {
  if constexpr (TA == 0 && TB == 0) XT_WGMMA_FP8("e4m3.e4m3");
  else if constexpr (TA == 1 && TB == 0) XT_WGMMA_FP8("e5m2.e4m3");
  else if constexpr (TA == 0 && TB == 1) XT_WGMMA_FP8("e4m3.e5m2");
  else XT_WGMMA_FP8("e5m2.e5m2");
}
#undef XT_WGMMA_FP8

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---- 64-row tiles of 64-column boxes (the block-sparse kernels and the
// flash backward at D != 128): one box of a 64-row tile is BOX64 bytes
constexpr uint32_t BOX64 = 64 * 128;

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(p) + 1023) &
                                          ~static_cast<uintptr_t>(1023));
}

__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

template <int M, int N>
__device__ __forceinline__ void reg_fence(float (&r)[M][N]) {
#pragma unroll
  for (int m = 0; m < M; ++m) reg_fence(r[m]);
}

// acc[n] (64 x 64 f32, columns 64 n..) += A (16 keys a step, bf16 registers)
// B, where B is an MN-major tile of 64 keys in 64-column boxes at `tile`
template <int N>
__device__ __forceinline__ void acc_rs(float (&acc)[N][32], const uint32_t (&a)[16],
                                       uint32_t tile) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_m64n64_rs<1>(acc[n], a[4 * kk], a[4 * kk + 1], a[4 * kk + 2], a[4 * kk + 3],
                         desc(tile + n * BOX64 + kk * 2048, BOX64, 1024));
}

// s (64 x 64 f32) = A B^T over X columns (a multiple of 16): A, B K-major
// tiles of 64 rows in 64-column boxes, box strides a_box and BOX64
template <int X>
__device__ __forceinline__ void ss_nt(float (&s)[32], uint32_t a, uint32_t a_box, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < X / 16; ++kk)
    wgmma_m64n64_ss<0, 0>(s, desc(a + (kk / 4) * a_box + (kk % 4) * 32, 16, 1024),
                          desc(b + (kk / 4) * BOX64 + (kk % 4) * 32, 16, 1024), kk > 0);
}

// rows of a warpgroup's accumulator (times mul, to bf16) into its 64 rows
// of a 128-row buffer of 64-column boxes (box stride 2 BOX64), swizzled as
// TMA reads them
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
        *reinterpret_cast<uint32_t*>(buf + n * 2 * BOX64 + R * 128 + ((j ^ (R & 7)) << 4) +
                                     4 * tq) =
            pack_bf16(acc[n][4 * j + 2 * r] * mul[r], acc[n][4 * j + 2 * r + 1] * mul[r]);
      }
}

// write one warpgroup's (64 key rows x X) accumulator, times mul, as bf16
// rows of a (B, L, H, XG) tensor, its first XG columns (XG <= X, a multiple
// of 8: a head dim the accumulator pads to X); with BOUNDED, rows at or past
// L are not written (without, the caller's tiles end at L)
template <int X, bool BOUNDED = false, int XG = X>
__device__ __forceinline__ void store_keys(__nv_bfloat16* dst, const float (&acc)[X / 64][32],
                                           float mul, int b, int k0, int h, int L, int H,
                                           int row0, int tq) {
  static_assert(XG <= X && XG % 8 == 0, "the tensor's columns fit the accumulator's");
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + row0 + 8 * r;
    if (BOUNDED && key >= L) continue;
    const int64_t o = (((int64_t)b * L + key) * H + h) * XG + 2 * tq;
#pragma unroll
    for (int n = 0; n < X / 64; ++n)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (64 * n + 8 * j < XG)
          *reinterpret_cast<uint32_t*>(dst + o + 64 * n + 8 * j) =
              pack_bf16(acc[n][4 * j + 2 * r] * mul, acc[n][4 * j + 2 * r + 1] * mul);
  }
}

// the depth of a product over a head dim of `d` columns in k16 steps: d
// rounded up to 16 (the columns past d read as zeros)
__host__ __device__ constexpr int k16(int d) { return (d + 15) / 16 * 16; }

// exclusive prefix sum of v over a CTA of THREADS threads (a multiple of
// 32); `total` gets the sum. wsum: THREADS / 32 ints of shared memory
template <int THREADS>
__device__ __forceinline__ int block_scan(int v, int* wsum, int& total) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int x = v;
#pragma unroll
  for (int off = 1; off < 32; off *= 2) {
    const int y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) wsum[warp] = x;
  __syncthreads();
  int base = 0, tot = 0;
#pragma unroll
  for (int w = 0; w < THREADS / 32; ++w) {
    const int s = wsum[w];
    base += w < warp ? s : 0;
    tot += s;
  }
  __syncthreads();  // wsum is free again
  total = tot;
  return base + x - v;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                     &res);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &res);
#endif
    if (res == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// the card's SM count (a persistent grid's size), read once
int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      n = 0;
  }
  return n;
}

// (B, L, H, cols) bf16 (cols = D = 128 unless given) -> boxes of (64
// columns, 1 head, rows, 1 batch row), 128-byte swizzled; rows past L read
// as zeros
bool make_map(CUtensorMap* map, EncodeTiled encode, const void* ptr, int B, int L, int H,
              int rows, int cols = MAP_D) {
  const cuuint64_t dims[4] = {(cuuint64_t)cols, (cuuint64_t)H, (cuuint64_t)L, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)cols * 2, (cuuint64_t)H * cols * 2,
                                 (cuuint64_t)L * H * cols * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// a contiguous bf16 (or f32) tensor of rank 2 to 4, dims innermost first,
// -> boxes of `box` (the innermost 128 bytes: 64 bf16 or 32 f32 columns),
// 128-byte swizzled; what lies past an edge reads as zeros and is not
// written (one expert's matrix of a (E, K, N) stack mapped as (N, K, E)
// never reads or writes the next expert's rows)
bool make_map_nd(CUtensorMap* map, EncodeTiled encode, const void* ptr, int rank,
                 const cuuint64_t* dims, const cuuint32_t* box, bool f32 = false) {
  cuuint64_t strides[3];
  cuuint64_t stride = f32 ? 4 : 2;
  for (int i = 0; i + 1 < rank; ++i) strides[i] = stride *= dims[i];
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                rank, const_cast<void*>(ptr), dims,
                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// a contiguous uint8 tensor (fp8 codes) of rank 2 or 3, dims innermost
// first -> boxes of `box` (the innermost 128 bytes: 128 codes, one scale
// tile of depth), 128-byte swizzled; what lies past an edge reads as zeros
bool make_map_u8(CUtensorMap* map, EncodeTiled encode, const void* ptr, int rank,
                 const cuuint64_t* dims, const cuuint32_t* box) {
  cuuint64_t strides[2];
  cuuint64_t stride = 1;
  for (int i = 0; i + 1 < rank; ++i) strides[i] = stride *= dims[i];
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, rank, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
