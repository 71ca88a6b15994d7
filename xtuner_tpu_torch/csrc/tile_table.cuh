// The table of 64-row tiles of a packed row's segment ids that the flash
// forward (flash_fwd.cu) and the block-sparse kernels (block_sparse.cu)
// walk by: per tile {lowest non-zero id (int32 max if none), highest (0 if
// none), the id if the tile holds one document and no padding else 0, 0},
// over the ids padded to Lp (positions past L read as padding). The
// flash backward's wrapper builds the same table in torch
// (ops/attention/flash.py::_tile_table).

#pragma once

#include <cuda_runtime.h>

namespace {

// one warp per 64-row tile of the ids padded to Lp
__global__ void __launch_bounds__(256)
tile_table_kernel(const int* __restrict__ seg, int4* __restrict__ tiles, int B, int L, int Lp) {
  const int w = (int)((blockIdx.x * blockDim.x + threadIdx.x) / 32);
  const int lane = threadIdx.x % 32;
  const int nt = Lp / 64;
  if (w >= B * nt) return;  // whole warps
  const int b = w / nt, t = w % nt;
  int lo = 0x7fffffff, hi = 0, mn = 0x7fffffff;
  for (int r = 0; r < 2; ++r) {
    const int pos = 64 * t + 32 * r + lane;
    const int v = pos < L ? seg[(int64_t)b * L + pos] : 0;
    hi = max(hi, v);
    mn = min(mn, v);
    if (v != 0) lo = min(lo, v);
  }
  for (int off = 16; off > 0; off /= 2) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
    mn = min(mn, __shfl_xor_sync(0xffffffffu, mn, off));
  }
  if (lane == 0) tiles[w] = make_int4(lo, hi, mn == hi ? hi : 0, 0);
}

// launch it on `stream` for (B, L) ids into a (B, Lp / 64) table
inline cudaError_t launch_tile_table(const int* seg, int4* tiles, int B, int L, int Lp,
                                     cudaStream_t stream) {
  const int warps = B * (Lp / 64);
  tile_table_kernel<<<(warps + 7) / 8, 256, 0, stream>>>(seg, tiles, B, L, Lp);
  return cudaGetLastError();
}

}  // namespace
