// Block-level exclusive scan and the row-offset scan shared by ccl.cu and
// boundary.cu. Hand-written (no cub): a warp shuffle scan, then a scan of
// the warp totals in shared memory.
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

namespace rvt {
namespace {   // internal linkage: included by several .cu files

constexpr int kScanThreads = 256;           // threads per tile block
constexpr int kScanItems = 4;               // consecutive items per thread
constexpr int kScanTile = kScanThreads * kScanItems;

// Exclusive prefix of `v` over the block's threads in threadIdx order; the
// block total goes to *total. Every thread of the block must call it.
__device__ __forceinline__ int block_exclusive_scan(int v, int* total) {
  __shared__ int warp_sums[32];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[wid] = x;
  __syncthreads();
  if (wid == 0) {
    int s = lane < nw ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    if (lane < nw) warp_sums[lane] = s;      // inclusive over warps
  }
  __syncthreads();
  const int res = (wid > 0 ? warp_sums[wid - 1] : 0) + x - v;
  *total = warp_sums[nw - 1];
  __syncthreads();                            // warp_sums reusable
  return res;
}

// counts c[0..nblk) become their exclusive prefix, and c[nblk] the total.
// Every thread of the block must call it. Reads go through L2: other
// blocks of the same launch may have written the counts.
__device__ void scan_row(int* c, int nblk) {
  int carry = 0;
  for (int base = 0; base < nblk; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const int v = i < nblk ? __ldcg(c + i) : 0;
    int tot;
    const int ex = block_exclusive_scan(v, &tot);
    if (i < nblk) c[i] = carry + ex;
    carry += tot;
  }
  if (threadIdx.x == 0) c[nblk] = carry;
}

// One block per batch row: counts[b, 0..nblk) (row stride nblk + 1) become
// their exclusive prefix, and counts[b, nblk] the row total.
__global__ void scan_rows_kernel(int* counts, int nblk) {
  scan_row(counts + (size_t)blockIdx.x * (nblk + 1), nblk);
}

}  // namespace
}  // namespace rvt
