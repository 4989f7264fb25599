// K11: per-segment min and max, mn[b, s] = min(2^30, min{val[b, i] :
// seg[b, i] == s}) and mx[b, s] = max(-2^30, max{...}) for s in [0, S);
// an empty segment reads 2^30 / -2^30 and a segment id outside [0, S) is
// dropped.
//
// Replaces ros_vision_tpu/ops/gather_pallas.py segment_min_max
// (pallas_call at :251, kernel body _make_minmax_kernel:201). The TPU
// masks a one-hot (K_TILE, 256) plane per S-chunk and reduces it, because
// it has no scatter-min. Bound on the H100: bytes, seg and val read once
// (1 MB per 131,072-point frame) and the two (B, S) tables written once.
// Design: each block keeps both tables of its batch row for a slice of at
// most kSegs segments in shared memory (2 x 4 KB at S = 1025), folds its
// share of the points in with shared atomicMin/atomicMax, and merges the
// entries it changed into the global tables (first filled with +-2^30)
// with global atomics. Min and max are order-independent, so the result
// is bit-exact whatever the order. Lanes holding the same segment (sorted
// ids put whole warps on one) reduce with __reduce_min_sync /
// __reduce_max_sync first and one leader per group updates the table.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItemsPerThread = 8;
constexpr int kSegs = 4096;       // segments per block slice: 32 KB of tables
constexpr int kBig = 1 << 30;

__global__ void fill_minmax_kernel(int* mn, int* mx, int total) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < total) {
    mn[i] = kBig;
    mx[i] = -kBig;
  }
}

__global__ void segment_minmax_kernel(const int* __restrict__ seg,
                                      const int* __restrict__ val, int* mn,
                                      int* mx, int k, int s) {
  __shared__ int tmin[kSegs];
  __shared__ int tmax[kSegs];
  const int row = blockIdx.y;
  const int s0 = blockIdx.z * kSegs;
  const int ns = min(kSegs, s - s0);
  for (int i = threadIdx.x; i < ns; i += blockDim.x) {
    tmin[i] = kBig;
    tmax[i] = -kBig;
  }
  __syncthreads();
  const int* sg = seg + (size_t)row * k;
  const int* vl = val + (size_t)row * k;
  const int lane = threadIdx.x & 31;
  const int stride = gridDim.x * blockDim.x;
  // the loop bound is uniform over the block, so every lane of every warp
  // reaches __match_any_sync together
  for (int base = blockIdx.x * blockDim.x; base < k; base += stride) {
    const int i = base + threadIdx.x;
    const int sl = i < k ? sg[i] - s0 : -1;
    const bool in = sl >= 0 && sl < ns;
    const int key = in ? sl : -1;
    const int v = i < k ? vl[i] : 0;
    const unsigned peers = __match_any_sync(0xffffffffu, key);
    const int lo = __reduce_min_sync(peers, v);
    const int hi = __reduce_max_sync(peers, v);
    if (in && lane == __ffs(peers) - 1) {
      atomicMin(tmin + sl, lo);
      atomicMax(tmax + sl, hi);
    }
  }
  __syncthreads();
  int* om = mn + (size_t)row * s + s0;
  int* ox = mx + (size_t)row * s + s0;
  for (int i = threadIdx.x; i < ns; i += blockDim.x) {
    if (tmin[i] != kBig) atomicMin(om + i, tmin[i]);
    if (tmax[i] != -kBig) atomicMax(ox + i, tmax[i]);
  }
}

}  // namespace

extern "C" int rvt_segment_min_max(const int* seg, const int* val, int* mn,
                                   int* mx, int b, int k, int s, int device,
                                   cudaStream_t stream) {
  cudaSetDevice(device);
  const int total = b * s;
  if (total == 0) return 0;
  fill_minmax_kernel<<<(total + kThreads - 1) / kThreads, kThreads, 0,
                       stream>>>(mn, mx, total);
  if (k == 0) return (int)cudaGetLastError();
  const int per_block = kThreads * kItemsPerThread;
  segment_minmax_kernel<<<dim3((k + per_block - 1) / per_block, b,
                               (s + kSegs - 1) / kSegs),
                          kThreads, 0, stream>>>(seg, val, mn, mx, k, s);
  return (int)cudaGetLastError();
}
