// K4: value histogram, out[b, s] = #(values[b, :] == s) for s in [0, S);
// values outside [0, S) are not counted.
//
// Replaces ros_vision_tpu/ops/gather_pallas.py value_histogram
// (pallas_call at :168, kernel body _make_hist_kernel:131), which
// cluster_and_fit calls for the per-segment point and peak counts
// (quadfit.py:326,672) at (B, 8192) or (B, 32768) with S = 1025.
//
// Bound on the H100: launch latency and shared-memory atomics. The input
// is 32-128 KB per frame, far below any bandwidth limit. The TPU kernel
// built one-hot (K_TILE, 512) planes and summed them because the TPU has
// no scatter-add; here each block keeps a private S-bin histogram of its
// batch row in shared memory (4.1 KB), counts its slice with shared
// atomicAdd, and adds the non-zero bins into the zeroed global row. The
// segment ids arrive sorted, so neighbouring lanes mostly hold the same
// value: lanes are grouped with __match_any_sync and one leader per group
// adds the group's popcount, which removes the same-address serialisation.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItemsPerThread = 4;

__global__ void hist_kernel(const int* __restrict__ values, int* out, int k,
                            int s) {
  extern __shared__ int bins[];
  const int b = blockIdx.y;
  for (int i = threadIdx.x; i < s; i += blockDim.x) bins[i] = 0;
  __syncthreads();
  const int* v = values + (size_t)b * k;
  const int lane = threadIdx.x & 31;
  const int stride = gridDim.x * blockDim.x;
  // the loop bound is uniform over the block, so every lane of every warp
  // reaches __match_any_sync together
  for (int base = blockIdx.x * blockDim.x; base < k; base += stride) {
    const int i = base + threadIdx.x;
    const int val = i < k ? v[i] : -1;
    const bool in = val >= 0 && val < s;
    const unsigned peers = __match_any_sync(0xffffffffu, in ? val : -1);
    if (in && lane == __ffs(peers) - 1) atomicAdd(bins + val, __popc(peers));
  }
  __syncthreads();
  int* o = out + (size_t)b * s;
  for (int i = threadIdx.x; i < s; i += blockDim.x)
    if (bins[i] != 0) atomicAdd(o + i, bins[i]);
}

}  // namespace

extern "C" int rvt_value_histogram(const int* values, int* out, int b, int k,
                                   int s, int device, cudaStream_t stream) {
  cudaSetDevice(device);
  cudaError_t err = cudaMemsetAsync(out, 0, sizeof(int) * (size_t)b * s,
                                    stream);
  if (err != cudaSuccess) return (int)err;
  const int per_block = kThreads * kItemsPerThread;
  const int nx = (k + per_block - 1) / per_block;
  hist_kernel<<<dim3(nx > 0 ? nx : 1, b), kThreads, sizeof(int) * s,
                stream>>>(values, out, k, s);
  return (int)cudaGetLastError();
}
