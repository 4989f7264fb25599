// K4: value histogram, out[b, s] = #(values[b, :] == s) for s in [0, S);
// values outside [0, S) are not counted.
//
// Replaces ros_vision_tpu/ops/gather_pallas.py value_histogram
// (pallas_call at :168, kernel body _make_hist_kernel:131), which
// cluster_and_fit calls for the per-segment point and peak counts
// (quadfit.py:278,492) at (B, 32768) (1280x800) and (B, 131072)
// (1920x1080) with S = 1025.
//
// Bound on the H100: bytes (128-512 KB per frame, ~0.2-0.6 us at 3.35
// TB/s); in practice a launch and the counting's shared-memory atomics.
// The TPU kernel built one-hot (K_TILE, 512) planes and summed them
// because the TPU has no scatter-add. Here one thread-block cluster of C =
// 8 blocks takes a row in one launch:
//   - counting: each block counts its slices of the row (4,096 values a
//     block at K = 32,768, 16,384 at 131,072) into its own S-bin table in
//     shared memory. The values arrive as sorted segment ids or mostly the
//     sentinel S - 1, so neighbouring lanes mostly hold the same value:
//     lanes are grouped with __match_any_sync and one leader per group adds
//     the group's popcount, which removes the same-address serialisation;
//   - merge: after cluster.sync(), block rank r sums bins
//     [r * ceil(S / C), (r + 1) * ceil(S / C)) over the C tables through
//     distributed shared memory and writes that slice of the output row
//     with plain coalesced stores;
//   - a second cluster.sync() keeps every table alive until it is read.
// Every output bin is written exactly once: no memset of the output and no
// global atomics. Counts are integers, so the result is bit-exact in any
// order. The plan holds S at most 8,192 (one 32 KB table, within the 48 KB
// a block has without opting in).
//
// The launch plan (C, threads, bins per rank, shared bytes) is
// ops/gather_kernel.py histogram_plan's; rvt_value_histogram takes it as
// given and checks only what the device and the kernel's layout require.
#include <atomic>
#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxCluster = 8;   // the portable cluster size limit
constexpr int kMaxThreads = 1024;
constexpr int kDefaultSmem = 48 * 1024;  // a block's shared memory, no opt-in
constexpr int kItems = 4;  // values a thread loads before counting them
constexpr int kMaxDevices = 64;
constexpr int kClusterUnplaceable = -1;

__global__ void __launch_bounds__(kMaxThreads)
    hist_cluster_kernel(const int* __restrict__ values, int* out, int k,
                        int s, int per_rank) {
  extern __shared__ int bins[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int c = (int)cluster.num_blocks();
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  for (int i = tid; i < s; i += blockDim.x) bins[i] = 0;
  __syncthreads();
  const int* v = values + (size_t)blockIdx.y * k;
  const int span = blockDim.x * kItems;
  // the loop bound is uniform over the block, so every lane of every warp
  // reaches __match_any_sync together
  for (int base = rank * span; base < k; base += c * span) {
    int val[kItems];
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      const int i = base + it * blockDim.x + tid;
      val[it] = i < k ? v[i] : -1;
    }
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      const bool in = val[it] >= 0 && val[it] < s;
      const unsigned peers = __match_any_sync(0xffffffffu, in ? val[it] : -1);
      if (in && lane == __ffs(peers) - 1)
        atomicAdd(bins + val[it], __popc(peers));
    }
  }
  cluster.sync();
  int* o = out + (size_t)blockIdx.y * s;
  const int hi = min(s, (rank + 1) * per_rank);
  for (int i = rank * per_rank + tid; i < hi; i += blockDim.x) {
    int sum = 0;
    for (int r = 0; r < c; ++r) sum += cluster.map_shared_rank(bins, r)[i];
    o[i] = sum;
  }
  cluster.sync();
}

// Once per process, device and cluster size: that the device can place
// such a cluster.
int prepare(int device, const cudaLaunchConfig_t& cfg, int cluster) {
  static std::atomic<int> placed[kMaxDevices][kMaxCluster + 1];
  if (device < 0 || device >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (placed[device][cluster].load(std::memory_order_acquire)) return 0;
  cudaLaunchConfig_t one = cfg;
  one.gridDim = dim3(cluster, 1, 1);
  int clusters = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveClusters(&clusters, hist_cluster_kernel, &one);
  if (err != cudaSuccess) return (int)err;
  if (clusters < 1) return kClusterUnplaceable;
  placed[device][cluster].store(1, std::memory_order_release);
  return 0;
}

}  // namespace

// values (B, K), out (B, S); cluster, threads, per_rank and smem the plan of
// ops/gather_kernel.py histogram_plan. *launches receives the number of
// kernel launches made. Returns a cudaError_t, or -1 when the device
// cannot place the cluster.
extern "C" int rvt_value_histogram(const int* values, int* out,
                                   int* launches, int b, int k, int s,
                                   int cluster, int threads, int per_rank,
                                   int smem, int device,
                                   cudaStream_t stream) {
  *launches = 0;
  cudaSetDevice(device);
  if (b == 0 || s == 0) return 0;
  // the layout: whole warps (__match_any_sync over all 32 lanes), every
  // bin in one rank's slice, the S-bin table in shared memory
  if (s < 0 || k < 0 || cluster < 1 || cluster > kMaxCluster ||
      threads < 32 || threads % 32 != 0 || threads > kMaxThreads ||
      per_rank < 1 || (long long)per_rank * cluster < s ||
      smem < (int)sizeof(int) * s || smem > kDefaultSmem)
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, b, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const int err = prepare(device, cfg, cluster);
  if (err != 0) return err;
  const cudaError_t rc = cudaLaunchKernelEx(&cfg, hist_cluster_kernel, values,
                                            out, k, s, per_rank);
  *launches = rc == cudaSuccess;
  return (int)rc;
}
