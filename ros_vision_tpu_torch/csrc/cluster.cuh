// The placement check of a thread-block cluster launch (segment.cu; the
// launchers of histogram.cu, boundary.cu and sort.cu still keep their own
// copies): whether the device can place one cluster of a kernel at all, so
// that a launch it cannot place raises instead of failing later.
#pragma once
#include <atomic>
#include <cuda_runtime.h>

namespace rvt {
namespace {   // internal linkage: included by several .cu files

constexpr int kClusterUnplaceable = -1;  // what a launcher returns then
constexpr int kPortableCluster = 8;
constexpr int kMaxClusterBlocks = 16;    // the H100's, non-portable
constexpr int kMaxPlaceDevices = 64;

// 0 when the device can place one cluster of `cluster` blocks of kKernel,
// each of `threads` threads and `smem` bytes of dynamic shared memory, with
// cfg's other launch attributes; kClusterUnplaceable when it cannot; a
// cudaError_t otherwise. Past the portable 8 blocks it first allows the
// non-portable size. A yes is kept per device and cluster size, so a caller
// passes the largest blocks its plans may ask for.
template <auto kKernel>
int cluster_placeable(int device, const cudaLaunchConfig_t& cfg, int cluster,
                      int threads, int smem) {
  static std::atomic<int> placed[kMaxPlaceDevices][kMaxClusterBlocks + 1];
  if (device < 0 || device >= kMaxPlaceDevices)
    return (int)cudaErrorInvalidDevice;
  if (cluster < 1 || cluster > kMaxClusterBlocks)
    return (int)cudaErrorInvalidValue;
  if (placed[device][cluster].load(std::memory_order_acquire)) return 0;
  cudaError_t err = cudaSuccess;
  if (cluster > kPortableCluster)
    err = cudaFuncSetAttribute(
        kKernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t one = cfg;
  one.gridDim = dim3(cluster, 1, 1);
  one.blockDim = dim3(threads, 1, 1);
  one.dynamicSmemBytes = smem;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kKernel, &one);
  if (err != cudaSuccess) return (int)err;
  if (clusters < 1) return kClusterUnplaceable;
  placed[device][cluster].store(1, std::memory_order_release);
  return 0;
}

}  // namespace
}  // namespace rvt
