// K12: rank gather, out[b, i] = rank_v[b, labels[b, i]], 0 where the label
// lies outside [0, N).
//
// Replaces ros_vision_tpu/ops/gather_pallas.py rank_gather (pallas_call at
// :340, kernel body _make_rank_gather_kernel:285), the rank broadcast of
// ccl.flood_ranks at (B, N) with N < 2^19. The TPU factors the label into
// (label >> 9, label & 511) and gathers through two one-hot MXU products
// because it has no fast random gather. Bound on the H100: bytes, 8 read
// and 4 written per element (the (B, N) table stays in the 50 MB L2 at
// 1080p: 2 MB per frame). Design: one thread per element, a bounds check
// and one indexed load.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void rank_gather_kernel(const int* __restrict__ labels,
                                   const int* __restrict__ rank_v, int* out,
                                   int n, int total) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int lab = labels[i];
  out[i] = (lab >= 0 && lab < n) ? rank_v[(size_t)(i / n) * n + lab] : 0;
}

}  // namespace

extern "C" int rvt_rank_gather(const int* labels, const int* rank_v, int* out,
                               int b, int n, int device, cudaStream_t stream) {
  cudaSetDevice(device);
  const int total = b * n;
  const int t = 256;
  rank_gather_kernel<<<(total + t - 1) / t, t, 0, stream>>>(labels, rank_v,
                                                             out, n, total);
  return (int)cudaGetLastError();
}
