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

// K10: channel-major table gather, out[b, c, k] = table[b, idx[b, k], c],
// 0 where the index lies outside [0, S).
//
// Replaces ros_vision_tpu/ops/gather_pallas.py table_take_cm (pallas_call
// at :95, kernel body _make_take_kernel:57). The TPU builds a one-hot
// (K_TILE, 256) f32 plane per S-chunk and takes table^T @ onehot on the
// MXU, because it has no fast random gather. That product equals the
// gather for finite tables except that -0.0 comes out +0.0, and an inf or
// NaN anywhere in a 256-row chunk turns the whole chunk's column into NaN
// (0 * inf); this kernel gathers directly, to table_take_cm_ref's contract
// (-0.0, inf and NaN are copied). Bound on the H100: bytes, the (B, K)
// indices and (B, C, K) output once each; the (B, S, C) table (16 KB per
// row at S = 1025, C = 4) stays in L1/L2. Design: one thread per (b, k),
// a bounds check, C loads of one table row, C stores coalesced along k.
namespace {

__global__ void table_take_cm_kernel(const float* __restrict__ table,
                                     const int* __restrict__ idx, float* out,
                                     int s, int c, int k) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= k) return;
  const int row = blockIdx.y;
  const int j = idx[(size_t)row * k + i];
  const bool in = j >= 0 && j < s;
  const float* t = table + ((size_t)row * s + (in ? j : 0)) * c;
  float* o = out + (size_t)row * c * k + i;
  for (int ch = 0; ch < c; ++ch) o[(size_t)ch * k] = in ? t[ch] : 0.0f;
}

}  // namespace

extern "C" int rvt_table_take_cm(const float* table, const int* idx,
                                 float* out, int b, int s, int c, int k,
                                 int device, cudaStream_t stream) {
  cudaSetDevice(device);
  if (b == 0 || k == 0) return 0;
  const int t = 256;
  table_take_cm_kernel<<<dim3((k + t - 1) / t, b), t, 0, stream>>>(
      table, idx, out, s, c, k);
  return (int)cudaGetLastError();
}
