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
// row at S = 1025, C = 4) stays in L1/L2, so it is not staged in shared
// memory (every block would copy its row's whole table). At the path's
// 2.6 MB a launch weighs as much as the bytes. Design: one launch, one
// thread per 4 consecutive k (one wave at K = 32,768, B = 4): one 16-byte
// load of the 4 indices, the 4 table rows fetched together (one float4
// each through the read-only path when C = 4; otherwise a loop over C),
// then C 16-byte stores along k, one a channel. A ragged K or a pointer
// that is not 16-byte aligned takes scalar loads and stores.
namespace {

constexpr int kTakeThreads = 256;

template <bool kC4, bool kVec>
__global__ void __launch_bounds__(kTakeThreads)
    table_take_cm_kernel(const float* __restrict__ table,
                         const int* __restrict__ idx,
                         float* __restrict__ out, int s, int c, int k) {
  const int k0 = 4 * (blockIdx.x * blockDim.x + threadIdx.x);
  if (k0 >= k) return;
  const int row = blockIdx.y;
  const float* tab = table + (size_t)row * s * c;
  float* o = out + (size_t)row * c * k + k0;
  int j[4];
  if (kVec) {
    const int4 q = __ldg(reinterpret_cast<const int4*>(idx +
                                                       (size_t)row * k + k0));
    j[0] = q.x;
    j[1] = q.y;
    j[2] = q.z;
    j[3] = q.w;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      j[e] = k0 + e < k ? __ldg(idx + (size_t)row * k + k0 + e) : 0;
  }
  bool in[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) in[e] = (unsigned)j[e] < (unsigned)s;
  if (kC4) {
    float4 r[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      r[e] = in[e] ? __ldg(reinterpret_cast<const float4*>(tab) + j[e])
                   : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    reinterpret_cast<float4*>(o)[0] =
        make_float4(r[0].x, r[1].x, r[2].x, r[3].x);
    reinterpret_cast<float4*>(o + k)[0] =
        make_float4(r[0].y, r[1].y, r[2].y, r[3].y);
    reinterpret_cast<float4*>(o + 2 * (size_t)k)[0] =
        make_float4(r[0].z, r[1].z, r[2].z, r[3].z);
    reinterpret_cast<float4*>(o + 3 * (size_t)k)[0] =
        make_float4(r[0].w, r[1].w, r[2].w, r[3].w);
    return;
  }
  for (int ch = 0; ch < c; ++ch) {
    float r[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      r[e] = in[e] ? __ldg(tab + (size_t)j[e] * c + ch) : 0.0f;
    float* oc = o + (size_t)ch * k;
    if (kVec) {
      reinterpret_cast<float4*>(oc)[0] = make_float4(r[0], r[1], r[2], r[3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (k0 + e < k) oc[e] = r[e];
    }
  }
}

}  // namespace

// table (B, S, C), idx (B, K), out (B, C, K). *launches receives the number
// of kernel launches made. Returns a cudaError_t.
extern "C" int rvt_table_take_cm(const float* table, const int* idx,
                                 float* out, int* launches, int b, int s,
                                 int c, int k, int device,
                                 cudaStream_t stream) {
  *launches = 0;
  cudaSetDevice(device);
  if (b == 0 || k == 0 || c == 0) return 0;
  if (b < 0 || b > 65535 || s < 0 || c < 0 || k < 0 || k > (1 << 30))
    return (int)cudaErrorInvalidValue;
  const bool vec = k % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(idx) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const bool c4 = vec && c == 4 &&
                  reinterpret_cast<uintptr_t>(table) % 16 == 0;
  const dim3 grid((k + 4 * kTakeThreads - 1) / (4 * kTakeThreads), b);
  if (c4)
    table_take_cm_kernel<true, true><<<grid, kTakeThreads, 0, stream>>>(
        table, idx, out, s, c, k);
  else if (vec)
    table_take_cm_kernel<false, true><<<grid, kTakeThreads, 0, stream>>>(
        table, idx, out, s, c, k);
  else
    table_take_cm_kernel<false, false><<<grid, kTakeThreads, 0, stream>>>(
        table, idx, out, s, c, k);
  const cudaError_t rc = cudaGetLastError();
  *launches = rc == cudaSuccess;
  return (int)rc;
}
