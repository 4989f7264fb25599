// P1: tag pose of every quad slot, estimate_poses.
//
// Replaces the device-side loops of ros_vision_tpu/ops/pose.py
// estimate_poses: not a Pallas kernel, but the JAX function's two
// lax.fori_loops (the 8 Newton polar steps at :61 inside each of the
// orthogonal iteration's steps at :107), which run inside the jitted
// detector on the TPU. Eager PyTorch enqueues every 3x3 operation of those
// loops from the host (~14,000 launches a call); here one launch does the
// whole stage. Work: ~2 x 50 x (8 x ~60 + ~250) f32 operations a slot in
// one dependent chain, and 88 bytes a slot (H in; R, t and err out), so at
// the path's 8-512 slots the kernel is bound by the chain's latency, not by
// bytes or the core rate. Design: one thread per (b, q) slot, 128 threads
// a block, the slot's rays, projectors, G, R and t in registers
// (pose.cuh). A slot reads only its own H and its row's intrinsics; there
// are no atomics and nothing is shared across slots, so a call gives the
// same bits when repeated, in any batch or tier.
#include <climits>
#include <cuda_runtime.h>

#include "pose.cuh"

namespace {

constexpr int kPoseThreads = 128;

__global__ void __launch_bounds__(kPoseThreads)
    estimate_poses_kernel(const float* __restrict__ h,
                          const float* __restrict__ fx,
                          const float* __restrict__ fy,
                          const float* __restrict__ cx,
                          const float* __restrict__ cy, float* __restrict__ r,
                          float* __restrict__ t, float* __restrict__ err,
                          int nq, int total, float tag_size, int n_steps) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int b = i / nq;
  float hs[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) hs[k] = h[(size_t)i * 9 + k];
  float rs[9], ts[3], es;
  rvt_pose::estimate_slot(hs, fx[b], fy[b], cx[b], cy[b], tag_size, n_steps,
                          rs, ts, &es);
#pragma unroll
  for (int k = 0; k < 9; ++k) r[(size_t)i * 9 + k] = rs[k];
#pragma unroll
  for (int k = 0; k < 3; ++k) t[(size_t)i * 3 + k] = ts[k];
  err[i] = es;
}

}  // namespace

// h (B, NQ, 3, 3); fx, fy, cx, cy (B,); r (B, NQ, 3, 3), t (B, NQ, 3),
// err (B, NQ). *launches receives the number of kernel launches made.
// Returns a cudaError_t.
extern "C" int rvt_estimate_poses(const float* h, const float* fx,
                                  const float* fy, const float* cx,
                                  const float* cy, float* r, float* t,
                                  float* err, int* launches, int b, int nq,
                                  float tag_size, int n_steps, int device,
                                  cudaStream_t stream) {
  *launches = 0;
  cudaSetDevice(device);
  if (b < 0 || nq < 0 || n_steps < 0 || (long long)b * nq * 9 > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const int total = b * nq;
  if (total == 0) return 0;
  estimate_poses_kernel<<<(total + kPoseThreads - 1) / kPoseThreads,
                          kPoseThreads, 0, stream>>>(
      h, fx, fy, cx, cy, r, t, err, nq, total, tag_size, n_steps);
  const cudaError_t rc = cudaGetLastError();
  *launches = rc == cudaSuccess;
  return (int)rc;
}
