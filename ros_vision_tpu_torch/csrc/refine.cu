// P2: subpixel edge refinement of every quad slot, refine_edges.
//
// Replaces ros_vision_tpu/ops/decode.py _refine_edges_core (:167), which
// runs inside the jitted detector on the TPU with its calibrated-camera
// undistortion as a 25-step lax.fori_loop (_undistort, :126): not a Pallas
// kernel, but a device-side loop that eager PyTorch would enqueue op by op
// from the host (~250 launches a call without distortion, ~1,300 with).
// Here one launch does the whole stage. Work per slot: 4 edges x n_alpha
// samples x 25 normal offsets, each two pixel reads and ~46 f32 operations,
// plus ~808 more for the undistortion where the camera is calibrated; at
// the path's 8-32 slots that is far below a microsecond of the card's core
// rate and ~0.1 MB of pixels, so the kernel is bound by its dependent
// chains and the launch, not by bytes or operations.
//
// Design: one block per (b, q) slot, 128 threads per edge (512 a block).
// Each thread sums every 128th term of its edge (refine.cuh thread_sums:
// the terms are independent, so the 25-step undistortions of one edge run
// on 128 threads at once); each warp sums its threads by a shuffle-down
// tree, the edge's first thread sums the four warps in order and fits the
// line; after a __syncthreads four threads intersect consecutive lines into
// the four corners. Every slot is computed, valid or not. No atomics, and
// every sum in a fixed order, so a repeated call gives the same bits.
#include <climits>
#include <cuda_runtime.h>

#include "refine.cuh"

namespace {

constexpr int kEdges = 4;
constexpr int kWarpsPerEdge = rvt_refine::kEdgeThreads / 32;
constexpr int kRefineThreads = kEdges * rvt_refine::kEdgeThreads;

__global__ void __launch_bounds__(kRefineThreads)
    refine_edges_kernel(const uint8_t* __restrict__ gray,
                        const float* __restrict__ corners,
                        const bool* __restrict__ quad_valid,
                        const float* __restrict__ intr,
                        const float* __restrict__ dist,
                        float* __restrict__ out, int intr_stride,
                        int dist_stride, int nq, int h, int w, int n_alpha,
                        int have_dist, int reversed) {
  __shared__ float warp_sums[kEdges][kWarpsPerEdge][6];
  __shared__ rvt_refine::Line lines[kEdges];
  const int slot = blockIdx.x;
  const int b = slot / nq;
  const int edge = threadIdx.x / rvt_refine::kEdgeThreads;
  const int t = threadIdx.x % rvt_refine::kEdgeThreads;
  const float* c = corners + (size_t)slot * 8;
  rvt_refine::Lens lens = {};
  if (have_dist) {
    const float* r = intr + (size_t)b * intr_stride;
    const float* d = dist + (size_t)b * dist_stride;
    lens = {r[0], r[1], r[2], r[3], d[0], d[1], d[2], d[3], d[4]};
  }
  const int next = (edge + 1) & 3;
  const rvt_refine::Edge e = rvt_refine::make_edge(
      c[2 * edge], c[2 * edge + 1], c[2 * next], c[2 * next + 1], n_alpha);

  float m[6];
  rvt_refine::thread_sums(e, gray + (size_t)b * h * w, h, w, n_alpha, lens,
                          have_dist != 0, reversed != 0, t, m);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int q = 0; q < 6; ++q)
      m[q] = rvt_refine::add(m[q], __shfl_down_sync(0xffffffffu, m[q], off));
  if ((t & 31) == 0)
#pragma unroll
    for (int q = 0; q < 6; ++q) warp_sums[edge][t >> 5][q] = m[q];
  __syncthreads();
  if (t == 0) {
    float s[6];
#pragma unroll
    for (int q = 0; q < 6; ++q) {
      s[q] = warp_sums[edge][0][q];
#pragma unroll
      for (int k = 1; k < kWarpsPerEdge; ++k)
        s[q] = rvt_refine::add(s[q], warp_sums[edge][k][q]);
    }
    lines[edge] = rvt_refine::fit_line(e, s);
  }
  __syncthreads();
  if (threadIdx.x < kEdges) {
    const int i = threadIdx.x;
    const int j = (i + 1) & 3;
    float xy[2];
    rvt_refine::corner(lines[i], lines[j], quad_valid[slot], lens,
                       have_dist != 0, c + 2 * j, xy);
    out[(size_t)slot * 8 + 2 * j] = xy[0];
    out[(size_t)slot * 8 + 2 * j + 1] = xy[1];
  }
}

}  // namespace

// gray (B, H, W) u8; corners, out (B, NQ, 4, 2) f32; quad_valid (B, NQ)
// bool; intr (B, 4) [fx, fy, cx, cy] and dist (B, 5) f32 rows, intr_stride
// and dist_stride floats apart (so a (B, 9) intrinsics row serves both),
// read only when have_dist. *launches receives the number of kernel
// launches made. Returns a cudaError_t.
extern "C" int rvt_refine_edges(const uint8_t* gray, const float* corners,
                                const bool* quad_valid, const float* intr,
                                const float* dist, float* out, int* launches,
                                int intr_stride, int dist_stride, int b,
                                int nq, int h, int w, int n_alpha,
                                int have_dist, int reversed_border,
                                int device, cudaStream_t stream) {
  *launches = 0;
  cudaSetDevice(device);
  if (b < 0 || nq < 0 || h < 1 || w < 1 || n_alpha < 1 ||
      (long long)b * nq * 8 > INT_MAX || (long long)h * w > INT_MAX ||
      (long long)n_alpha * rvt_refine::kNormalSteps > INT_MAX ||
      (have_dist && (intr == nullptr || dist == nullptr ||
                     intr_stride < 0 || dist_stride < 0)))
    return (int)cudaErrorInvalidValue;
  const int slots = b * nq;
  if (slots == 0) return 0;
  refine_edges_kernel<<<slots, kRefineThreads, 0, stream>>>(
      gray, corners, quad_valid, intr, dist, out, intr_stride, dist_stride,
      nq, h, w, n_alpha, have_dist, reversed_border);
  const cudaError_t rc = cudaGetLastError();
  *launches = rc == cudaSuccess;
  return (int)rc;
}
