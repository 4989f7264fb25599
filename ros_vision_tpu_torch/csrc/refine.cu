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
// chains, the rate at which one SM runs an edge's undistortions, and the
// launch, not by bytes or operations. A block a slot with 128 threads an
// edge left each thread 6-7 undistortions in a row at 32 samples (25 at
// 128) and 100 of the 132 SMs idle.
//
// Design: one cooperative launch. A block takes one (slot, edge) at a time
// (items blockIdx.x, + gridDim.x, ...), a thread a term of the edge's
// n_alpha x 25 grid (refine.cuh edge_threads: 800 threads at 32 samples,
// 1,024 taking at most 2 and 4 terms at 64 and 128), so that a calibrated
// call's chain is one undistortion; the grid is as many blocks as the card
// holds at once (one an SM), so the path's 32 slots run their 128 edges on
// 128 SMs in one wave. Each thread sums its terms (refine.cuh
// thread_sums); each warp sums its threads by a shuffle-down tree and
// warp 0 the warps' totals by another (zeros past the last warp); the
// line fit (refine.cuh fit_line) takes its five divisions on five threads
// and its f64 cosine and sine on two warps, and the block stores the line
// in `lines`. After a grid
// barrier a thread a corner intersects the lines of its two edges. A slot's
// four edge blocks as one 4-block thread-block cluster, the lines joined
// through distributed shared memory, ran the path's 32 slots in two waves:
// the H100 places at most 30 such clusters at once (one block an SM), and
// one wave is one block's time (PERF.md §6). Every slot is computed,
// valid or not. No atomics, and every sum in a fixed order, so a repeated
// call gives the same bits.
#include <atomic>
#include <climits>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "refine.cuh"

// -DRVT_REFINE_PHASE_CLOCKS (a timing build, off by default; see
// scripts/mb_torch_pose_refine_phases.py): thread 0 of each block adds the
// clock cycles of the kernel's five phases and counts the blocks;
// rvt_refine_clocks(out) returns the five sums, the blocks, the first
// start, the last end and the last start on the global timer (ns), and
// the most blocks that ran on one SM, since the last read. The phases,
// over a block's items: thread 0's terms; the warp trees and the
// __syncthreads (the block's slowest warp); warp 0's tree, the line fit
// and its store; then the grid barrier; the corners.
#ifdef RVT_REFINE_PHASE_CLOCKS
constexpr int kPhases = 5;
constexpr int kMaxSms = 256;
__device__ unsigned long long g_refine_clocks[kPhases + 5];
__device__ unsigned int g_refine_sm_blocks[kMaxSms];
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
// phase 0 starts the block's clock (and -1 restarts it for the next item);
// phases 1-5 add the cycles since the last call to sum phase - 1, and
// phase 5 ends the block
__device__ __forceinline__ void phase_clock(int phase, long long& since) {
  if (threadIdx.x != 0) return;
  const long long now = clock64();
  unsigned long long* c = g_refine_clocks;
  if (phase == 0) {
    const unsigned long long ns = global_ns();
    atomicMin(&c[kPhases + 1], ns);
    atomicMax(&c[kPhases + 3], ns);
    unsigned int sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    const unsigned int on_sm = atomicAdd(&g_refine_sm_blocks[sm % kMaxSms],
                                         1u) + 1u;
    atomicMax(&c[kPhases + 4], (unsigned long long)on_sm);
  } else if (phase > 0) {
    atomicAdd(&c[phase - 1], (unsigned long long)(now - since));
  }
  if (phase == kPhases) {
    atomicAdd(&c[kPhases], 1ull);
    atomicMax(&c[kPhases + 2], global_ns());
  }
  since = now;
}
extern "C" int rvt_refine_clocks(unsigned long long* out) {
  unsigned long long zero[kPhases + 5] = {};
  zero[kPhases + 1] = ~0ull;
  unsigned int none[kMaxSms] = {};
  cudaError_t e = cudaMemcpyFromSymbol(out, g_refine_clocks, sizeof(zero));
  if (e != cudaSuccess) return (int)e;
  e = cudaMemcpyToSymbol(g_refine_sm_blocks, none, sizeof(none));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaMemcpyToSymbol(g_refine_clocks, zero, sizeof(zero));
}
#else
__device__ __forceinline__ void phase_clock(int, long long&) {}
#endif

namespace {

constexpr int kEdges = 4;
constexpr int kMaxWarps = rvt_refine::kMaxEdgeThreads / 32;
constexpr int kMaxDevices = 64;
static_assert(sizeof(rvt_refine::Line) == 5 * sizeof(float),
              "lines holds five floats a line");

__device__ __forceinline__ rvt_refine::Lens lens_of(
    const float* intr, const float* dist, int intr_stride, int dist_stride,
    int b) {
  const float* r = intr + (size_t)b * intr_stride;
  const float* d = dist + (size_t)b * dist_stride;
  return {r[0], r[1], r[2], r[3], d[0], d[1], d[2], d[3], d[4]};
}

template <bool kDist>
__global__ void __launch_bounds__(rvt_refine::kMaxEdgeThreads)
    refine_edges_kernel(const uint8_t* __restrict__ gray,
                        const float* __restrict__ corners,
                        const bool* __restrict__ quad_valid,
                        const float* __restrict__ intr,
                        const float* __restrict__ dist,
                        float* __restrict__ out,
                        rvt_refine::Line* __restrict__ lines,
                        int intr_stride, int dist_stride, int nq, int h,
                        int w, int n_alpha, int reversed, int items) {
  __shared__ float warp_sums[kMaxWarps][6];
  __shared__ float sums[6], quotients[5], sine;
  const int t = threadIdx.x;
  long long since = 0;
  phase_clock(0, since);
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int slot = item / kEdges;
    const int edge = item % kEdges;
    const int b = slot / nq;
    const float* c = corners + (size_t)slot * 8;
    const rvt_refine::Lens lens =
        kDist ? lens_of(intr, dist, intr_stride, dist_stride, b)
              : rvt_refine::Lens{};
    const int next = (edge + 1) & 3;
    const rvt_refine::Edge e = rvt_refine::make_edge(
        c[2 * edge], c[2 * edge + 1], c[2 * next], c[2 * next + 1], n_alpha);
    float m[6];
    rvt_refine::thread_sums(e, gray + (size_t)b * h * w, h, w, n_alpha, lens,
                            kDist, reversed != 0, t, blockDim.x, m);
    phase_clock(1, since);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int q = 0; q < 6; ++q)
        m[q] = rvt_refine::add(m[q], __shfl_down_sync(0xffffffffu, m[q], off));
    if ((t & 31) == 0)
#pragma unroll
      for (int q = 0; q < 6; ++q) warp_sums[t >> 5][q] = m[q];
    __syncthreads();
    phase_clock(2, since);
    if (t < 32) {
      const int warps = blockDim.x >> 5;
#pragma unroll
      for (int q = 0; q < 6; ++q) m[q] = t < warps ? warp_sums[t][q] : 0.0f;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
#pragma unroll
        for (int q = 0; q < 6; ++q)
          m[q] = rvt_refine::add(m[q],
                                 __shfl_down_sync(0xffffffffu, m[q], off));
      if (t == 0)
#pragma unroll
        for (int q = 0; q < 6; ++q) sums[q] = m[q];
    }
    __syncthreads();
    // fit_line with its five divisions on five threads and its cosine and
    // sine on two warps (the same operations, so the same bits)
    if (t < 5) quotients[t] = rvt_refine::dvd(
        sums[t], rvt_refine::moment_divisor(sums));
    __syncthreads();
    if (t == 0 || t == 32) {
      const float theta = rvt_refine::line_angle(quotients);
      if (t == 32) sine = rvt_refine::sin_f64(theta);
      else m[0] = rvt_refine::cos_f64(theta);
    }
    __syncthreads();
    if (t == 0)
      lines[item] = {rvt_refine::add(quotients[0], e.emx),
                     rvt_refine::add(quotients[1], e.emy), m[0], sine,
                     sums[5] > 1e-9f};
    phase_clock(-1, since);
  }
  phase_clock(3, since);
  cooperative_groups::this_grid().sync();
  phase_clock(4, since);
  // corner j of a slot: where the lines of edges j - 1 and j meet
  for (int k = blockIdx.x * blockDim.x + t; k < items;
       k += gridDim.x * blockDim.x) {
    const int slot = k / kEdges;
    const int j = k % kEdges;
    const rvt_refine::Lens lens =
        kDist ? lens_of(intr, dist, intr_stride, dist_stride, slot / nq)
              : rvt_refine::Lens{};
    float xy[2];
    rvt_refine::corner(lines[slot * kEdges + ((j + 3) & 3)], lines[k],
                       quad_valid[slot], lens, kDist,
                       corners + (size_t)k * 2, xy);
    out[(size_t)k * 2] = xy[0];
    out[(size_t)k * 2 + 1] = xy[1];
  }
  phase_clock(5, since);
}

// The blocks of `threads` threads that the device holds at once (the
// grid of a cooperative launch), once per device, variant and warp count.
int resident_blocks(int device, bool have_dist, int threads, int* fit) {
  static std::atomic<int> resident[kMaxDevices][2][kMaxWarps + 1];
  if (device < 0 || device >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  std::atomic<int>& slot = resident[device][have_dist][threads / 32];
  *fit = slot.load(std::memory_order_acquire);
  if (*fit > 0) return 0;
  int per_sm = 0, sms = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm,
      have_dist ? refine_edges_kernel<true> : refine_edges_kernel<false>,
      threads, 0);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  *fit = per_sm * sms;
  slot.store(*fit, std::memory_order_release);
  return 0;
}

}  // namespace

// gray (B, H, W) u8; corners, out (B, NQ, 4, 2) f32; quad_valid (B, NQ)
// bool; lines (B, NQ, 4, 5) f32 scratch, written before it is read; intr
// (B, 4) [fx, fy, cx, cy] and dist (B, 5) f32 rows, intr_stride and
// dist_stride floats apart (so a (B, 9) intrinsics row serves both), read
// only when have_dist. *launches receives the number of kernel launches
// made. Returns a cudaError_t.
extern "C" int rvt_refine_edges(const uint8_t* gray, const float* corners,
                                const bool* quad_valid, const float* intr,
                                const float* dist, float* out, float* lines,
                                int* launches, int intr_stride,
                                int dist_stride, int b, int nq, int h, int w,
                                int n_alpha, int have_dist,
                                int reversed_border, int device,
                                cudaStream_t stream) {
  *launches = 0;
  cudaSetDevice(device);
  if (b < 0 || nq < 0 || h < 1 || w < 1 || n_alpha < 1 ||
      (long long)b * nq * 8 > INT_MAX || (long long)h * w > INT_MAX ||
      (long long)n_alpha * rvt_refine::kNormalSteps +
              rvt_refine::kMaxEdgeThreads > INT_MAX ||
      (have_dist && (intr == nullptr || dist == nullptr ||
                     intr_stride < 0 || dist_stride < 0)))
    return (int)cudaErrorInvalidValue;
  int items = b * nq * kEdges;
  if (items == 0) return 0;
  const int threads = rvt_refine::edge_threads(n_alpha);
  int fit = 0;
  const int err = resident_blocks(device, have_dist != 0, threads, &fit);
  if (err != 0) return err;
  rvt_refine::Line* line_rows = reinterpret_cast<rvt_refine::Line*>(lines);
  void* args[] = {(void*)&gray,        (void*)&corners,     (void*)&quad_valid,
                  (void*)&intr,        (void*)&dist,        (void*)&out,
                  (void*)&line_rows,   (void*)&intr_stride, (void*)&dist_stride,
                  (void*)&nq,          (void*)&h,           (void*)&w,
                  (void*)&n_alpha,     (void*)&reversed_border,
                  (void*)&items};
  const cudaError_t rc = cudaLaunchCooperativeKernel(
      have_dist ? (const void*)refine_edges_kernel<true>
                : (const void*)refine_edges_kernel<false>,
      dim3(items < fit ? items : fit), dim3(threads), args, 0, stream);
  *launches = rc == cudaSuccess;
  return (int)rc;
}
