// P1: tag pose of every quad slot, estimate_poses.
//
// Replaces the device-side loops of ros_vision_tpu/ops/pose.py
// estimate_poses: not a Pallas kernel, but the JAX function's two
// lax.fori_loops (the 8 Newton polar steps at :61 inside each of the
// orthogonal iteration's steps at :107), which run inside the jitted
// detector on the TPU. Eager PyTorch enqueues every 3x3 operation of those
// loops from the host (~14,000 launches a call); here one launch does the
// whole stage. Work: ~2 x 50 x (8 x ~60 + ~250) f32 operations a slot, and
// 88 bytes a slot (H in; R, t and err out), so at the path's 8-512 slots
// the kernel is bound by the slot's dependent chain, not by bytes or the
// core rate: a thread a slot took 0.32 ms on an NVIDIA H100 for one slot
// as for 32 (PERF.md §6), one warp running ~85,800 operations back to
// back.
//
// Design: a slot on a warp (pose.cuh estimate_slot_lanes), one warp a
// block, so the path's 32 slots take 32 SMs and 128 slots 128. Each Newton
// step runs on 9 lanes, one an entry of X: a lane takes its cofactor's
// four operands by shuffles and every lane the whole of X for
// det = X[0] . c[0], so that the step's nine IEEE divisions run side by
// side and its chain is one shuffle round, the cofactor, the 3-term det
// and one division. Each orthogonal-iteration step runs its rotated
// corners and projections on 12 lanes, one a (corner, row), its polar
// input's columns on 6 and their norms on 3, and every lane sums the
// step's translation and the rest from those values in the serial order.
// A warp a slot rather than two slots a warp: a slot's shuffles then take
// the constant full mask. With a half-warp mask (a run-time value), ptxas
// guards every group of shuffles with a MATCH.ANY test of the lanes'
// masks, and in a warp whose halves hold two slots it takes the divergent
// path at each: a Newton step took ~235 cycles (PERF.md §6). A slot
// whose rays are not finite leaves as a whole warp. Every value keeps the
// serial estimate_slot's operands and order, so the kernel gives the bits
// the thread-a-slot kernel gave. A slot reads only its own H and its row's
// intrinsics; there are no atomics and nothing is shared across slots, so
// a call gives the same bits when repeated, in any batch or tier.
#include <climits>
#include <cuda_runtime.h>

#include "pose.cuh"

// -DRVT_POSE_PHASE_CLOCKS (a timing build, off by default; see
// scripts/mb_torch_pose_refine_phases.py): lane 0 of each slot adds the
// clock cycles of the lane form's six phases (pose.cuh's marks) and
// counts the slots; rvt_pose_clocks(out) returns the six sums, the slots,
// and the first start and the last end on the global timer (ns) since the
// last read. The phases, each step: 0 the rotated corners and the
// translation, 1 the projections and the polar input, 2 the polar start,
// 3 the 8 Newton steps, 4 the sign; 5 the rest (rays, the start, the
// mirror, the errors). The start's two polar rotations count in 2-4.
#ifdef RVT_POSE_PHASE_CLOCKS
constexpr int kPhases = 6;
__device__ unsigned long long g_pose_clocks[kPhases + 3];
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
extern "C" int rvt_pose_clocks(unsigned long long* out) {
  unsigned long long zero[kPhases + 3] = {};
  zero[kPhases + 1] = ~0ull;
  cudaError_t e = cudaMemcpyFromSymbol(out, g_pose_clocks, sizeof(zero));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaMemcpyToSymbol(g_pose_clocks, zero, sizeof(zero));
}
#endif

namespace {

constexpr int kSlotLanes = rvt_pose::kSlotLanes;  // a warp a slot
constexpr int kPoseThreads = kSlotLanes;           // a slot a block

// pose.cuh's exchange on the card: a slot's lanes are a warp
struct CardLanes {
  using Q = float;
  int lane;
  __device__ float at(float v, int k) const {
    return __shfl_sync(0xffffffffu, v, k);
  }
  __device__ float own(float v, int) const { return v; }
  template <class F>
  __device__ float each(int n, F f) const {
    return f(lane < n ? lane : n - 1);
  }
#ifdef RVT_POSE_PHASE_CLOCKS
  mutable long long since = 0;
  mutable long long cycles[kPhases] = {};
  __device__ void mark(int p) const {
    const long long now = clock64();
    cycles[p] += now - since;
    since = now;
  }
  __device__ void start() const {
    since = clock64();
    if (lane == 0) atomicMin(&g_pose_clocks[kPhases + 1], global_ns());
  }
  __device__ void end() const {
    mark(5);
    if (lane != 0) return;
#pragma unroll
    for (int p = 0; p < kPhases; ++p)
      atomicAdd(&g_pose_clocks[p], (unsigned long long)cycles[p]);
    atomicAdd(&g_pose_clocks[kPhases], 1ull);
    atomicMax(&g_pose_clocks[kPhases + 2], global_ns());
  }
#else
  __device__ void mark(int) const {}
  __device__ void start() const {}
  __device__ void end() const {}
#endif
};

__global__ void __launch_bounds__(kPoseThreads)
    estimate_poses_kernel(const float* __restrict__ h,
                          const float* __restrict__ fx,
                          const float* __restrict__ fy,
                          const float* __restrict__ cx,
                          const float* __restrict__ cy, float* __restrict__ r,
                          float* __restrict__ t, float* __restrict__ err,
                          int nq, float tag_size, int n_steps) {
  const int i = blockIdx.x;
  const CardLanes ln{(int)threadIdx.x};
  const int b = i / nq;
  float hs[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) hs[k] = h[(size_t)i * 9 + k];
  float rs[9], ts[3], es;
  ln.start();
  if (!rvt_pose::estimate_slot_lanes(ln, hs, fx[b], fy[b], cx[b], cy[b],
                                     tag_size, n_steps, rs, ts, &es)) {
#pragma unroll
    for (int k = 0; k < 9; ++k) rs[k] = NAN;
    ts[0] = ts[1] = ts[2] = es = NAN;
  }
  ln.end();
  if (ln.lane != 0) return;  // every lane holds the result
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
  estimate_poses_kernel<<<total, kPoseThreads, 0, stream>>>(
      h, fx, fy, cx, cy, r, t, err, nq, tag_size, n_steps);
  const cudaError_t rc = cudaGetLastError();
  *launches = rc == cudaSuccess;
  return (int)rc;
}
